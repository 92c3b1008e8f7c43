#!/usr/bin/env python3
"""Run one cell of the benchmark of dextractor_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
metrics are found by the names in BENCHMARK.json (core/registry.py).  The
run fixes its thread count, makes its files from the seed, warms up, measures for ``--seconds``,
checks every answer due in the window against the plain reference
(``ref/``), and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit, which also end standard error.

It exits with another code than 0, and prints no result, when CUDA is not
available or the cell asks for more cards than there are, and when the
process holds JAX or the JAX package once the window has closed.  Build and
kernel caches, and Python's bytecode, stay inside the checkout
(``portbench/_cache/``, and the program's own ``dextractor_tpu_torch/_build/``
and ``native/build/``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dextractor_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare():
    """The run's settings, before torch is imported: the thread count and
    the build and kernel caches inside the checkout.  Returns the registry
    module and the loaded BENCHMARK.json."""
    cache = os.path.join(HERE, "_cache")
    # Python's bytecode too, torch's included: where the environment says
    # not to write it (PYTHONDONTWRITEBYTECODE), every run would compile
    # torch's sources again, seconds of host time that swing with the load
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(cache, "pyc")
    sys.path.insert(0, HERE)
    from core import device, registry

    log(f"portbench: {device.steady()}")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    sys.path.insert(1, ROOT)
    return registry, registry.load(ROOT)


def card(chips: int) -> bool:
    """Import torch with the fixed thread count; False (and why, on standard
    error) when the cell's cards are not there."""
    import torch

    from core import device

    log(f"portbench: set-up: torch imported at {time.perf_counter() - T0:.3f} s")
    torch.set_num_threads(device.THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return False
    log(f"portbench: card {device.readings()}")
    log(f"portbench: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.get_num_threads()} threads")
    return True


def main(argv=None) -> int:
    args = parse(argv)
    registry, bench = prepare()
    if not card(int(registry.cell(bench, args.workload)["chips"])):
        return 3
    from core import runner

    result, checks = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     t_start=T0, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the process holds {bad} after the window")
        return 4
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
