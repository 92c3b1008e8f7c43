"""In a fresh interpreter: importing every module of the benchmark, and
running a cell's set-up and window on the CPU, loads neither JAX nor the
JAX package (top-level names compared whole), and the reference's modules
load nothing of the program."""

import os
import subprocess
import sys

from core import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "dextractor_tpu")

SCRIPT = r"""
import glob, importlib, importlib.util, os, sys
here, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [here]
import ref.encode, ref.gen, ref.huffman
leaked = sorted({m.split(".")[0] for m in sys.modules} & {"dextractor_tpu_torch"})
assert not leaked, ("the reference loads", leaked)
sys.path.insert(1, root)
for mod in ("core.device", "core.formulas", "core.kinds", "core.peaks", "core.registry", "core.runner",
            "core.trace", "run", "control"):
    importlib.import_module(mod)
for path in glob.glob(os.path.join(here, "metrics", "*.py")):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import time
from core import runner
cfg = None
sys.path.insert(0, os.path.join(here, "tests"))
import tiny
for w in ("rs2-p6.decode_step", "rs2-2kb.compress"):
    tiny.run(w)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_nothing_loads_jax_or_the_jax_package():
    here = os.path.join(registry.ROOT, "portbench")
    out = subprocess.run([sys.executable, "-c", SCRIPT, here, registry.ROOT],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "dextractor_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
