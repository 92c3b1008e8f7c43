#!/usr/bin/env python3
"""Read a cell's checks over many seeds in one process, the program sound
or on its lossy path (the control), to set and test the limits.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 4 --lossy 1

One JSON line a seed: the seed, ``correct`` and each number compared.  With
``--lossy 1`` the program runs its own lower-precision path (``dexqv -l``:
insQV and mergeQV quantised) where the cell would run it losslessly, and is
judged against the lossless reference: every seed has to come out not
correct.  The benchmark's own runs (``run.py``) never do this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--lossy", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    registry, bench = run.prepare()
    if not run.card(int(registry.cell(bench, args.workload)["chips"])):
        return 3
    from core import runner

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, checks = runner.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                                         lossy=bool(args.lossy), log=run.log)
        print(json.dumps({"seed": seed, "lossy": args.lossy, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "checks": result["checks"], "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
