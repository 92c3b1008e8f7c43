"""Host-clock seconds of the batched QV decodes of several checkouts of this
repository, alternated in one run on one device.

Each tree given runs, in the order given, in a fresh interpreter with that
tree first on its path (so a parent checkout is timed by its own package,
through entry points that every tree since the DB family has):

  decode <batch> <route>  ``decode_dexqv_to_quiva(enc, device=...)`` of the
                          uniform and the long-read batch (testing.
                          uniform_quiva, long_quiva; encoded by the native
                          host encoder) on the segmented and the per-read
                          route (``DXT_SEG_DECODE=0``), each output checked
                          against the original;
  db <route>              ``DazzDB.load_all_qventries(1, device=...)`` of a
                          two-cell DB of both batches (testing.make_bam and
                          dex2DB, built once by this process) on the fused
                          and the per-scheme route (``DXT_DB_FUSED=0``),
                          the two routes' streams checked equal.

Each time is the median over ``--reps`` calls after one warm-up call (which
builds the kernels in a tree's first run).  Run the trees as A B B A to see
the drift of the card between runs.

    python -m dextractor_tpu_torch.tools.decode_ab --trees PARENT . . PARENT
        [--reps 5] [--device cuda]

Prints the card's name and power limit, then one ``DECODE_AB: {...}`` JSON
line a run of a tree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

SNIPPET = r"""
import json, os, statistics, sys, time
import numpy as np
import torch
from dextractor_tpu_torch import testing
from dextractor_tpu_torch.codecs.qv_codec import decode_dexqv_to_quiva, encode_quiva_to_dexqv
from dextractor_tpu_torch.db import open_db

args = json.loads(sys.argv[1])
dev = torch.device(args["device"])


def timed(fn, check):
    fn()
    secs = []
    for _ in range(args["reps"]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
        if not check(out):
            raise AssertionError("a decode differs from its reference")
    return statistics.median(secs)


res = {}
for name, quiva in (("uniform", testing.uniform_quiva()), ("long_reads", testing.long_quiva())):
    enc = encode_quiva_to_dexqv(quiva, device=False)
    for route, flag in (("segmented", "1"), ("per_read", "0")):
        os.environ["DXT_SEG_DECODE"] = flag
        res[f"decode {name} {route}"] = timed(
            lambda: decode_dexqv_to_quiva(enc, device=dev), lambda out: out == quiva)
os.environ["DXT_SEG_DECODE"] = "1"
db = open_db(args["db"])
db.open_qvs()
want = []
for route, flag in (("fused", "1"), ("scheme", "0")):
    os.environ["DXT_DB_FUSED"] = flag
    want = want or [db.load_all_qventries(1, device=dev)[0]]
    res[f"db {route}"] = timed(lambda: db.load_all_qventries(1, device=dev),
                               lambda out: np.array_equal(out[0], want[0]))
print("DECODE_AB: " + json.dumps({"tree": args["tree"], "seconds": res}), flush=True)
"""


def build_db(workdir: str) -> str:
    """The two-cell DB of both batches in ``workdir``; returns its path."""
    import numpy as np

    from .. import testing
    from ..cli import main as tool

    n = testing.BENCH_MB * 1_000_000 // (5 * testing.UNIFORM_READ_LEN)
    r = testing.UNIFORM_READ_LEN
    bams = [testing.make_bam(np.random.default_rng(0), n_reads=n, min_len=r - 50,
                             max_len=r + 50, level=1, movie=b"m0")[0],
            testing.make_bam(np.random.default_rng(2), lengths=testing.lognormal_lengths(),
                             level=1, movie=b"m1")[0]]
    paths = []
    for k, bam in enumerate(bams):
        paths.append(os.path.join(workdir, f"m{k}.subreads.bam"))
        with open(paths[-1], "wb") as f:
            f.write(bam)
    db = os.path.join(workdir, "both")
    if tool(["dex2DB", "-q", "-eln>=0", db, *paths]) != 0:
        raise RuntimeError("dex2DB failed")
    return db + ".db"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=int, default=900)
    a = ap.parse_args(argv)
    smi = shutil.which("nvidia-smi")
    card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if smi else "no card"
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        db = build_db(tmp)
        for tree in a.trees:
            root = os.path.abspath(tree)
            payload = json.dumps({"tree": tree, "device": a.device, "reps": a.reps, "db": db})
            r = subprocess.run([sys.executable, "-c", SNIPPET, payload], cwd=root,
                               env=dict(os.environ, PYTHONPATH=root), timeout=a.timeout,
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stderr[-3000:], file=sys.stderr)
                return r.returncode
            print(next(line for line in r.stdout.splitlines()
                       if line.startswith("DECODE_AB: ")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
