"""Byte check of the encode step at the benchmark's shapes (the port's
counterpart of the JAX package's ``tools/step_verify.py``).

On the uniform batch (``testing.uniform_quiva``, 1,600 reads of
1,950-2,050 symbols at 16 MB) built as ``testing.step_batch`` builds it,
rows padded by ``pad_rows(align=512, bucket=True)``, the row count by
``bucket_rows``, with the coding's real ``run_on`` flags, it runs
``parallel.pipeline.qv_encode_step`` (K1-K3 on the card) and assembles the
container with ``codecs.qv_codec.assemble_from_step``; the bytes must equal
the native host encoder's (``encode_quiva_to_dexqv(device=False)``).  The
JAX tool also passes a run-token bound to its step; the port's K2 has none.

Run: python -m dextractor_tpu_torch.tools.step_verify [--mb 16] [--device cuda|cpu]
Prints one ``STEPV: {...}`` JSON line and exits 1 when the bytes differ;
without ``--device cpu`` it needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def verify(quiva: bytes, device="cuda") -> dict:
    """The STEPV record of the encode step on ``quiva`` (a .quiva image) on
    ``device``: the step's shapes and ``run_on``, and ``step_bytes_ok``."""
    from ..codecs.qv_codec import (assemble_from_step, create_qvcoding,
                                   encode_quiva_to_dexqv, scan_quiva)
    from ..formats.quiva import parse_quiva
    from ..parallel.pipeline import qv_encode_step
    from ..testing import step_batch
    from .decode_ablate import card_line

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run on the CPU)")
    args, run_on = step_batch(quiva)
    q = parse_quiva(quiva)
    coding = create_qvcoding(scan_quiva(q), q.prefix, False)
    out = qv_encode_step(*(torch.from_numpy(a).to(dev) for a in args), run_on=run_on)
    ours = assemble_from_step(out, coding, q.wells, q.begs, q.ends, q.qvs, q.n_entries)
    host = encode_quiva_to_dexqv(quiva, device=False)
    return {"device": str(dev), "card": card_line(dev), "reads": int(q.n_entries),
            "streams": list(args[0].shape), "run_on": list(run_on),
            "container_bytes": len(host), "step_bytes_ok": ours == host}


def main(argv=None) -> int:
    from ..testing import uniform_quiva

    p = argparse.ArgumentParser(prog="python -m dextractor_tpu_torch.tools.step_verify",
                                description="Check the encode step's bytes.")
    p.add_argument("--mb", type=int, default=16, help="payload size (MB), as bench.py's")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    res = dict(mb=a.mb, **verify(uniform_quiva(a.mb), a.device))
    print("STEPV: " + json.dumps(res), flush=True)
    return 0 if res["step_bytes_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
