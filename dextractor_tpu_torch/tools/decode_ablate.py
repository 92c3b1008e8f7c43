"""Decode-step phase split on the card (the port's counterpart of the JAX
package's ``tools/decode_ablate.py``), at the uniform batch's shapes.

Times each phase of ``ops/decode2.decode_entry_batch2`` on its own:

  full        the fused five-channel step: K4 (ins, mrg, sub in one
              launch), K5 and K6 with the delTag
  run_del     K5 (``decode_chains.decode_run``) on the delQV rectangle
  plain_ins   K4 with one channel (``decode_chains.decode_plain``, C = 1)
              on the insQV rectangle
  expand      K6 without tags (``expand.expand_runs``) on random tokens
  tag         the delTag prep (``tag.tag_state``, ``tag.tag_words``) and K10
              (``tag.tag_route_rows``) on random delQV rows and the real tag
              rectangle

The data is the JAX tool's: ``make_quiva(default_rng(0))`` reads of
1,950-2,050 symbols, ``max(8, mb * 1e6 // 10,000)`` of them, encoded by
the native host encoder; the step's arguments as ``testing.decode_batch``
builds them (rows padded to ``bucket_rows``, width ``bucket_len``); the
expand tokens from ``default_rng(1)``, the tag phase's delQV rows from
``default_rng(2)`` (values 0-39).  On the card each phase's time is the
median over rounds of CUDA-event times of back-to-back calls after a
warm-up; on the CPU (``--device cpu``) it is its one call on the host
clock, which checks the control flow and is no device time.  Each phase
also reports the kernel launches and twin calls of its first call.

Run: python -m dextractor_tpu_torch.tools.decode_ablate [--mb 16]
         [--phases full,tag] [--device cuda|cpu]
Prints one ``ABLATE: {...}`` JSON line; without ``--device cpu`` it needs a
CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("full", "run_del", "plain_ins", "expand", "tag")
READ_LEN = 2000
REPS, ROUNDS, WARMUP = 20, 5, 3   # calls per round, rounds, warm-up calls
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[ablate +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def ablate_batch(mb: int):
    """(dexqv, decode_batch arguments, keyword arguments, run-token counts
    (entries, 2)) of the JAX tool's data at ``mb`` MB."""
    from ..codecs.qv_codec import _index_native, encode_quiva_to_dexqv
    from ..formats import dexqv as dq
    from ..testing import decode_batch, make_quiva

    n_reads = max(8, (mb * 1_000_000) // (5 * READ_LEN))
    quiva = make_quiva(np.random.default_rng(0), n_reads=n_reads,
                       min_len=READ_LEN - 50, max_len=READ_LEN + 50)
    enc = encode_quiva_to_dexqv(quiva, device=False)
    args, kw = decode_batch(enc)
    coding, off = dq.parse_qvcoding(memoryview(enc), 2)
    ntoks = _index_native(enc, coding, off, True)[7]
    return enc, args, kw, ntoks


def expand_tokens(ntoks: np.ndarray, n_rows: int, max_tokens: int):
    """The JAX tool's random (runs, lits) planes (N, max_tokens) int32:
    row r < len(ntoks) holds its entry's larger run-token count of tokens,
    runs 0-3 and literals 0-50; other tokens are (0, -1)."""
    rng = np.random.default_rng(1)
    runs = np.zeros((n_rows, max_tokens), np.int32)
    lits = np.full((n_rows, max_tokens), -1, np.int32)
    for r in range(len(ntoks)):
        tk = max(1, min(int(np.max(ntoks[r])), max_tokens))
        runs[r, :tk] = rng.integers(0, 4, tk)
        lits[r, :tk] = rng.integers(0, 51, tk)
    return runs, lits


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _event_ms(fn) -> float:
    """Median over ROUNDS of the stream time per call of REPS back-to-back
    calls of fn() on the card after WARMUP calls, in ms (CUDA events)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / REPS)
    return statistics.median(times)


def phase_calls(args, kw, ntoks, dev: torch.device) -> dict:
    """{phase: argument-free call} of every phase the batch has (run_del
    needs delQV run-coded, expand a run-coded channel)."""
    from ..ops import decode2 as d2
    from ..ops import decode_chains as dch
    from ..ops import expand, tag
    from ..testing import batch_to

    dargs = batch_to(args, dev)
    rd, tg, ri, rm, rs, rl, sids, f1, f2, types, dc, sc = dargs
    sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
    n, max_len, max_tokens, lmax = rl.shape[0], kw["max_len"], kw["max_tokens"], kw["lmax"]
    f1c = [f1[int(sids[k])] for k in range(6)]
    calls = {"full": lambda: d2.decode_entry_batch2(*dargs, **kw)}
    if kw["del_mode"] == "run":
        calls["run_del"] = lambda: dch.decode_run(
            rd, rl, f1c[1], f1c[0], f2, sig[0], max_tokens=max_tokens,
            subw=max(sw[0], sw[1]), lmax=lmax)
    f1_ins = f1c[2][None].contiguous()
    calls["plain_ins"] = lambda: dch.decode_plain(
        [ri], rl, f1_ins, f2, [sig[2]], [sw[2]], max_len=max_len, lmax=lmax)
    if "run" in (kw["del_mode"], kw["sub_mode"]):
        runs, lits = (torch.from_numpy(x).to(dev)
                      for x in expand_tokens(ntoks, n, max_tokens))
        calls["expand"] = lambda: expand.expand_runs(runs, lits, ord("n"),
                                                     max_len=max_len)
    del_rows = torch.from_numpy(np.random.default_rng(2).integers(
        0, 40, (n, max_len)).astype(np.uint8)).to(dev)
    calls["tag"] = lambda: tag.tag_route_rows(
        tag.tag_words(tg), tag.tag_state(del_rows, rl, dc), max_len=max_len)
    return calls


def run(mb: int = 16, phases=None, device="cuda"):
    """Run the phases (all, or those named in ``phases``) once each on
    ``device``, counting launches and twin calls, and on the card time them
    (``_event_ms``).  Returns (results: the ABLATE
    line's dict, outputs: {phase: what its first call returned})."""
    from ..utils import dispatch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run on the CPU)")
    on_card = dev.type == "cuda"
    enc, args, kw, ntoks = ablate_batch(mb)
    log(f"host encode done ({len(enc) / 1e6:.1f} MB container)")
    rlens = args[5]
    results = {"payload_MB": 5 * int(rlens.sum()) / 1e6, "del_mode": kw["del_mode"],
               "sub_mode": kw["sub_mode"], "rows": len(rlens), "max_len": kw["max_len"],
               "max_tokens": kw["max_tokens"], "tag_bytes": list(args[1].shape),
               "device": str(dev), "card": card_line(dev),
               "timer": (f"CUDA events, median of {ROUNDS} rounds of {REPS} calls after "
                         f"{WARMUP} warm-up calls" if on_card else
                         "host clock, the one call (no device time)")}
    log(f"n={len(ntoks)} (pad {len(rlens)}) max_len={kw['max_len']} "
        f"max_tokens={kw['max_tokens']} del_mode={kw['del_mode']} "
        f"sub_mode={kw['sub_mode']} subw={kw['subw']} lmax={kw['lmax']}")
    outputs = {}
    for label, fn in phase_calls(args, kw, ntoks, dev).items():
        if phases is not None and label not in phases:
            continue
        launches, twins = dict(dispatch.LAUNCHES), dict(dispatch.TWIN_CALLS)
        t0 = time.perf_counter()
        outputs[label] = fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        results[f"{label}_launches"] = {k: v - launches[k] for k, v in
                                        dispatch.LAUNCHES.items() if v != launches[k]}
        results[f"{label}_twin_calls"] = {k: v - twins[k] for k, v in
                                          dispatch.TWIN_CALLS.items() if v != twins[k]}
        results[f"{label}_ms"] = _event_ms(fn) if on_card else host_ms
        log(f"{label}: {results[f'{label}_ms']} ms/call, launches "
            f"{results[f'{label}_launches']}")
    return results, outputs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dextractor_tpu_torch.tools.decode_ablate",
                                description="Time the phases of the decode step.")
    p.add_argument("--mb", type=int, default=16, help="payload size (MB), as bench.py's")
    p.add_argument("--phases", default=None,
                   help=f"comma-separated subset of {','.join(PHASES)}")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    phases = None if a.phases is None else set(a.phases.split(","))
    if phases is not None and not phases <= set(PHASES):
        p.error(f"unknown phases {sorted(phases - set(PHASES))}")
    results, _ = run(a.mb, phases, a.device)
    print("ABLATE: " + json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
