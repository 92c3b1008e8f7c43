"""Device times of K1 and K4 at the main path's shapes, for the package (and
the ``chip_smoke.py``) that the import path finds first.

Run it as a file; with PYTHONPATH set to another checkout of the repository
it times that checkout's kernels with that checkout's ``chip_smoke.device_ms``,
so two trees can be compared on one card in one go, in turns (other, this,
this, other):

    PYTHONPATH=/path/to/other/checkout python3 dextractor_tpu_torch/tools/kernel_times.py
    PYTHONPATH=. python3 dextractor_tpu_torch/tools/kernel_times.py

Shapes: K1 (``ops.emit.encode_plain``) on the arguments that the encode
step (``parallel.pipeline.channels_fused``) gives it for the uniform batch
and for the widest bucket of the long-read batch that takes K1/K2; K4
(``ops.decode_chains.decode_plain``) on ins, mrg and sub of the decode
phase split's batch at 16 MB (``tools/decode_ablate.py``) in one launch,
and on ins alone.  Each output is checked against the kernel's twin; each
time is the mean device time per launch over 20 launches, L2 flushed
before each.  Prints one ``TIMES: {...}`` JSON line with the card and the
package's path; needs a CUDA device.  It calls only what older trees have
too.
"""

import json
import sys

import torch


def _k1_args(batch, dev):
    """The arguments of the encode step's call of K1 on ``batch``, recorded
    while the twin stands in for the wrapper."""
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.parallel import pipeline

    (streams, lengths, sym, run, rchars, _), run_on = batch
    seen, saved = [], emit.encode_plain

    def record(*args):
        seen.append(args)
        return bt.encode_plain_ref(*args)

    emit.encode_plain = record
    try:
        pipeline.channels_fused(*(torch.from_numpy(a).to(dev)
                                  for a in (streams, lengths, sym, run, rchars)), run_on)
    finally:
        emit.encode_plain = saved
    return seen[0]


def main() -> int:
    import chip_smoke
    import dextractor_tpu_torch
    from dextractor_tpu_torch.codecs.qv_codec import encode_buckets
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import decode2 as d2
    from dextractor_tpu_torch.ops import decode_chains as dch
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.testing import (batch_to, long_quiva, step_batch, uniform_quiva,
                                              widest_bucket_batch)
    from dextractor_tpu_torch.tools.decode_ablate import ablate_batch, card_line

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    dev = torch.device("cuda")
    long = long_quiva()
    widths = [w for w, _ in encode_buckets(parse_quiva(long).lengths)]
    i = max(i for i, w in enumerate(widths) if emit.fused_ok(w))
    k1 = {"uniform": _k1_args(step_batch(uniform_quiva()), dev),
          f"widest K1 bucket, width {widths[i]}": _k1_args(widest_bucket_batch(long, i), dev)}
    _, args, kw, _ = ablate_batch(16)
    rd, tg, ri, rm, rs, rl, sids, f1, f2, types, dc, sc = batch_to(args, dev)
    sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
    dkw = dict(max_len=kw["max_len"], lmax=kw["lmax"])
    k4 = {"ins, mrg, sub": ([ri, rm, rs], rl, torch.stack([f1[int(sids[k])] for k in (2, 3, 4)]),
                            f2, [sig[k] for k in (2, 3, 4)], [sw[k] for k in (2, 3, 4)]),
          "ins": ([ri], rl, f1[int(sids[2])][None].contiguous(), f2, [sig[2]], [sw[2]])}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"card": card_line(dev), "package": dextractor_tpu_torch.__path__[0],
           "timer": "chip_smoke.device_ms, mean device time per launch of 20, L2 flushed"}

    def flushed_ms(fn, kernel):
        ms, _ = chip_smoke.device_ms(lambda: (flush.zero_(), fn()), match=kernel)
        if ms is None:
            raise RuntimeError(f"the profiler recorded no launch of {kernel}")
        return ms

    for label, a in k1.items():
        got, ref = emit.encode_plain(*a), bt.encode_plain_ref(*a)
        keep = torch.arange(ref[0].shape[-1], device=dev) < ((ref[1].long() + 31) >> 5)[..., None]
        if not (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]) and torch.equal(
                torch.where(keep, got[0], 0), torch.where(keep, ref[0], 0))):
            raise AssertionError(f"encode_plain ({label}) disagrees with its twin")
        out[f"encode_plain ({label}, {tuple(a[0].shape)})"] = flushed_ms(
            lambda: emit.encode_plain(*a), "encode_plain_kernel")
    for label, a in k4.items():
        got, ref = dch.decode_plain(*a, **dkw), d2.plain_chains(*a, **dkw)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"decode_plain ({label}) disagrees with its twin")
        out[f"decode_plain ({label}, {rl.shape[0]} rows)"] = flushed_ms(
            lambda: dch.decode_plain(*a, **dkw), "decode_plain_kernel")
    print("TIMES: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
