"""Device times of K1-K4, K6, K7, K9 and the 2-bit unpack at the main
path's shapes, for the package (and the ``chip_smoke.py``) that the import
path finds first.

Run it as a file; with PYTHONPATH set to another checkout of the repository
it times that checkout's kernels with that checkout's ``chip_smoke.device_ms``,
so two trees can be compared on one card in one go, in turns (other, this,
this, other):

    PYTHONPATH=/path/to/other/checkout python3 dextractor_tpu_torch/tools/kernel_times.py
    PYTHONPATH=. python3 dextractor_tpu_torch/tools/kernel_times.py [k1-k3] [k4] [k6] [k7] [k9] [unpack]

(the arguments pick the sets; none: all six).  Shapes: K1
(``ops.emit.encode_plain``), K2 (``ops.emit.encode_run``) and K3
(``ops.emit.pack_tags``) on the arguments that the encode step
(``parallel.pipeline.qv_encode_step``) gives them for the uniform batch, K1
and K2 for the widest bucket of the long-read batch that takes K1/K2, and
K3 for the widest bucket of the long-read batch; K4 (``ops.decode_chains.decode_plain``)
on ins, mrg and sub of the decode phase split's batch at 16 MB
(``tools/decode_ablate.py``) in one launch, and on ins alone; K7
(``ops.pack2bit.pack2bit``) on the flat reads of the three 2-bit corpora
(``testing.uniform_fasta``, ``long_fasta``, ``uniform_arrow``), and the
unpack (``ops.pack2bit.unpack2bit``) on K7's payloads of them; K6
(``ops.expand.expand_runs``) with the delTag codes on K5's tokens of the
uniform batch and of the long-read batch's widest bucket on the per-read
route (its 8 rows, and its widest row alone).  Each
output is checked against the kernel's twin; each time is the mean device
time per launch over 20 launches, L2 flushed before each, and warm.  K9
(``ops.lut``) is timed by what its launches do, since a tree may take a
bucket's lookups in one launch or in one per lookup: the summed device time
of its launches in one call of the emission route
(``pipeline.channels_emissions``) at the widest long-read bucket, flushed
and warm, and in one ``encode_quiva_to_dexqv`` of the long-read batch
(as chip_smoke.py's phase 5), each with its launches.  Prints one
``TIMES: {...}`` JSON line with the card and the package's path; needs a
CUDA device.  It calls only what older trees have too.
"""

import json
import sys

import torch


def _recorded(batch, dev):
    """The arguments of the first call of each K1-K3 wrapper of ``ops.emit``
    that ``parallel.pipeline.qv_encode_step`` makes on ``batch``, recorded
    while the twins stand in for the wrappers: {wrapper name: arguments}."""
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.parallel import pipeline

    twins = {"encode_plain": bt.encode_plain_ref, "encode_run": bt.encode_run_ref,
             "pack_tags": pipeline._pack_tags}
    seen, saved = {}, {k: getattr(emit, k) for k in twins}

    def recorder(name):
        def call(*args):
            seen.setdefault(name, args)
            return twins[name](*args)
        return call

    for k in twins:
        setattr(emit, k, recorder(k))
    try:
        (streams, lengths, sym, run, rchars, nlut), run_on = batch
        pipeline.qv_encode_step(*(torch.from_numpy(a).to(dev) for a in (
            streams, lengths, sym, run, rchars, nlut)), run_on=run_on)
    finally:
        for k, fn in saved.items():
            setattr(emit, k, fn)
    return seen


def _k9_times(long, dev, flush):
    """K9's summed device time per call of the widest long-read bucket's
    emission route, [L2 flushed, warm], its launches per call, and its summed
    device time and launches in one long-read encode."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from dextractor_tpu_torch.codecs.qv_codec import encode_quiva_to_dexqv
    from dextractor_tpu_torch.parallel import pipeline
    from dextractor_tpu_torch.testing import widest_bucket_batch
    from dextractor_tpu_torch.utils import dispatch

    (streams, lengths, sym, run, rchars, _), run_on = widest_bucket_batch(long)
    w_in = [torch.from_numpy(a).to(dev) for a in (streams, lengths, sym, run, rchars)]
    fused = pipeline.channels_fused(*w_in, run_on)
    got = pipeline.channels_emissions(*w_in, run_on)
    keep = torch.arange(got[0].shape[-1], device=dev) < ((fused[1].long() + 31) >> 5)[..., None]
    if not (torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2]) and torch.equal(
            torch.where(keep, got[0], 0), torch.where(keep, fused[0], 0))):
        raise AssertionError("the emission route disagrees with K1/K2 at the widest bucket")
    before = dispatch.LAUNCHES["lut_gather"]
    pipeline.channels_emissions(*w_in, run_on)
    per_call = dispatch.LAUNCHES["lut_gather"] - before
    out = {}
    for key, fn in (("flushed", lambda: (flush.zero_(), pipeline.channels_emissions(
            *w_in, run_on))), ("warm", lambda: pipeline.channels_emissions(*w_in, run_on))):
        mean, _ = chip_smoke.device_ms(fn, reps=10, match="lut_gather_kernel")
        if mean is None:
            raise RuntimeError("the profiler recorded no launch of lut_gather_kernel")
        out[key] = mean * per_call
    route = [out["flushed"], out["warm"], per_call]
    encode_quiva_to_dexqv(long, device="cuda")
    for _ in range(3):
        before = dispatch.LAUNCHES["lut_gather"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            encode_quiva_to_dexqv(long, device="cuda")
            torch.cuda.synchronize()
        launched = dispatch.LAUNCHES["lut_gather"] - before
        ev = [e.time_range.elapsed_us() / 1000 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "lut_gather_kernel" in e.name]
        if len(ev) == launched:
            break
    return route, [sum(ev), len(ev), launched]


def _k7_times(dev, times):
    """K7 at the shapes of the three 2-bit corpora, checked against its twin."""
    import chip_smoke
    import numpy as np
    from dextractor_tpu_torch.formats.fasta import parse_seq_file
    from dextractor_tpu_torch.ops import pack2bit as pk
    from dextractor_tpu_torch.ops import twobit as tb
    from dextractor_tpu_torch.testing import long_fasta, uniform_arrow, uniform_fasta

    out = {}
    for name, text, arrow in (("uniform .fasta", uniform_fasta(), False),
                              ("long-read .fasta", long_fasta(), False),
                              (".arrow", uniform_arrow(), True)):
        f = parse_seq_file(text, arrow=arrow)
        lengths = f.seqs.lengths.astype(np.int64)
        a = chip_smoke._twobit_args(f.seqs.flat, lengths,
                                    tb.NUMBER_ARROW_LUT if arrow else tb.NUMBER_BASE_LUT, dev)
        if not torch.equal(pk.pack2bit(*a), tb.pack2bit_twin(a[0], a[1].diff(), a[3])):
            raise AssertionError(f"pack2bit ({name}) disagrees with its twin")
        out[f"pack2bit ({name}, {len(lengths)} reads, {a[4]} bytes)"] = times(
            lambda: pk.pack2bit(*a), "pack2bit_kernel")
    return out


def _unpack_times(dev, times):
    """The 2-bit unpack at the shapes of the three 2-bit corpora, on K7's
    payloads, checked against its twin."""
    import chip_smoke
    import numpy as np
    from dextractor_tpu_torch.formats.fasta import parse_seq_file
    from dextractor_tpu_torch.ops import pack2bit as pk
    from dextractor_tpu_torch.ops import twobit as tb
    from dextractor_tpu_torch.testing import long_fasta, uniform_arrow, uniform_fasta

    out = {}
    for name, text, arrow in (("uniform .fasta", uniform_fasta(), False),
                              ("long-read .fasta", long_fasta(), False),
                              (".arrow", uniform_arrow(), True)):
        f = parse_seq_file(text, arrow=arrow)
        lengths = f.seqs.lengths.astype(np.int64)
        a = chip_smoke._twobit_args(f.seqs.flat, lengths,
                                    tb.NUMBER_ARROW_LUT if arrow else tb.NUMBER_BASE_LUT, dev)
        letters = torch.from_numpy(tb.ARROW_LETTER_LUT if arrow else tb.LOWER_LUT).to(dev)
        u = (pk.pack2bit(*a), a[2], a[1] - a[1][0], letters, int(lengths.sum()))
        if not torch.equal(pk.unpack2bit(*u), tb.unpack2bit_twin(u[0], u[2].diff(), letters)):
            raise AssertionError(f"unpack2bit ({name}) disagrees with its twin")
        out[f"unpack2bit ({name}, {len(lengths)} reads, {u[4]} letters)"] = times(
            lambda: pk.unpack2bit(*u), "unpack2bit_kernel")
    return out


def _k6_times(dev, times):
    """K6 with the delTag codes on the tokens K5 gives it: the uniform batch's
    decode shapes, and the long-read batch's widest bucket on the per-read
    route (its rows and the widest row alone), checked against its twin."""
    import numpy as np
    from dextractor_tpu_torch.codecs.qv_batch import span_buckets
    from dextractor_tpu_torch.codecs.qv_codec import _index_native, encode_quiva_to_dexqv
    from dextractor_tpu_torch.formats import dexqv as dq
    from dextractor_tpu_torch.ops import decode2 as d2
    from dextractor_tpu_torch.ops import decode_chains as dch
    from dextractor_tpu_torch.ops import expand
    from dextractor_tpu_torch.testing import batch_to, decode_batch, long_quiva, uniform_quiva

    out = {}
    for name, q in (("uniform", uniform_quiva()), ("long reads", long_quiva())):
        dexqv = encode_quiva_to_dexqv(q, device=False)
        args, kw = decode_batch(dexqv)
        rd, tg, _, _, _, rl, sids, f1, f2, types, dc, _ = batch_to(args, dev)
        sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
        runs, lits, _, _ = dch.decode_run(rd, rl, f1[sids[1]], f1[sids[0]], f2, sig[0],
                                          max_tokens=kw["max_tokens"], subw=max(sw[0], sw[1]),
                                          lmax=kw["lmax"])
        sets = {"uniform": slice(None)}
        if name != "uniform":
            coding, off = dq.parse_qvcoding(memoryview(dexqv), 2)
            _, _, _, _, _, _, coffs, ntoks = _index_native(dexqv, coding, off, True)
            kws = span_buckets(np.asarray(coffs, np.int64))
            sel = np.flatnonzero(kws == kws.max())
            top = int(np.argmax(np.asarray(ntoks)[:, 0]))
            sets = {f"widest per-read bucket, {len(sel)} rows": torch.from_numpy(sel).to(dev),
                    "widest per-read row": slice(top, top + 1)}
        for label, rows in sets.items():
            a = (runs[rows].contiguous(), lits[rows].contiguous(), dc)
            k = dict(max_len=kw["max_len"], tag_bytes=tg[rows].contiguous())
            got, ref = expand.expand_runs(*a, **k), expand.expand_runs_ref(*a, **k)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"expand_runs ({label}) disagrees with its twin")
            out[f"expand_runs ({label}, {tuple(a[0].shape)} tokens, max_len "
                f"{kw['max_len']}, tags)"] = times(lambda: expand.expand_runs(*a, **k),
                                                   "expand_runs_kernel")
    return out


def main() -> int:
    import chip_smoke
    import dextractor_tpu_torch
    from dextractor_tpu_torch.codecs.qv_codec import encode_buckets
    from dextractor_tpu_torch.formats.quiva import parse_quiva
    from dextractor_tpu_torch.ops import bitstream_torch as bt
    from dextractor_tpu_torch.ops import decode2 as d2
    from dextractor_tpu_torch.ops import decode_chains as dch
    from dextractor_tpu_torch.ops import emit
    from dextractor_tpu_torch.parallel import pipeline
    from dextractor_tpu_torch.testing import (batch_to, long_quiva, step_batch, uniform_quiva,
                                              widest_bucket_batch)
    from dextractor_tpu_torch.tools.decode_ablate import ablate_batch, card_line

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    every = {"k1-k3", "k4", "k7", "k9", "unpack", "k6"}
    sets = set(sys.argv[1:]) or every
    if sets - every:
        raise SystemExit(f"unknown sets {sorted(sets)}: {', '.join(sorted(every))}")
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"card": card_line(dev), "package": dextractor_tpu_torch.__path__[0],
           "timer": "chip_smoke.device_ms, mean device time per launch of 20, "
                    "[L2 flushed, warm]"}

    def times(fn, kernel):
        warm, _ = chip_smoke.device_ms(fn, match=kernel)
        flushed, _ = chip_smoke.device_ms(lambda: (flush.zero_(), fn()), match=kernel)
        if warm is None or flushed is None:
            raise RuntimeError(f"the profiler recorded no launch of {kernel}")
        return [flushed, warm]

    def words_equal(got, ref):
        keep = torch.arange(ref[0].shape[-1], device=dev) < ((ref[1].long() + 31) >> 5)[..., None]
        return (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]) and torch.equal(
            torch.where(keep, got[0], 0), torch.where(keep, ref[0], 0)))

    long = long_quiva() if sets & {"k1-k3", "k9"} else None
    if "k1-k3" in sets:
        widths = [w for w, _ in encode_buckets(parse_quiva(long).lengths)]
        i = max(i for i, w in enumerate(widths) if emit.fused_ok(w))
        uniform = _recorded(step_batch(uniform_quiva()), dev)
        k12 = {"uniform": uniform,
               f"widest K1 bucket, width {widths[i]}": _recorded(widest_bucket_batch(long, i),
                                                                 dev)}
        k3 = {"uniform": uniform["pack_tags"],
              f"widest bucket, width {widths[-1]}": _recorded(widest_bucket_batch(long),
                                                              dev)["pack_tags"]}
        encode = [("encode_plain", emit.encode_plain, bt.encode_plain_ref),
                  ("encode_run", emit.encode_run, bt.encode_run_ref)]
        for label, recorded in k12.items():
            for name, kern, twin in encode:
                a = recorded[name]
                if not words_equal(kern(*a), twin(*a)):
                    raise AssertionError(f"{name} ({label}) disagrees with its twin")
                out[f"{name} ({label}, {tuple(a[0].shape)})"] = times(lambda: kern(*a),
                                                                      f"{name}_kernel")
        for label, a in k3.items():
            got, ref = emit.pack_tags(*a), pipeline._pack_tags(*a)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"pack_tags ({label}) disagrees with its twin")
            out[f"pack_tags ({label}, {tuple(a[0].shape)})"] = times(
                lambda: emit.pack_tags(*a), "pack_tags_kernel")
    if "k4" in sets:
        _, args, kw, _ = ablate_batch(16)
        rd, tg, ri, rm, rs, rl, sids, f1, f2, types, dc, sc = batch_to(args, dev)
        sig, sw = d2.channel_params(sids, types, kw["subw"], kw["chan_l2"])
        dkw = dict(max_len=kw["max_len"], lmax=kw["lmax"])
        k4 = {"ins, mrg, sub": ([ri, rm, rs], rl,
                                torch.stack([f1[int(sids[k])] for k in (2, 3, 4)]), f2,
                                [sig[k] for k in (2, 3, 4)], [sw[k] for k in (2, 3, 4)]),
              "ins": ([ri], rl, f1[int(sids[2])][None].contiguous(), f2, [sig[2]], [sw[2]])}
        for label, a in k4.items():
            got, ref = dch.decode_plain(*a, **dkw), d2.plain_chains(*a, **dkw)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"decode_plain ({label}) disagrees with its twin")
            out[f"decode_plain ({label}, {rl.shape[0]} rows)"] = times(
                lambda: dch.decode_plain(*a, **dkw), "decode_plain_kernel")
    if "k7" in sets:
        out.update(_k7_times(dev, times))
    if "unpack" in sets:
        out.update(_unpack_times(dev, times))
    if "k6" in sets:
        out.update(_k6_times(dev, times))
    if "k9" in sets:
        route, encode = _k9_times(long, dev, flush)
        out["lut_gather (widest long-read bucket's emission route: summed ms a call, "
            "[L2 flushed, warm], launches a call)"] = route
        out["lut_gather (one long-read encode: summed ms, traced launches, "
            "counted launches)"] = encode
    print("TIMES: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
