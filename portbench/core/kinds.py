"""The general traffic generator: what one call of a cell is, and how its
answers are judged.

A traffic file (``portbench/traffic/<name>.json``) names its ``kind`` and
gives its parameters: ``files`` (distinct files a run makes from its seed
and uses in turn), ``sample`` (answers kept a file, or a file's bucket,
for the check, drawn from the seed), ``trace_seconds`` (the traced part of
a ``--trace 1`` window; absent: the whole window).  Set-up runs the first
file once through the program (the whole-file kinds) or every step once.

- ``restore``: one call is ``decode_dexqv_to_quiva`` of a whole .dexqv,
  made by the reference encoder in set-up; every output is compared with
  the .quiva it came from.
- ``compress``: one call is ``encode_quiva_to_dexqv`` of a whole .quiva;
  every output is compared with the reference encoder's .dexqv.
- ``decode_step``: one call is ``ops.decode2.decode_entry_batch_seg`` over
  every segment of a whole file, on the arguments that
  ``codecs.qv_batch.build_seg_launch_flat`` builds in set-up, on the card;
  the sampled calls' live symbols are compared with the file's streams.
- ``encode_step``: one call is ``parallel.pipeline.qv_encode_step`` on one
  bucket's rectangle (``codecs.qv_codec.encode_buckets`` and
  ``bucket_rect``); the sampled calls' streams (words up to ``raw``, the
  repeated or zero last word, the packed delTags and their counts) are
  compared with the reference encoder's.

With ``lossy`` (the control, ``control.py``) the program is driven on its
lossy path (``dexqv -l``: insQV and mergeQV quantised) and judged against
the lossless reference, so every check has to fail.

Each call returns the payload bytes it completed: five bytes a base of the
reads it covered.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ref import encode as ref_encode
from ref import gen


class Kind:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, lossy: bool = False,
                 log=None):
        self.cfg, self.traffic, self.seed, self.dev, self.lossy = cfg, traffic, seed, dev, lossy
        self.log = log or (lambda *a: None)
        self.n_files = int(traffic.get("files", 2))
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 7919])
        self.refs = None          # the reference's Encoded of each file
        self.reference_s = 0.0    # seconds in the reference, which set-up does not count
        self.kept = {}            # reservoir of sampled answers by key
        self.seen = {}

    # -- set-up ------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.log(f"portbench: {name} {time.perf_counter() - t0:.3f} s")

    def make_files(self) -> None:
        with self.phase("set-up: files"), ThreadPoolExecutor(max_workers=self.n_files) as ex:
            self.files = list(ex.map(lambda i: gen.make_file(self.cfg, self.seed, i),
                                     range(self.n_files)))

    def quiva_texts(self) -> list[bytes]:
        with self.phase("set-up: .quiva text"), ThreadPoolExecutor(max_workers=self.n_files) as ex:
            return list(ex.map(gen.quiva_text, self.files))

    def reference(self, lossy: bool = False) -> list:
        """The reference's encode of every file (the files side by side); its
        seconds are kept apart from set-up's."""
        t0 = time.perf_counter()
        with self.phase("reference encode"), ThreadPoolExecutor(max_workers=self.n_files) as ex:
            out = list(ex.map(lambda q: ref_encode.encode(q, lossy), self.files))
        self.reference_s += time.perf_counter() - t0
        return out

    def sync(self) -> None:
        if self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize(self.dev)

    def sample(self, key, answer) -> None:
        """Keep ``answer`` in the reservoir of ``key`` (of ``sample`` answers),
        with the seed's draws."""
        k = int(self.traffic.get("sample", 1))
        n = self.seen.get(key, 0) + 1
        self.seen[key] = n
        slot = self.kept.setdefault(key, [])
        if len(slot) < k:
            slot.append(answer)
        else:
            j = int(self.rng.integers(0, n))
            if j < k:
                slot[j] = answer

    def work_bytes(self, i: int) -> int:
        """Bytes call ``i`` has to move at the least: its reads' payload,
        written or read once, and their compressed streams, read or
        written once; counted from the reference's file, once it has run."""
        raise NotImplementedError


class WholeFile(Kind):
    unit = "file"

    def setup(self) -> None:
        from dextractor_tpu_torch.codecs import qv_codec
        self.codec = qv_codec
        self.make_files()
        self.outputs = []
        self.prepare()
        with self.phase("set-up: warm-up"):
            self.run(0)
            self.sync()

    def call(self, i: int) -> int:
        k = i % self.n_files
        self.outputs.append((k, self.run(k)))
        return self.files[k].payload_bytes

    def judge(self, expected: list) -> dict:
        wrong = [k for k, out in self.outputs if out != expected[k]]
        self.failed = len(wrong)
        return {"wrong_files": (len(wrong), 0)}


class Restore(WholeFile):
    def prepare(self) -> None:
        self.texts = self.quiva_texts()
        self.images = [e.image for e in self.reference(lossy=self.lossy)]

    def run(self, k: int) -> bytes:
        return self.codec.decode_dexqv_to_quiva(self.images[k], device=self.dev)

    def check(self) -> dict:
        return self.judge(self.texts)


class Compress(WholeFile):
    def prepare(self) -> None:
        self.texts = self.quiva_texts()

    def run(self, k: int) -> bytes:
        return self.codec.encode_quiva_to_dexqv(self.texts[k], lossy=self.lossy, device=self.dev)

    def check(self) -> dict:
        self.refs = self.reference()
        return self.judge([e.image for e in self.refs])


class Step(Kind):
    """A device-resident step, called back to back on arguments that set-up
    builds as the program does and puts on the card."""
    unit = "step"

    def setup(self) -> None:
        self.make_files()
        self.steps = []
        self.inputs()
        with self.phase("set-up: step arguments"):
            self.build()
        with self.phase("set-up: warm-up"):
            for i in range(len(self.steps)):
                self.run(i)
            self.sync()

    def inputs(self) -> None:
        pass

    def call(self, i: int) -> int:
        j = i % len(self.steps)
        self.sample(j, self.run(j))
        return self.steps[j]["payload"]


class DecodeStep(Step):
    def inputs(self) -> None:
        self.refs = self.reference(lossy=self.lossy)

    def build(self) -> None:
        """Every file's launch arguments, as ``fused_decode_entries_seg`` builds
        them, with the tables on the card."""
        import torch
        from dextractor_tpu_torch.codecs import qv_batch, qv_codec
        from dextractor_tpu_torch.formats import dexqv as dq
        from dextractor_tpu_torch.ops import decode2

        self.d2 = decode2
        for q, enc in zip(self.files, self.refs):
            data = enc.image
            coding, off = dq.parse_qvcoding(memoryview(data), 2)
            idx = qv_codec._index_native(data, coding, off, True)
            _, _, _, _, eoffs, elens, coffs, ntoks = idx
            ck = qv_codec._index_checkpoints(data, coding, off, True, elens)
            buf = np.frombuffer(data, np.uint8)
            args, statics, rid, kseg = qv_batch.build_seg_launch_flat(
                buf, eoffs, elens.astype(np.int32), coffs, ntoks, coding, ck)
            sids, f1, f2, types, _, _, subw, lmax = qv_batch.decode_tables_v2(coding)
            chan_l2 = tuple(bool(((f1[sids[k]] >> 20) & 1).any()) for k in range(6))

            def put(x):
                x = np.ascontiguousarray(x)
                if x.dtype == np.uint32:
                    x = x.view(np.int32)
                t = torch.from_numpy(x)
                return t.to(self.dev, torch.int32 if t.dtype != torch.uint8 else torch.uint8)

            dev_args = [put(a) for a in args]
            self.steps.append(dict(
                args=(*dev_args, sids, torch.from_numpy(f1).to(self.dev),
                      torch.from_numpy(f2).to(self.dev), types,
                      coding.del_char & 0xFF, coding.sub_char & 0xFF),
                kw=dict(subw=subw, lmax=lmax, chan_l2=chan_l2, **statics),
                rid=rid, kseg=kseg, seg_rlens=np.asarray(args[5]), seg=ck[0],
                payload=q.payload_bytes))

    def run(self, k: int):
        s = self.steps[k]
        return self.d2.decode_entry_batch_seg(*s["args"], **s["kw"])

    def check(self) -> dict:
        wrong = calls = bad_calls = 0
        for k, answers in self.kept.items():
            s, q = self.steps[k], self.files[k]
            off = np.zeros(len(q.lengths) + 1, np.int64)
            np.cumsum(q.lengths, out=off[1:])
            rl = s["seg_rlens"].astype(np.int64)
            row = np.repeat(np.arange(len(rl)), rl)
            col = np.arange(int(rl.sum())) - np.repeat(np.cumsum(rl) - rl, rl)
            src = off[s["rid"]][row] + s["kseg"][row] * s["seg"] + col
            want = q.streams[:, src]
            for rows in answers:
                got = rows.cpu().numpy()[:, row, col]
                bad = int((got != want).sum())
                wrong += bad
                bad_calls += bad > 0
                calls += 1
        self.failed = bad_calls
        self.checked = calls
        return {"wrong_symbols": (wrong, 0)}

    def work_bytes(self, i: int) -> int:
        k = i % len(self.steps)
        return self.files[k].payload_bytes + int(self.refs[k].entry_bytes().sum())


class EncodeStep(Step):
    def build(self) -> None:
        """Every bucket's rectangle of every file, as ``_encode_entries_device``
        builds them, on the card."""
        import torch
        from dextractor_tpu_torch.codecs import qv_codec
        from dextractor_tpu_torch.formats import quiva as qv
        from dextractor_tpu_torch.parallel import pipeline

        self.pipeline = pipeline
        for k, q in enumerate(self.files):
            pq = qv.parse_quiva(gen.quiva_text(q))
            coding = qv_codec.create_qvcoding(qv_codec.scan_quiva(pq), pq.prefix, self.lossy)
            sym, run, rchars, nlut, run_on = qv_codec.step_tables(coding)
            tables = [torch.as_tensor(x).to(self.dev) for x in (sym, run, rchars, nlut)]
            for width, sel in qv_codec.encode_buckets(pq.lengths):
                rect, lengths = qv_codec.bucket_rect(pq, sel, width, self.lossy)
                self.steps.append(dict(
                    file=k, sel=sel, run_on=run_on, tables=tables,
                    rect=torch.from_numpy(rect).to(self.dev),
                    lengths=torch.from_numpy(lengths).to(self.dev),
                    payload=5 * int(q.lengths[sel].sum())))

    def run(self, j: int):
        s = self.steps[j]
        return self.pipeline.qv_encode_step(s["rect"], s["lengths"], *s["tables"],
                                            run_on=s["run_on"])

    def check(self) -> dict:
        self.refs = self.reference()
        wrong = calls = bad_calls = 0
        for j, answers in self.kept.items():
            s = self.steps[j]
            ref = self.refs[s["file"]]
            for out in answers:
                bad = _stream_mismatches(out, s["sel"], ref)
                wrong += bad
                bad_calls += bad > 0
                calls += 1
        self.failed = bad_calls
        self.checked = calls
        return {"wrong_streams": (wrong, 0)}

    def work_bytes(self, i: int) -> int:
        s = self.steps[i % len(self.steps)]
        return s["payload"] + int(self.refs[s["file"]].entry_bytes()[s["sel"]].sum())


def _ragged(flat: np.ndarray, lens: np.ndarray, sel: np.ndarray):
    """The entries ``sel`` of a butted part: (their bytes butted, their lengths)."""
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ln = lens[sel]
    idx = np.arange(int(ln.sum())) - np.repeat(np.cumsum(ln) - ln - starts[sel], ln)
    return flat[idx], ln


def _mismatched_entries(got, got_lens, want, want_lens) -> int:
    """How many entries' byte strings differ (lengths first, then bytes)."""
    bad = got_lens != want_lens
    same = ~bad
    if same.any() and len(want):
        g = np.repeat(np.arange(len(want_lens)), want_lens)
        mism = np.zeros(len(want_lens), bool)
        ok = np.repeat(same, want_lens)
        gs = np.repeat(np.cumsum(got_lens) - got_lens, want_lens)
        ws = np.repeat(np.cumsum(want_lens) - want_lens, want_lens)
        rel = np.arange(len(want)) - ws
        diff = ok & (got[np.where(ok, gs + rel, 0)] != want)
        np.logical_or.at(mism, g[diff], True)
        bad |= mism
    return int(bad.sum())


def _stream_mismatches(out, sel: np.ndarray, ref) -> int:
    """Streams of the step's entries that differ from the reference's: the
    four QV channels (words up to ``raw``, then the last word again where
    ``dup``, a zero word where ``zext``), the packed delTags, and the kept
    delTag counts."""
    words, raw, outw, dup, zext, packed, clens = (x.cpu().numpy() for x in out)
    n = len(sel)
    bad = 0
    for c, part in zip(range(4), (0, 2, 3, 4)):
        r = raw[c, :n].astype(np.int64)
        o = outw[c, :n].astype(np.int64)
        row = np.repeat(np.arange(n), o)
        rel = np.arange(int(o.sum())) - np.repeat(np.cumsum(o) - o, o)
        w = words[c][row, np.minimum(rel, np.repeat(r, o) - 1)].astype(np.uint32)
        w[(rel >= np.repeat(r, o)) & np.repeat(zext[c, :n].astype(bool), o)] = 0
        want, want_lens = _ragged(*ref.parts[part], sel)
        bad += _mismatched_entries(w.view(np.uint8), 4 * o, want, want_lens)
    tl = (clens[:n].astype(np.int64) + 3) >> 2
    got = packed[np.repeat(np.arange(n), tl),
                 np.arange(int(tl.sum())) - np.repeat(np.cumsum(tl) - tl, tl)]
    want, want_lens = _ragged(*ref.parts[1], sel)
    bad += _mismatched_entries(got, tl, want, want_lens)
    bad += int((clens[:n].astype(np.int64) != ref.kept[sel]).sum())
    return bad


KINDS = {"restore": Restore, "compress": Compress, "decode_step": DecodeStep,
         "encode_step": EncodeStep}
