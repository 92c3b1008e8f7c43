"""K10, the delTag route by kept rank (ops/tag.py), and the decode-step
phase split that launches it (tools/decode_ablate.py), on the CPU: the
twin against the JAX package's Pallas kernel in interpret mode and against
a NumPy model of Unpack_Tag, the prep against the JAX tool's, the twin on
a decoded corpus against the TAG rows of the port's full decode, and the
tool end to end."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dextractor_tpu.ops.tag_pallas import tag_route_rows as jax_tag_route_rows

from dextractor_tpu_torch.codecs import qv_codec as tq
from dextractor_tpu_torch.formats import dexqv as tdq
from dextractor_tpu_torch.formats.ragged import rows_to_flat
from dextractor_tpu_torch.ops import decode2 as d2
from dextractor_tpu_torch.ops import tag
from dextractor_tpu_torch.testing import batch_to, decode_batch, make_quiva
from dextractor_tpu_torch.tools import decode_ablate as ablate
from dextractor_tpu_torch.utils import dispatch


def _model(tag_bytes, keep, in_read):
    """NumPy Unpack_Tag (the model of tests/test_tag_pallas.py): the r-th
    kept position of a row takes code r of its bytes (first code in bits
    7-6), holes in the read 'n', the rest 0; codes past the bytes read 0."""
    n, max_len = keep.shape
    out = np.zeros((n, max_len), np.uint8)
    letters = np.frombuffer(b"acgt", np.uint8)
    for i in range(n):
        codes = ((tag_bytes[i][:, None] >> np.array([6, 4, 2, 0])) & 3).reshape(-1)
        codes = np.pad(codes, (0, max(0, max_len - len(codes))))
        r = 0
        for c in range(max_len):
            if not in_read[i, c]:
                continue
            if keep[i, c]:
                out[i, c] = letters[codes[r]]
                r += 1
            else:
                out[i, c] = ord("n")
    return out


def _jax_prep(tag_bytes, keep, in_read):
    """The JAX tool's prep (tools/decode_ablate.py:226-239) in NumPy:
    (state (N, L) i32, words (N, TB // 4) u32)."""
    n, tb = tag_bytes.shape
    rank = np.cumsum(keep.astype(np.int32), axis=1) - 1
    state = ((np.maximum(rank, 0).astype(np.int32) << 2)
             | (keep.astype(np.int32) << 1) | in_read.astype(np.int32))
    b = tag_bytes[:, :4 * (tb // 4)].reshape(n, tb // 4, 4).astype(np.uint32)
    words = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    return state, words


def _rows(seed, n, max_len, tb, kept_share=0.8):
    """Random rows with reads of length 0 (row 0), full (row 1), all kept
    (row 2) and none kept (row 3): (tag_bytes (N, TB) u8, keep, in_read)."""
    rng = np.random.default_rng(seed)
    rlens = rng.integers(0, max_len + 1, n)
    rlens[0], rlens[1] = 0, max_len
    in_read = np.arange(max_len)[None, :] < rlens[:, None]
    keep = in_read & (rng.random((n, max_len)) < kept_share)
    keep[2, :rlens[2]] = True
    keep[3] = False
    return rng.integers(0, 256, (n, tb)).astype(np.uint8), keep, in_read


def _twin(words, state, max_len):
    dispatch.reset_counts()
    got = tag.tag_route_rows(torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(state), max_len=max_len).numpy()
    assert dispatch.TWIN_CALLS["tag_route"] == 1 and not any(dispatch.LAUNCHES.values())
    return got


@pytest.mark.parametrize("n, max_len", [(70, 256), (8, 2560)])
def test_twin_matches_pallas_interpret(n, max_len):
    """70 x 256 are tests/test_tag_pallas.py's shapes (rows past the
    kernel's 64-row block); 8 x 2,560 has 160 words a row, past the
    kernel's first 128-word slice, and 8 rows padded to 64."""
    tag_bytes, keep, in_read = _rows(17, n, max_len, max_len // 4)
    state, words = _jax_prep(tag_bytes, keep, in_read)
    want = np.asarray(jax_tag_route_rows(jnp.asarray(words), jnp.asarray(state),
                                         max_len=max_len, interpret=True))
    got = _twin(words, state, max_len)
    assert (got == want).all()
    assert (got == _model(tag_bytes, keep, in_read)).all()


@pytest.mark.parametrize("max_len, tb", [(301, 80), (1001, 12), (5, 0)])
def test_twin_matches_model_any_width(max_len, tb):
    """Widths that are no multiple of 128 (or 4), and rows whose kept ranks
    run past their TB // 4 words (read as code 0, 'a')."""
    tag_bytes, keep, in_read = _rows(5, 12, max_len, tb)
    state, words = _jax_prep(tag_bytes, keep, in_read)
    got = _twin(words, state, max_len)
    assert (got == _model(tag_bytes[:, :4 * (tb // 4)], keep, in_read)).all()
    assert (got[in_read & keep][(np.cumsum(keep, 1) - 1)[in_read & keep]
                                >= 16 * (tb // 4)] == ord("a")).all()


def test_prep_matches_jax_tool():
    tag_bytes, keep, in_read = _rows(3, 9, 333, 83)
    rng = np.random.default_rng(4)
    del_char = 7
    rlens = in_read.sum(1)
    del_rows = np.where(keep, rng.integers(8, 40, keep.shape), del_char).astype(np.uint8)
    del_rows[~in_read] = rng.integers(0, 40, int((~in_read).sum()))
    state, words = _jax_prep(tag_bytes, keep, in_read)
    got_state = tag.tag_state(torch.from_numpy(del_rows), torch.from_numpy(rlens), del_char)
    got_words = tag.tag_words(torch.from_numpy(tag_bytes))
    assert got_state.dtype == torch.int32 and got_words.dtype == torch.int32
    assert (got_state.numpy() == state).all()
    assert (got_words.numpy().view(np.uint32) == words).all()


def test_twin_is_the_decode_unpack_tag():
    """On a decoded corpus with delQV runs: the twin, fed the full decode's
    delQV rows and the tag rectangle, gives the full decode's TAG rows, so
    K10 computes the main path's Unpack_Tag."""
    data = make_quiva(np.random.default_rng(2), lengths=[600, 0, 1, 2100, 37, 999, 513])
    enc = tq.encode_quiva_to_dexqv(data, device=False)
    args, kw = decode_batch(enc)
    assert kw["del_mode"] == "run"
    dargs = batch_to(args, "cpu")
    rows = d2.decode_entry_batch2(*dargs, **kw)
    state = tag.tag_state(rows[0], dargs[5], dargs[10])
    got = tag.tag_route_rows(tag.tag_words(dargs[1]), state, max_len=kw["max_len"])
    assert (got == rows[1]).all()
    assert (got == ord("n")).any() and (got == ord("a")).any()


def test_wrapper_checks_its_arguments():
    words = torch.zeros((4, 8), dtype=torch.int32)
    state = torch.zeros((4, 64), dtype=torch.int32)
    assert tag.tag_route_rows(words, state, max_len=64).shape == (4, 64)
    with pytest.raises(TypeError):
        tag.tag_route_rows(words.to(torch.int64), state, max_len=64)
    with pytest.raises(ValueError):
        tag.tag_route_rows(words, state, max_len=63)
    with pytest.raises(ValueError):
        tag.tag_route_rows(words[:3], state, max_len=64)
    with pytest.raises(ValueError, match="contiguous"):
        tag.tag_route_rows(words, torch.zeros((64, 4), dtype=torch.int32).t(), max_len=64)


def test_decode_ablate_on_the_cpu(monkeypatch, capsys):
    """The tool at --mb 0 (8 reads) on the CPU: one ABLATE line with all five
    phases, the twins run and no kernel, and the full phase's rows equal the
    native walker's streams of the same reads."""
    seen = {}

    def spy(*a, **k):
        seen["res"], seen["out"] = res = real(*a, **k)
        return res

    real = ablate.run
    monkeypatch.setattr(ablate, "run", spy)
    assert ablate.main(["--mb", "0", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("ABLATE: ")]
    assert len(lines) == 1
    res = json.loads(lines[0][len("ABLATE: "):])
    assert res == json.loads(json.dumps(seen["res"]))
    assert {f"{p}_ms" for p in ablate.PHASES} <= set(res)
    assert res["device"] == "cpu" and res["rows"] == 8
    assert res["tag_twin_calls"] == {"tag_route": 1}
    assert res["plain_ins_twin_calls"] == {"decode_plain": 1}
    assert not any(res[f"{p}_launches"] for p in ablate.PHASES)

    enc, args, _, _ = ablate.ablate_batch(0)
    coding, off = tdq.parse_qvcoding(memoryview(enc), 2)
    *_, lengths, streams = tq._walk_native(enc, coding, off, True)
    rows = seen["out"]["full"].numpy()
    assert len(lengths) == 8 and (args[5][:8] == lengths).all()
    for s in range(5):
        assert (rows_to_flat(rows[s][:8], lengths) == streams[s]).all()


def test_decode_ablate_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ablate.main(["--mb", "0", "--phases", "tag"])
    with pytest.raises(SystemExit):
        ablate.main(["--phases", "full,nope", "--device", "cpu"])
