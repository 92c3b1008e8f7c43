"""The port's qv_encode_step against the JAX package's on the example
batch of ``__graft_entry__.entry()`` (``_example_batch``), for each channel
routing.  On the CPU the port's step runs the kernels' plain twins."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dextractor_tpu.parallel import qv_encode_step as jax_step

from dextractor_tpu_torch.parallel import pipeline as tp
from dextractor_tpu_torch.utils import dispatch


@pytest.fixture(scope="module")
def batch():
    args, _ = ge._example_batch(n_entries=16, length=512)
    return args


@pytest.mark.parametrize("run_on", [(True, True), (False, False), (True, False)])
def test_step_matches_reference(batch, run_on):
    ref = [np.asarray(x) for x in jax_step(*batch, run_on=run_on)[:7]]
    dispatch.reset_counts()
    got = tp.qv_encode_step(*batch, run_on=run_on)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in got)
    assert dispatch.LAUNCHES == dict.fromkeys(dispatch.KERNELS, 0)
    assert dispatch.TWIN_CALLS["encode_run"] == int(any(run_on))
    words, raw, out, dup, zext, packed, clens = (x.numpy() for x in got)
    r_words, r_raw, r_out, r_dup, r_zext, r_packed, r_clens = ref
    for a, b in ((raw, r_raw), (out, r_out), (dup, r_dup), (zext, r_zext),
                 (packed, r_packed), (clens, r_clens)):
        assert np.array_equal(a, b)
    assert words.shape == r_words.shape
    words = words.view(np.uint32)
    for c in range(4):
        for i in range(words.shape[1]):
            r = int(raw[c, i])
            assert np.array_equal(words[c, i, :r], r_words[c, i, :r]), (c, i)


def test_step_keeps_tensors_on_their_device(batch):
    tensors = [torch.from_numpy(np.asarray(a)) for a in batch]
    got = tp.qv_encode_step(*tensors, run_on=(True, False))
    ref = tp.qv_encode_step(*batch, run_on=(True, False))
    for a, b in zip(got, ref):
        assert a.device.type == "cpu"
        assert torch.equal(a, b)
