"""The plain reference encoder against the program's native host encoder
(DEXTRACTOR's C channel encoder, ``device=False``), and the work bytes
counted from a file."""

import numpy as np
import pytest

from core import kinds
from ref import encode, gen
from tiny import config


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("workload,bases", [("rs2-p6.restore", 260_000),
                                            ("rs2-2kb.compress", 30_000)])
def test_reference_equals_the_native_encoder(workload, bases, lossy):
    from dextractor_tpu_torch.codecs import qv_codec

    cfg = config(workload)
    cfg["bases_per_file" if "bases_per_file" in cfg else "reads_per_file"] = (
        bases if "bases_per_file" in cfg else bases // 2000)
    q = gen.make_file(cfg, 77, 0)
    e = encode.encode(q, lossy)
    assert e.image == qv_codec.encode_quiva_to_dexqv(gen.quiva_text(q), lossy=lossy,
                                                     device=False)
    if "bases_per_file" in cfg:                  # past 200,000 symbols subQV is RLE
        assert e.coding.sub_char >= 0 and e.coding.del_char >= 0


def test_work_bytes_count_payload_and_compressed_streams():
    k = kinds.DecodeStep(config("rs2-p6.restore"), {"files": 2}, 3, None)
    k.make_files()
    k.refs = k.reference()
    k.steps = [None, None]
    for i in range(2):
        q, e = k.files[i], k.refs[i]
        streams = len(e.image) - len(encode.coding_bytes(e.coding)) - 2 - 13 * len(q.lengths)
        assert int(e.entry_bytes().sum()) == streams      # wells rise by < 255
        assert k.work_bytes(i) == 5 * int(q.lengths.sum()) + streams
    sel = np.array([0, 1])
    steps = [{"file": 1, "sel": sel, "payload": 5 * int(k.files[1].lengths[sel].sum())}]
    e = kinds.EncodeStep(config("rs2-2kb.compress"), {"files": 2}, 3, None)
    e.files, e.refs, e.steps = k.files, k.refs, steps
    assert e.work_bytes(0) == steps[0]["payload"] + int(k.refs[1].entry_bytes()[sel].sum())
