"""The generator: the same seed gives the same files, every seed the same
reads in another order, and the configuration's channel layout."""

import numpy as np
import pytest

from ref import encode, gen
from tiny import config

SEEDS = (0, 12345, 2**31 + 7, -3, 2**40 + 1)


@pytest.mark.parametrize("workload", ["rs2-p6.restore", "rs2-2kb.compress"])
@pytest.mark.parametrize("seed", SEEDS)
def test_files_follow_the_seed_and_the_configuration(workload, seed):
    cfg = config(workload)
    a, b = gen.make_file(cfg, seed, 0), gen.make_file(cfg, seed, 0)
    assert gen.quiva_text(a) == gen.quiva_text(b)
    other = gen.make_file(cfg, seed, 1)
    assert not np.array_equal(a.streams, other.streams)
    lengths = gen.read_lengths(cfg)
    assert sorted(a.lengths) == sorted(lengths) == sorted(other.lengths)
    # every seed the same reads, in another order: the same coding tables
    again = gen.make_file(cfg, seed + 1, 0)
    assert not np.array_equal(again.lengths, a.lengths)
    for c in range(5):
        assert np.array_equal(np.bincount(again.streams[c], minlength=256),
                              np.bincount(a.streams[c], minlength=256))
    ea, eb = encode.encode(a, False), encode.encode(again, False)
    assert encode.coding_bytes(ea.coding) == encode.coding_bytes(eb.coding)
    spec = cfg["lengths"]
    assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]
    ch = cfg["channels"]
    run = a.streams[gen.DEL] == ch["del"]["run_char"]
    assert (a.streams[gen.TAG][run] == ord("n")).all()
    assert np.isin(a.streams[gen.TAG][~run], np.frombuffer(b"acgt", np.uint8)).all()
    for c, name in ((gen.INS, "ins"), (gen.MRG, "mrg")):
        s = a.streams[c]
        assert s.min() >= ch[name]["first"] and s.max() < ch[name]["first"] + ch[name]["count"]
    assert (a.ends - a.begs == a.lengths).all() and (np.diff(a.wells) >= 0).all()


def test_full_size_lengths_are_the_configurations_own():
    """998 long reads holding 12.8 M bases; 6,400 short reads."""
    long = gen.read_lengths({"lengths": config("rs2-p6.restore")["lengths"],
                             "bases_per_file": 12_800_000})
    assert len(long) == 998 and long.sum() >= 12_800_000
    short = gen.read_lengths({"lengths": config("rs2-2kb.compress")["lengths"],
                              "reads_per_file": 6400})
    assert len(short) == 6400


def test_quiva_text_is_what_the_program_parses():
    from dextractor_tpu_torch.formats.quiva import parse_quiva

    q = gen.make_file(config("rs2-p6.restore"), 5, 0)
    p = parse_quiva(gen.quiva_text(q))
    assert p.prefix == q.prefix and np.array_equal(p.streams, q.streams)
    for f in ("wells", "begs", "ends", "qvs", "lengths"):
        assert np.array_equal(getattr(p, f), getattr(q, f))
