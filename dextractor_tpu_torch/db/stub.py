"""ASCII stub (.db) grammar: NFILE FDATA^nfile [NBLOCK PARAMS BDATA^nblock+1].

Byte-exact writers for the reference's fixed-width format strings
(DB.h:431-435) and fscanf-tolerant readers (Read_DB_Stub DB.c:478-588,
Fetch_Block_Range DB.c:593-645).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..utils.errors import FormatError

DB_NFILE = "files = {:9d}\n"
DB_FDATA = "  {:9d} {} {}\n"
DB_NBLOCK = "blocks = {:9d}\n"
DB_PARAMS = "size = {:11d} cutoff = {:9d} all = {:1d}\n"
DB_BDATA = " {:9d} {:9d}\n"

_NFILE_RE = re.compile(r"\s*files\s*=\s*(-?\d+)")
_FDATA_RE = re.compile(r"\s*(-?\d+)\s+(\S+)\s+(\S+)")
_NBLOCK_RE = re.compile(r"\s*blocks\s*=\s*(-?\d+)")
_PARAMS_RE = re.compile(r"\s*size\s*=\s*(-?\d+)\s*cutoff\s*=\s*(-?\d+)\s*all\s*=\s*(-?\d+)")
_BDATA_RE = re.compile(r"\s*(-?\d+)\s+(-?\d+)")


@dataclass
class Stub:
    nfiles: int = 0
    nreads: list = field(default_factory=list)    # last-read-index per cell
    fname: list = field(default_factory=list)
    prolog: list = field(default_factory=list)
    all: int = 1
    cutoff: int = 0
    bsize: int = 0
    nblocks: int = 0                              # 0 => not partitioned
    ublocks: list = field(default_factory=list)
    tblocks: list = field(default_factory=list)
    partitioned: bool = False


class _Scanner:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def match(self, pattern):
        m = pattern.match(self.text, self.pos)
        if m is None:
            return None
        self.pos = m.end()
        return m


def parse_stub(text: str, path: str = "<stub>") -> Stub:
    sc = _Scanner(text)
    m = sc.match(_NFILE_RE)
    if m is None:
        raise FormatError(f"Stub file {path} is junk")
    stub = Stub(nfiles=int(m.group(1)))
    for _ in range(stub.nfiles):
        m = sc.match(_FDATA_RE)
        if m is None:
            raise FormatError(f"Stub file {path} is junk")
        stub.nreads.append(int(m.group(1)))
        stub.fname.append(m.group(2))
        stub.prolog.append(m.group(3))
    m = sc.match(_NBLOCK_RE)
    if m is None:
        return stub                                  # unpartitioned DB
    stub.nblocks = int(m.group(1))
    stub.partitioned = True
    m = sc.match(_PARAMS_RE)
    if m is None:
        raise FormatError(f"Stub file {path} is junk")
    stub.bsize = int(m.group(1))
    stub.cutoff = int(m.group(2))
    stub.all = int(m.group(3))
    for _ in range(stub.nblocks + 1):
        m = sc.match(_BDATA_RE)
        if m is None:
            raise FormatError(f"Stub file {path} is junk")
        stub.ublocks.append(int(m.group(1)))
        stub.tblocks.append(int(m.group(2)))
    return stub


def read_stub(path: str) -> Stub:
    with open(path, "r") as f:
        return parse_stub(f.read(), path)


def format_stub(stub: Stub) -> str:
    out = [DB_NFILE.format(stub.nfiles)]
    for n, f, p in zip(stub.nreads, stub.fname, stub.prolog):
        out.append(DB_FDATA.format(n, f, p))
    if stub.partitioned:
        out.append(DB_NBLOCK.format(stub.nblocks))
        out.append(DB_PARAMS.format(stub.bsize, stub.cutoff, stub.all))
        for u, t in zip(stub.ublocks, stub.tblocks):
            out.append(DB_BDATA.format(u, t))
    return "".join(out)


def write_stub(path: str, stub: Stub) -> None:
    with open(path, "w") as f:
        f.write(format_stub(stub))


def fetch_block_range(path: str, trim: bool, n: int):
    """Read index range [first, last) of block n (Fetch_Block_Range
    DB.c:593-645); (-1, -1) when n is out of range."""
    stub = read_stub(path)
    if n < 0 or n >= stub.nblocks:
        return -1, -1
    if trim:
        return stub.tblocks[n], stub.tblocks[n + 1]
    return stub.ublocks[n], stub.ublocks[n + 1]
