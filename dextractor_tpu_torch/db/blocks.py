"""@-block command-line expansion (reference Block_Looper, DB.c:2657-2923).

``path.@`` / ``path.@i`` / ``path.@i-j`` arguments expand to a sequence of
numbered block files — the reference's HPC fan-out mechanism.  For DB
arguments an open-ended range is bounded by the stub's block count.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from ..utils.errors import DextractorError
from ..utils.paths import path_to, root as rootof, catenate, numbered_suffix
from . import stub as stub_mod

BLOCK_SYMBOL = "@"
INT_MAX = 2 ** 31 - 1


@dataclass
class BlockLooper:
    pwd: str
    root: str
    ppnt: str          # suffix after the range spec
    first: int         # -1 => no @ in the argument (single plain file)
    last: int
    next: int
    is_db: int

    def reset(self):
        self.next = self.first - 1

    def _disp(self, n: int) -> str:
        if n < 0:
            return self.root
        return numbered_suffix(self.root, n, self.ppnt)

    def next_exists(self) -> bool:
        if self.next + 1 > self.last:
            return False
        if self.is_db:
            return True
        disp = self._disp(self.next + 1 if self.next >= 0 else -1)
        return os.path.exists(catenate(self.pwd, "/", disp, ".las"))

    def advance(self) -> bool:
        if self.next_exists():
            self.next += 1
            return True
        return False

    def arg_root(self) -> str:
        return self._disp(self.next)

    def arg_path(self) -> str:
        return self.pwd

    def next_slice(self, slice_n: int) -> str | None:
        if self.next + 1 > self.last:
            return None
        if self.next + slice_n > self.last:
            slice_n = self.last - self.next
        if self.first < 0:
            out = f"{self.pwd}/{self.root}"
        else:
            out = (f"{self.pwd}/{self.root}{BLOCK_SYMBOL}"
                   f"{self.next + 1}-{self.next + slice_n}{self.ppnt}")
        self.next += slice_n
        return out


def _parse(arg: str, is_db: int) -> BlockLooper:
    pwd = path_to(arg)
    if is_db:
        if arg.endswith(".dam"):
            root = rootof(arg, ".dam")
            is_db = 2
        else:
            root = rootof(arg, ".db")
    else:
        root = rootof(arg, ".las")

    at = root.find(BLOCK_SYMBOL)
    if at < 0:
        first = last = -1
        ppnt = ""
    else:
        if root.find(BLOCK_SYMBOL, at + 1) >= 0:
            raise DextractorError(
                f"Two or more occurrences of {BLOCK_SYMBOL}-sign in source name '{root}'")
        spec = root[at + 1:]
        root = root[:at]
        m = re.match(r"(\d+)(?:-(\d+))?", spec)
        if m is None:
            first, last = 1, INT_MAX
            ppnt = spec
        else:
            first = int(m.group(1))
            if first < 1:
                raise DextractorError(
                    f"Integer following {BLOCK_SYMBOL}-sign is less than 1 "
                    f"in source name '{root}'")
            if m.group(2) is not None:
                last = int(m.group(2))
                if last < first:
                    raise DextractorError(
                        f"2nd integer is less than 1st integer in source name '{root}'")
            else:
                last = INT_MAX
            ppnt = spec[m.end():]

    looper = BlockLooper(pwd=pwd, root=root, ppnt=ppnt,
                         first=first, last=last, next=first - 1, is_db=is_db)

    if is_db and first >= 0 and last == INT_MAX:
        for suffix in (".db", ".dam"):
            name = catenate(pwd, "/", root, suffix)
            if os.path.exists(name):
                looper.last = stub_mod.read_stub(name).nblocks
                break
        else:
            raise DextractorError(f"Cannot open database {root}[db|dam]")
    return looper


def parse_block_las_arg(arg: str) -> BlockLooper:
    return _parse(arg, 0)


def parse_block_db_arg(arg: str) -> BlockLooper:
    return _parse(arg, 1)
