"""Subread filter expression DSL.

Grammar and semantics of the reference parser (expr.c:62-257):

  or   := and ( '||' and )*
  and  := pred ( '&&' pred )*
  pred := '(' or ')' | terminal cmp terminal
  cmp  := < | <= | > | >= | != | ==
  terminal := zm | ln | rq | bc1 | bc2 | bq | np | qs | integer

Eight variables (README.md:79-97): zm (well), ln (pulse length), rq
(quality*1000), bc1/bc2 (barcodes), bq (barcode qual), np (pass count),
qs (pulse start).  Variables a record does not define evaluate to -1
(expr.c:377-384).

Unlike the reference's per-record tree walk, evaluation here is vectorized:
``Filter.evaluate`` takes a dict of equal-length NumPy arrays and returns a
boolean keep-mask for the whole batch in one pass.  The port's own copy of
``dextractor_tpu/ingest/filter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

VARS = ("zm", "ln", "rq", "bc1", "bc2", "bq", "np", "qs")

_ERRORS = [
    "Out of memory",
    "Unrecognized token",
    "Expecting closing paren",
    "Expecting comparison operator",
]


class FilterError(ValueError):
    def __init__(self, expr: str, pos: int, code: int):
        self.expr = expr
        self.pos = pos
        self.code = code
        super().__init__(
            f"Filter expression syntax error:\n\n    {expr}\n"
            f"{' ' * (pos + 4)}^ {_ERRORS[code]}")


@dataclass
class Node:
    op: str
    lft: "Node | int | None" = None
    rgt: "Node | None" = None


class _Parser:
    def __init__(self, expr: str):
        self.s = expr
        self.i = 0

    def error(self, code: int):
        raise FilterError(self.s, self.i, code)

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else "\0"

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def terminal(self) -> Node:
        c = self.peek()
        for v in VARS:          # bc1/bc2 are listed before bq on purpose
            if self.s.startswith(v, self.i):
                self.i += len(v)
                return Node(v)
        if c.isdigit():
            j = self.i
            while self.peek().isdigit():
                self.i += 1
            return Node("int", int(self.s[j:self.i]))
        self.error(1)

    def pred(self) -> Node:
        self.skip_ws()
        if self.peek() == "(":
            self.i += 1
            v = self.or_()
            self.skip_ws()
            if self.peek() != ")":
                self.error(2)
            self.i += 1
            return v
        v = self.terminal()
        self.skip_ws()
        c = self.peek()
        if c == "<":
            self.i += 1
            op = "<"
            if self.peek() == "=":
                self.i += 1
                op = "<="
        elif c == ">":
            self.i += 1
            op = ">"
            if self.peek() == "=":
                self.i += 1
                op = ">="
        elif c == "!":
            if self.s.startswith("!=", self.i):
                self.i += 2
                op = "!="
            else:
                self.error(3)
        elif c == "=":
            if self.s.startswith("==", self.i):
                self.i += 2
                op = "=="
            else:
                self.error(3)
        else:
            self.error(3)
        self.skip_ws()
        w = self.terminal()
        return Node(op, v, w)

    def and_(self) -> Node:
        v = self.pred()
        while True:
            self.skip_ws()
            if self.peek() != "&":
                return v
            if not self.s.startswith("&&", self.i):
                self.error(1)
            self.i += 2
            v = Node("&&", v, self.pred())

    def or_(self) -> Node:
        v = self.and_()
        while True:
            self.skip_ws()
            if self.peek() != "|":
                return v
            if not self.s.startswith("||", self.i):
                self.error(1)
            self.i += 2
            v = Node("||", v, self.and_())


_CMPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "!=": lambda a, b: a != b,
    "==": lambda a, b: a == b,
}


@dataclass
class Filter:
    root: Node
    source: str

    def evaluate(self, fields: dict) -> np.ndarray:
        """Vectorized keep-mask over a batch of records.

        ``fields`` maps variable names to integer arrays; missing
        variables evaluate to -1 per the reference (expr.c:377-384).
        Comparison results act as 0/1 integers when fed to comparisons
        (C semantics).
        """
        n = None
        for v in fields.values():
            n = len(v)
            break

        def ev(node: Node):
            op = node.op
            if op == "int":
                return np.asarray(node.lft)
            if op in VARS:
                if op in fields:
                    return np.asarray(fields[op])
                return np.asarray(-1)
            if op == "&&":
                return ev(node.lft).astype(bool) & ev(node.rgt).astype(bool)
            if op == "||":
                return ev(node.lft).astype(bool) | ev(node.rgt).astype(bool)
            a = ev(node.lft)
            b = ev(node.rgt)
            # comparisons on boolean subresults use C 0/1 semantics
            if a.dtype == bool:
                a = a.astype(np.int64)
            if b.dtype == bool:
                b = b.astype(np.int64)
            return _CMPS[op](a, b)

        out = ev(self.root)
        out = np.asarray(out).astype(bool)
        if out.ndim == 0 and n is not None:
            out = np.full(n, bool(out))
        return out


DEFAULT_FILTER = "ln>=500 && rq>=750"     # dextract.c:217


def parse_filter(expr: str) -> Filter:
    p = _Parser(expr)
    root = p.or_()
    return Filter(root, expr)
