"""view's ``-e`` filter-expression language (htslib's hts_expr, which
samtools view applies through sam_passes_filter, sam_view.c:154);
counterpart of samtools_tpu/core/sam_expr.py.

Grammar (hts_expr.c): C-like expressions over per-record fields with
numeric, string and regex comparisons.  The expression compiles once into
an evaluator over the whole columnar batch: each predicate is a numpy
column, not a per-record interpreter loop.  Host code: no device work.

Fields: flag (+ flag.paired etc), mapq, pos, endpos, rlen, qlen, rname,
mpos, mrname, qname, cigar, seq, qual, tlen, hclen, sclen, library, and
[TAG] aux lookups.  Functions: min, max, abs, sqrt, log, pow, exp, length,
default, exists.
"""

from __future__ import annotations

import re

import numpy as np

from . import aux as auxmod
from . import flags as F


class ExprError(ValueError):
    pass


TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|\d+(?:[eE][-+]?\d+)?|0[xX][0-9a-fA-F]+)
    | (?P<str>"(?:[^"\\]|\\.)*")
    | (?P<tag>\[[A-Za-z][A-Za-z0-9]\])
    | (?P<op><=|>=|==|!=|=~|!~|&&|\|\||<<|>>|[-+*/%()<>!&|^~,])
    | (?P<id>[A-Za-z_][A-Za-z_.0-9]*)
    )""", re.X)


def tokenize(s: str):
    out = []
    pos = 0
    while pos < len(s):
        m = TOKEN_RE.match(s, pos)
        if not m or m.end() == m.start():
            if s[pos:].strip() == "":
                break
            raise ExprError(f"bad token at {s[pos:]!r}")
        pos = m.end()
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
    out.append(("end", ""))
    return out


class Node:
    def __init__(self, kind, *kids, value=None):
        self.kind = kind
        self.kids = kids
        self.value = value


class Parser:
    """Precedence-climbing parser for the hts_expr grammar."""

    BINOPS = [  # lowest to highest precedence
        {"||"}, {"&&"}, {"|"}, {"^"}, {"&"},
        {"==", "!=", "=~", "!~"}, {"<", "<=", ">", ">="},
        {"<<", ">>"}, {"+", "-"}, {"*", "/", "%"},
    ]

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse(self) -> Node:
        node = self.parse_binary(0)
        if self.peek()[0] != "end":
            raise ExprError(f"trailing tokens: {self.peek()[1]!r}")
        return node

    def parse_binary(self, level: int) -> Node:
        if level >= len(self.BINOPS):
            return self.parse_unary()
        lhs = self.parse_binary(level + 1)
        while self.peek()[1] in self.BINOPS[level] and self.peek()[0] == "op":
            op = self.next()[1]
            rhs = self.parse_binary(level + 1)
            lhs = Node("bin", lhs, rhs, value=op)
        return lhs

    def parse_unary(self) -> Node:
        kind, val = self.peek()
        if kind == "op" and val in ("!", "-", "+", "~"):
            self.next()
            return Node("un", self.parse_unary(), value=val)
        return self.parse_primary()

    def parse_primary(self) -> Node:
        kind, val = self.next()
        if kind == "num":
            return Node("num", value=float(int(val, 16)) if
                        val.lower().startswith("0x") else float(val))
        if kind == "str":
            body = val[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            return Node("str", value=body)
        if kind == "tag":
            return Node("tag", value=val[1:-1])
        if kind == "op" and val == "(":
            node = self.parse_binary(0)
            if self.next()[1] != ")":
                raise ExprError("expected )")
            return node
        if kind == "id":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_binary(0))
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_binary(0))
                if self.next()[1] != ")":
                    raise ExprError("expected )")
                return Node("call", *args, value=val)
            return Node("id", value=val)
        raise ExprError(f"unexpected token {val!r}")


_FLAG_FIELDS = {
    "flag.paired": F.FPAIRED, "flag.proper_pair": F.FPROPER_PAIR,
    "flag.unmap": F.FUNMAP, "flag.munmap": F.FMUNMAP,
    "flag.reverse": F.FREVERSE, "flag.mreverse": F.FMREVERSE,
    "flag.read1": F.FREAD1, "flag.read2": F.FREAD2,
    "flag.secondary": F.FSECONDARY, "flag.qcfail": F.FQCFAIL,
    "flag.dup": F.FDUP, "flag.supplementary": F.FSUPPLEMENTARY,
}


class Value:
    """Evaluation result: numeric array, string object-array, or scalar."""

    def __init__(self, data, is_str=False):
        self.data = data
        self.is_str = is_str


def _num(x) -> np.ndarray:
    if isinstance(x, Value):
        if x.is_str:
            raise ExprError("string used in numeric context")
        return x.data
    return x


class Evaluator:
    def __init__(self, header, batch):
        self.h = header
        self.b = batch
        self._cache = {}

    # -------------------------------------------------------- field access
    def field(self, name: str) -> Value:
        b = self.b
        if name in self._cache:
            return self._cache[name]
        if name in _FLAG_FIELDS:
            v = Value(((b.flag.astype(np.int64) & _FLAG_FIELDS[name]) != 0)
                      .astype(np.float64))
        elif name == "flag":
            v = Value(b.flag.astype(np.float64))
        elif name == "mapq":
            v = Value(b.mapq.astype(np.float64))
        elif name == "pos":
            v = Value((b.pos + 1).astype(np.float64))
        elif name == "endpos":
            v = Value(b.end_pos().astype(np.float64))
        elif name == "pnext" or name == "mpos":
            v = Value((b.mpos + 1).astype(np.float64))
        elif name == "tlen":
            v = Value(b.tlen.astype(np.float64))
        elif name == "rlen":
            v = Value(b.ref_span().astype(np.float64))
        elif name == "qlen":
            ops = (b.cigar & 0xF).astype(np.int64)
            lens = (b.cigar >> 4).astype(np.int64)
            cq = np.array(F.CIGAR_CONSUMES_QUERY, np.int64)
            contrib = lens * cq[ops]
            csum = np.concatenate([[0], np.cumsum(contrib)])
            v = Value((csum[b.cigar_off[1:]]
                       - csum[b.cigar_off[:-1]]).astype(np.float64))
        elif name == "rname":
            names = np.array(self.h.ref_names + ["*"], object)
            v = Value(names[np.where(b.tid < 0, len(self.h.ref_names),
                                     b.tid)], is_str=True)
        elif name == "mrname":
            names = np.array(self.h.ref_names + ["*"], object)
            v = Value(names[np.where(b.mtid < 0, len(self.h.ref_names),
                                     b.mtid)], is_str=True)
        elif name == "qname":
            out = np.empty(b.n, object)
            for i in range(b.n):
                out[i] = b.qname_str(i)
            v = Value(out, is_str=True)
        elif name == "cigar":
            from ..io.sam_text import cigar_to_str
            out = np.empty(b.n, object)
            for i in range(b.n):
                out[i] = cigar_to_str(b.cigar_of(i))
            v = Value(out, is_str=True)
        elif name == "seq":
            from ..io.sam_text import NT16_CHARS
            out = np.empty(b.n, object)
            for i in range(b.n):
                s = b.seq_of(i)
                out[i] = (bytes(NT16_CHARS[s]).decode("latin-1")
                          if s.size else "*")
            v = Value(out, is_str=True)
        elif name == "qual":
            out = np.empty(b.n, object)
            for i in range(b.n):
                q = b.qual_of(i)
                out[i] = (bytes((q + 33).astype(np.uint8)).decode("latin-1")
                          if q.size and not (q == 0xFF).all() else "*")
            v = Value(out, is_str=True)
        elif name in ("hclen", "sclen"):
            op_want = F.CHARD_CLIP if name == "hclen" else F.CSOFT_CLIP
            ops = (b.cigar & 0xF).astype(np.int64)
            lens = (b.cigar >> 4).astype(np.int64)
            contrib = np.where(ops == op_want, lens, 0)
            csum = np.concatenate([[0], np.cumsum(contrib)])
            v = Value((csum[b.cigar_off[1:]]
                       - csum[b.cigar_off[:-1]]).astype(np.float64))
        elif name == "library":
            from ..tools.view_cmd import _rg_to_library
            lbmap = _rg_to_library(self.h)
            rg = auxmod.batch_tag_values(b, "RG")
            out = np.empty(b.n, object)
            for i in range(b.n):
                out[i] = lbmap.get(rg[i], "") if rg[i] is not None else ""
            v = Value(out, is_str=True)
        elif name == "ncigar":
            v = Value(b.n_cigar.astype(np.float64))
        elif name == "tid":
            v = Value(b.tid.astype(np.float64))
        elif name == "mtid":
            v = Value(b.mtid.astype(np.float64))
        else:
            raise ExprError(f"unknown field {name!r}")
        self._cache[name] = v
        return v

    def tag(self, tag: str) -> Value:
        vals = auxmod.batch_tag_values(self.b, tag)
        # numeric if all present values are numeric, else string
        any_str = any(isinstance(v, str) for v in vals if v is not None)
        if any_str:
            out = np.array([v if v is not None else None for v in vals],
                           object)
            return Value(out, is_str=True)
        out = np.array([float(v) if v is not None and not isinstance(v, (list, tuple))
                        else np.nan for v in vals], np.float64)
        return Value(out)

    # --------------------------------------------------------- evaluation
    def eval(self, node: Node) -> Value:
        k = node.kind
        if k == "num":
            return Value(np.full(self.b.n, node.value))
        if k == "str":
            return Value(np.full(self.b.n, node.value, object), is_str=True)
        if k == "id":
            return self.field(node.value)
        if k == "tag":
            return self.tag(node.value)
        if k == "un":
            v = self.eval(node.kids[0])
            x = _num(v)
            if node.value == "!":
                return Value((~_truthy(v)).astype(np.float64))
            if node.value == "-":
                return Value(-x)
            if node.value == "~":
                return Value((~x.astype(np.int64)).astype(np.float64))
            return Value(+x)
        if k == "bin":
            return self.eval_bin(node)
        if k == "call":
            return self.eval_call(node)
        raise ExprError(f"bad node {k}")

    def eval_bin(self, node: Node) -> Value:
        op = node.value
        if op in ("&&", "||"):
            a = _truthy(self.eval(node.kids[0]))
            b = _truthy(self.eval(node.kids[1]))
            return Value(((a & b) if op == "&&" else (a | b))
                         .astype(np.float64))
        a = self.eval(node.kids[0])
        b = self.eval(node.kids[1])
        if op in ("=~", "!~"):
            if not b.is_str:
                raise ExprError("regex operand must be a string")
            pat = b.data[0] if b.data.size else ""
            rex = re.compile(pat)
            lhs = a.data if a.is_str else a.data.astype(str)
            hit = np.array([bool(rex.search(x)) if x is not None else False
                            for x in lhs])
            if op == "!~":
                hit = ~hit
            return Value(hit.astype(np.float64))
        if a.is_str or b.is_str:
            if op not in ("==", "!=", "<", "<=", ">", ">="):
                raise ExprError(f"operator {op} not valid for strings")
            la = a.data if a.is_str else a.data.astype(str)
            lb = b.data if b.is_str else b.data.astype(str)
            la = np.array(["" if x is None else x for x in la], object)
            lb = np.array(["" if x is None else x for x in lb], object)
            res = {"==": la == lb, "!=": la != lb, "<": la < lb,
                   "<=": la <= lb, ">": la > lb, ">=": la >= lb}[op]
            return Value(np.asarray(res).astype(np.float64))
        x, y = a.data, b.data
        if op == "+":
            r = x + y
        elif op == "-":
            r = x - y
        elif op == "*":
            r = x * y
        elif op == "/":
            r = x / np.where(y == 0, np.nan, y)
        elif op == "%":
            r = np.mod(x, np.where(y == 0, np.nan, y))
        elif op == "&":
            r = (x.astype(np.int64) & y.astype(np.int64)).astype(np.float64)
        elif op == "|":
            r = (x.astype(np.int64) | y.astype(np.int64)).astype(np.float64)
        elif op == "^":
            r = (x.astype(np.int64) ^ y.astype(np.int64)).astype(np.float64)
        elif op == "<<":
            r = (x.astype(np.int64) << y.astype(np.int64)).astype(np.float64)
        elif op == ">>":
            r = (x.astype(np.int64) >> y.astype(np.int64)).astype(np.float64)
        elif op == "==":
            r = (x == y).astype(np.float64)
        elif op == "!=":
            r = (x != y).astype(np.float64)
        elif op == "<":
            r = (x < y).astype(np.float64)
        elif op == "<=":
            r = (x <= y).astype(np.float64)
        elif op == ">":
            r = (x > y).astype(np.float64)
        elif op == ">=":
            r = (x >= y).astype(np.float64)
        else:
            raise ExprError(f"unknown operator {op}")
        return Value(r)

    def eval_call(self, node: Node) -> Value:
        fn = node.value
        args = [self.eval(k) for k in node.kids]
        if fn == "length":
            v = args[0]
            if v.is_str:
                return Value(np.array(
                    [len(x) if x is not None else 0 for x in v.data],
                    np.float64))
            return Value(np.abs(v.data))
        if fn == "min":
            return Value(np.minimum(_num(args[0]), _num(args[1])))
        if fn == "max":
            return Value(np.maximum(_num(args[0]), _num(args[1])))
        if fn == "abs":
            return Value(np.abs(_num(args[0])))
        if fn == "sqrt":
            return Value(np.sqrt(_num(args[0])))
        if fn == "log":
            return Value(np.log(_num(args[0])))
        if fn == "exp":
            return Value(np.exp(_num(args[0])))
        if fn == "pow":
            return Value(np.power(_num(args[0]), _num(args[1])))
        if fn == "exists":
            v = args[0]
            if v.is_str:
                return Value(np.array([x is not None for x in v.data],
                                      np.float64))
            return Value((~np.isnan(v.data)).astype(np.float64))
        if fn == "default":
            v, d = args
            if v.is_str:
                out = np.array([x if x is not None else
                                (d.data[i] if d.is_str else d.data[i])
                                for i, x in enumerate(v.data)], object)
                return Value(out, is_str=True)
            return Value(np.where(np.isnan(v.data), _num(d), v.data))
        raise ExprError(f"unknown function {fn!r}")


def _truthy(v: Value) -> np.ndarray:
    if v.is_str:
        return np.array([x is not None and x != "" for x in v.data], bool)
    return ~np.isnan(v.data) & (v.data != 0)


def compile_filter(expr: str):
    """Compile expression to fn(header, batch) -> bool mask."""
    ast = Parser(tokenize(expr)).parse()

    def run(header, batch) -> np.ndarray:
        ev = Evaluator(header, batch)
        return _truthy(ev.eval(ast))

    return run
