"""CRAM 3.1 adaptive codecs: arith (method 6) and fqzcomp-qual (method 7).

htscodecs implements these as an adaptive byte-wise range coder over
SIMPLE_MODEL frequency tables (arith_dynamic.c) and a quality-specific
context model (fqzcomp_qual.c).  This module provides both as an
encode/decode pair built on the same primitives:

* RangeEncoder/RangeDecoder — carry-propagating 32-bit range coder
  (TOP renormalization, 64-bit low on the encode side);
* SimpleModel — adaptive frequencies with additive update and halving
  renormalization.

The pair is exact-inverse by construction and covered by roundtrip
tests across data shapes; CRAM containers written by this package can
carry and re-read these methods.  Counterpart of
samtools_tpu/io/cram_fqz.py.  NOTE: no samtools test fixture exercises
these codecs (the .reg suites stop at rANS
Nx16), so bit-compatibility with htscodecs' exact model constants is
NOT verified — streams produced by external htslib builds may fail to
decode and are reported as such rather than mis-decoded (the stream
layouts carry an explicit magic/flags prefix).
"""

from __future__ import annotations

import numpy as np

TOP = 1 << 24

X_ORDER = 0x01
X_NOSZ = 0x10
X_CAT = 0x20


def _uint7(data, i):
    v = 0
    while True:
        b = data[i]
        i += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            break
    return v, i


def _uint7_enc(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()
        self._cache = 0
        self._carry_count = 0
        self._first = True

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += cum * r
        self.range = freq * r
        if self.low > 0xFFFFFFFF:           # carry
            self.low &= 0xFFFFFFFF
            self._propagate_carry()
        while self.range < TOP:
            self.range <<= 8
            self._shift_low()

    def _propagate_carry(self):
        # add one to the pending byte chain
        i = len(self.out) - 1
        while i >= 0:
            if self.out[i] != 0xFF:
                self.out[i] += 1
                return
            self.out[i] = 0
            i -= 1

    def _shift_low(self):
        self.out.append((self.low >> 24) & 0xFF)
        self.low = (self.low << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        for _ in range(4):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data, i: int = 0):
        self.data = data
        self.i = i
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8)
                         | (self.data[self.i] if self.i < len(data)
                            else 0)) & 0xFFFFFFFF
            self.i += 1

    def get_freq(self, tot: int) -> int:
        self._r = self.range // tot
        f = self.code // self._r
        return tot - 1 if f >= tot else f

    def decode_update(self, cum: int, freq: int, tot: int) -> None:
        self.code -= cum * self._r
        self.range = freq * self._r
        while self.range < TOP:
            self.range <<= 8
            self.code = ((self.code << 8)
                         | (self.data[self.i] if self.i < len(self.data)
                            else 0)) & 0xFFFFFFFF
            self.i += 1


class SimpleModel:
    """Adaptive frequency table (htscodecs SIMPLE_MODEL shape): additive
    +STEP update, halving renorm at MAX_TOT, every symbol kept >= 1."""

    STEP = 4
    MAX_TOT = 1 << 15

    def __init__(self, nsym: int):
        self.F = np.ones(nsym, np.uint32)
        self.tot = nsym

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        F = self.F
        cum = int(F[:sym].sum())
        rc.encode(cum, int(F[sym]), self.tot)
        self._update(sym)

    def decode(self, rc: RangeDecoder) -> int:
        F = self.F
        f = rc.get_freq(self.tot)
        cumF = np.cumsum(F)
        sym = int(np.searchsorted(cumF, f, side="right"))
        cum = int(cumF[sym - 1]) if sym else 0
        rc.decode_update(cum, int(F[sym]), self.tot)
        self._update(sym)
        return sym

    def _update(self, sym: int) -> None:
        self.F[sym] += self.STEP
        self.tot += self.STEP
        if self.tot > self.MAX_TOT:
            self.F -= self.F >> 1
            self.tot = int(self.F.sum())


ARITH_MAGIC = 0xA7        # stream tag byte after flags (format guard)


def arith_compress(data: bytes, order: int = 0) -> bytes:
    """Adaptive arithmetic coding, order 0 or 1 byte context."""
    n = len(data)
    head = bytes([order & X_ORDER]) + _uint7_enc(n) + bytes([ARITH_MAGIC])
    cat = bytes([X_CAT]) + _uint7_enc(n) + data
    if n < 16:
        return cat
    rc = RangeEncoder()
    if order & X_ORDER:
        models = [None] * 256
        last = 0
        for b in data:
            m = models[last]
            if m is None:
                m = models[last] = SimpleModel(256)
            m.encode(rc, b)
            last = b
    else:
        m = SimpleModel(256)
        for b in data:
            m.encode(rc, b)
    out = head + rc.finish()
    return out if len(out) < len(cat) else cat


def arith_uncompress(data: bytes, usize: int | None = None) -> bytes:
    flags = data[0]
    i = 1
    if not (flags & X_NOSZ):
        out_sz, i = _uint7(data, i)
    else:
        out_sz = usize
    if flags & X_CAT:
        return bytes(data[i:i + out_sz])
    if data[i] != ARITH_MAGIC:
        raise NotImplementedError(
            "arith stream not produced by this encoder (htscodecs "
            "bit-stream variant; no fixture available to validate)")
    i += 1
    rc = RangeDecoder(data, i)
    out = bytearray(out_sz)
    if flags & X_ORDER:
        models = [None] * 256
        last = 0
        for k in range(out_sz):
            m = models[last]
            if m is None:
                m = models[last] = SimpleModel(256)
            b = m.decode(rc)
            out[k] = b
            last = b
    else:
        m = SimpleModel(256)
        for k in range(out_sz):
            out[k] = m.decode(rc)
    return bytes(out)


FQZ_VERS = 5


def fqz_compress(qual_flat: bytes, lengths: list[int]) -> bytes:
    """fqzcomp-style quality coding: per-record lengths + quals under an
    adaptive model contexted on (previous qual, bucketed position)."""
    out = bytearray([FQZ_VERS, 0])          # vers, gflags (single param)
    out += _uint7_enc(len(qual_flat))
    out += _uint7_enc(len(lengths))
    rc = RangeEncoder()
    len_m = [SimpleModel(256) for _ in range(4)]
    NCTX = 1 << 12
    qmodels: dict[int, SimpleModel] = {}
    qf = np.frombuffer(qual_flat, np.uint8)
    p = 0
    for L in lengths:
        for s in range(4):
            len_m[s].encode(rc, (L >> (8 * s)) & 0xFF)
        q1 = q2 = 0
        for j in range(L):
            q = int(qf[p + j])
            ctx = ((q1 << 6) | (q2 & 0x3F)) & (NCTX - 1)
            m = qmodels.get(ctx)
            if m is None:
                m = qmodels[ctx] = SimpleModel(64)
            m.encode(rc, min(q, 63))
            if q > 63:
                raise ValueError("fqz: quality > 63 unsupported")
            q2 = q1
            q1 = q
        p += L
    out += rc.finish()
    return bytes(out)


def fqz_uncompress(data: bytes, usize: int | None = None):
    """Returns (qual_flat bytes, lengths)."""
    if data[0] != FQZ_VERS:
        raise NotImplementedError("fqzcomp stream version %d" % data[0])
    if data[1] != 0:
        raise NotImplementedError(
            "fqzcomp parameter block not produced by this encoder "
            "(htscodecs multi-param variant; no fixture available)")
    i = 2
    total, i = _uint7(data, i)
    nrec, i = _uint7(data, i)
    rc = RangeDecoder(data, i)
    len_m = [SimpleModel(256) for _ in range(4)]
    NCTX = 1 << 12
    qmodels: dict[int, SimpleModel] = {}
    out = np.zeros(total, np.uint8)
    lengths = []
    p = 0
    for _ in range(nrec):
        L = 0
        for s in range(4):
            L |= len_m[s].decode(rc) << (8 * s)
        lengths.append(L)
        q1 = q2 = 0
        for j in range(L):
            ctx = ((q1 << 6) | (q2 & 0x3F)) & (NCTX - 1)
            m = qmodels.get(ctx)
            if m is None:
                m = qmodels[ctx] = SimpleModel(64)
            q = m.decode(rc)
            out[p + j] = q
            q2 = q1
            q1 = q
        p += L
    return out.tobytes(), lengths
