"""CRAM 3.1 name tokenizer (method 8, htscodecs tok3 architecture).

Read names compress poorly as flat bytes; tok3 splits each name into
typed tokens (alpha runs, digit runs with/without leading zeros,
punctuation), diffs each token column against the previous name
(MATCH / numeric DELTA / literal), and entropy-codes every column
stream separately — digits in one stream compress to almost nothing
when they increment by 1.  This module implements that architecture on
top of this package's rANS Nx16 codec:

* tokenize + column-diff (encode) / reassemble (decode);
* one type stream + per-column content streams, each put through the
  Nx16 method trials.

The pair is exact-inverse and roundtrip-tested.  As with arith/fqzcomp
there is NO reference fixture exercising tok3, so htscodecs bit-stream
compatibility is unverified; foreign streams fail the leading magic
check with a clear error instead of mis-decoding.  Counterpart of
samtools_tpu/io/cram_tok3.py.
"""

from __future__ import annotations

import re

import numpy as np

from .cram_codecs import ransNx16_compress, ransNx16_uncompress

TOK3_MAGIC = b"\x00nT3"

T_MATCH = 0        # token equals previous name's token at this column
T_ALPHA = 1        # literal alpha/punct run (string stream + len)
T_DIGITS = 2       # numeric literal (u32 stream)
T_DIGITS0 = 3      # numeric literal with leading zeros (u32 + len)
T_DELTA = 4        # numeric delta 0..255 vs previous name's token
T_END = 5          # end of name

_TOKEN_RE = re.compile(rb"\d+|[^\d]+")


def _tokenize(name: bytes) -> list[bytes]:
    return _TOKEN_RE.findall(name)


def _uint7_enc(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _uint7(data, i):
    v = 0
    while True:
        b = data[i]
        i += 1
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            break
    return v, i


class _Streams:
    def __init__(self):
        self.b: dict[str, bytearray] = {}

    def put(self, key: str, data: bytes):
        self.b.setdefault(key, bytearray()).extend(data)


def tok3_compress(names: list[bytes]) -> bytes:
    st = _Streams()
    prev_toks: list[bytes] = []
    for name in names:
        toks = _tokenize(name)
        for col, t in enumerate(toks):
            key = str(col)
            if col < len(prev_toks) and prev_toks[col] == t:
                st.put("T", bytes([T_MATCH]))
                continue
            if t.isdigit():
                v = int(t)
                if (col < len(prev_toks) and prev_toks[col].isdigit()
                        and len(prev_toks[col]) == len(t)
                        and 0 <= v - int(prev_toks[col]) <= 255):
                    st.put("T", bytes([T_DELTA]))
                    st.put("D" + key,
                           bytes([v - int(prev_toks[col])]))
                elif t[0:1] == b"0" and len(t) > 1:
                    st.put("T", bytes([T_DIGITS0]))
                    st.put("V" + key, int(v).to_bytes(4, "little")
                           + bytes([len(t)]))
                elif v < (1 << 32):
                    st.put("T", bytes([T_DIGITS]))
                    st.put("V" + key, int(v).to_bytes(4, "little"))
                else:
                    st.put("T", bytes([T_ALPHA]))
                    st.put("S" + key, _uint7_enc(len(t)) + t)
            else:
                st.put("T", bytes([T_ALPHA]))
                st.put("S" + key, _uint7_enc(len(t)) + t)
        st.put("T", bytes([T_END]))
        prev_toks = toks
    out = bytearray(TOK3_MAGIC)
    out += _uint7_enc(len(names))
    out += _uint7_enc(len(st.b))
    for key in sorted(st.b):
        payload = bytes(st.b[key])
        kb = key.encode()
        best = min((ransNx16_compress(payload, 0),
                    ransNx16_compress(payload, 1)), key=len)
        out += _uint7_enc(len(kb)) + kb
        out += _uint7_enc(len(payload)) + _uint7_enc(len(best)) + best
    return bytes(out)


def tok3_uncompress(data: bytes) -> list[bytes]:
    if data[:4] != TOK3_MAGIC:
        raise NotImplementedError(
            "tok3 stream not produced by this encoder (htscodecs "
            "bit-stream variant; no fixture available to validate)")
    i = 4
    n_names, i = _uint7(data, i)
    n_streams, i = _uint7(data, i)
    streams: dict[str, bytes] = {}
    for _ in range(n_streams):
        klen, i = _uint7(data, i)
        key = data[i:i + klen].decode()
        i += klen
        usize, i = _uint7(data, i)
        csize, i = _uint7(data, i)
        body, _ = ransNx16_uncompress(data[i:i + csize], 0, usize)
        streams[key] = body
        i += csize
    tpos = {k: 0 for k in streams}

    def take(key, n):
        p = tpos[key]
        tpos[key] = p + n
        return streams[key][p:p + n]

    names: list[bytes] = []
    prev_toks: list[bytes] = []
    T = streams.get("T", b"")
    ti = 0
    for _ in range(n_names):
        toks: list[bytes] = []
        col = 0
        while True:
            t = T[ti]
            ti += 1
            if t == T_END:
                break
            key = str(col)
            if t == T_MATCH:
                toks.append(prev_toks[col])
            elif t == T_DELTA:
                d = take("D" + key, 1)[0]
                base = prev_toks[col]
                v = int(base) + d
                toks.append(str(v).rjust(len(base), "0")
                            .encode()[-len(base):]
                            if len(str(v)) <= len(base)
                            else str(v).encode())
            elif t == T_DIGITS:
                v = int.from_bytes(take("V" + key, 4), "little")
                toks.append(str(v).encode())
            elif t == T_DIGITS0:
                raw = take("V" + key, 5)
                v = int.from_bytes(raw[:4], "little")
                width = raw[4]
                toks.append(str(v).encode().rjust(width, b"0"))
            elif t == T_ALPHA:
                sk = "S" + key
                p = tpos[sk]
                ln, p2 = _uint7(streams[sk], p)
                tpos[sk] = p2 + ln
                toks.append(streams[sk][p2:p2 + ln])
            else:
                raise ValueError("tok3: bad token type %d" % t)
            col += 1
        names.append(b"".join(toks))
        prev_toks = toks
    return names
