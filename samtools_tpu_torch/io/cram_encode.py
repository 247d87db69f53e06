"""CRAM 3.0 writer.

Reference-based encoder producing spec-conformant containers that both
this package's reader (io/cram_decode.py, validated byte-exact against
reference-produced fixtures) and htslib can decode.  Capability analog:
htslib cram_encode.c as used by `samtools view -C`.  Counterpart of
samtools_tpu/io/cram_encode.py: the same bytes for the same batch.

Encoding choices (an encoder picks its own; these favor simplicity and
robust interop):
* every data series EXTERNAL in its own block (ITF8 ints / raw bytes);
  read names and byte arrays as BYTE_ARRAY_STOP with NUL stops
* absolute alignment positions (AP=0), read names kept (RN=1)
* every record detached (CF bit 2) with explicit mate info — the
  always-correct mate representation (spec 10.4)
* mapped sequences as reference substitutions (X/BS with the canonical
  matrix) + I/S/D/N/P/H features from CIGAR; bases outside ACGTN via
  'B' base+qual features
* gzip block compression (method 1), one slice per container
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

from ..core import flags as F
from .cram import CramError

SEQ16 = "=ACMGRSVTWYHKDBN"
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606"
    "010001000100ee63014b")

# content ids (arbitrary but stable)
CID = {k: i + 1 for i, k in enumerate(
    ["BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS", "MQ",
     "FN", "FC", "FP", "BS", "IN", "SC", "DL", "BA", "QS", "TL", "RS",
     "PD", "HC", "BB", "QQ"])}
TAG_CID0 = 100

# canonical substitution matrix: for ref base i the 4 alternates in
# ACGTN-minus-self order get codes 0..3 (byte 0b00011011 per row)
SM_BYTES = bytes([0b00011011] * 5)
_BASES = "ACGTN"
_SUB_CODE = {}
for _i, _rb in enumerate(_BASES):
    _others = [b for b in _BASES if b != _rb]
    for _j, _alt in enumerate(_others):
        _SUB_CODE[(_rb, _alt)] = _j  # code j stored in 2 bits 00,01,10,11


def itf8_enc(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x400000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8_enc(v: int) -> bytes:
    v &= (1 << 64) - 1
    for n in range(8):  # n = leading ones = trailing payload bytes
        if v < (1 << (7 - n + 8 * n)):
            mask = (0xFF << (8 - n)) & 0xFF
            first = mask | (v >> (8 * n))
            rest = (v & ((1 << (8 * n)) - 1)).to_bytes(n, "big") \
                if n else b""
            return bytes([first]) + rest
    return bytes([0xFF]) + v.to_bytes(8, "big")


def _enc_external(cid: int) -> bytes:
    params = itf8_enc(cid)
    return itf8_enc(1) + itf8_enc(len(params)) + params


def _enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8_enc(cid)
    return itf8_enc(5) + itf8_enc(len(params)) + params


def _gzip_member(payload: bytes) -> bytes:
    deflated = zlib.compress(payload, 6)[2:-4]
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
            + deflated
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload) & 0xFFFFFFFF))


def encode_block(method: int, ctype: int, content_id: int,
                 payload: bytes, version=(3, 0)) -> bytes:
    """method: 0 raw, 1 gzip, 4 rANS 4x8, 6 rANS Nx16, -1 = pick the
    smallest of {gzip, rans-4x8 o0/o1, and for CRAM >= 3.1 rans-Nx16
    o0/o1} (the htslib method-trial behavior for external data series,
    cram_io.c cram_compress_block)."""
    usize = len(payload)
    if method == -1:
        cands = [(1, _gzip_member(payload))]
        if 0 < usize < (1 << 30):
            from .cram_codecs import rans4x8_compress, ransNx16_compress
            try:
                cands.append((4, rans4x8_compress(payload, 0)))
                if usize >= 1024:
                    cands.append((4, rans4x8_compress(payload, 1)))
            except Exception:
                pass
            if version >= (3, 1):
                # method 5 = rANS Nx16 (CRAM 3.1 codec table)
                try:
                    cands.append((5, ransNx16_compress(payload, 0)))
                    if usize >= 1024:
                        cands.append((5, ransNx16_compress(payload, 1)))
                except Exception:
                    pass
        method, comp = min(cands, key=lambda mc: len(mc[1]))
    elif method == 1:
        comp = _gzip_member(payload)
    else:
        comp = payload
    out = bytes([method, ctype]) + itf8_enc(content_id) + \
        itf8_enc(len(comp)) + itf8_enc(usize) + comp
    return out + struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)


def _container_header(length: int, ref_id: int, start: int, span: int,
                      n_records: int, counter: int, n_bases: int,
                      n_blocks: int, landmarks: list[int]) -> bytes:
    out = struct.pack("<i", length)
    out += itf8_enc(ref_id) + itf8_enc(start) + itf8_enc(span)
    out += itf8_enc(n_records) + ltf8_enc(counter) + ltf8_enc(n_bases)
    out += itf8_enc(n_blocks) + itf8_enc(len(landmarks))
    for lm in landmarks:
        out += itf8_enc(lm)
    return out + struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)


class _Streams:
    """Per-series external byte streams."""

    def __init__(self):
        self.b = {}

    def s(self, key) -> bytearray:
        if key not in self.b:
            self.b[key] = bytearray()
        return self.b[key]

    def put_int(self, key, v: int):
        self.s(key).extend(itf8_enc(int(v)))

    def put_byte(self, key, v: int):
        self.s(key).append(v & 0xFF)

    def put_stop(self, key, data: bytes):
        st = self.s(key)
        st += data
        st.append(0)


def _tag_list(aux: bytes):
    """[(tag2, type, value_bytes)] from raw BAM aux bytes."""
    out = []
    i = 0
    n = len(aux)
    while i + 3 <= n:
        tag = aux[i:i + 2].decode("latin-1")
        typ = chr(aux[i + 3 - 1])
        i += 3
        if typ in "cC":
            val = aux[i:i + 1]
            i += 1
        elif typ in "sS":
            val = aux[i:i + 2]
            i += 2
        elif typ in "iIf":
            val = aux[i:i + 4]
            i += 4
        elif typ == "A":
            val = aux[i:i + 1]
            i += 1
        elif typ in "ZH":
            j = aux.index(b"\x00", i)
            val = aux[i:j + 1]
            i = j + 1
        elif typ == "B":
            sub = chr(aux[i])
            cnt = struct.unpack_from("<I", aux, i + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
                  "f": 4}[sub]
            val = aux[i:i + 5 + cnt * sz]
            i += 5 + cnt * sz
        else:
            raise CramError("unknown aux type %r" % typ)
        out.append((tag, typ, bytes(val)))
    return out


def encode_cram(header, batch, ref_lookup, version=(3, 0),
                slice_records: int = 10000):
    """Encode a whole batch; returns (cram_bytes, crai_lines).

    ref_lookup(tid) -> uppercase reference bytes for that contig (or
    None; mapped records then fall back to per-base 'B' features).
    Records must be grouped by tid for single-reference slices
    (coordinate-sorted input satisfies this; mixed groups get split).
    """
    out = bytearray()
    out += b"CRAM" + bytes([version[0], version[1]])
    fid = b"samtools_tpu.cram"
    out += fid.ljust(20, b"\x00")[:20]

    # SAM header container: one RAW block padded with NULs so the
    # header can later be replaced in place (cram_reheader_inplace,
    # bam_reheader.c:193 — htslib pads the same way)
    htext = header.text.encode("latin-1")
    pad = max(1024, len(htext) // 2)
    hpayload = struct.pack("<i", len(htext)) + htext + b"\x00" * pad
    hblock = encode_block(0, 0, 0, hpayload)
    out += _container_header(len(hblock), 0, 0, 0, 0, 0, 0, 1, [0])
    out += hblock

    crai = []
    counter = 0
    # split into single-ref runs of <= slice_records
    n = batch.n
    i = 0
    runs = []
    while i < n:
        t = int(batch.tid[i])
        j = i
        while j < n and int(batch.tid[j]) == t and j - i < slice_records:
            j += 1
        runs.append((i, j, t))
        i = j
    for beg, end, tid in runs:
        cont = _encode_container(header, batch, beg, end, tid,
                                 ref_lookup, counter, crai, len(out),
                                 version)
        counter += end - beg
        out += cont
    out += CRAM_EOF
    return bytes(out), crai


def _encode_container(header, batch, beg, end, tid, ref_lookup, counter,
                      crai, file_offset, version=(3, 0)):
    nrec = end - beg
    ref = ref_lookup(tid) if tid >= 0 else None
    st = _Streams()
    tag_dict = []
    tag_keys = {}
    tag_seen = {}

    rl_sum = 0
    for ri in range(beg, end):
        rl_sum += _encode_record(header, batch, ri, st, ref, tag_dict,
                                 tag_keys, tag_seen)

    if tid >= 0:
        spans = batch.end_pos()[beg:end]
        pos_min = int(batch.pos[beg:end].min()) + 1
        pos_max = int(max(spans.max(), batch.pos[beg:end].max() + 1))
        ref_start, ref_span = pos_min, pos_max - pos_min + 1
    else:
        ref_start, ref_span = 0, 0

    # ---- compression header ------------------------------------------
    # preservation map: RN=1, AP=0, RR=1, SM, TD
    td = b"".join(
        b"".join(t.encode() + typ.encode() for t, typ in row) + b"\x00"
        for row in tag_dict) if tag_dict else b"\x00"
    pm = bytearray()
    entries = [(b"RN", b"\x01"), (b"AP", b"\x00"), (b"RR", b"\x01"),
               (b"SM", SM_BYTES), (b"TD", itf8_enc(len(td)) + td)]
    pm += itf8_enc(len(entries))
    for k, v in entries:
        pm += k + v
    pmap = itf8_enc(len(pm)) + bytes(pm)

    ds = bytearray()
    used = [k for k in CID if k in st.b or k in
            ("BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
             "TL")]
    enc_entries = []
    for key in used:
        if key in ("RN", "IN", "SC", "BB", "QQ"):
            enc = _enc_byte_array_stop(0, CID[key])
        else:
            enc = _enc_external(CID[key])
        enc_entries.append(key.encode() + enc)
    ds += itf8_enc(len(enc_entries))
    for e in enc_entries:
        ds += e
    dsmap = itf8_enc(len(ds)) + bytes(ds)

    tg = bytearray()
    tg += itf8_enc(len(tag_keys))
    for (tag, typ), (cid_len, cid_val) in tag_keys.items():
        key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
        sub = _enc_external(cid_len) + _enc_external(cid_val)
        tg += itf8_enc(key) + itf8_enc(4) + itf8_enc(len(sub)) + sub
    tgmap = itf8_enc(len(tg)) + bytes(tg)

    ch_payload = pmap + dsmap + tgmap
    ch_block = encode_block(1, 1, 0, bytes(ch_payload))

    # ---- slice -------------------------------------------------------
    ext_blocks = []
    content_ids = []
    for key, data in st.b.items():
        cid = CID[key] if key in CID else key  # tag streams keyed by cid
        content_ids.append(cid)
        ext_blocks.append(encode_block(-1, 4, cid, bytes(data),
                                        version))
    core_block = encode_block(0, 5, 0, b"")

    md5 = b"\x00" * 16
    if tid >= 0 and ref is not None:
        md5 = hashlib.md5(
            ref[ref_start - 1:ref_start - 1 + ref_span]).digest()
    sh = bytearray()
    sh += itf8_enc(tid) + itf8_enc(ref_start) + itf8_enc(ref_span)
    sh += itf8_enc(nrec) + ltf8_enc(counter)
    sh += itf8_enc(1 + len(ext_blocks))
    sh += itf8_enc(len(content_ids))
    for cid in content_ids:
        sh += itf8_enc(cid)
    sh += itf8_enc(-1)  # no embedded reference
    sh += md5
    sh_block = encode_block(0, 2, 0, bytes(sh))

    body = ch_block + sh_block + core_block + b"".join(ext_blocks)
    landmarks = [len(ch_block)]
    n_blocks = 2 + 1 + len(ext_blocks)
    chdr = _container_header(len(body), tid, ref_start, ref_span, nrec,
                             counter, rl_sum, n_blocks, landmarks)
    crai.append((tid, ref_start, ref_span, file_offset,
                 len(ch_block), len(sh_block) + len(core_block)
                 + sum(len(b) for b in ext_blocks)))
    return chdr + body


def _encode_record(header, batch, ri, st, ref, tag_dict, tag_keys,
                   tag_seen) -> int:
    flag = int(batch.flag[ri])
    tid = int(batch.tid[ri])
    rl = int(batch.l_qseq[ri])
    seq_codes = batch.seq[batch.seq_off[ri]:batch.seq_off[ri + 1]]
    qual = batch.qual[batch.seq_off[ri]:batch.seq_off[ri + 1]]
    has_seq = rl > 0
    has_qual = has_seq and qual.size and not (qual == 0xFF).all()

    cf = 2  # detached
    if has_qual:
        cf |= 1
    if not has_seq:
        cf |= 8
        if not (flag & F.FUNMAP):
            # seq-less mapped: RL = CIGAR query length so the decoder
            # reconstructs the CIGAR (seq/qual stay '*' via CF bit 8)
            cg = batch.cigar[batch.cigar_off[ri]:batch.cigar_off[ri + 1]]
            ops = cg & 0xF
            q_ops = (ops == F.CMATCH) | (ops == F.CINS) | \
                (ops == F.CSOFT_CLIP) | (ops == F.CEQUAL) | \
                (ops == F.CDIFF)
            rl = int((cg[q_ops] >> 4).sum())
    st.put_int("BF", flag)
    st.put_int("CF", cf)
    st.put_int("RL", rl)
    st.put_int("AP", int(batch.pos[ri]) + 1)
    # RG from aux
    tags = _tag_list(bytes(batch.aux[batch.aux_off[ri]:
                                     batch.aux_off[ri + 1]]))
    rg = -1
    rest = []
    rg_ids = header.rg_ids()
    for tag, typ, val in tags:
        if tag == "RG" and typ == "Z":
            name = val.rstrip(b"\x00").decode("latin-1")
            if name in rg_ids:
                rg = rg_ids.index(name)
                continue
        rest.append((tag, typ, val))
    st.put_int("RG", rg)
    qname = bytes(batch.qname[batch.qname_off[ri]:batch.qname_off[ri + 1]])
    st.put_stop("RN", qname)
    # detached mate info
    mf = 0
    if flag & F.FMREVERSE:
        mf |= 1
    if flag & F.FMUNMAP:
        mf |= 2
    st.put_int("MF", mf)
    st.put_int("NS", int(batch.mtid[ri]))
    st.put_int("NP", int(batch.mpos[ri]) + 1)
    st.put_int("TS", int(batch.tlen[ri]))
    # tags
    row = tuple((t, typ) for t, typ, _ in rest)
    if row not in tag_seen:
        tag_seen[row] = len(tag_dict)
        tag_dict.append(list(row))
    st.put_int("TL", tag_seen[row])
    for tag, typ, val in rest:
        k = (tag, typ)
        if k not in tag_keys:
            tag_keys[k] = (TAG_CID0 + 2 * len(tag_keys),
                           TAG_CID0 + 2 * len(tag_keys) + 1)
        cid_len, cid_val = tag_keys[k]
        st.s(cid_len).extend(itf8_enc(len(val)))
        st.s(cid_val).extend(val)

    if flag & F.FUNMAP:
        # CRAM cannot carry a CIGAR on unmapped records; htslib strips
        # it on write (cram_encode.c behavior) and so do we
        if has_seq:
            st.s("BA").extend(ord(SEQ16[c]) for c in seq_codes)
            if cf & 1:
                st.s("QS").extend(qual)
        return rl

    # ---- mapped record: features from CIGAR vs reference -------------
    cigar = batch.cigar[batch.cigar_off[ri]:batch.cigar_off[ri + 1]]
    feats = []
    qpos = 0
    rpos = int(batch.pos[ri])  # 0-based
    asciis = bytes(bytearray(ord(SEQ16[c]) for c in seq_codes))
    for cg in cigar:
        op = int(cg) & 0xF
        ln = int(cg) >> 4
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            if has_seq and ref is not None:
                for k in range(ln):
                    rb = chr(ref[rpos + k]).upper() \
                        if rpos + k < len(ref) else "N"
                    qb = chr(asciis[qpos + k])
                    if qb == rb:
                        continue
                    if qb in _BASES and rb in _BASES and \
                            (rb, qb) in _SUB_CODE:
                        feats.append((qpos + k + 1, "X",
                                      _SUB_CODE[(rb, qb)]))
                    else:
                        feats.append((qpos + k + 1, "B",
                                      (asciis[qpos + k],
                                       int(qual[qpos + k])
                                       if qual.size else 0xFF)))
            elif has_seq:
                # no reference: store the bases verbatim
                feats.append((qpos + 1, "b",
                              asciis[qpos:qpos + ln]))
            qpos += ln
            rpos += ln
        elif op == F.CINS:
            feats.append((qpos + 1, "I",
                          asciis[qpos:qpos + ln] if has_seq
                          else b"N" * ln))
            qpos += ln
        elif op == F.CSOFT_CLIP:
            feats.append((qpos + 1, "S",
                          asciis[qpos:qpos + ln] if has_seq
                          else b"N" * ln))
            qpos += ln
        elif op == F.CDEL:
            feats.append((qpos + 1, "D", ln))
            rpos += ln
        elif op == F.CREF_SKIP:
            feats.append((qpos + 1, "N", ln))
            rpos += ln
        elif op == F.CPAD:
            feats.append((qpos + 1, "P", ln))
        elif op == F.CHARD_CLIP:
            feats.append((qpos + 1, "H", ln))
        # B op (back) unsupported in CRAM: dropped like htslib

    st.put_int("FN", len(feats))
    last = 0
    for fpos, kind, payload in feats:
        st.put_byte("FC", ord(kind))
        st.put_int("FP", fpos - last)
        last = fpos
        if kind == "X":
            st.put_int("BS", payload)
        elif kind == "B":
            st.put_byte("BA", payload[0])
            st.put_byte("QS", payload[1])
        elif kind == "I":
            st.put_stop("IN", payload)
        elif kind == "S":
            st.put_stop("SC", payload)
        elif kind == "b":
            st.put_stop("BB", payload)
        elif kind in ("D",):
            st.put_int("DL", payload)
        elif kind == "N":
            st.put_int("RS", payload)
        elif kind == "P":
            st.put_int("PD", payload)
        elif kind == "H":
            st.put_int("HC", payload)
    st.put_int("MQ", int(batch.mapq[ri]))
    if cf & 1:
        st.s("QS").extend(qual)
    return rl


def write_crai(path: str, crai_lines):
    import gzip
    body = "".join("%d\t%d\t%d\t%d\t%d\t%d\n" % tuple(t)
                   for t in crai_lines).encode()
    with gzip.open(path, "wb") as f:
        f.write(body)
