"""CRAM slice record decoding -> columnar ReadBatch.

Re-derivation of the CRAM 3.0/3.1 record model from the published
specification: per-slice data series decoding (core bit-stream +
external byte streams), feature-based sequence reconstruction against
the (embedded or external) reference, substitution matrix, mate
reconstruction for non-detached pairs.  Counterpart of
samtools_tpu/io/cram_decode.py (htslib cram_decode.c analog): the same
records, field by field, into the port's ReadBatch.  Pure Python, one
record at a time; the tools decode on the host and hand the batch to
the same device paths as a BAM's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..core import flags as F
from .cram import (CramReader, CramError, parse_block,
                   parse_compression_header, parse_slice_header, itf8,
                   Encoding)
from .header import SamHeader

_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


class BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7

    def read1(self) -> int:
        b = (self.data[self.pos] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return b

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read1()
        return v


class ByteStream:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def until(self, stop: int) -> bytes:
        i = self.data.index(stop, self.pos)
        out = self.data[self.pos:i]
        self.pos = i + 1
        return out

    def itf8(self) -> int:
        v, self.pos = itf8(self.data, self.pos)
        return v


class Decoder:
    """One data-series decoder bound to its streams."""

    def __init__(self, enc: Encoding, core: BitReader, ext: dict):
        self.enc = enc
        self.core = core
        self.ext = ext
        if enc.codec == 3:  # HUFFMAN: build canonical codes
            self.huff = _build_huffman(enc.alphabet, enc.bitlens)

    def _stream(self, cid):
        s = self.ext.get(cid)
        if s is None:
            raise CramError("missing external block %d" % cid)
        return s

    def read_int(self) -> int:
        e = self.enc
        if e.codec == 1:
            return self._stream(e.content_id).itf8()
        if e.codec == 3:
            return self._read_huffman()
        if e.codec == 6:  # BETA
            return self.core.read(e.nbits) - e.offset
        if e.codec == 9:  # GAMMA
            n = 0
            while self.core.read1() == 0:
                n += 1
            return ((1 << n) | self.core.read(n)) - e.offset
        raise CramError("unsupported int codec %d" % e.codec)

    def read_byte(self) -> int:
        e = self.enc
        if e.codec == 1:
            return self._stream(e.content_id).byte()
        if e.codec == 3:
            return self._read_huffman()
        if e.codec == 6:
            return self.core.read(e.nbits) - e.offset
        raise CramError("unsupported byte codec %d" % e.codec)

    def read_bytes(self, sub_len_dec=None) -> bytes:
        e = self.enc
        if e.codec == 5:  # BYTE_ARRAY_STOP
            return self._stream(e.content_id).until(e.stop_byte)
        if e.codec == 4:  # BYTE_ARRAY_LEN
            n = self.len_dec.read_int()
            return self.val_dec.read_n(n)
        raise CramError("unsupported byte-array codec %d" % e.codec)

    def read_n(self, n: int) -> bytes:
        e = self.enc
        if e.codec == 1:
            return self._stream(e.content_id).take(n)
        # fall back to per-byte decode
        return bytes(self.read_byte() for _ in range(n))

    def _read_huffman(self) -> int:
        codes, maxlen = self.huff
        if maxlen == 0:
            return self.enc.alphabet[0]
        v = 0
        n = 0
        while n <= maxlen:
            v = (v << 1) | self.core.read1()
            n += 1
            hit = codes.get((n, v))
            if hit is not None:
                return hit
        raise CramError("bad huffman code")


def _build_huffman(alphabet, bitlens):
    if not alphabet:
        return {}, 0
    if max(bitlens) == 0:
        return {}, 0
    # canonical codes: sort by (len, symbol)
    pairs = sorted(zip(bitlens, alphabet))
    codes = {}
    code = 0
    prev_len = pairs[0][0]
    for ln, sym in pairs:
        code <<= (ln - prev_len)
        prev_len = ln
        codes[(ln, code)] = sym
        code += 1
    return codes, max(bitlens)


def make_decoder(enc: Encoding, core: BitReader, ext: dict) -> Decoder:
    d = Decoder(enc, core, ext)
    if enc.codec == 4:
        d.len_dec = make_decoder(enc.sub_len, core, ext)
        d.val_dec = make_decoder(enc.sub_val, core, ext)
    return d


@dataclass
class CramRecord:
    bf: int = 0
    cf: int = 0
    ref_id: int = 0
    rl: int = 0
    apos: int = 0
    rg: int = -1
    name: bytes = b""
    mate_flags: int = 0
    mate_ref_id: int = -1
    mate_pos: int = 0
    tlen: int = 0
    nf: int = -1
    tags: bytes = b""
    seq: bytes = b""
    qual: bytes = b""
    mapq: int = 0
    end: int = 0


def decode_substitution_matrix(sm: bytes):
    """SM byte i gives 2-bit codes for substituting ref base
    "ACGTN"[i] with each of the other four bases in ACGTN order."""
    bases = "ACGTN"
    table = {}
    for i, refb in enumerate(bases):
        others = [b for b in bases if b != refb]
        byte = sm[i] if i < len(sm) else 0
        row = [None] * 4
        for j, alt in enumerate(others):
            code = (byte >> (6 - 2 * j)) & 3
            row[code] = alt
        table[refb] = row
        table[refb.lower()] = row
    return table


def decode_slice(ch, sh, blocks, header, version, ref_bytes=None,
                 counter_start=0):
    """Decode one slice's records.

    blocks: list of Block (slice data blocks, first CORE then externals).
    ref_bytes: reference sequence covering [sh.ref_start-1, +span) for
    this slice (bytes), or None.
    Returns list[CramRecord]."""
    core = None
    ext = {}
    embedded_ref = None
    for b in blocks:
        if b.content_type == 5:
            core = BitReader(b.data())
        else:
            ext[b.content_id] = ByteStream(b.data())
            if b.content_id == sh.embedded_ref_id:
                embedded_ref = b.data()
    if core is None:
        core = BitReader(b"")

    if embedded_ref is not None:
        ref_bytes = embedded_ref
        ref_off = sh.ref_start - 1
    elif ref_bytes is not None:
        ref_off = 0
    else:
        ref_off = 0

    ds = {}
    for key, enc in ch.data_series.items():
        ds[key] = make_decoder(enc, core, ext)
    tag_dec = {k: make_decoder(e, core, ext)
               for k, e in ch.tag_encodings.items()}

    subst = decode_substitution_matrix(ch.subst_matrix) \
        if ch.subst_matrix else None

    multiref = sh.ref_seq_id == -2
    last_pos = sh.ref_start
    recs = []
    for ri in range(sh.n_records):
        r = CramRecord()
        r.bf = ds["BF"].read_int()
        r.cf = ds["CF"].read_int()
        if multiref:
            r.ref_id = ds["RI"].read_int()
        else:
            r.ref_id = sh.ref_seq_id
        r.rl = ds["RL"].read_int()
        if ch.ap_delta:
            r.apos = last_pos + ds["AP"].read_int()
            last_pos = r.apos
        else:
            r.apos = ds["AP"].read_int()
        r.rg = ds["RG"].read_int() if "RG" in ds else -1
        if ch.read_names_included and "RN" in ds:
            r.name = ds["RN"].read_bytes()
        if r.cf & 2:  # detached
            r.mate_flags = ds["MF"].read_int()
            if not ch.read_names_included and "RN" in ds:
                r.name = ds["RN"].read_bytes()
            r.mate_ref_id = ds["NS"].read_int()
            r.mate_pos = ds["NP"].read_int()
            r.tlen = ds["TS"].read_int()
        elif r.cf & 4:  # mate downstream
            r.nf = ds["NF"].read_int()

        tl = ds["TL"].read_int() if "TL" in ds else 0
        tags = bytearray()
        if ch.tag_dict and 0 <= tl < len(ch.tag_dict):
            for tag, typ in ch.tag_dict[tl]:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                val = tag_dec[key].read_bytes()
                tags += tag.encode()
                tags += typ.encode()
                if typ in "ZH":
                    if not val.endswith(b"\x00"):
                        val += b"\x00"
                tags += val
        r.tags = bytes(tags)

        if not (r.bf & F.FUNMAP):
            _decode_mapped(r, ds, ref_bytes, ref_off, subst, version)
        else:
            seq = ds["BA"].read_n(r.rl) if "BA" in ds else b"N" * r.rl
            r.seq = seq
            if r.cf & 1:
                r.qual = ds["QS"].read_n(r.rl)
            else:
                r.qual = b"\xff" * r.rl
            r.end = r.apos
            r.mapq = 0
        recs.append(r)

    _resolve_mates(recs)
    return recs


def _decode_mapped(r, ds, ref_bytes, ref_off, subst, version):
    fn = ds["FN"].read_int()
    seq = bytearray(b"N" * r.rl)
    qual = bytearray(b"\xff" * r.rl)
    has_qual_feat = False
    # features with (qpos 0-based, kind, payload)
    feats = []
    fpos = 0
    for _ in range(fn):
        fc = chr(ds["FC"].read_byte())
        fp = ds["FP"].read_int()
        fpos += fp
        if fc == "B":
            b = ds["BA"].read_byte()
            q = ds["QS"].read_byte()
            feats.append((fpos, "B", (b, q)))
            has_qual_feat = True
        elif fc == "X":
            feats.append((fpos, "X", ds["BS"].read_int()))
        elif fc == "I":
            feats.append((fpos, "I", ds["IN"].read_bytes()))
        elif fc == "S":
            feats.append((fpos, "S", ds["SC"].read_bytes()))
        elif fc == "D":
            feats.append((fpos, "D", ds["DL"].read_int()))
        elif fc == "N":
            feats.append((fpos, "N", ds["RS"].read_int()))
        elif fc == "P":
            feats.append((fpos, "P", ds["PD"].read_int()))
        elif fc == "H":
            feats.append((fpos, "H", ds["HC"].read_int()))
        elif fc == "i":
            feats.append((fpos, "i", ds["BA"].read_byte()))
        elif fc == "b":
            feats.append((fpos, "b", ds["BB"].read_bytes()))
        elif fc == "q":
            feats.append((fpos, "q", ds["QQ"].read_bytes()))
            has_qual_feat = True
        elif fc == "Q":
            feats.append((fpos, "Q", ds["QS"].read_byte()))
            has_qual_feat = True
        else:
            raise CramError("unknown feature code %r" % fc)
    r.mapq = ds["MQ"].read_int()
    if r.cf & 1:
        q = ds["QS"].read_n(r.rl)
        qual = bytearray(q)

    # build cigar + sequence from features (CRAM spec section 10.5)
    cigar = []
    qpos = 0          # 0-based query cursor
    rpos = r.apos     # 1-based ref cursor
    def add_op(op, ln):
        if ln <= 0:
            return
        if cigar and (cigar[-1] & 0xF) == op:
            cigar[-1] += ln << 4
        else:
            cigar.append((ln << 4) | op)

    def fill_ref(q0, n, rp):
        """copy n ref bases at 1-based rp into seq[q0:]"""
        if ref_bytes is None:
            return
        s = rp - 1 - ref_off
        for k in range(n):
            if 0 <= s + k < len(ref_bytes) and q0 + k < r.rl:
                seq[q0 + k] = ref_bytes[s + k]

    for fpos, kind, payload in feats:
        f_q = fpos - 1  # feature pos is 1-based within read
        # match run before this feature
        run = f_q - qpos
        if run > 0:
            add_op(F.CMATCH, run)
            fill_ref(qpos, run, rpos)
            qpos += run
            rpos += run
        if kind == "B":
            b, q = payload
            if qpos < r.rl:
                seq[qpos] = b
                qual[qpos] = q
            add_op(F.CMATCH, 1)
            qpos += 1
            rpos += 1
        elif kind == "X":
            refb = chr(ref_bytes[rpos - 1 - ref_off]) \
                if ref_bytes is not None and \
                0 <= rpos - 1 - ref_off < len(ref_bytes) else "N"
            if subst is not None:
                sb = subst.get(refb.upper(), subst["N"])[payload]
                if qpos < r.rl and sb is not None:
                    seq[qpos] = ord(sb)
            add_op(F.CMATCH, 1)
            qpos += 1
            rpos += 1
        elif kind == "I":
            ins = payload
            seq[qpos:qpos + len(ins)] = ins
            add_op(F.CINS, len(ins))
            qpos += len(ins)
        elif kind == "S":
            sc = payload
            seq[qpos:qpos + len(sc)] = sc
            add_op(F.CSOFT_CLIP, len(sc))
            qpos += len(sc)
        elif kind == "D":
            add_op(F.CDEL, payload)
            rpos += payload
        elif kind == "N":
            add_op(F.CREF_SKIP, payload)
            rpos += payload
        elif kind == "P":
            add_op(F.CPAD, payload)
        elif kind == "H":
            add_op(F.CHARD_CLIP, payload)
        elif kind == "i":
            if qpos < r.rl:
                seq[qpos] = payload
            add_op(F.CINS, 1)
            qpos += 1
        elif kind == "b":
            bb = payload
            seq[qpos:qpos + len(bb)] = bb
            add_op(F.CMATCH, len(bb))
            qpos += len(bb)
            rpos += len(bb)
        elif kind == "q":
            qq = payload
            qual[qpos:qpos + len(qq)] = qq
        elif kind == "Q":
            if qpos < r.rl:
                qual[qpos] = payload
    # trailing match
    if qpos < r.rl:
        run = r.rl - qpos
        add_op(F.CMATCH, run)
        fill_ref(qpos, run, rpos)
        rpos += run
        qpos += run
    r.seq = bytes(seq)
    r.qual = bytes(qual)
    r.cigar = cigar
    r.end = rpos - 1  # 1-based inclusive end


def _resolve_mates(recs):
    """Link non-detached mates within a slice (spec 10.4)."""
    n = len(recs)
    for i, r in enumerate(recs):
        if r.nf < 0 or getattr(r, "_mated", False):
            continue
        chain = [i]
        j = i
        while recs[j].nf >= 0:
            j2 = j + recs[j].nf + 1
            if j2 >= n:
                break
            chain.append(j2)
            j = j2
            if recs[j].nf < 0:
                break
        # link circularly: each record's mate is the next; last -> first
        for k, idx in enumerate(chain):
            nxt = chain[(k + 1) % len(chain)]
            a, b = recs[idx], recs[nxt]
            a.mate_ref_id = b.ref_id
            a.mate_pos = b.apos
            if b.bf & F.FUNMAP:
                a.bf |= F.FMUNMAP
            if b.bf & F.FREVERSE:
                a.bf |= F.FMREVERSE
            a._mated = True
        # template length
        aleft = min(recs[k].apos for k in chain)
        aright = max(recs[k].end if recs[k].end else recs[k].apos
                     for k in chain)
        tlen = aright - aleft + 1
        first = True
        for k in chain:
            if recs[k].apos == aleft and first:
                recs[k].tlen = tlen
                first = False
            else:
                recs[k].tlen = -tlen


def _ref_path_lookup(header, tid: int):
    """Resolve an external reference via REF_PATH/REF_CACHE M5 lookup
    (htslib cram_ref semantics: %s expanded to the hex MD5 from @SQ)."""
    import os
    name = header.ref_name(tid)
    md5 = None
    for line in header.text.split("\n"):
        if line.startswith("@SQ") and ("SN:%s\t" % name in line + "\t"
                                       or line.endswith("SN:" + name)):
            for fld in line.split("\t"):
                if fld.startswith("M5:"):
                    md5 = fld[3:]
        if md5:
            break
    if not md5:
        return None
    paths = []
    for env in ("REF_CACHE", "REF_PATH"):
        val = os.environ.get(env)
        if not val:
            continue
        for p in val.split(":"):
            if "%s" in p:
                paths.append(p.replace("%s", md5))
            else:
                paths.append(os.path.join(p, md5))
    for p in paths:
        try:
            raw = open(p, "rb").read()
        except OSError:
            continue
        if raw.startswith(b">"):
            seq = b"".join(raw.split(b"\n")[1:])
        else:
            seq = raw.replace(b"\n", b"")
        return seq
    return None


def read_cram(data: bytes, fai=None) -> tuple:
    """Decode a whole CRAM file into (SamHeader, ReadBatch)."""
    from ..core.batch import ReadBatch
    from .sam_text import NT16_LUT

    rd = CramReader(data)
    gen = rd.containers()
    # container 0: SAM header
    cont0, i0 = next(gen)
    blk, _ = parse_block(data, i0, rd.major)
    hd = blk.data()
    # header block: int32 text length + text
    tlen = struct.unpack_from("<i", hd, 0)[0]
    text = hd[4:4 + tlen].rstrip(b"\x00").decode("latin-1")
    header = SamHeader.from_text(text)

    recs_all = []
    counter = 0
    for cont, i in gen:
        if cont.n_records == 0 and cont.n_bases == 0:
            continue
        blk, i = parse_block(data, i, rd.major)
        ch = parse_compression_header(blk.data())
        for _s in range(len(cont.landmarks)):
            blk, i = parse_block(data, i, rd.major)
            sh = parse_slice_header(blk.data(), rd.major)
            blocks = []
            for _b in range(sh.n_blocks):
                blk, i = parse_block(data, i, rd.major)
                blocks.append(blk)
            ref_bytes = None
            if sh.embedded_ref_id < 0 and sh.ref_seq_id >= 0:
                if fai is not None:
                    try:
                        ref_bytes = fai.fetch(
                            header.ref_name(sh.ref_seq_id))
                    except Exception:
                        ref_bytes = None
                if ref_bytes is None:
                    ref_bytes = _ref_path_lookup(header, sh.ref_seq_id)
            recs = decode_slice(ch, sh, blocks, header, rd.major,
                                ref_bytes, counter)
            counter += len(recs)
            recs_all.extend(recs)

    # build ReadBatch
    n = len(recs_all)
    out = ReadBatch(n=n)
    out.tid = np.array([r.ref_id for r in recs_all], np.int32)
    out.pos = np.array([r.apos - 1 for r in recs_all], np.int64)
    out.mapq = np.array([r.mapq & 0xFF for r in recs_all], np.uint8)
    out.flag = np.array([r.bf & 0xFFFF for r in recs_all], np.uint16)
    out.mtid = np.array([r.mate_ref_id for r in recs_all], np.int32)
    out.mpos = np.array([r.mate_pos - 1 for r in recs_all], np.int64)
    out.tlen = np.array([r.tlen for r in recs_all], np.int64)

    def ragged(parts, dtype):
        offs = np.zeros(n + 1, np.int64)
        for k, p in enumerate(parts):
            offs[k + 1] = offs[k] + len(p)
        flat = (np.concatenate([np.frombuffer(p, np.uint8)
                                if isinstance(p, (bytes, bytearray))
                                else np.asarray(p, dtype)
                                for p in parts])
                if parts and offs[-1] else np.empty(0, dtype))
        return flat.astype(dtype), offs

    names = [r.name if r.name else b"*" for r in recs_all]
    out.qname, out.qname_off = ragged(names, np.uint8)
    cigs = [np.array(getattr(r, "cigar", []) or [], np.uint32)
            for r in recs_all]
    out.cigar, out.cigar_off = ragged(cigs, np.uint32)
    # seq: ASCII -> nt16 codes; '*' for missing under CF&8
    seqs = []
    for r in recs_all:
        if r.cf & 8:
            seqs.append(np.empty(0, np.uint8))
        else:
            seqs.append(NT16_LUT[np.frombuffer(r.seq, np.uint8)])
    out.seq, out.seq_off = ragged(seqs, np.uint8)
    quals = []
    for r in recs_all:
        if r.cf & 8:
            quals.append(np.empty(0, np.uint8))
        else:
            quals.append(np.frombuffer(r.qual, np.uint8))
    out.qual = (np.concatenate(quals) if quals and out.seq_off[-1]
                else np.empty(0, np.uint8))
    # aux: prepend RG:Z if rg >= 0
    rg_ids = header.rg_ids()
    auxes = []
    for r in recs_all:
        a = r.tags
        if r.rg >= 0 and r.rg < len(rg_ids):
            a = a + b"RGZ" + rg_ids[r.rg].encode() + b"\x00"
        auxes.append(a)
    out.aux, out.aux_off = ragged(auxes, np.uint8)
    return header, out
