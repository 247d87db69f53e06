"""BAM binary codec: header parse, columnar record decode and the
vectorized writer (SAM spec 4.2).

Counterpart of samtools_tpu/io/bam.py (:72-106, :140-243, :261-396).
Record decode runs in the port's host library; the writer is numpy.
``read_bam_indexed`` gives each record's virtual offsets, what the
BAI/CSI builder (``io/index.py``) needs.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core import aux as auxmod
from ..core.batch import ReadBatch, ragged_gather_indices
from . import bgzf, native
from .header import SamHeader

BAM_MAGIC = b"BAM\1"

_FIXED = np.dtype([
    ("block_size", "<i4"), ("refID", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar_op", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
    ("next_refID", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
])
FIXED_SIZE = 36  # including block_size


class BamError(RuntimeError):
    pass


def decode_header(data: np.ndarray) -> tuple[SamHeader, int]:
    """Parse the BAM header; return (header, offset of the first record).
    Only the header region is materialized as bytes."""
    head = bytes(data[:8])
    if head[:4] != BAM_MAGIC:
        raise BamError("not a BAM stream (bad magic)")
    l_text = struct.unpack_from("<i", head, 4)[0]
    win_end = 8 + l_text + 4
    buf = bytes(data[4:win_end])
    text = buf[4:4 + l_text].split(b"\0", 1)[0].decode("latin-1")
    n_ref = struct.unpack_from("<i", buf, 4 + l_text)[0]
    off = win_end
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", bytes(data[off:off + 4]), 0)[0]
        names.append(bytes(data[off + 4:off + 4 + l_name - 1])
                     .decode("latin-1"))
        lens.append(struct.unpack_from(
            "<i", bytes(data[off + 4 + l_name:off + 8 + l_name]), 0)[0])
        off += 8 + l_name
    return SamHeader.from_text(text, names, lens), off


def decode_records(data: np.ndarray, offs: np.ndarray, threads: int = 2,
                   fields: int = native.FIELD_ALL) -> ReadBatch:
    """Decode the records at the given offsets into a ReadBatch."""
    try:
        cols = native.bam_decode_columns(data, offs, threads, fields)
    except ValueError as e:
        raise BamError(f"corrupt BAM: {e}") from None
    b = ReadBatch(n=int(offs.size), **cols)
    if fields & native.FIELD_CIGAR and fields & native.FIELD_AUX:
        _fixup_long_cigars(b)
    return b


def _fixup_long_cigars(b: ReadBatch):
    """SAM-spec long-CIGAR convention: the real cigar sits in a CG:B,I tag
    behind a ``<l_seq>S<ref_len>N`` placeholder.  Rare; per record."""
    ncig = b.n_cigar
    lseq = b.l_qseq
    needs = {}
    for i in np.nonzero(ncig == 2)[0].tolist():
        c = b.cigar_of(i)
        if ((c[0] & 0xF) == 4 and (c[0] >> 4) == lseq[i]
                and (c[1] & 0xF) == 3):
            cg = auxmod.cg_cigar(b.aux_of(i))
            if cg is not None:
                needs[i] = cg
    if not needs:
        return
    parts, aux_parts = [], []
    for i in range(b.n):
        if i in needs:
            parts.append(needs[i])
            aux_parts.append(auxmod.delete_tag(b.aux_of(i), b"CG"))
        else:
            parts.append(b.cigar_of(i))
            aux_parts.append(b.aux_of(i))
    b.cigar = np.concatenate(parts).astype(np.uint32)
    b.cigar_off = np.concatenate(
        [[0], np.cumsum([p.size for p in parts])]).astype(np.int64)
    b.aux = np.concatenate(aux_parts).astype(np.uint8)
    b.aux_off = np.concatenate(
        [[0], np.cumsum([p.size for p in aux_parts])]).astype(np.int64)


def reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """BAI bin of each interval [beg, end) (SAM spec 5.3)."""
    e = end - 1
    out = np.zeros(beg.shape, np.int32)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = (~done) & ((beg >> shift) == (e >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def reg2bin(beg: int, end: int) -> int:
    """BAI bin of the interval [beg, end) (SAM spec 5.3)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def uoffset_to_voffset(uoffs: np.ndarray, coffs: np.ndarray,
                       offsets: np.ndarray) -> np.ndarray:
    """BGZF virtual offsets ``coffset << 16 | within_block`` of positions
    in the uncompressed stream, from ``bgzf.decompress_with_index``'s
    block table (``coffs`` extended by the end-of-data block)."""
    blk = np.minimum(np.searchsorted(uoffs, offsets, "right") - 1,
                     coffs.size - 1)
    return ((coffs[blk].astype(np.uint64) << np.uint64(16))
            | (offsets - uoffs[blk]).astype(np.uint64))


def read_bam_indexed(path: str, threads: int = 2):
    """Read a whole BGZF BAM: (header, batch, vstart, vend), the virtual
    offsets of each record's first byte and of the byte after it."""
    with open(path, "rb") as f:
        comp = f.read()
    raw, coffs, uoffs = bgzf.decompress_with_index(comp, threads)
    # the end-of-data block, so a record ending the data resolves
    coffs = np.append(coffs, len(comp) - len(bgzf.BGZF_EOF)
                      if comp.endswith(bgzf.BGZF_EOF) else len(comp))
    header, off = decode_header(raw)
    offs = native.bam_record_offsets(raw, off)
    batch = decode_records(raw, offs, threads)
    if not offs.size:
        empty = np.empty(0, np.uint64)
        return header, batch, empty, empty
    rec_end = np.append(offs[1:], raw.size)
    return (header, batch, uoffset_to_voffset(uoffs, coffs, offs),
            uoffset_to_voffset(uoffs, coffs, rec_end))


def pack_nibbles(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-read 4-bit codes -> packed bytes (two bases per byte)."""
    if codes.size == 0:
        return np.empty(0, np.uint8)
    nbytes = (lens + 1) // 2
    staging = np.zeros(int((nbytes * 2).sum()), np.uint8)
    starts2 = np.concatenate([[0], np.cumsum(nbytes * 2)[:-1]])
    staging[ragged_gather_indices(starts2, lens)] = codes
    return (staging[0::2] << 4) | staging[1::2]


def encode_header(header: SamHeader) -> bytes:
    text = header.text.encode("latin-1")
    out = [BAM_MAGIC, struct.pack("<i", len(text)), text,
           struct.pack("<i", header.n_refs)]
    for name, ln in zip(header.ref_names, header.ref_lens):
        nb = name.encode("latin-1") + b"\0"
        out += [struct.pack("<i", len(nb)), nb, struct.pack("<i", ln)]
    return b"".join(out)


def encode_records(b: ReadBatch) -> bytes:
    """Vectorized ReadBatch -> raw BAM record stream."""
    n = b.n
    if n == 0:
        return b""
    qname_lens = (b.qname_off[1:] - b.qname_off[:-1]).astype(np.int64)
    n_cigar = b.n_cigar
    l_seq = b.l_qseq
    aux_lens = (b.aux_off[1:] - b.aux_off[:-1]).astype(np.int64)
    seq_bytes = (l_seq + 1) // 2
    block_size = (32 + (qname_lens + 1) + 4 * n_cigar + seq_bytes + l_seq
                  + aux_lens)
    rec_sizes = block_size + 4
    out = np.zeros(int(rec_sizes.sum()), np.uint8)
    offs = np.concatenate([[0], np.cumsum(rec_sizes)[:-1]])
    end = b.pos + np.maximum(b.ref_span(), 1)
    fixed = np.zeros(n, dtype=_FIXED)
    fixed["block_size"] = block_size
    fixed["refID"] = b.tid
    fixed["pos"] = b.pos.astype(np.int32)
    fixed["l_read_name"] = (qname_lens + 1).astype(np.uint8)
    fixed["mapq"] = b.mapq
    fixed["bin"] = reg2bin_vec(b.pos.astype(np.int64),
                               end.astype(np.int64)).astype(np.uint16)
    fixed["n_cigar_op"] = n_cigar.astype(np.uint16)
    fixed["flag"] = b.flag
    fixed["l_seq"] = l_seq.astype(np.int32)
    fixed["next_refID"] = b.mtid
    fixed["next_pos"] = b.mpos.astype(np.int32)
    fixed["tlen"] = b.tlen.astype(np.int32)
    out[offs[:, None] + np.arange(FIXED_SIZE)] = \
        fixed.view(np.uint8).reshape(n, FIXED_SIZE)
    qname_start = offs + FIXED_SIZE
    out[ragged_gather_indices(qname_start, qname_lens)] = b.qname
    # NUL terminators are already zero
    cigar_start = qname_start + qname_lens + 1
    out[ragged_gather_indices(cigar_start, 4 * n_cigar)] = \
        b.cigar.astype("<u4").view(np.uint8)
    seq_start = cigar_start + 4 * n_cigar
    out[ragged_gather_indices(seq_start, seq_bytes)] = \
        pack_nibbles(b.seq, l_seq)
    qual_start = seq_start + seq_bytes
    out[ragged_gather_indices(qual_start, l_seq)] = b.qual
    out[ragged_gather_indices(qual_start + l_seq, aux_lens)] = b.aux
    return out.tobytes()


def write_bam(path: str, header: SamHeader, batch: ReadBatch,
              level: int = 6, threads: int = 2):
    raw = encode_header(header) + encode_records(batch)
    with open(path, "wb") as f:
        f.write(bgzf.compress(raw, level=level, threads=threads))
