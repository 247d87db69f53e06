"""ctypes bindings for the port's host library (native/samtpu_host.cc).

Counterpart of samtools_tpu/io/native.py (:247-292, :411-520, :545-610,
:644-760).  The
library is built with ``g++`` into the port's build directory at first
use (see ``samtools_tpu_torch.build``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import build

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

_SIGNATURES = {
    "samtpu_bam_scan_offsets": (_I64, [_P, _I64, _I64, _P, _I64]),
    "samtpu_bam_scan_partial": (_I64, [_P, _I64, _I64, _P, _I64, _P]),
    "samtpu_bam_decode_sizes": (_I64, [_P, _I64, _P, _I64] + [_P] * 4),
    "samtpu_bam_decode_fill": (_I64, [_P, _I64, _P, _I64] + [_P] * 16
                               + [_INT] * 2),
    "samtpu_baq_batch": (_I64, [_P, _P, _P, _P, _P, _P, _I64, _P, _I64,
                                _INT, _P, _P, _INT]),
    "samtpu_bench_baq_census": (_I64, [_P, _I64, ctypes.c_int32, _P, _I64,
                                       _INT, _INT, _INT, _INT, _P, _P]),
    "samtpu_classify_reads": (_I64, [_P, _P, _P, _P, _P, _I64, _P, _I64,
                                     _I64, _I64, _I64, _I64, _P, _P, _P, _P,
                                     _INT]),
    "samtpu_census_checksum": (None, [_P, _P, _I64, _P]),
    "samtpu_buf_free": (None, [_P]),
    "samtpu_mpileup_text": (_I64, [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I64, _P, _I64, _I64, _I64, _INT, _P,
                                   _INT, _INT, _INT, _INT, _INT, _P, _P]),
    "samtpu_ragged_gather": (_I64, [_P, _P, _P, _I64, _P, _P, _I64, _INT]),
    "samtpu_ragged_copy": (_I64, [_P, _P, _P, _P, _P, _I64, _INT]),
    "samtpu_nm_init_batch": (_I64, [_P, _P, _P, _P, _P, _P, _P, _I64, _INT,
                                    _INT, _INT, ctypes.c_double, _INT, _INT,
                                    _P]),
    "samtpu_stats_crc32_batch": (_I64, [_P, _P, _P, _P, _P, _P, _I64, _P]),
    "samtpu_aux_find_batch": (_I64, [_P, _P, _P, _I64, ctypes.c_uint8,
                                     ctypes.c_uint8, _P, _P]),
    "samtpu_stats_cov_gcd": (_I64, [_I64, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _INT, _I64, _P, _I64, _P, _I64,
                                    _I64, _I64, _I64, _P, _P, _I64]),
    "samtpu_stats_orig_hists": (_I64, [_P, _P, _P, _P, _I64, _P, _P, _I64,
                                       _I64, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _INT]),
    "samtpu_sam_format": (_I64, [_I64] + [_P] * 19 + [_I64, _P, _P]),
}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build.build(("host",))["host"])
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
    return _lib


def bam_record_offsets(data: np.ndarray, start: int) -> np.ndarray:
    """Offsets of every record's block_size field in data[start:]."""
    data = np.ascontiguousarray(data)
    cap = max(16, (data.size - start) // 38 + 2)
    out = np.empty(cap, np.int64)
    got = _load().samtpu_bam_scan_offsets(data.ctypes.data, data.size, start,
                                          out.ctypes.data, cap)
    if got == -1:
        raise ValueError("corrupt BAM record size")
    if got == -2:
        raise ValueError("truncated BAM record at end of stream")
    if got < 0:
        raise RuntimeError(f"native BAM scan failed (code {got})")
    return out[:got].copy()


def bam_scan_partial(data: np.ndarray, start: int):
    """(offsets, consumed): offsets of every COMPLETE record at
    data[start:]; a truncated tail record is left for the next chunk."""
    data = np.ascontiguousarray(data)
    cap = max(16, (data.size - start) // 38 + 2)
    out = np.empty(cap, np.int64)
    consumed = ctypes.c_int64(start)
    got = _load().samtpu_bam_scan_partial(data.ctypes.data, data.size, start,
                                          out.ctypes.data, cap,
                                          ctypes.byref(consumed))
    if got < 0:
        raise ValueError(f"corrupt BAM record (partial scan, code {got})")
    return out[:got].copy(), int(consumed.value)


FIELD_QNAME, FIELD_CIGAR, FIELD_SEQ, FIELD_QUAL, FIELD_AUX = 1, 2, 4, 8, 16
FIELD_ALL = 31


def bam_decode_columns(data: np.ndarray, offs: np.ndarray, threads: int,
                       fields: int = FIELD_ALL) -> dict:
    """Decode BAM records into ReadBatch column arrays (sizes pass, then a
    record-parallel fill).  ``fields`` selects the ragged columns; skipped
    ones come back empty with zero offsets.  Raises ValueError on corrupt
    records."""
    lib = _load()
    data = np.ascontiguousarray(data)
    offs = np.ascontiguousarray(offs, np.int64)
    n = int(offs.size)
    qname_off, cigar_off, seq_off, aux_off = (np.empty(n + 1, np.int64)
                                              for _ in range(4))
    rc = lib.samtpu_bam_decode_sizes(
        data.ctypes.data, data.size, offs.ctypes.data, n,
        qname_off.ctypes.data, cigar_off.ctypes.data, seq_off.ctypes.data,
        aux_off.ctypes.data)
    if rc < 0:
        raise ValueError("corrupt BAM record (native decode sizes)")
    cols = dict(
        tid=np.empty(n, np.int32), pos=np.empty(n, np.int64),
        mapq=np.empty(n, np.uint8), flag=np.empty(n, np.uint16),
        mtid=np.empty(n, np.int32), mpos=np.empty(n, np.int64),
        tlen=np.empty(n, np.int64),
        qname=np.empty(qname_off[-1] if fields & FIELD_QNAME else 0,
                       np.uint8),
        cigar=np.empty(cigar_off[-1] if fields & FIELD_CIGAR else 0,
                       np.uint32),
        seq=np.empty(seq_off[-1] if fields & FIELD_SEQ else 0, np.uint8),
        qual=np.empty(seq_off[-1] if fields & FIELD_QUAL else 0, np.uint8),
        aux=np.empty(aux_off[-1] if fields & FIELD_AUX else 0, np.uint8))
    rc = lib.samtpu_bam_decode_fill(
        data.ctypes.data, data.size, offs.ctypes.data, n,
        qname_off.ctypes.data, cigar_off.ctypes.data, seq_off.ctypes.data,
        aux_off.ctypes.data, *(cols[k].ctypes.data for k in (
            "tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen", "qname",
            "cigar", "seq", "qual", "aux")),
        fields, max(1, threads))
    if rc < 0:
        raise ValueError("corrupt BAM record (native decode fill)")
    zero = np.zeros(n + 1, np.int64)
    cols["qname_off"] = qname_off if fields & FIELD_QNAME else zero
    cols["cigar_off"] = cigar_off if fields & FIELD_CIGAR else zero
    # seq and qual share offsets; keep them if either column was decoded
    cols["seq_off"] = seq_off if fields & (FIELD_SEQ | FIELD_QUAL) else zero
    cols["aux_off"] = aux_off if fields & FIELD_AUX else zero
    return cols


def baq_batch(pos: np.ndarray, cigar: np.ndarray, cigar_off: np.ndarray,
              seq: np.ndarray, qual: np.ndarray, seq_off: np.ndarray,
              ref_int: np.ndarray, flag: int = 3, threads: int = 1
              ) -> tuple[np.ndarray, np.ndarray]:
    """Batched f64 BAQ recompute (sam_prob_realn without stored tags).
    Returns (new qual flat array, skipped bool per read); skipped reads
    keep their original quals."""
    n = int(pos.size)
    pos = np.ascontiguousarray(pos, np.int64)
    cigar = np.ascontiguousarray(cigar, np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, np.int64)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    ref_int = np.ascontiguousarray(ref_int, np.uint8)
    out = qual.copy()
    skipped = np.empty(n, np.uint8)
    rc = _load().samtpu_baq_batch(
        pos.ctypes.data, cigar.ctypes.data, cigar_off.ctypes.data,
        seq.ctypes.data, qual.ctypes.data, seq_off.ctypes.data, n,
        ref_int.ctypes.data, ref_int.size, flag, out.ctypes.data,
        skipped.ctypes.data, max(1, threads))
    if rc < 0:
        raise ValueError(f"native BAQ failed (code {rc})")
    return out, skipped.astype(bool)


def bench_baq_census(body: np.ndarray, tid: int, ref_int: np.ndarray,
                     excl_flags: int = 0x704, min_mapq: int = 0,
                     min_baseq: int = 13, baq_flag: int = 3
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """Single-core reference mpileup-with-BAQ pipeline over a decoded BAM
    record body (bam_plcmd.c:451 sam_prob_realn + :607 column census).
    Returns (census int32[ref_len,5], qsum int64[ref_len], nrec)."""
    body = np.ascontiguousarray(body)
    ref_int = np.ascontiguousarray(ref_int, np.uint8)
    ref_len = int(ref_int.size)
    census = np.zeros(ref_len * 5, np.int32)
    qsum = np.zeros(ref_len, np.int64)
    got = _load().samtpu_bench_baq_census(
        body.ctypes.data, body.size, tid, ref_int.ctypes.data, ref_len,
        excl_flags, min_mapq, min_baseq, baq_flag, census.ctypes.data,
        qsum.ctypes.data)
    if got < 0:
        raise ValueError("corrupt BAM record (bench baq census)")
    return census.reshape(ref_len, 5), qsum, int(got)


def classify_reads(pos: np.ndarray, cigar: np.ndarray,
                   cigar_off: np.ndarray, seq_off: np.ndarray,
                   qual: np.ndarray, sel: np.ndarray, l_query: int,
                   ref_len: int, bw: int, maxops: int, threads: int = 2):
    """Native device-eligibility walk (ops/mpileup_device.classify_reads
    semantics).  Returns (elig bool[n], lead i64[n], lref i64[n],
    cig8 u32[n, maxops])."""
    n = int(sel.size)
    pos = np.ascontiguousarray(pos, np.int64)
    cigar = np.ascontiguousarray(cigar, np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, np.int64)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    qual = np.ascontiguousarray(qual, np.uint8)
    sel = np.ascontiguousarray(sel, np.int64)
    elig = np.empty(n, np.uint8)
    lead = np.empty(n, np.int64)
    lref = np.empty(n, np.int64)
    cig8 = np.empty((n, maxops), np.uint32)
    _load().samtpu_classify_reads(
        pos.ctypes.data, cigar.ctypes.data, cigar_off.ctypes.data,
        seq_off.ctypes.data, qual.ctypes.data, int(qual.size),
        sel.ctypes.data, n, l_query, ref_len, bw, maxops,
        elig.ctypes.data, lead.ctypes.data, lref.ctypes.data,
        cig8.ctypes.data, max(1, threads))
    return elig.astype(bool), lead, lref, cig8


def census_checksum(census: np.ndarray, qsum: np.ndarray
                    ) -> tuple[int, int]:
    """Two-lane weighted checksum over (census[wlen,5], qsum[wlen])."""
    census = np.ascontiguousarray(census, np.int64)
    qsum = np.ascontiguousarray(qsum, np.int64)
    out2 = np.empty(2, np.uint32)
    _load().samtpu_census_checksum(census.ctypes.data, qsum.ctypes.data,
                                   int(qsum.size), out2.ctypes.data)
    return int(out2[0]), int(out2[1])


def mpileup_text(sub, ref: bytes | None, name: str, emit_beg: int,
                 emit_end: int, all_mode: bool, bedmask, min_baseq: int,
                 rev_del: int, no_ends: int, no_ins: int,
                 no_del: int) -> bytes:
    """Default-column pileup text of one window of a single file: the
    columns [emit_beg, emit_end) of the reads in ``sub`` (a ReadBatch
    whose reads may reach past the window), as the rows samtools prints.
    ``bedmask`` (uint8 per column, or None) drops the columns it zeroes."""
    lib = _load()
    pos = np.ascontiguousarray(sub.pos, np.int64)
    flag = np.ascontiguousarray(sub.flag, np.uint16)
    mapq = np.ascontiguousarray(sub.mapq, np.uint8)
    cigar = np.ascontiguousarray(sub.cigar, np.uint32)
    cigar_off = np.ascontiguousarray(sub.cigar_off, np.int64)
    seq = np.ascontiguousarray(sub.seq, np.uint8)
    qual = np.ascontiguousarray(sub.qual, np.uint8)
    seq_off = np.ascontiguousarray(sub.seq_off, np.int64)
    refarr = np.frombuffer(ref, np.uint8) if ref is not None else None
    nm = name.encode()
    bm = (np.ascontiguousarray(bedmask, np.uint8)
          if bedmask is not None else None)
    if bm is not None and bm.size != emit_end - emit_beg:
        raise ValueError("bedmask must hold one byte per emitted column")
    outp = ctypes.c_void_p()
    outn = ctypes.c_int64()
    got = lib.samtpu_mpileup_text(
        pos.ctypes.data, sub.n, flag.ctypes.data, mapq.ctypes.data,
        cigar.ctypes.data, cigar_off.ctypes.data, seq.ctypes.data,
        qual.ctypes.data, seq_off.ctypes.data,
        refarr.ctypes.data if refarr is not None else None,
        len(ref) if ref is not None else 0, nm, len(nm), emit_beg, emit_end,
        1 if all_mode else 0, bm.ctypes.data if bm is not None else None,
        min_baseq, rev_del, no_ends, no_ins, no_del, ctypes.byref(outp),
        ctypes.byref(outn))
    try:
        if got < 0:
            raise ValueError("native mpileup text failed")
        return ctypes.string_at(outp.value, outn.value) if outn.value \
            else b""
    finally:
        if outp.value:
            lib.samtpu_buf_free(outp)


def ragged_gather(flat: np.ndarray, off: np.ndarray, rows: np.ndarray,
                  out_off: np.ndarray, total: int,
                  threads: int = 0) -> np.ndarray:
    """out[k] = flat[off[rows[k]] : off[rows[k]+1]], concatenated."""
    flat = np.ascontiguousarray(flat)
    off = np.ascontiguousarray(off, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    out_off = np.ascontiguousarray(out_off, np.int64)
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= off.size - 1):
        raise IndexError("ragged_gather: row index out of range")
    out = np.empty(total, flat.dtype)
    _load().samtpu_ragged_gather(flat.ctypes.data, off.ctypes.data,
                                 rows.ctypes.data, rows.size,
                                 out_off.ctypes.data, out.ctypes.data,
                                 flat.dtype.itemsize, threads)
    return out


def ragged_copy(dst: np.ndarray, dst_start: np.ndarray, lens: np.ndarray,
                src: np.ndarray, src_start: np.ndarray,
                threads: int = 0) -> None:
    """dst[dst_start[k] : +lens[k]] = src[src_start[k] : +lens[k]] for
    every k, in place (uint8 arrays)."""
    if dst.dtype != np.uint8 or src.dtype != np.uint8 \
            or not dst.flags.c_contiguous:
        raise TypeError("ragged_copy: dst and src must be uint8, dst "
                        "contiguous")
    lens = np.ascontiguousarray(lens, np.int64)
    dst_start = np.ascontiguousarray(dst_start, np.int64)
    src_start = np.ascontiguousarray(src_start, np.int64)
    live = lens > 0
    if live.any():
        for start, arr in ((dst_start, dst), (src_start, src)):
            s, e = start[live], start[live] + lens[live]
            if int(s.min()) < 0 or int(e.max()) > arr.size:
                raise IndexError("ragged_copy: range out of bounds")
    src = np.ascontiguousarray(src)
    _load().samtpu_ragged_copy(dst.ctypes.data, dst_start.ctypes.data,
                               src.ctypes.data, src_start.ctypes.data,
                               lens.ctypes.data, lens.size, threads)


def nm_init_batch(qual: np.ndarray, seq: np.ndarray, seq_off: np.ndarray,
                  cigar: np.ndarray, cigar_off: np.ndarray,
                  md: np.ndarray, md_off: np.ndarray, use_mqual: int,
                  adj_qual: int, bayes116: int, homopoly_fix: float,
                  nm_halo: int, sc_cost: int):
    """consensus's nm_init (bam_consensus.c:1012) over a batch: (int32
    local NM profile with the homopolymer length in the top 8 bits, per
    base; the quals, smoothed in place when ``homopoly_fix`` is set)."""
    n = seq_off.size - 1
    qual = np.ascontiguousarray(qual, np.uint8)
    seq = np.ascontiguousarray(seq, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    cigar = np.ascontiguousarray(cigar, np.uint32)
    cigar_off = np.ascontiguousarray(cigar_off, np.int64)
    md = np.ascontiguousarray(md, np.uint8)
    md_off = np.ascontiguousarray(md_off, np.int64)
    out = np.zeros(int(seq_off[-1]), np.int32)
    _load().samtpu_nm_init_batch(
        qual.ctypes.data, seq.ctypes.data, seq_off.ctypes.data,
        cigar.ctypes.data, cigar_off.ctypes.data, md.ctypes.data,
        md_off.ctypes.data, n, use_mqual, adj_qual, bayes116,
        homopoly_fix, nm_halo, sc_cost, out.ctypes.data)
    return out, qual


def has_stats_native() -> bool:
    """The stats passes are part of the host library, which builds at
    first use (a failed build raises)."""
    return _load() is not None


def stats_crc32_batch(qname: np.ndarray, qname_off: np.ndarray,
                      seq: np.ndarray, qual: np.ndarray,
                      seq_off: np.ndarray, idx: np.ndarray):
    """(names, reads, quals) CRC32 sums over the selected records
    (update_checksum, stats.c:783), each CRC zlib's."""
    qname = np.ascontiguousarray(qname, np.uint8)
    qname_off = np.ascontiguousarray(qname_off, np.int64)
    seq = np.ascontiguousarray(seq, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.zeros(3, np.uint32)
    _load().samtpu_stats_crc32_batch(
        qname.ctypes.data, qname_off.ctypes.data, seq.ctypes.data,
        qual.ctypes.data, seq_off.ctypes.data, idx.ctypes.data, idx.size,
        out.ctypes.data)
    return int(out[0]), int(out[1]), int(out[2])


def aux_find_batch(aux: np.ndarray, aux_off: np.ndarray, idx: np.ndarray,
                   tag: str):
    """Per selected record: (value offset into aux, type char byte) of the
    tag, offset -1 when absent."""
    aux = np.ascontiguousarray(aux, np.uint8)
    aux_off = np.ascontiguousarray(aux_off, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    out_off = np.empty(idx.size, np.int64)
    out_type = np.empty(idx.size, np.uint8)
    _load().samtpu_aux_find_batch(
        aux.ctypes.data, aux_off.ctypes.data, idx.ctypes.data, idx.size,
        ord(tag[0]), ord(tag[1]), out_off.ctypes.data,
        out_type.ctypes.data)
    return out_off, out_type


def stats_cov_gcd(n: int, state: np.ndarray, tid: np.ndarray,
                  pos: np.ndarray, readlen: np.ndarray,
                  active: np.ndarray, gc_term: np.ndarray,
                  span_off: np.ndarray, span_beg: np.ndarray,
                  span_end: np.ndarray, fai_mode: int, gcd_bin_size: int,
                  rbuf: np.ndarray, cov: np.ndarray, cov_min: int,
                  cov_max: int, cov_step: int, gcd_gc: np.ndarray,
                  gcd_depth: np.ndarray) -> int:
    """Drive the sorted-block residue; see samtpu_host.cc
    samtpu_stats_cov_gcd for the state/return contract.  All arrays are
    mutated in place and must be contiguous and of the C types."""
    return int(_load().samtpu_stats_cov_gcd(
        n, state.ctypes.data, tid.ctypes.data, pos.ctypes.data,
        readlen.ctypes.data, active.ctypes.data, gc_term.ctypes.data,
        span_off.ctypes.data, span_beg.ctypes.data, span_end.ctypes.data,
        fai_mode, gcd_bin_size, rbuf.ctypes.data, rbuf.size,
        cov.ctypes.data, cov.size, cov_min, cov_max, cov_step,
        gcd_gc.ctypes.data, gcd_depth.ctypes.data, gcd_gc.size))


def stats_orig_hists(seq, qual, seq_off, oidx, order, rev, nbases, q1, q2,
                     a1, a2, ar, threads=2):
    """K12's host branch: the per-base original-read histograms,
    accumulated into q1/q2/a1/a2/ar (int64, in place); returns (gc_count,
    qual_sum) per selected read and the largest qual."""
    no = oidx.size
    gc_out = np.zeros(no, np.int64)
    qsum_out = np.zeros(no, np.int64)
    maxq = np.zeros(1, np.int64)
    oidx = np.ascontiguousarray(oidx, np.int64)
    order = np.ascontiguousarray(order, np.uint8)
    rev = np.ascontiguousarray(rev, np.uint8)
    for a in (q1, q2, a1, a2, ar):
        if a.dtype != np.int64 or not a.flags.c_contiguous:
            raise TypeError("stats_orig_hists: histograms must be "
                            "contiguous int64")
    _load().samtpu_stats_orig_hists(
        seq.ctypes.data, qual.ctypes.data, seq_off.ctypes.data,
        oidx.ctypes.data, no, order.ctypes.data, rev.ctypes.data,
        nbases, q1.shape[0], q1.ctypes.data, q2.ctypes.data,
        a1.ctypes.data, a2.ctypes.data, ar.ctypes.data,
        gc_out.ctypes.data, qsum_out.ctypes.data, maxq.ctypes.data,
        threads)
    return gc_out, qsum_out, int(maxq[0])


def sam_format(b, idx: np.ndarray, names_blob: np.ndarray,
               names_off: np.ndarray) -> str | None:
    """Records b[idx] as SAM text (each line ending in a newline); None
    when a record's aux is malformed (the caller takes the Python path,
    which raises its error)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    cols = [np.ascontiguousarray(getattr(b, name), dt) for name, dt in (
        ("tid", np.int32), ("pos", np.int64), ("mapq", np.uint8),
        ("flag", np.uint16), ("mtid", np.int32), ("mpos", np.int64),
        ("tlen", np.int64), ("qname", np.uint8), ("qname_off", np.int64),
        ("cigar", np.uint32), ("cigar_off", np.int64), ("seq", np.uint8),
        ("seq_off", np.int64), ("qual", np.uint8), ("aux", np.uint8),
        ("aux_off", np.int64))]
    names_blob = np.ascontiguousarray(names_blob, np.uint8)
    names_off = np.ascontiguousarray(names_off, np.int64)
    out = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.samtpu_sam_format(
        idx.size, idx.ctypes.data, *[c.ctypes.data for c in cols],
        names_blob.ctypes.data, names_off.ctypes.data, names_off.size - 1,
        ctypes.byref(out), ctypes.byref(out_len))
    if rc < 0:
        return None
    try:
        return ctypes.string_at(out.value, out_len.value).decode("latin-1")
    finally:
        lib.samtpu_buf_free(out)
