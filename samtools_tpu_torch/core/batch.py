"""Columnar (structure-of-arrays) alignment-record batches.

Counterpart of samtools_tpu/core/batch.py: a whole batch of records as
dense numpy columns; ragged payloads (cigar/seq/qual/aux) live in flat
arrays plus ``int64`` offset vectors of length ``n+1``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np


# the ragged columns ``ReadBatch.take`` copies by default
ALL_RAGGED = ("qname", "cigar", "seq", "qual", "aux")


def empty_offsets() -> np.ndarray:
    return np.zeros(1, dtype=np.int64)


@dataclass
class ReadBatch:
    """A batch of alignment records in columnar form.

    Field semantics match the BAM record (SAM spec 4.2): ``pos`` is
    0-based, ``seq`` holds one 4-bit nt16 code per base, ``qual`` is raw
    phred (0xFF = absent), ``cigar`` packs ``len<<4 | op``.
    """

    n: int = 0
    tid: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    mapq: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    flag: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint16))
    mtid: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    mpos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    tlen: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    qname: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    qname_off: np.ndarray = field(default_factory=empty_offsets)
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))
    cigar_off: np.ndarray = field(default_factory=empty_offsets)
    seq: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    seq_off: np.ndarray = field(default_factory=empty_offsets)
    qual: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    aux: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    aux_off: np.ndarray = field(default_factory=empty_offsets)

    @classmethod
    def from_columns(cls, d: dict) -> "ReadBatch":
        """Build a batch from a dict of column arrays (the JAX package's
        ``vars(batch)`` has exactly these keys)."""
        kw = {f.name: d[f.name] for f in fields(cls)}
        kw["n"] = int(kw["n"])
        return cls(**kw)

    def __len__(self) -> int:
        return self.n

    @property
    def l_qseq(self) -> np.ndarray:
        return (self.seq_off[1:] - self.seq_off[:-1]).astype(np.int64)

    @property
    def n_cigar(self) -> np.ndarray:
        return (self.cigar_off[1:] - self.cigar_off[:-1]).astype(np.int64)

    def qname_str(self, i: int) -> str:
        return bytes(self.qname[self.qname_off[i]:
                                self.qname_off[i + 1]]).decode()

    def cigar_of(self, i: int) -> np.ndarray:
        return self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]]

    def seq_of(self, i: int) -> np.ndarray:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]]

    def qual_of(self, i: int) -> np.ndarray:
        return self.qual[self.seq_off[i]:self.seq_off[i + 1]]

    def aux_of(self, i: int) -> np.ndarray:
        return self.aux[self.aux_off[i]:self.aux_off[i + 1]]

    def ref_span(self) -> np.ndarray:
        """Reference bases consumed per record (bam_cigar2rlen)."""
        if self.n == 0:
            return np.zeros(0, np.int64)
        ops = (self.cigar & 0xF).astype(np.int64)
        lens = (self.cigar >> 4).astype(np.int64)
        consumes_ref = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0], np.int64)
        csum = np.concatenate([[0], np.cumsum(lens * consumes_ref[ops])])
        return csum[self.cigar_off[1:]] - csum[self.cigar_off[:-1]]

    def end_pos(self) -> np.ndarray:
        """0-based exclusive reference end per record (bam_endpos: a
        record that consumes no reference gets pos + 1)."""
        spans = self.ref_span()
        return self.pos + np.where(spans > 0, spans, 1)

    def take(self, idx: np.ndarray, ragged: tuple = ALL_RAGGED
             ) -> "ReadBatch":
        """A new batch of the given records, in the given order.  The
        ragged columns named in ``ragged`` are copied (all by default:
        mates pair by qname); the others come back empty, with their
        offsets kept, so ``l_qseq``, ``n_cigar`` and ``end_pos`` hold."""
        idx = np.asarray(idx, dtype=np.int64)
        out = ReadBatch(n=int(idx.size))
        for f in _FIXED_COLUMNS:
            setattr(out, f, getattr(self, f)[idx])
        for flat, off in (("qname", "qname_off"), ("cigar", "cigar_off"),
                          ("seq", "seq_off"), ("aux", "aux_off")):
            soff = getattr(self, off)
            noff = np.zeros(idx.size + 1, np.int64)
            np.cumsum(soff[idx + 1] - soff[idx], out=noff[1:])
            setattr(out, off, noff)
            src = getattr(self, flat)
            setattr(out, flat, _gather(src, soff, idx, noff)
                    if flat in ragged else np.empty(0, src.dtype))
            if flat == "seq":
                out.qual = (_gather(self.qual, soff, idx, noff)
                            if "qual" in ragged else np.empty(0, np.uint8))
        return out

    @staticmethod
    def concat(batches: list["ReadBatch"]) -> "ReadBatch":
        batches = [b for b in batches if b.n > 0]
        if not batches:
            return ReadBatch()
        out = ReadBatch(n=sum(b.n for b in batches))
        for f in _FIXED_COLUMNS + ("qname", "cigar", "seq", "qual", "aux"):
            setattr(out, f, np.concatenate([getattr(b, f) for b in batches]))
        for off in ("qname_off", "cigar_off", "seq_off", "aux_off"):
            parts = [np.zeros(1, np.int64)]
            base = 0
            for b in batches:
                o = getattr(b, off)
                parts.append(o[1:] + base)
                base += int(o[-1])
            setattr(out, off, np.concatenate(parts))
        return out


_FIXED_COLUMNS = ("tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen")


def _gather(flat: np.ndarray, off: np.ndarray, idx: np.ndarray,
            noff: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of a ragged column, by the host library's per-row
    copy (no index array as large as the payload)."""
    from ..io import native
    if flat.size == 0:
        return np.empty(0, flat.dtype)
    return native.ragged_gather(flat, off, idx, noff, int(noff[-1]))


def ragged_gather_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for ragged slices: concat(arange(s, s+l))."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    # repeat/cumsum trick: within a slice step +1, at each slice boundary
    # jump to the next slice's start
    nonzero = lens > 0
    starts_nz = starts[nonzero]
    lens_nz = lens[nonzero]
    ends_nz = np.cumsum(lens_nz)
    mx = int((starts_nz + lens_nz).max())
    dt = np.int32 if (mx < (1 << 31) - 1
                      and int(starts_nz.min()) >= 0) else np.int64
    out = np.ones(total, dt)
    out[0] = starts_nz[0]
    out[ends_nz[:-1]] = (starts_nz[1:]
                         - (starts_nz[:-1] + lens_nz[:-1] - 1)).astype(dt)
    return np.cumsum(out)
