"""Minimiser (minhash) sort keys that cluster unmapped reads (``sort -M``).

Counterpart of samtools_tpu/ops/minhash.py (:1-305); samtools'
bam_sort.c:2499 ``minhash`` (a windowed forward and reverse rolling 2-bit
k-mer hash, homopolymers optionally squashed), :2619
``build_minhash_index`` (the reference FASTA's minimisers with a
uniqueness bit), :2697/:2836 ``minhash_with_idx[_squash]`` (the whole
read, preferring k-mers unique in the index) and :3090 ``worker_minhash``
(the key packed into pos/mpos/isize, a read reverse-complemented when its
reverse minimiser wins).  The rolling hash of a read is one numpy
sliding-window dot product over its 2-bit codes; the order is a stable
``np.lexsort`` over the derived key columns.
"""

from __future__ import annotations

import numpy as np

from ..core import flags as F
from ..io.fasta import load_fasta
from ..io.sam_text import NT16_LUT

XOR = 0xDEAD7878BEEF7878
UNIQ_BIT = 60
UNIQ_MASK = (1 << UNIQ_BIT) - 1
U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# nt16 -> 2-bit code (A,C,G,T -> 0..3, everything else 0), bam_sort.c L[]
_L = np.zeros(16, np.uint64)
_L[1], _L[2], _L[4], _L[8] = 0, 1, 2, 3
# nt16 -> reverse-complement 2-bit code (T,G,C,A order), bam_sort.c R[]
_RC2 = np.zeros(16, np.uint64)
_RC2[1], _RC2[2], _RC2[4], _RC2[8] = 3, 2, 1, 0

# nt16 reverse-complement map via bam_sort.c:3031 reverse_complement's
# char table ('=' -> N; the table maps 'Y'->'Y', an htslib quirk kept
# for byte parity)
NT16_COMP = np.array([15, 8, 4, 12, 2, 10, 6, 14, 1, 9, 10, 13, 3, 11, 7, 15],
                     np.uint8)


def _squash_keep(nt16: np.ndarray) -> np.ndarray:
    """Mask of bases kept when collapsing homopolymer runs (compare on
    raw nt16 codes, first base always kept; fresh run state per call)."""
    keep = np.empty(nt16.size, bool)
    if nt16.size:
        keep[0] = True
        keep[1:] = nt16[1:] != nt16[:-1]
    return keep


def _window_hashes(codes: np.ndarray, kmer: int) -> np.ndarray:
    """Rolling hash h[t] = sum codes[t+j] << 2*(kmer-1-j) for every
    window of ``kmer`` consecutive kept codes; empty if too short."""
    n = codes.size - kmer + 1
    if n <= 0:
        return np.empty(0, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(codes, kmer)
    shifts = np.arange(kmer - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    return (win << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def minhash_window(nt16: np.ndarray, kmer: int, window: int, start: int,
                   no_squash: bool):
    """bam_sort.c:2499 minhash(), the forward-only windowed call of
    ``MinhashIndex.add_sequence``.  Returns (hash, out_pos, at_end)."""
    length = nt16.size
    i_end = min(start + window, length)
    seg = nt16[start:i_end]
    keep = np.ones(seg.size, bool) if no_squash else _squash_keep(seg)
    kept_idx = np.nonzero(keep)[0]
    codes = _L[seg[kept_idx]]
    hashes = _window_hashes(codes, kmer)
    at_end = i_end == length
    if hashes.size == 0:
        return None, start - (kmer - 1), at_end
    mask = np.uint64((1 << (2 * kmer)) - 1)
    hx = (hashes ^ np.uint64(XOR)) & mask
    t = int(np.argmin(hx))
    # position reported = original index of the window's last base
    minpos = start + int(kept_idx[t + kmer - 1])
    return int(hx[t]), minpos - (kmer - 1), at_end


def _read_minima(nt16: np.ndarray, kmer: int, try_rev: bool,
                 no_squash: bool):
    """Forward and reverse minimiser scan over a whole read.

    Returns (fwd_hx, fwd_kept_end_idx, rev_hx, rev_kept_end_idx,
    kept_idx) where the hx arrays are per-window xored hashes (empty if
    the read is too short) and kept_idx maps squashed index -> original
    base index.
    """
    keep = np.ones(nt16.size, bool) if no_squash else _squash_keep(nt16)
    kept_idx = np.nonzero(keep)[0]
    sq = nt16[kept_idx]
    mask = np.uint64((1 << (2 * kmer)) - 1)
    fwd = (_window_hashes(_L[sq], kmer) ^ np.uint64(XOR)) & mask
    if try_rev:
        # reverse hash at squashed step t: sum rc(sq[t-j]) << 2*(k-1-j)
        rev = (_window_hashes(_RC2[sq][::-1], kmer)[::-1]
               ^ np.uint64(XOR)) & mask if sq.size >= kmer else \
            np.empty(0, np.uint64)
    else:
        rev = np.empty(0, np.uint64)
    return fwd, rev, kept_idx


def minhash_read(nt16: np.ndarray, kmer: int, try_rev: bool,
                 no_squash: bool):
    """Whole-read minhash (window = l_qseq): returns (hash, pos, rev)
    exactly as bam_sort.c:2499 with curr_pos=0/try_fwd=1."""
    fwd, rev, kept_idx = _read_minima(nt16, kmer, try_rev, no_squash)
    length = nt16.size
    if fwd.size == 0:
        # loop never ran; minhashf stays UINT64_MAX, pos stays 0
        return int(U64MAX), -(kmer - 1), 0
    tf = int(np.argmin(fwd))
    best = int(fwd[tf])
    best_pos = int(kept_idx[tf + kmer - 1])
    is_rev = 0
    if rev.size:
        # rev window ending at squashed step t has hash over
        # sq[t-k+1..t]; reported pos = len - i + kmer - 2 with i the
        # original index of sq[t]
        tr = int(np.argmin(rev))
        rbest = int(rev[tr])
        if rbest < best:
            best = rbest
            best_pos = length - int(kept_idx[tr + kmer - 1]) + kmer - 2
            is_rev = 1
    return best, best_pos - (kmer - 1), is_rev


class MinhashIndex:
    """bam_sort.c:2619 build_minhash_index: minimiser -> position in the
    concatenated reference, with a non-uniqueness bit."""

    def __init__(self, kmer: int, window: int, no_squash: bool):
        self.kmer = kmer
        self.window = window
        self.no_squash = no_squash
        self.table: dict[int, int] = {}

    def add_sequence(self, nt16: np.ndarray, tpos: int) -> int:
        """Index one reference sequence; returns its length."""
        length = nt16.size
        if length < self.window:
            return 0  # samtools skips short sequences without advancing
        pos = 0
        while True:
            last_pos = pos
            h, pos, end = minhash_window(nt16, self.kmer, self.window, pos,
                                         self.no_squash)
            if h is not None:
                prev = self.table.get(h)
                val = tpos + pos
                if prev is not None:
                    val |= 1 << UNIQ_BIT  # kh_put ret==0 -> mark dup
                self.table[h] = val
            if end:
                break
            pos = max(last_pos + self.kmer, pos + 1)
        return length

    @classmethod
    def from_fasta(cls, path: str, kmer: int, window: int,
                   no_squash: bool) -> "MinhashIndex":
        idx = cls(kmer, window, no_squash)
        fai = load_fasta(path)
        tpos = 0
        for name in fai.order:
            seq = np.frombuffer(fai.fetch(name), np.uint8)
            tpos += idx.add_sequence(NT16_LUT[seq], tpos)
        return idx


def minhash_with_idx(nt16: np.ndarray, kmer: int, try_rev: bool,
                     no_squash: bool, index: MinhashIndex):
    """bam_sort.c:2697/:2836 minhash_with_idx[_squash]: whole-read scan
    preferring (unique-in-index > dup-in-index > unindexed) minimisers;
    the returned key is the minimiser's reference position when indexed.

    Returns (key, pos, rev)."""
    fwd, rev, kept_idx = _read_minima(nt16, kmer, try_rev, no_squash)
    length = nt16.size
    table = index.table
    umax = int(U64MAX)

    def best_of(hx: np.ndarray):
        # Faithful scan mechanics: the index lookup only happens under
        # the guard, and indexed-class assignments are unconditional
        # overwrites — so the dup-class value is the LAST qualifying
        # dup, not the min (bam_sort.c:2730-2748).
        min_f = min_fi = min_fd = umax
        pos_f = pos_fi = pos_fd = 0
        found = 0
        for t in range(hx.size):
            h = int(hx[t])
            cls = 0
            if min_fi > h or (found < 2 and min_fd > h):
                v = table.get(h)
                if v is not None:
                    cls = 2 if not (v & (1 << UNIQ_BIT)) else 1
            found |= cls
            if cls == 2:
                min_fi, pos_fi = h, t
            elif cls == 1:
                min_fd, pos_fd = h, t
            elif min_f > h:
                min_f, pos_f = h, t
        if min_fi != umax:
            return min_fi, pos_fi, found
        if min_fd != umax:
            return min_fd, pos_fd, found
        return min_f, pos_f, found

    bf, tf, found_f = best_of(fwd)
    pos_f = int(kept_idx[tf + kmer - 1]) if fwd.size else 0
    best, best_pos, dir_ = bf, pos_f, 0
    if rev.size:
        br, tr, found_r = best_of(rev)
        pos_r = int(kept_idx[tr + kmer - 1])
        if (best > br) or (not found_f and found_r):
            if not found_f or found_r:
                best = br
                best_pos = length - pos_r + kmer - 2
                dir_ = 1
    v = table.get(best)
    if v is not None:
        best = v & UNIQ_MASK
    if best == int(U64MAX):
        best = 0
    return best, best_pos, dir_


def reverse_complement_records(batch, which: np.ndarray) -> None:
    """In-place reverse complement (seq via NT16_COMP, qual reversed,
    flag ^= FREVERSE) of the selected records — bam_sort.c:3031."""
    for i in np.nonzero(which)[0]:
        s, e = batch.seq_off[i], batch.seq_off[i + 1]
        batch.seq[s:e] = NT16_COMP[batch.seq[s:e][::-1]]
        if batch.qual.size:
            batch.qual[s:e] = batch.qual[s:e][::-1]
        batch.flag[i] ^= F.FREVERSE


def minhash_order(batch, kmer: int = 20, try_rev: bool = True,
                  no_squash: bool = True, ref_fa: str | None = None,
                  ref_window: int = 100):
    """Compute the MinHash sort permutation (bam_sort.c:3090
    worker_minhash + :2138 bam1_cmp_by_minhash).  Mutates ``batch`` by
    reverse-complementing reads whose reverse minimiser wins.

    Mapped records keep coordinate order; unmapped (tid==-1) records
    order by (64-bit minimiser key, descending stored isize, input
    order).  Returns the permutation.
    """
    n = batch.n
    mh_hi = np.zeros(n, np.int64)
    mh_lo = np.zeros(n, np.int64)
    neg_isize = np.zeros(n, np.int64)
    rev_mask = np.zeros(n, bool)
    unmapped = batch.tid < 0

    index = None
    if ref_fa is not None:
        index = MinhashIndex.from_fasta(ref_fa, kmer, ref_window,
                                        no_squash)

    for i in np.nonzero(unmapped)[0]:
        seq = batch.seq_of(i)
        if index is not None:
            mh, pos, rv = minhash_with_idx(seq, kmer, try_rev, no_squash,
                                           index)
            mh = (mh - pos) & 0xFFFFFFFFFFFFFFFF
            pos = 0
        else:
            mh, pos, rv = minhash_read(seq, kmer, try_rev, no_squash)
            mh = (mh + (1 << 30)) & 0xFFFFFFFFFFFFFFFF
            pos = max(0, 65535 - pos)
        rev_mask[i] = bool(rv)
        # 62-bit key exactly as stored in pos/mpos (31 bits each)
        mh_hi[i] = (mh >> 31) & 0x7FFFFFFF
        mh_lo[i] = mh & 0x7FFFFFFF
        neg_isize[i] = -pos

    reverse_complement_records(batch, rev_mask)

    # bam1_cmp_by_minhash: mapped (either tid != -1) -> cmp_core;
    # unmapped pairs -> (mh, isize desc, cmp_core) where cmp_core's
    # surviving tie-break is the post-revcomp REVERSE flag (tid and pos
    # compare equal — pos holds the shared mh bits).  Compose as one
    # lexsort; stability = tie-break by input index.
    tid = batch.tid.astype(np.int64)
    tid_key = np.where(tid < 0, np.iinfo(np.int64).max, tid)
    rev = (batch.flag.astype(np.int64) & F.FREVERSE) != 0
    pos_key = np.where(unmapped, 0, batch.pos.astype(np.int64))
    return np.lexsort((rev, neg_isize, mh_lo, mh_hi,
                       pos_key, tid_key))
