"""Read-pair overlap quality tweak (mpileup's default; ``-x`` turns it off).

Counterpart of samtools_tpu/ops/overlaps.py (:23-107), htslib's
overlap_push + tweak_overlap_quality: where both mates of a template have
aligned (M) bases at the same reference position, their qualities merge.
Same base: the first mate gets min(200, q1 + q2), the second 0.  Different
base: the higher-quality side keeps 0.8 q (truncated), the other gets 0.
"""

from __future__ import annotations

import numpy as np

from ..core import flags as F


def _aligned_map(sub, i: int):
    """(refpos[], flat qual offset[]) of the M/=/X bases of read i."""
    cig = sub.cigar_of(i)
    rp, qp = [], []
    x = int(sub.pos[i])
    y = 0
    for op, ln in zip((cig & 0xF).tolist(), (cig >> 4).tolist()):
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            rp.append(np.arange(x, x + ln))
            qp.append(np.arange(y, y + ln))
            x += ln
            y += ln
        elif op in (F.CINS, F.CSOFT_CLIP):
            y += ln
        elif op in (F.CDEL, F.CREF_SKIP):
            x += ln
    if not rp:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(rp), np.concatenate(qp) + int(sub.seq_off[i])


def tweak_overlaps(sub) -> None:
    """Adjust quals in place over one contig's reads, in file order."""
    if sub.n == 0:
        return
    end = sub.end_pos()
    stored: dict[bytes, int] = {}
    qf = sub.qname.tobytes()
    off = sub.qname_off
    fl = sub.flag.astype(np.int64)
    # only paired reads on their mate's contig whose mate starts before
    # their end can overlap it
    cand = np.nonzero(((fl & F.FMUNMAP) == 0) & (sub.tid == sub.mtid)
                      & (sub.mpos < end) & ((fl & F.FPAIRED) != 0))[0]
    for i in cand.tolist():
        name = qf[off[i]:off[i + 1]]
        j = stored.pop(name, None)
        if j is None:
            # only store reads whose mate is still to arrive
            if sub.mpos[i] >= sub.pos[i] or sub.mpos[i] == -1:
                stored[name] = i
            continue
        _tweak_pair(sub, j, i)


def _tweak_pair(sub, a: int, b: int) -> None:
    """tweak_overlap_quality(a, b), a the mate that arrived first."""
    ra, qa = _aligned_map(sub, a)
    rb, qb = _aligned_map(sub, b)
    if ra.size == 0 or rb.size == 0:
        return
    common, ia, ib = np.intersect1d(ra, rb, return_indices=True)
    if common.size == 0:
        return
    qa_i, qb_i = qa[ia], qb[ib]
    qual = sub.qual
    same = sub.seq[qa_i] == sub.seq[qb_i]
    qsum = qual[qa_i].astype(np.int64) + qual[qb_i].astype(np.int64)
    a_ge = qual[qa_i] >= qual[qb_i]
    new_a = np.where(same, np.minimum(qsum, 200),
                     np.where(a_ge, (0.8 * qual[qa_i].astype(np.float64))
                              .astype(np.int64), 0))
    new_b = np.where(same, 0,
                     np.where(a_ge, 0, (0.8 * qual[qb_i].astype(np.float64))
                              .astype(np.int64)))
    qual[qa_i] = new_a.astype(np.uint8)
    qual[qb_i] = new_b.astype(np.uint8)
