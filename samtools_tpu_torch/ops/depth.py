"""Depth on the host: the overlap clips of ``depth -s``, the numpy depth of
one window (the ``SAMTPU_DEVICE=0`` branch) and the row set ``depth``
prints.

Counterpart of samtools_tpu/ops/depth.py (:20-124), whose reference is
samtools' bam2depth.c: a window's reads become difference arrays
(M/=/X and, with -J, D spans) or per-base counts (with a base-quality
gate), summed with ``np.bincount``, which gives ``np.add.at``'s integers.
"""

from __future__ import annotations

import numpy as np

from ..core import flags as F
from ..core.batch import ragged_gather_indices
from .cigar import expand_ops


def overlap_clips(batch, order: np.ndarray) -> np.ndarray:
    """Per-read clip positions for ``-s`` (0 = no clip), bam2depth.c's
    qname hash: walking the reads in ``order``, an eligible read's first
    sighting stores its end, the second sighting of its name clips at that
    end and clears the entry."""
    clips = np.zeros(batch.n, np.int64)
    eligible = ((batch.flag & F.FPAIRED) != 0) & ((batch.flag & F.FMUNMAP)
                                                   == 0)
    end = batch.end_pos()
    stored: dict[bytes, int] = {}
    qf = batch.qname.tobytes()
    off = batch.qname_off
    for i in order:
        if not eligible[i]:
            continue
        name = qf[off[i]:off[i + 1]]
        got = stored.pop(name, None)
        if got is not None:
            clips[i] = got
        elif batch.mpos[i] == -1 or (batch.mtid[i] == batch.tid[i]
                                     and batch.mpos[i] <= end[i]):
            stored[name] = int(end[i])
    return clips


def _count(idx: np.ndarray, n: int) -> np.ndarray:
    """int64[n]: how many times each index in [0, n) occurs in idx."""
    return np.bincount(idx, minlength=n).astype(np.int64, copy=False)


def depth_window(batch, sel: np.ndarray, wbeg: int, wend: int,
                 min_qual: int, count_del: bool,
                 clips: np.ndarray | None = None) -> np.ndarray:
    """int32 depth over [wbeg, wend) of the selected reads of one file.
    ``clips``: per-read absolute overlap-clip positions (0 = none); bases
    and deleted positions before a read's clip do not count."""
    L = wend - wbeg
    diff = np.zeros(L + 1, np.int64)      # interval adds
    direct = np.zeros(L, np.int64)        # per-base adds
    if sel.size == 0:
        return direct.astype(np.int32)
    ragged = ("cigar", "qual") if min_qual else ("cigar",)
    sub = batch.take(sel, ragged=ragged)
    t = expand_ops(sub)
    clip = (clips[sel] if clips is not None else np.zeros(sel.size, np.int64))

    m = np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF))
    if m.any():
        rs = t.rpos[m]
        re = rs + t.oplen[m]
        opclip = clip[t.rid[m]]
        if min_qual == 0:
            s = np.clip(np.maximum(rs, opclip), wbeg, wend) - wbeg
            e = np.clip(np.maximum(re, opclip), wbeg, wend) - wbeg
            diff += _count(s, L + 1) - _count(e, L + 1)
        else:
            lens = t.oplen[m]
            refpos = ragged_gather_indices(rs, lens)
            qoff = ragged_gather_indices(t.qpos[m], lens)
            rid = np.repeat(t.rid[m], lens)
            qual = sub.qual[sub.seq_off[rid] + qoff]
            ok = ((qual >= min_qual) & (refpos >= clip[rid])
                  & (refpos >= wbeg) & (refpos < wend))
            direct += _count(refpos[ok] - wbeg, L)

    if count_del:
        d = t.op == F.CDEL
        if d.any():
            rs = t.rpos[d]
            re = rs + t.oplen[d]
            opclip = clip[t.rid[d]]
            qpos = t.qpos[d]
            rid = t.rid[d]
            # the quality gate reads the base at the deletion's query
            # cursor without advancing it; reads without bases always
            # count (bam2depth.c:419-429)
            ok = np.ones(rs.size, bool)
            if min_qual:
                has_q = qpos < sub.l_qseq[rid]
                qv = np.zeros(rs.size, np.int64)
                qv[has_q] = sub.qual[sub.seq_off[rid[has_q]]
                                     + qpos[has_q]].astype(np.int64)
                ok = ~has_q | (qv >= min_qual)
            s = np.clip(np.maximum(rs, opclip), wbeg, wend) - wbeg
            e = np.clip(np.maximum(re, opclip), wbeg, wend) - wbeg
            diff += _count(s[ok], L + 1) - _count(e[ok], L + 1)

    return (np.cumsum(diff[:L]) + direct).astype(np.int32)


def coverage_envelope(pos: np.ndarray, end: np.ndarray,
                      wbeg: int, wend: int) -> np.ndarray:
    """bool[wend - wbeg]: the positions inside the union of the read
    spans [pos, end), the rows ``depth`` prints without -a."""
    L = wend - wbeg
    s = np.clip(pos, wbeg, wend) - wbeg
    e = np.clip(end, wbeg, wend) - wbeg
    return np.cumsum((_count(s, L + 1) - _count(e, L + 1))[:L]) > 0
