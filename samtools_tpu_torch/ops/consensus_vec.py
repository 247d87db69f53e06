"""Vectorized gap5 consensus scorer, with its column sums on the card (K10).

Counterpart of samtools_tpu/ops/consensus_vec.py.  The host half is a
copy: the reference computes, per column, 15 diploid-hypothesis log
scores from per-base probability tables selected by (base, qual, qual2)
and then normalizes/softmaxes them into a call + het call + phreds
(samtools' bam_consensus.c:1258-1791).  This module computes the same
thing for ALL columns of a window at once:

* per-entry (base, qual, qual2) -> 15-vector contributions come from a
  precomputed [6, 101, 101, 15] table (exactly the pMM/pxx/... sums the
  scalar code forms per entry);
* the per-column S accumulation runs in ENTRY ORDER via a depth-slot
  loop (iteration d adds the d-th entry of every column), so float
  rounding matches the scalar loop bit for bit;
* the finalization (priors, shift, fast_exp softmax, norm prefix sums,
  phred/het phreds) is vectorized with bit-exact ports of the
  reference's fast_log2 / fast_exp table tricks.

The scalar implementation in tools/consensus_cmd.py remains the oracle;
tests assert bitwise equality on random columns.

K10 (``consensus_segsum``, ``csrc/consensus_segsum.cu``) replaces the JAX
package's device scorer (``_get_dev_segsum`` :346 and
``gap5_scores_device`` :367): per column, the sum of the table rows of its
kept entries, with the kept-base counts and the depth.  Where the JAX
function sums in f32 and gates the columns whose outcome the f32 error
could change (``finalize_risky``, recomputed in f64 on the host), K10
sums the f64 rows in entry order, as ``gap5_scores`` does: its S is the
host branch's bit for bit, and no column needs a recompute.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from .. import kernels
from ..device import h2d

TENLOG2OVERLOG10 = 3.0103
DBL_MIN = 2.2250738585072014e-308
MIN_E_EXP = -1021 * _math.log(2) + 1

L_TAB = np.array([5, 0, 1, 5, 2, 5, 5, 5, 3, 5, 5, 5, 5, 5, 5, 5]
                 + [4] * 16, np.int8)
MAP_SING = np.array([0, 5, 5, 5, 5, 1, 5, 5, 5, 2, 5, 5, 3, 5, 4],
                    np.int8)
MAP_HET = np.array([0, 1, 2, 3, 4, 6, 7, 8, 9, 12, 13, 14, 18, 19, 24],
                   np.int8)
PURE = np.array([0, 5, 9, 12, 14], np.int64)
NONPURE = np.array([j for j in range(15) if j not in (0, 5, 9, 12, 14)],
                   np.int64)

Q2P = np.array([10 ** (-i / 10.0) for i in range(101)], np.float64)
MQUAL_POW_1M = np.array(
    [10 ** (-(i * 0.9) / 10.0) for i in range(255)] + [0.0], np.float64)
MQUAL_POW_1M[255] = MQUAL_POW_1M[10]

E_TAB = np.array([_math.exp(i) for i in range(-500, 501)], np.float64)
E_TAB2 = np.array([_math.exp(i / 10.0) for i in range(-500, 501)],
                  np.float64)


def fast_log2_vec(v: np.ndarray) -> np.ndarray:
    """Bit-exact vector port of bam_consensus.c:898 fast_log2."""
    x = np.ascontiguousarray(v, np.float64).view(np.uint64).copy()
    E = (((x >> np.uint64(52)) & np.uint64(2047)).astype(np.int64)
         - 1024)
    x &= ~np.uint64(2047 << 52)
    x += np.uint64(1023 << 52)
    m = x.view(np.float64)
    return E.astype(np.float64) + ((-1 / 3.0) * m + 2) * m - 2 / 3.0


def ph_log_vec(v: np.ndarray) -> np.ndarray:
    return -TENLOG2OVERLOG10 * fast_log2_vec(v)


def fast_exp_vec(y: np.ndarray) -> np.ndarray:
    """Bit-exact vector port of bam_consensus.c:885 fast_exp."""
    y = np.asarray(y, np.float64)
    small = (y >= -50) & (y <= 50)
    idx2 = np.clip((y * 10).astype(np.int64) + 500, 0, 1000)
    yc = np.clip(y, -500.0, 500.0)
    idx1 = np.clip(yc.astype(np.int64) + 500, 0, 1000)
    return np.where(small, E_TAB2[idx2], E_TAB[idx1])


_TABLE9_CACHE: dict = {}


def gap5_table9(cp) -> np.ndarray:
    """[6, 101, 101, 15] per-(base, qual, qual2) S contributions —
    exactly the per-entry sums formed at bam_consensus.c:1440-1525."""
    key = id(cp)
    got = _TABLE9_CACHE.get(key)
    if got is not None and got[0] is cp:
        return got[1]
    q = np.arange(101)
    pMM = np.asarray(cp.pMM)[q]
    pxx = np.asarray(cp.pxx)[q]
    pxM = np.asarray(cp.pxM)[q]
    poo = np.asarray(cp.poo)[q]
    poM = np.asarray(cp.poM)[q]
    pox = np.asarray(cp.pox)[q]
    puu = np.asarray(cp.puu)[q]
    pum = np.asarray(cp.pum)[q]
    pmm = np.asarray(cp.pmm)[q]
    xx = pxx[:, None] * np.ones(101)[None, :]
    MM = pMM[:, None] - xx
    xM = pxM[:, None] - xx
    oo = poo[None, :] - xx
    oM = poM[None, :] - xx
    ox = pox[None, :] - xx
    uu = puu[None, :] - xx
    um = pum[None, :] - xx
    mm = pmm[None, :] - xx
    T = np.zeros((6, 101, 101, 15), np.float64)
    Z = np.zeros_like(MM)

    def put(b, vals):
        for j, v in vals.items():
            T[b, :, :, j] = v
    put(0, {0: MM, 1: xM, 2: xM, 3: xM, 4: oM,
            8: ox, 11: ox, 13: ox, 14: oo})
    put(1, {1: xM, 5: MM, 6: xM, 7: xM, 8: oM,
            4: ox, 11: ox, 13: ox, 14: oo})
    put(2, {2: xM, 6: xM, 9: MM, 10: xM, 11: oM,
            4: ox, 8: ox, 13: ox, 14: oo})
    put(3, {3: xM, 7: xM, 10: xM, 12: MM, 13: oM,
            4: ox, 8: ox, 11: ox, 14: oo})
    put(4, {0: uu, 1: uu, 2: uu, 3: uu, 4: um, 5: uu, 6: uu, 7: uu,
            8: um, 9: uu, 10: uu, 11: um, 12: uu, 13: um, 14: mm})
    put(5, {0: MM, 1: MM, 2: MM, 3: MM, 4: oM, 5: MM, 6: MM, 7: MM,
            8: oM, 9: MM, 10: MM, 11: oM, 12: MM, 13: oM, 14: oo})
    del Z
    if len(_TABLE9_CACHE) > 4:
        _TABLE9_CACHE.clear()
    _TABLE9_CACHE[key] = (cp, T)
    return T


def entry_quals(qual, base4, mapq, nm_loc, poly, td, opts, use_mqual_flag,
                q0_is_255):
    """Per-entry (base6, qual, qual2) — bit-exact vectorization of the
    per-entry stanza at bam_consensus.c:1370-1438 (consensus_cmd
    calculate_consensus_gap5 :757-798).

    qual: int array (raw per-entry); base4: nt16-ish codes (16='*');
    nm_loc/poly: per-entry nm_local()/poly_len() values; td: per-entry
    column total depth; q0_is_255: per-entry bool (read's first qual is
    255 while this qual is 0)."""
    qual = np.asarray(qual, np.int64)
    q = np.where((qual == 255) | ((qual == 0) & q0_is_255),
                 opts.default_qual, qual)
    base6 = np.where(base4 < 32, L_TAB[np.minimum(base4, 31)], 4) \
        .astype(np.int64)
    if use_mqual_flag:
        mq = np.asarray(mapq, np.float64).copy()
        if opts.nm_adjust:
            mq /= np.asarray(nm_loc, np.float64) + 1
            td30 = np.minimum(td, 30).astype(np.float64)
            mq *= 1 + 2 * (0.5 - td30 / 60.0)
        mq *= opts.scale_mqual
        mq = np.where(mq < opts.low_mqual, float(opts.low_mqual), mq)
        mq = np.where(mq > opts.high_mqual, float(opts.high_mqual), mq)
        P = Q2P[np.minimum(q, 100)]
        M = MQUAL_POW_1M[np.clip(mq.astype(np.int64), 0, 255)]
        q = ph_log_vec(P + .75 * M - P * M).astype(np.int64)
    q = np.minimum(np.maximum(q, 1), 100)
    # scalar: max(1, int(qual - (poly-2)*poly_mul)) then min(..., 100)
    pm = opts_poly_mul(opts)
    q2 = np.trunc(q - (np.asarray(poly, np.float64) - 2) * pm) \
        .astype(np.int64)
    q2 = np.minimum(np.maximum(q2, 1), 100)
    return base6, q, q2


def opts_poly_mul(opts):
    cp = opts.cp_recall if opts.cp_recall is not None else opts.cp_precise
    return cp.poly_mul if cp is not None else 0.0


def gap5_scores(col_off: np.ndarray, base6, q, q2, keep, cp):
    """S[ncols, 15] accumulated in entry order (depth-slot loop keeps
    per-column addition order identical to the scalar loop), plus
    counts[ncols, 6] and passing depth per column.

    keep: per-entry mask (qual >= min_qual and not refskip)."""
    T = gap5_table9(cp)
    ncols = col_off.size - 1
    S = np.zeros((ncols, 15), np.float64)
    counts = np.zeros((ncols, 6), np.int64)
    depth = np.zeros(ncols, np.int64)
    # compact kept entries per column while preserving order
    kidx = np.nonzero(keep)[0]
    kpre = np.zeros(base6.size + 1, np.int64)
    np.cumsum(keep.astype(np.int64), out=kpre[1:])
    kcol_counts = kpre[col_off[1:]] - kpre[col_off[:-1]]
    koff = np.zeros(ncols + 1, np.int64)
    np.cumsum(kcol_counts, out=koff[1:])
    kb = base6[kidx]
    kq = q[kidx]
    kq2 = q2[kidx]
    np.add.at(counts, (np.repeat(np.arange(ncols), kcol_counts), kb), 1)
    depth = kcol_counts
    dmax = int(kcol_counts.max(initial=0))
    for d in range(dmax):
        sel = kcol_counts > d
        rows = koff[:-1][sel] + d
        S[sel] += T[kb[rows], kq[rows], kq2[rows]]
    return S, counts, depth


def gap5_finalize(S, counts, depth, cp):
    """Vector port of bam_consensus.c:1607-1790 finalization.  Returns
    (call, phred, het_call, het_logodd, depth_out) arrays."""
    ncols = S.shape[0]
    S = S + np.asarray(cp.lprior15)[None, :]
    shift = S.max(axis=1)
    # strict-< argmax (first max wins) — np.argmax matches
    call = PURE[np.argmax(S[:, PURE], axis=1)]
    mx = S[np.arange(ncols), call]
    het_call = NONPURE[np.argmax(S[:, NONPURE], axis=1)]
    S = S - shift[:, None]
    E = fast_exp_vec(S)
    Sx = np.where(S > MIN_E_EXP, E, DBL_MIN)
    norm = np.zeros_like(Sx)
    tot1 = np.zeros(ncols, np.float64)
    tot2 = np.zeros(ncols, np.float64)
    for j in range(15):
        norm[:, j] += tot1
        norm[:, 14 - j] += tot2
        tot1 = tot1 + Sx[:, j]
        tot2 = tot2 + Sx[:, 14 - j]
    del mx
    empty = (depth == 0) | (depth == counts[:, 5])
    nc = norm[np.arange(ncols), call]
    nc = np.where(nc == 0, DBL_MIN, nc)
    sc = Sx[np.arange(ncols), call]
    ph_a = np.trunc(ph_log_vec(nc) + .5).astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ph_b = np.trunc(ph_log_vec(1 - sc / (nc + sc)) + .5) \
            .astype(np.int64)
    ph = np.where((sc == 1) & (nc < .01), ph_a, ph_b)
    phred = np.maximum(ph, 0)
    nh = norm[np.arange(ncols), het_call]
    nh = np.where(nh == 0, DBL_MIN, nh)
    sh = Sx[np.arange(ncols), het_call]
    het_logodd = np.trunc(
        TENLOG2OVERLOG10 * (fast_log2_vec(sh) - fast_log2_vec(nh))
        + .5).astype(np.int64)
    out_call = MAP_SING[call].astype(np.int64)
    out_het = MAP_HET[het_call].astype(np.int64)
    # empty/all-N columns
    out_call = np.where(empty, 4, out_call)
    out_het = np.where(empty, 0, out_het)
    het_logodd = np.where(empty, 0, het_logodd)
    phred = np.where(empty, 0, phred)
    depth_out = np.where(empty, 0, depth)
    return out_call, phred, out_het, het_logodd, depth_out


def gap5m_blend(P, R):
    """Vector port of calculate_consensus_gap5m's mixed-mode blending
    (bam_consensus.c:1799).  P/R are (call, phred, het_call,
    het_logodd, depth) tuples; returns a blended tuple."""
    pc, pp, ph_, pl, pd = (a.copy() for a in P)
    rc, rp, rh, rl, rd = R
    call, phred, het, lo, dep = pc, pp, ph_, pl, pd
    done = np.zeros(pc.size, bool)

    m = (pp > 0) & (rp > 0) & (pc == rc)
    phred = np.where(m, phred + np.minimum(20, rp), phred)
    done |= m

    m2 = ~done & (pl >= 0) & (rl >= 0) & (ph_ == rh)
    lo = np.where(m2, lo + np.minimum(20, rl), lo)
    done |= m2

    m3 = ~done & (pl >= 0)
    q2 = np.maximum(rp, rl)
    lo = np.where(m3, np.maximum(1, lo - q2 // 2), lo)
    done |= m3

    m4 = ~done & (rl >= 70)
    if m4.any():
        q1 = pp
        q2b = rl
        sub_lo = np.minimum(
            15.0, np.maximum((q2b - q1 * 2) / 2.0,
                             1 + q2b / (q1 + 1.0))).astype(np.int64)
        call = np.where(m4, rc, call)
        phred = np.where(m4, rp, phred)
        het = np.where(m4, rh, het)
        dep = np.where(m4, rd, dep)
        lo = np.where(m4, sub_lo, lo)
    done |= m4

    m5 = ~done & (rl >= 0)
    if m5.any():
        q1 = pp
        q2c = rl
        sub_lo = (np.maximum(1, q2c - 0.3 * q1).astype(np.int64)
                  + 5 * (ph_ == rh))
        call = np.where(m5, rc, call)
        het = np.where(m5, rh, het)
        dep = np.where(m5, rd, dep)
        lo = np.where(m5, sub_lo, lo)
        phred = np.where(m5, 0, phred)
    done |= m5

    m6 = ~done
    if m6.any():
        rp2 = rd.copy()
        rphalf = rp // 2
        take_r = m6 & (rphalf > pp)
        call = np.where(take_r, rc, call)
        het = np.where(take_r, rh, het)
        lo = np.where(take_r, rl, lo)
        dep = np.where(take_r, rd, dep)
        phred = np.where(take_r, rphalf, phred)
        phred = np.where(m6, np.maximum(10, phred), phred)
        del rp2
    return call, phred, het, lo, dep


HET_CHARS = "NACMGRSVTWYHKDBN" "*ac?g???t???????"
CALL_CHARS = "ACGT*"


def consensus_base_vec(cons, opts):
    """Vector port of consensus_base (bam_consensus.c:2139) for the
    gap5 modes: (cb char codes, cq) per column."""
    call, phred, het_call, het_logodd, depth = cons
    cb = np.frombuffer(CALL_CHARS.encode(), np.uint8)[
        np.clip(call, 0, 4)].astype(np.int64)
    cq = phred.copy()
    if opts.ambig:
        m = het_logodd > 0
        hchars = np.frombuffer(HET_CHARS.encode(), np.uint8)
        cb = np.where(m, hchars[np.clip(het_call, 0, 31)], cb)
        cq = np.where(m, het_logodd, cq)
    lowdep = (depth < opts.min_depth) & (call != 4)
    cb = np.where(lowdep, ord("N"), cb)
    cq = np.where(lowdep, 0, cq)
    cut = (cq < opts.cons_cutoff) & (cb != ord("*")) \
        & (het_call % 5 != 4) & (het_call // 5 != 4)
    cb = np.where(cut, ord("N"), cb)
    cq = np.where(cut, 0, cq)
    return cb, cq


# ---------------------------------------------------------------- device
# table rows padded from 15 to 16 doubles: 128-byte rows, one coalesced
# load per entry for the kernel's 16 lanes
ROW = 16


def segsum_table(cp, device) -> torch.Tensor:
    """gap5_table9(cp) as K10's f64 table [6 * 101 * 101, 16] on
    ``device``."""
    T = np.zeros((6 * 101 * 101, ROW), np.float64)
    T[:, :15] = gap5_table9(cp).reshape(-1, 15)
    return h2d(T, device)


def consensus_segsum_plain(T: torch.Tensor, ent: torch.Tensor,
                           col_off: torch.Tensor):
    """K10's plain version: the kept entries' table rows gathered and
    added into their columns by ``index_add_`` in f64.  Returns (S
    f64[ncols, 15], counts int32[ncols, 6], depth int32[ncols]).  On the
    CPU ``index_add_`` adds in entry order, as K10 and gap5_scores do."""
    ncols = col_off.numel() - 1
    e = ent.long()
    keep = e[:, 3] != 0
    col = torch.repeat_interleave(
        torch.arange(ncols, device=T.device), torch.diff(col_off))[keep]
    e = e[keep]
    S = torch.zeros(ncols, 15, dtype=torch.float64, device=T.device)
    S.index_add_(0, col, T[(e[:, 0] * 101 + e[:, 1]) * 101 + e[:, 2], :15])
    counts = torch.zeros(ncols * 6, dtype=torch.int32, device=T.device)
    counts.index_add_(0, col * 6 + e[:, 0],
                      torch.ones(col.numel(), dtype=torch.int32,
                                 device=T.device))
    counts = counts.view(ncols, 6)
    return S, counts, counts.sum(1, dtype=torch.int32)


# K10's launch geometry, as csrc/consensus_segsum.cu fixes it: a
# quarter-warp a stream of consecutive columns, 8 to 32 streams a block,
# at most 32 columns a stream; about three blocks an SM
SEGSUM_STREAMS = (8, 32)
SEGSUM_CMAX = 32


def segsum_plan(ncols: int, sms: int) -> tuple[int, int, int]:
    """K10's plan for ``ncols`` columns on a card of ``sms`` SMs:
    (streams a block, columns a stream, blocks).  Block b takes columns
    [b * streams * C, (b + 1) * streams * C), its stream s the C of them
    from b * streams * C + s * C.  Streams shrink (down to 8 a block)
    before blocks fall short of three an SM, so deep columns, one a stream,
    still run side by side; columns a stream grow (up to 32) when there
    are more columns than streams.  All zero for no columns."""
    if ncols <= 0:
        return 0, 0, 0
    target = 3 * sms
    lo, streams = SEGSUM_STREAMS
    while streams > lo and -(-ncols // streams) < target:
        streams //= 2
    C = min(SEGSUM_CMAX, max(1, -(-ncols // (streams * target))))
    return streams, C, -(-ncols // (streams * C))


def consensus_segsum(T: torch.Tensor, ent: torch.Tensor,
                     col_off: torch.Tensor):
    """K10: for each column c, S[c] = the sum, in entry order and in f64,
    of T[row(e), :15] over its kept entries e in [col_off[c], col_off[c +
    1]), row(e) = (b6 * 101 + q) * 101 + q2, with the kept entries' base
    counts and their number.  ``T`` f64[61206, 16] (``segsum_table``),
    ``ent`` uint8[n, 4] = (b6, q, q2, keep) per entry in column order,
    ``col_off`` int64[ncols + 1].  S equals gap5_scores' bit for bit.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/consensus_segsum.cu``: blocks of ``segsum_plan``, a
    quarter-warp a stream of columns, the table rows of 8 entries loaded
    through L1 before their adds)."""
    ncols = col_off.numel() - 1
    kernels.check(T, "T", torch.float64, (6 * 101 * 101, ROW))
    kernels.check(ent, "ent", torch.uint8, (None, 4))
    kernels.check(col_off, "col_off", torch.int64, (ncols + 1,))
    if not kernels.on_card(T, ent, col_off):
        return consensus_segsum_plain(T, ent, col_off)
    S = torch.empty(ncols, 15, dtype=torch.float64, device=T.device)
    counts = torch.empty(ncols, 6, dtype=torch.int32, device=T.device)
    depth = torch.empty(ncols, dtype=torch.int32, device=T.device)
    if ncols:
        kernels.launch("consensus_segsum", "samtpu_consensus_segsum",
                       T.data_ptr(), ent.data_ptr(), col_off.data_ptr(),
                       S.data_ptr(), counts.data_ptr(), depth.data_ptr(),
                       ncols, *segsum_plan(ncols, kernels.sm_count(T.device)),
                       kernels.stream_of(T), device=T.device)
    return S, counts, depth


_T_DEV_CACHE: dict = {}


def gap5_scores_device(col_off, base6, q, q2, keep, cp, device):
    """gap5_scores through K10 on ``device`` (the CPU takes its plain
    version): the same S, counts and depth, bit for bit."""
    key = (id(cp), str(device))
    got = _T_DEV_CACHE.get(key)
    if got is None or got[0] is not cp:
        if len(_T_DEV_CACHE) > 4:
            _T_DEV_CACHE.clear()
        got = (cp, segsum_table(cp, device))
        _T_DEV_CACHE[key] = got
    ent = np.empty((base6.size, 4), np.uint8)
    ent[:, 0] = base6
    ent[:, 1] = q
    ent[:, 2] = q2
    ent[:, 3] = keep
    S, counts, depth = consensus_segsum(
        got[1], h2d(ent, device),
        h2d(np.ascontiguousarray(col_off, np.int64), device))
    return (S.cpu().numpy(), counts.cpu().numpy().astype(np.int64),
            depth.cpu().numpy().astype(np.int64))
