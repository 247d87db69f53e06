"""Device BAQ: the banded glocal pair-HMM (K4 ``baq_hmm``), the finalize
step (K5 ``baq_finalize``) and BAQ apply (K8 ``baq_apply``: its front
``apply_expand``, then K4 and K5), each with its wrapper and its plain
PyTorch version.

Counterpart of samtools_tpu/ops/baq_device.py: ``_probaln_batch``
(:111-299) with ``_decode_row`` (:60-99), ``_finalize`` (:302-328), and
``_get_fused_apply`` (:334-375) with ``baq_apply_device_nt16``
(:378-410).
The plain versions mirror those functions op by op on [W, B] band-major
tensors (a loop over query rows); the kernels are csrc/baq_hmm.cu,
csrc/baq_finalize.cu and csrc/apply_expand.cu, whose source notes say
what bounds each on the H100 and how its design answers it.

Arithmetic is float32: where the f32 posterior lies within PHRED_MARGIN
of a phred rounding boundary, or the best state nearly ties
(TIE_MARGIN), the read is flagged ``risky`` and recomputed by the f64
host HMM, so the final qualities equal the host's byte for byte.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import kernels
from ..device import d2h, h2d

PD = 0.001
PE = 0.1
EI = 0.25
EM = 1.0 / 3.0

# margin (phred units) below which an f32 posterior may round differently
# than the f64 host HMM; the leak is summed directly (never 1 - max/sum),
# which keeps the f32 value within ~1e-4 phred of the f64 one
PHRED_MARGIN = 3e-3
# relative margin for best-state ties in the posterior argmax
TIE_MARGIN = 3e-4


def _transitions(l_query: int) -> dict:
    """HMM transition constants, computed in double as the reference does
    (the device arithmetic rounds each to float32)."""
    sM = 1.0 / (2 * l_query + 2)
    return dict(m0=(1 - 2 * PD) * (1 - sM), m1=PD * (1 - sM),
                m2=PD * (1 - sM), m3=(1 - PE) * (1 - sM),
                m4=PE * (1 - sM), m6=1 - PE, m8=PE, sM=sM)


def _decode_row(fM_i, bM_i, fI_i, bI_i, i, crow, qrow, W: int, bw: int):
    """Posterior decode of one query row (band-major [W, B] inputs):
    best state, phred of the leak mass, the state check and risk flags."""
    B = fM_i.shape[1]
    z2 = torch.stack([fM_i * bM_i, fI_i * bI_i], dim=1).reshape(2 * W, B)
    mx, best = z2.max(0)
    # torch.max returns the first maximal index, as jnp.argmax does
    rows2 = torch.arange(2 * W, device=z2.device)[:, None]
    z2z = torch.where(rows2 == best[None, :], torch.zeros_like(z2), z2)
    leak = z2z.sum(0)
    mx2 = z2z.max(0).values
    tot = mx + leak
    val = -4.343 * (torch.log(leak.clamp_min(1e-38))
                    - torch.log(tot.clamp_min(1e-38))) + 0.499
    kq = torch.where(leak > 0, val.to(torch.int32),
                     torch.full_like(best, 100, dtype=torch.int32))
    bq = torch.where(kq > 100, 99, kq)
    frac = val - torch.floor(val)
    matters = torch.floor(val) <= qrow.float() + 1
    risky = ((torch.minimum(frac, 1 - frac) < PHRED_MARGIN) & matters) | \
        (mx2 > (1 - TIE_MARGIN) * mx)
    # rounding flips on non-M bases (crow at the sentinel) change no output
    risky = risky & (crow < (1 << 19))
    kbest = best // 2 + i - 1 - bw
    good = (best % 2 == 0) & (kbest == crow + (i - 1)) & (mx > 0)
    return bq, good, risky


def bq_reaching_output(bq, qual, cdeltaT):
    """The part of a posterior qual that can reach an output: min(bq,
    qual) on M bases, 0 elsewhere (int32 [B, L]).  ``risky`` guards
    exactly these roundings (``matters`` in the decode); a raw bq above
    qual + 1, or on a non-M base, may round either way unflagged."""
    m = cdeltaT.t() < (1 << 19)
    return torch.where(m, torch.minimum(bq.to(torch.int32),
                                        qual.to(torch.int32)), 0)


def _matmul_f32(a, b):
    """a @ b at full f32 whatever the caller's TF32 setting (TF32 would
    round the D chains' inputs to 10 mantissa bits on the card); the
    caller's setting is restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def baq_hmm_plain(ref_win, query, qual, cdeltaT, lref, bMv, bIv,
                  l_query: int, l_ref_max: int, bw: int):
    """Banded glocal HMM for B reads of uniform query length, mirroring
    ``_probaln_batch`` with a loop over query rows.

    ref_win u8[B, l_ref_max] 0-4 codes; query/qual u8[B, l_query];
    cdeltaT i32[l_query, B] expected diagonal per base (large sentinel
    on non-M bases); lref i32[B] (|lref - l_query| <= bw); bMv/bIv
    f32[B] boundary probabilities.  Returns (bq u8[B, l_query],
    good bool[B, l_query], risky bool[B])."""
    dev = ref_win.device
    f32 = torch.float32
    B = ref_win.shape[0]
    W = 2 * bw + 1
    t = _transitions(l_query)
    m0, m1, m2, m3, m4, m6, m8, sM = (t[k] for k in (
        "m0", "m1", "m2", "m3", "m4", "m6", "m8", "sM"))
    cols = torch.arange(l_ref_max, device=dev)
    ref_win = torch.where(cols[None, :] < lref[:, None].long(), ref_win,
                          torch.full_like(ref_win, 15))
    queryT = query.t()
    qlnT = torch.pow(torch.tensor(10.0, dtype=f32, device=dev),
                     -qual.t().to(f32) / 10.0)
    lrow = lref[None, :].long()
    bM = bMv[None, :]
    bI = bIv[None, :]
    tt = np.arange(W)
    d = tt[:, None] - tt[None, :]
    # TLt[j, a] = m8^(j-a) for a <= j (forward D chain); TUt = its mirror
    TLt = torch.tensor(np.where(d >= 0, np.power(m8, np.maximum(d, 0)), 0.0),
                       dtype=f32, device=dev)
    TUt = TLt.t().contiguous()
    # ref transposed and padded so rows [i, i+W) hold ref[i+j-bw-1]
    refp = torch.full((l_ref_max + 2 * bw + 2, B), 15, dtype=torch.uint8,
                      device=dev)
    refp[bw + 1:bw + 1 + l_ref_max] = ref_win.t()
    js = torch.arange(W, device=dev)

    def band_mask(i):
        k = (i + js - bw)[:, None]
        return (k >= max(1, i - bw)) & (k <= torch.clamp(lrow, max=i + bw))

    def emis(rslice, q, ql):
        q = q[None, :]
        ql = ql[None, :]
        amb = (rslice > 3) | (q > 3)
        return torch.where(amb, torch.ones((), dtype=f32, device=dev),
                           torch.where(rslice == q, 1.0 - ql, ql * EM))

    # ---- forward
    e = emis(refp[1:1 + W], queryT[0], qlnT[0])
    k = (1 + js - bw)[:, None]
    mask = (k >= 1) & (k <= torch.clamp(lrow, max=bw + 1))
    fM = torch.where(mask, e * bM, 0.0)
    fI = torch.where(mask, EI * bI * torch.ones_like(e), 0.0)
    s = (fM + fI).sum(0)
    pM, pI = fM / s[None, :], fI / s[None, :]
    pD = torch.zeros_like(pM)
    fMs, fIs, ss = [pM], [pI], [s]
    zrow = torch.zeros(1, B, dtype=f32, device=dev)
    for i in range(2, l_query + 1):
        e = emis(refp[i:i + W], queryT[i - 1], qlnT[i - 1])
        mask = band_mask(i)
        pMs = torch.cat([pM[1:], zrow])
        pIs = torch.cat([pI[1:], zrow])
        fM = torch.where(mask, e * (m0 * pM + m3 * pI + m6 * pD), 0.0)
        fI = torch.where(mask, EI * (m1 * pMs + m4 * pIs), 0.0)
        Mshift = torch.cat([fM[:1], fM[:-1]])
        fD = torch.where(mask, _matmul_f32(TLt, m2 * Mshift), 0.0)
        s = (fM + fI + fD).sum(0)
        inv = (1.0 / s)[None, :]
        pM, pI, pD = fM * inv, fI * inv, fD * inv
        fMs.append(pM)
        fIs.append(pI)
        ss.append(s)

    # ---- end row: s[l_query+1] sums slots j in [1, 2bw] only
    k = (l_query + js - bw)[:, None]
    mask_end = (k >= 1) & (k <= lrow) & ((js >= 1) & (js <= 2 * bw))[:, None]
    s_end = ((fMs[-1] * sM + fIs[-1] * sM) * mask_end).sum(0)
    b_init = torch.where(mask_end, sM / ss[-1][None, :] / s_end[None, :], 0.0)
    bqs = [None] * l_query
    goods = [None] * l_query
    riskys = [None] * l_query
    bqs[-1], goods[-1], riskys[-1] = _decode_row(
        fMs[-1], b_init, fIs[-1], b_init, l_query, cdeltaT[l_query - 1],
        qual[:, l_query - 1], W, bw)

    # ---- backward + decode
    nM, nI = b_init, b_init
    for i in range(l_query - 1, 0, -1):
        rslice = refp[i + 1:i + 1 + W]
        e1 = emis(rslice, queryT[i], qlnT[i])
        k = (i + js - bw)[:, None]
        e1 = torch.where(k >= lrow, 0.0, e1)
        ee = e1 * nM
        nIs = torch.cat([nI[:1], nI[:-1]])
        bD = _matmul_f32(TUt, ee * m6)
        bDs = torch.cat([bD[1:], zrow])
        bMr = ee * m0 + EI * m1 * nIs + m2 * bDs
        bIr = ee * m3 + EI * m4 * nIs
        mask = band_mask(i)
        inv = (1.0 / ss[i - 1])[None, :]
        bMr = torch.where(mask, bMr, 0.0) * inv
        bIr = torch.where(mask, bIr, 0.0) * inv
        bqs[i - 1], goods[i - 1], riskys[i - 1] = _decode_row(
            fMs[i - 1], bMr, fIs[i - 1], bIr, i, cdeltaT[i - 1],
            qual[:, i - 1], W, bw)
        nM, nI = bMr, bIr
    bq = torch.stack(bqs, 1).to(torch.uint8)
    good = torch.stack(goods, 1)
    risky = torch.stack(riskys, 1).any(1)
    return bq, good, risky


def hmm_layout(l_query: int, l_ref_max: int, n: int) -> dict:
    """K4's launch geometry for n reads of l_query bases and ref windows
    of l_ref_max, as its source fixes it: checkpoint stride, threads per
    block, dynamic shared memory per block and the checkpoint scratch the
    wrapper allocates (bytes)."""
    return dict(zip(("stride", "threads", "smem_bytes", "scratch_bytes"),
                    kernels.layout("samtpu_baq_hmm_layout", l_query,
                                   l_ref_max, n)))


def baq_hmm(ref_win, query, qual, cdeltaT, lref, bMv, bIv,
            l_query: int, l_ref_max: int, bw: int = 7):
    """K4 wrapper (arguments and results as ``baq_hmm_plain``).  CPU
    tensors take the plain version; CUDA tensors launch csrc/baq_hmm.cu,
    which takes the band 2*7+1 only and needs a checkpoint scratch of
    ``hmm_layout(l_query, l_ref_max, B)["scratch_bytes"]``."""
    B = ref_win.shape[0]
    kernels.check(ref_win, "ref_win", torch.uint8, (B, l_ref_max))
    kernels.check(query, "query", torch.uint8, (B, l_query))
    kernels.check(qual, "qual", torch.uint8, (B, l_query))
    kernels.check(cdeltaT, "cdeltaT", torch.int32, (l_query, B))
    kernels.check(lref, "lref", torch.int32, (B,))
    kernels.check(bMv, "bMv", torch.float32, (B,))
    kernels.check(bIv, "bIv", torch.float32, (B,))
    args = (ref_win, query, qual, cdeltaT, lref, bMv, bIv)
    if not kernels.on_card(*args):
        return baq_hmm_plain(*args, l_query, l_ref_max, bw)
    if bw != 7:
        raise ValueError(f"the CUDA HMM is built for bw=7, got {bw}")
    dev = ref_win.device
    t = _transitions(l_query)
    m = (ctypes.c_float * 10)(*(t[k] for k in (
        "m0", "m1", "m2", "m3", "m4", "m6", "m8", "sM")),
        EI * t["m1"], EI * t["m4"])
    ck = torch.empty(hmm_layout(l_query, l_ref_max, B)["scratch_bytes"],
                     dtype=torch.uint8, device=dev)
    bq = torch.empty(B, l_query, dtype=torch.uint8, device=dev)
    good = torch.empty_like(bq)
    risky = torch.empty(B, dtype=torch.uint8, device=dev)
    kernels.launch("baq_hmm", "samtpu_baq_hmm", ref_win.data_ptr(),
                   query.data_ptr(), qual.data_ptr(), cdeltaT.data_ptr(),
                   lref.data_ptr(), bMv.data_ptr(), bIv.data_ptr(), B,
                   l_query, l_ref_max, bw, m, ck.data_ptr(), bq.data_ptr(),
                   good.data_ptr(), risky.data_ptr(),
                   kernels.stream_of(ref_win), device=ref_win.device)
    return bq, good.view(torch.bool), risky.view(torch.bool)


def baq_finalize_plain(bq, good, qual, seg):
    """State-check zeroing, qual cap, per-M-op smoothing and the applied
    qual (``_finalize``'s arithmetic): the segmented prefix/suffix
    running max rides the offset trick (adding 256*seg before a cummax
    keeps earlier segments from dominating later ones).  In the suffix
    pass a non-M base takes the offset of the nearest M op to its left
    (0 before the first), so its zero can never swamp that op's suffix
    max; ``_finalize`` gives it offset 0, the largest suffix offset, and
    loses the suffix max of any M op of ordinal >= 1 followed by a
    non-M base.  Non-M bases (seg < 0) take min(q, bq).  Returns u8
    [B, L]."""
    q = qual.to(torch.int32)
    b = bq.to(torch.int32)
    is_m = seg >= 0
    segc = seg.clamp_min(0)
    bqv = torch.where(good & is_m, torch.minimum(b, q), 0)
    K = 256
    left = torch.cummax(bqv + K * segc, dim=1).values - K * segc
    # seg rises along the read, so the running max is each M base's own
    # ordinal and, on a non-M base, that of the M op before it
    rseg = K * (64 - torch.cummax(segc, dim=1).values)
    rght = torch.cummax((bqv + rseg).flip(1), dim=1).values.flip(1) - rseg
    sm = torch.minimum(left, rght)
    out_m = q - torch.where(q <= sm, 0, q - sm)
    out_x = torch.minimum(q, b)
    return torch.where(is_m, out_m, out_x).to(torch.uint8)


def baq_finalize(bq, good, qual, seg):
    """K5 wrapper: bq u8[B, L], good bool[B, L], qual u8[B, L], seg
    i32[B, L] (cigar-op ordinal of each M base, -1 elsewhere) -> applied
    quals u8[B, L].  CPU tensors take the plain version; CUDA tensors
    launch csrc/baq_finalize.cu."""
    B, L = qual.shape
    kernels.check(bq, "bq", torch.uint8, (B, L))
    kernels.check(good, "good", torch.bool, (B, L))
    kernels.check(qual, "qual", torch.uint8, (B, L))
    kernels.check(seg, "seg", torch.int32, (B, L))
    if not kernels.on_card(bq, good, qual, seg):
        return baq_finalize_plain(bq, good, qual, seg)
    out = torch.empty_like(qual)
    kernels.launch("baq_finalize", "samtpu_baq_finalize", bq.data_ptr(),
                   good.data_ptr(), qual.data_ptr(), seg.data_ptr(), B, L,
                   out.data_ptr(), kernels.stream_of(qual),
                   device=qual.device)
    return out


# ---------------------------------------------------------------- K8
# reads per host->device copy of ``baq_apply_nt16``
APPLY_CHUNK = 1 << 16
# K8's ref window: the read's L bases and bw // 2 more (sam_prob_realn's
# extent for an all-M read)
APPLY_PAD = 3
# K8's front (csrc/apply_expand.cu): reads a block at most, and the bytes
# of a block's rows staged in shared memory at most
APPLY_READS = 32
APPLY_STAGE = 32768


def apply_plan(L: int) -> int:
    """Reads a block of K8's front for reads of L bases: APPLY_READS,
    fewer where their rows of 4 + 2L bytes would pass APPLY_STAGE."""
    return max(1, min(APPLY_READS, APPLY_STAGE // (4 + 2 * L)))


def apply_expand_plain(ref_dev, buf):
    """K8's front: unpack ``buf`` u8[B, 4 + 2L] (LE int32 pos | nt16
    bases | quals), map nt16 to 0-4 codes and gather ref windows of L + 3
    from the contig codes ``ref_dev``.  Returns (ref_win u8[B, L + 3], sq
    u8[B, L], qq u8[B, L])."""
    L = (buf.shape[1] - 4) // 2
    l_ref = L + APPLY_PAD
    dev = buf.device
    pc = buf[:, :4].contiguous().view(torch.int32)[:, 0]
    nt16_to4 = torch.tensor([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                            dtype=torch.uint8, device=dev)
    sq = nt16_to4[buf[:, 4:4 + L].long()]
    qq = buf[:, 4 + L:4 + 2 * L].contiguous()
    last = ref_dev.numel() - 1
    idx = pc.clamp(max=last)[:, None] + torch.arange(l_ref, device=dev)
    ref_win = ref_dev[idx.clamp(0, last).long()]
    return ref_win, sq, qq


def _check_apply(ref_dev, buf) -> int:
    """K8's argument checks (before any launch); returns L."""
    kernels.check(ref_dev, "ref_dev", torch.uint8, (None,))
    kernels.check(buf, "buf", torch.uint8, (None, None))
    B, row = buf.shape
    if row < 6 or row % 2:
        raise ValueError(f"buf: rows of 4 + 2L bytes (L >= 1), got {row}")
    if not 0 < B < (1 << 31) - APPLY_READS or ref_dev.numel() == 0:
        raise ValueError(f"K8 takes 1 to 2^31 - 33 reads and a contig, got "
                         f"{B} reads, {ref_dev.numel()} bases")
    return (row - 4) // 2


def apply_expand(ref_dev, buf):
    """K8's front, ``apply_expand_plain``'s (ref_win, sq, qq).  CPU
    tensors take the plain version; CUDA tensors launch
    csrc/apply_expand.cu (a block of ``apply_plan(L)`` reads, their rows
    staged in shared memory 16 bytes a thread, each output written 4
    bytes a thread)."""
    L = _check_apply(ref_dev, buf)
    if not kernels.on_card(ref_dev, buf):
        return apply_expand_plain(ref_dev, buf)
    if 4 + 2 * L > APPLY_STAGE:
        raise ValueError(f"the CUDA front stages rows of at most "
                         f"{APPLY_STAGE} bytes, got reads of {L} bases")
    B = buf.shape[0]
    dev = buf.device
    ref_win = torch.empty(B, L + APPLY_PAD, dtype=torch.uint8, device=dev)
    sq = torch.empty(B, L, dtype=torch.uint8, device=dev)
    qq = torch.empty(B, L, dtype=torch.uint8, device=dev)
    kernels.launch("apply_expand", "samtpu_apply_expand", buf.data_ptr(), B,
                   L, apply_plan(L), ref_dev.data_ptr(), ref_dev.numel(),
                   ref_win.data_ptr(), sq.data_ptr(), qq.data_ptr(),
                   kernels.stream_of(buf), device=dev)
    return ref_win, sq, qq


def _per_read(B: int, L: int, dev):
    """K4's per-read inputs that do not vary by read: (lref i32[B], bMv,
    bIv f32[B]), the window length and boundary probabilities."""
    l_ref = L + APPLY_PAD
    return (torch.full((B,), l_ref, dtype=torch.int32, device=dev),
            torch.full((B,), (1 - PD) / l_ref, dtype=torch.float32,
                       device=dev),
            torch.full((B,), PD / l_ref, dtype=torch.float32, device=dev))


def _fresh_constants(B: int, L: int, dev):
    """K4's and K5's inputs that do not vary by read, made anew: (cdT
    i32[L, B] zeros, lref, bMv, bIv, seg i32[B, L] zeros)."""
    return (torch.zeros(L, B, dtype=torch.int32, device=dev),
            *_per_read(B, L, dev),
            torch.zeros(B, L, dtype=torch.int32, device=dev))


_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.Lock()


def _kept_constants(B: int, L: int, dev):
    """``_fresh_constants``' tensors as views of ones made once a card and
    read length, at max(B, APPLY_CHUNK) reads: K4 reads cdT and K5 seg,
    neither writes them, so both view one zero buffer of the card (grown,
    after a sync of the card, when a call needs more)."""
    n = max(B, APPLY_CHUNK)
    with _CONSTANTS_LOCK:
        zeros = _CONSTANTS.get(dev.index)
        per = _CONSTANTS.get((dev.index, L))
        grow_zeros = zeros is None or zeros.numel() < n * L
        grow_per = per is None or per[0].numel() < n
        if (grow_zeros and zeros is not None) or (grow_per
                                                  and per is not None):
            # launches on any stream may still read the ones replaced
            torch.cuda.synchronize(dev)
        if grow_zeros:
            zeros = _CONSTANTS[dev.index] = torch.zeros(
                n * L, dtype=torch.int32, device=dev)
        if grow_per:
            per = _CONSTANTS[(dev.index, L)] = _per_read(n, L, dev)
        if grow_zeros or grow_per:
            # launches on other streams read them without waiting
            torch.cuda.current_stream(dev).synchronize()
    lref, bMv, bIv = (t[:B] for t in per)
    return (zeros[:L * B].view(L, B), lref, bMv, bIv,
            zeros[:B * L].view(B, L))


def _apply(ref_dev, buf, expand, constants, hmm, fin):
    """K8's body: the front (``expand``: ref windows, 0-4 codes and
    quals), then the HMM (every base expected on the diagonal, one window
    length and boundary probability for all) and the finalize (one M op
    per read), their per-read constants from ``constants``."""
    B = buf.shape[0]
    L = (buf.shape[1] - 4) // 2
    ref_win, sq, qq = expand(ref_dev, buf)
    cdT, lref, bMv, bIv, seg = constants(B, L, buf.device)
    bq, good, risky = hmm(ref_win, sq, qq, cdT, lref, bMv, bIv, L,
                          L + APPLY_PAD, 7)
    return fin(bq, good, qq, seg), risky


def baq_apply_plain(ref_dev, buf):
    """K8's plain version: ``_apply`` over the plain front, K4 and K5."""
    return _apply(ref_dev, buf, apply_expand_plain, _fresh_constants,
                  baq_hmm_plain, baq_finalize_plain)


def baq_apply(ref_dev, buf):
    """K8, BAQ apply of a uniform group of all-M reads: ref_dev u8[n]
    contig codes (0-4), buf u8[B, 4 + 2L] -> (applied quals u8[B, L],
    risky bool[B]).  CPU tensors take the plain version; CUDA tensors
    launch three kernels: the front (csrc/apply_expand.cu), K4 and K5
    (csrc/baq_hmm.cu, csrc/baq_finalize.cu), the constant per-read inputs
    views of tensors kept on the card."""
    _check_apply(ref_dev, buf)
    if not kernels.on_card(ref_dev, buf):
        return baq_apply_plain(ref_dev, buf)
    out = _apply(ref_dev, buf, apply_expand, _kept_constants, baq_hmm,
                 baq_finalize)
    kernels.launches["baq_apply"] += 1
    return out


def apply_fits(l_query: int, device: torch.device) -> bool:
    """Does K8 take reads of ``l_query`` bases on ``device``?  On the
    card, when K4's shared memory per block for that length fits the
    card's opt-in limit (K4 keeps each block's ref windows, queries and
    quals there: ~17 KB + ~96 bytes a base); the plain version takes any
    length."""
    if device.type != "cuda":
        return True
    smem = hmm_layout(l_query, l_query + APPLY_PAD, 1)["smem_bytes"]
    return smem <= torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def baq_apply_nt16(ref_dev, pos: np.ndarray, seq_nt16: np.ndarray,
                   qual: np.ndarray, chunk: int = APPLY_CHUNK):
    """K8 over a uniform group of all-M reads of L bases, on the device
    ``ref_dev`` lies on: pos int64[B] (pos + L + 3 inside the contig),
    seq_nt16 and qual u8[B, L].  One pinned host->device copy per chunk
    of ``chunk`` reads and one device->host copy, into pinned memory, of
    the group's applied quals and risky flags.  Returns (u8[B, L],
    bool[B]) as numpy."""
    B, L = qual.shape
    outs, risks = [], []
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        buf = np.empty((hi - lo, 4 + 2 * L), np.uint8)
        buf[:, :4] = pos[lo:hi].astype("<i4").view(np.uint8).reshape(-1, 4)
        buf[:, 4:4 + L] = seq_nt16[lo:hi]
        buf[:, 4 + L:] = qual[lo:hi]
        appq, rk = baq_apply(ref_dev, h2d(buf, ref_dev.device))
        outs.append(appq)
        risks.append(rk)
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    risky = torch.cat(risks) if len(risks) > 1 else risks[0]
    both = d2h(torch.cat([out.reshape(-1), risky.to(torch.uint8)]))
    return both[:B * L].reshape(B, L), both[B * L:].astype(bool)
