"""BAQ (per-Base Alignment Quality) for the mpileup tool: the host half.

Counterpart of samtools_tpu/ops/baq.py: ``probaln_glocal`` (:36),
``sam_prob_realn_single`` (:201) with ``_append_tag``/``_retag``
(:330-338), ``_ref_ints`` (:345), ``apply_baq_batch`` (:377-413),
``_apply_baq_native`` (:416-452) with its helpers (:455-478),
``_apply_baq_device`` (:534-586) and ``cap_mapq_batch`` with
``_cap_mapq_single`` (:589-642), the htslib sam_prob_realn and
sam_cap_mapq analogs.

``apply_baq_batch`` BAQs one contig's reads in place (flag 3, or 7 for
``-E``).  Without stored BQ/ZQ tags: uniform groups of all-M reads go
through K8 on the card (``_apply_baq_device``), the rest and the reads
K8 flags risky through the host library's f64 HMM, so the quals equal
the host HMM's byte for byte.  A read that may carry a stored tag sends
the whole batch through the per-read f64 path here, which also converts
and appends the tags.  The JAX package's device-to-host link probe and
its ``use_device`` gate are left out: K8 runs wherever the command runs
on the card.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..core import metrics
from ..core.batch import ragged_gather_indices
from ..device import h2d
from ..io import native
from . import baq_device
from .mpileup_device import HOST_THREADS, NT16_TO4

# probaln_par_t defaults used by sam_prob_realn: d=0.001, e=0.1, bw=7
PAR_D = 0.001
PAR_E = 0.1
EI = 0.25
EM = 1.0 / 3.0

# nt16 -> 2-bit int (4 = ambiguous), htslib seq_nt16_int
NT16_INT = NT16_TO4.astype(np.int64)

# ASCII base -> nt16 code (htslib seq_nt16_table; U reads as T)
NT16_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(F.SEQ_NT16_STR):
    NT16_LUT[ord(_c)] = _i
    NT16_LUT[ord(_c.lower())] = _i
NT16_LUT[ord("u")] = NT16_LUT[ord("U")] = 8

# the smallest uniform group of all-M reads that goes to K8 (the JAX
# package's rule, baq.py:569); smaller groups take the host HMM
DEVICE_GROUP_MIN = 2048


def _ref_ints(ref: bytes) -> np.ndarray:
    """A contig's 0-4 codes (A, C, G, T, other) from its ASCII bases."""
    return np.ascontiguousarray(
        NT16_TO4[NT16_LUT[np.frombuffer(ref, np.uint8)]], np.uint8)


def probaln_glocal(ref: np.ndarray, query: np.ndarray, iqual: np.ndarray,
                   bandwidth: int):
    """(state, bq) per query base: state[i] = (best_ref_pos << 2) |
    hmm_state, bq[i] the phred of its posterior.  ref/query are 0-3 codes
    (above 3: ambiguous).  The f64 HMM, summed in htslib's order."""
    l_ref = ref.size
    l_query = query.size
    if l_ref <= 0 or l_query <= 0:
        return None, None
    bw = max(l_ref, l_query)
    if bw > bandwidth:
        bw = bandwidth
    if bw < abs(l_ref - l_query):
        bw = abs(l_ref - l_query)
    bw2 = bw * 2 + 1
    W = bw2 * 3 + 6
    f = np.zeros((l_query + 1, W))
    b = np.zeros((l_query + 1, W))
    s = np.zeros(l_query + 2)
    qual = np.power(10.0, -iqual.astype(np.float64) / 10.0)

    m = np.zeros(9)
    sM = sI = 1.0 / (2 * l_query + 2)
    d, e = PAR_D, PAR_E
    m[0] = (1 - d - d) * (1 - sM)
    m[1] = m[2] = d * (1 - sM)
    m[3] = (1 - e) * (1 - sI)
    m[4] = e * (1 - sI)
    m[5] = 0.0
    m[6] = 1 - e
    m[8] = e
    m[7] = 0.0
    bM = (1 - d) / l_ref
    bI = d / l_ref

    def set_u(i, k):
        x = k - i + bw
        if x < 0:
            x = 0
        return x * 3

    # forward; row 1
    f[0, set_u(0, 0)] = s[0] = 1.0
    beg, end = 1, min(l_ref, bw + 1)
    ks = np.arange(beg, end + 1)
    e_match = np.where((ref[ks - 1] > 3) | (query[0] > 3), 1.0,
                       np.where(ref[ks - 1] == query[0],
                                1.0 - qual[0], qual[0] * EM))
    us = (ks - 1 + bw) * 3  # set_u(1, k)
    f[1, us] = e_match * bM
    f[1, us + 1] = EI * bI
    # htslib sums sequentially in k order: fi[u] + fi[u+1] per k
    ssum = float(np.cumsum(np.stack([f[1, us], f[1, us + 1]],
                                    axis=1).ravel())[-1])
    s[1] = ssum
    lo = set_u(1, beg)
    hi = set_u(1, end) + 2
    f[1, lo:hi + 1] /= ssum  # divides here (not a reciprocal multiply)

    for i in range(2, l_query + 1):
        qli = qual[i - 1]
        qyi = query[i - 1]
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        ks = np.arange(beg, end + 1)
        e_match = np.where((ref[ks - 1] > 3) | (qyi > 3), 1.0,
                           np.where(ref[ks - 1] == qyi,
                                    1.0 - qli, qli * EM))
        u = (np.maximum(ks - i + bw, 0)) * 3
        v11 = (np.maximum(ks - i + bw, 0)) * 3       # set_u(i-1, k-1)
        v10 = (np.maximum(ks - (i - 1) + bw, 0)) * 3  # set_u(i-1, k)
        fi1 = f[i - 1]
        fM = e_match * (m[0] * fi1[v11] + m[3] * fi1[v11 + 1]
                        + m[6] * fi1[v11 + 2])
        fI = EI * (m[1] * fi1[v10] + m[4] * fi1[v10 + 1])
        fi = f[i]
        fi[u] = fM
        fi[u + 1] = fI
        # the deletion recurrence reads the current row's k-1: a scan
        for idx, k in enumerate(ks):
            v01 = set_u(i, k - 1)
            fi[u[idx] + 2] = m[2] * fi[v01] + m[8] * fi[v01 + 2]
        # per k, fi[u] + fi[u+1] + fi[u+2], summed sequentially
        ssum = float(np.cumsum(np.stack([fi[u], fi[u + 1], fi[u + 2]],
                                        axis=1).ravel())[-1])
        s[i] = ssum
        lo = set_u(i, beg)
        hi = set_u(i, end) + 2
        fi[lo:hi + 1] *= 1.0 / ssum  # a reciprocal multiply here

    # the end row
    total = 0.0
    for k in range(1, l_ref + 1):
        u = set_u(l_query, k)
        if u < 3 or u >= bw2 * 3 + 3:
            continue
        total += f[l_query, u] * sM + f[l_query, u + 1] * sI
    s[l_query + 1] = total

    # backward
    for k in range(1, l_ref + 1):
        u = set_u(l_query, k)
        if u < 3 or u >= bw2 * 3 + 3:
            continue
        b[l_query, u] = sM / s[l_query] / s[l_query + 1]
        b[l_query, u + 1] = sI / s[l_query] / s[l_query + 1]
    for i in range(l_query - 1, 0, -1):
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        qli1 = qual[i]
        qyi1 = query[i]
        bi = b[i]
        bi1 = b[i + 1]
        for k in range(end, beg - 1, -1):
            u = set_u(i, k)
            v11 = set_u(i + 1, k + 1)
            v10 = set_u(i + 1, k)
            v01 = set_u(i, k + 1)
            if k >= l_ref:
                ee = 0.0
            elif ref[k] > 3 or qyi1 > 3:
                ee = 1.0 * bi1[v11]
            elif ref[k] == qyi1:
                ee = (1.0 - qli1) * bi1[v11]
            else:
                ee = qli1 * EM * bi1[v11]
            bi[u] = ee * m[0] + EI * m[1] * bi1[v10 + 1] + m[2] * bi[v01 + 2]
            bi[u + 1] = ee * m[3] + EI * m[4] * bi1[v10 + 1]
            bi[u + 2] = ee * m[6] + m[8] * bi[v01 + 2]
        lo = set_u(i, beg)
        hi = set_u(i, end) + 2
        bi[lo:hi + 1] *= 1.0 / s[i]

    # posterior decode
    state = np.zeros(l_query, np.int64)
    bq = np.zeros(l_query, np.int64)
    for i in range(1, l_query + 1):
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        ks = np.arange(beg, end + 1)
        u = (np.maximum(ks - i + bw, 0)) * 3
        zM = f[i, u] * b[i, u]
        zI = f[i, u + 1] * b[i, u + 1]
        # per k, M then I; a strict > keeps the first max; summed in order
        allz = np.stack([zM, zI], axis=1).ravel()
        ssum = float(np.cumsum(allz)[-1])
        kidx = int(np.argmax(allz))
        mx = float(allz[kidx])
        if mx <= 0.0:
            max_k = -1
            mx = 0.0
        else:
            max_k = (int(ks[kidx // 2]) - 1) << 2 | (kidx & 1)
        mxn = mx / ssum if ssum > 0 else 0.0
        state[i - 1] = max_k
        kq = int(-4.343 * np.log1p(-mxn) + 0.499) if mxn < 1.0 else 100
        bq[i - 1] = 99 if kq > 100 else kq
    return state, bq


def sam_prob_realn_single(pos: int, cigar: np.ndarray, seq: np.ndarray,
                          qual: np.ndarray, aux: np.ndarray,
                          ref_nt16int: np.ndarray, ref_len: int,
                          flag: int = 3):
    """One read's sam_prob_realn: (new quals, new aux), or None where BAQ
    leaves the read alone (htslib returns < 0).  A stored BQ or ZQ tag
    turns it into a tag conversion; ``ref_nt16int`` is the whole contig
    as 0-4 codes."""
    apply_baq = flag & 1
    extend_baq = (flag >> 1) & 1
    redo_baq = flag & 4
    l_qseq = seq.size
    if l_qseq == 0 or qual.size == 0 or qual[0] == 0xFF:
        return None

    bq_val = auxmod.get_value(aux, "BQ")
    zq_val = auxmod.get_value(aux, "ZQ")
    bq = bq_val[1] if bq_val is not None and bq_val[0] == "Z" else None
    zq = zq_val[1] if zq_val is not None and zq_val[0] == "Z" else None
    new_aux = aux
    if bq is not None and redo_baq:
        new_aux = auxmod.delete_tags(new_aux, {"BQ"})
        bq = None
    if bq is not None and zq is not None:
        new_aux = auxmod.delete_tags(new_aux, {"ZQ"})
        zq = None
    if bq is not None or zq is not None:
        if (apply_baq and zq is not None) or (not apply_baq
                                              and bq is not None):
            return None  # nothing to do
        q = qual.astype(np.int64)
        if bq is not None and apply_baq:  # BQ to ZQ
            tagq = np.frombuffer(bq.encode("latin-1"), np.uint8)[:l_qseq] \
                .astype(np.int64)
            newq = np.where(q + 64 < tagq, 0, q - (tagq - 64))
            new_aux = _retag(new_aux, "BQ", "ZQ", bq)
            return newq.astype(np.uint8), new_aux
        if zq is not None and not apply_baq:  # ZQ to BQ
            tagq = np.frombuffer(zq.encode("latin-1"), np.uint8)[:l_qseq] \
                .astype(np.int64)
            newq = q + (tagq - 64)
            new_aux = _retag(new_aux, "ZQ", "BQ", zq)
            return newq.astype(np.uint8), new_aux
        return None

    # the alignment's extent
    ops = (cigar & 0xF).astype(np.int64)
    lens = (cigar >> 4).astype(np.int64)
    x = pos
    y = 0
    xb = yb = xe = ye = -1
    for op, ln in zip(ops, lens):
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            if yb < 0:
                yb = y
            if xb < 0:
                xb = x
            ye = y + ln
            xe = x + ln
            x += ln
            y += ln
        elif op in (F.CSOFT_CLIP, F.CINS):
            y += ln
        elif op == F.CDEL:
            x += ln
        elif op == F.CREF_SKIP:
            return None
    if xb < 0:
        return None

    bw = 7
    if abs((xe - xb) - (ye - yb)) > bw:
        bw = abs((xe - xb) - (ye - yb)) + 3
    # the window: left by yb (within the contig), right by the rest of the
    # read and bw / 2 (the JAX package's extent rule)
    xb -= min(yb, xb)
    xe += l_qseq - ye + bw // 2
    if xe > ref_len:
        xe = ref_len
    if xe <= xb:
        return None

    query_int = NT16_INT[seq]
    r = ref_nt16int[xb:xe]
    state, bqv = probaln_glocal(r, query_int, qual.astype(np.int64), bw)
    if state is None:
        return None

    bqv = bqv.copy()
    x = pos
    y = 0
    for op, ln in zip(ops, lens):
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            ii = np.arange(y, y + ln)
            bad = ((state[ii] & 3) != 0) | ((state[ii] >> 2)
                                            != x - xb + (ii - y))
            bqv[ii] = np.where(bad, 0, np.minimum(bqv[ii],
                                                  qual[ii].astype(np.int64)))
            if extend_baq:
                left = np.maximum.accumulate(bqv[ii])
                rght = np.maximum.accumulate(bqv[ii][::-1])[::-1]
                bqv[ii] = np.minimum(left, rght)
            x += ln
            y += ln
        elif op in (F.CSOFT_CLIP, F.CINS):
            y += ln
        elif op == F.CDEL:
            x += ln

    q64 = qual.astype(np.int64)
    if extend_baq:
        final_bq = 64 + np.where(q64 <= bqv, 0, q64 - bqv)
    else:
        final_bq = q64 - bqv + 64
    tag_str = bytes(final_bq.astype(np.uint8)).decode("latin-1")
    if apply_baq:
        newq = q64 - (final_bq - 64)
        new_aux = _append_tag(new_aux, "ZQ", tag_str)
        return newq.astype(np.uint8), new_aux
    new_aux = _append_tag(new_aux, "BQ", tag_str)
    return qual, new_aux


def _append_tag(aux: np.ndarray, tag: str, val: str) -> np.ndarray:
    blob = tag.encode() + b"Z" + val.encode("latin-1") + b"\0"
    return np.concatenate([np.asarray(aux, np.uint8),
                           np.frombuffer(blob, np.uint8)])


def _retag(aux: np.ndarray, old: str, new: str, val: str) -> np.ndarray:
    return _append_tag(auxmod.delete_tags(aux, {old}), new, val)


def apply_baq_batch(sub, ref_int: np.ndarray, redo: bool = False,
                    device=None, ref_dev=None) -> None:
    """BAQ one contig's reads in place, in mplp_func's order (per read,
    flag 3, or 7 with ``redo``).  ``ref_int``: the contig's 0-4 codes.
    ``device``: the torch device K8 runs on (the CPU takes its plain
    version), or None for the host branch (the host HMM only);
    ``ref_dev``: the contig's codes already there.

    Without a possible stored BQ/ZQ tag, uniform all-M groups go through
    K8 and the rest through the host library's f64 HMM; otherwise every
    read takes the per-read path, which converts and appends tags."""
    if sub.n == 0:
        return
    flag = 7 if redo else 3
    if _apply_baq_native(sub, ref_int, device, ref_dev):
        return
    aux_parts = []
    aux_changed = False
    for i in range(sub.n):
        qual = sub.qual[sub.seq_off[i]:sub.seq_off[i + 1]]
        got = sam_prob_realn_single(
            int(sub.pos[i]), sub.cigar_of(i), sub.seq_of(i), qual,
            sub.aux_of(i), ref_int, ref_int.size, flag)
        if got is None:
            aux_parts.append(sub.aux_of(i))
            continue
        newq, new_aux = got
        sub.qual[sub.seq_off[i]:sub.seq_off[i + 1]] = newq
        aux_parts.append(np.asarray(new_aux, np.uint8))
        aux_changed = True
    if aux_changed:
        new_off = np.zeros(sub.n + 1, np.int64)
        np.cumsum([len(p) for p in aux_parts], out=new_off[1:])
        sub.aux = np.concatenate(aux_parts).astype(np.uint8)
        sub.aux_off = new_off


def _apply_baq_native(sub, ref_int: np.ndarray, device, ref_dev) -> bool:
    """K8 and the host library's batched HMM, when no read may carry a
    stored tag (a byte search of the aux column, conservative).  True when
    it handled the batch.  With no stored tag, flag 7 computes what flag
    3 does."""
    raw = sub.aux.tobytes()
    if b"BQZ" in raw or b"ZQZ" in raw:
        return False
    done = np.zeros(sub.n, bool)
    if device is not None:
        _apply_baq_device(sub, ref_int, done, device, ref_dev)
    rest = np.nonzero(~done)[0]
    if rest.size:
        with metrics.stage("native.baq", rest.size, "reads"):
            idx = _ragged_idx(sub, rest)
            out, _ = native.baq_batch(
                sub.pos[rest], _gather_cigar(sub, rest),
                _cigar_off_of(sub, rest), sub.seq[idx], sub.qual[idx],
                _seq_off_of(sub, rest),
                np.ascontiguousarray(ref_int, np.uint8), flag=3,
                threads=HOST_THREADS)
            sub.qual[idx] = out
    return True


def _ragged_idx(sub, rows):
    lens = sub.seq_off[rows + 1] - sub.seq_off[rows]
    return ragged_gather_indices(sub.seq_off[rows], lens)


def _seq_off_of(sub, rows):
    lens = sub.seq_off[rows + 1] - sub.seq_off[rows]
    off = np.zeros(rows.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off


def _cigar_off_of(sub, rows):
    lens = sub.cigar_off[rows + 1] - sub.cigar_off[rows]
    off = np.zeros(rows.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off


def _gather_cigar(sub, rows):
    lens = sub.cigar_off[rows + 1] - sub.cigar_off[rows]
    return sub.cigar[ragged_gather_indices(sub.cigar_off[rows], lens)]


def _apply_baq_device(sub, ref_int: np.ndarray, done: np.ndarray, device,
                      ref_dev) -> None:
    """K8 over the uniform groups of all-M reads, one group per length L:
    a group goes to K8 when L >= 8, every read has pos + L + 3 inside the
    contig and a first qual other than 0xFF, it holds DEVICE_GROUP_MIN
    reads or more, and ``baq_device.apply_fits`` says K4's shared memory
    for L fits the card (checked before any launch).  The reads K8 does
    not flag risky get its quals and are marked in ``done``; the rest
    stay for the host HMM."""
    n1 = (sub.cigar_off[1:] - sub.cigar_off[:-1]) == 1
    op0 = np.zeros(sub.n, np.uint32)
    op0[n1] = sub.cigar[sub.cigar_off[:-1][n1]]
    lens = sub.seq_off[1:] - sub.seq_off[:-1]
    q0ok = sub.qual[np.minimum(sub.seq_off[:-1], sub.seq_off[-1] - 1)] \
        != 0xFF if sub.seq_off[-1] else np.zeros(sub.n, bool)
    for L in np.unique(lens[n1]):
        L = int(L)
        if L < 8:
            continue
        grp = np.nonzero(n1 & (lens == L) & (op0 == np.uint32(L << 4))
                         & (sub.pos >= 0)
                         & (sub.pos + L + baq_device.APPLY_PAD
                            <= ref_int.size) & q0ok)[0]
        if grp.size < DEVICE_GROUP_MIN or not baq_device.apply_fits(
                L, device):
            continue
        if ref_dev is None:
            ref_dev = h2d(np.ascontiguousarray(ref_int, np.uint8), device)
        idx2 = sub.seq_off[grp][:, None] + np.arange(L)[None, :]
        with metrics.stage("device.baq", grp.size, "reads"):
            out, risky = baq_device.baq_apply_nt16(
                ref_dev, sub.pos[grp].astype(np.int64), sub.seq[idx2],
                sub.qual[idx2])
        ok = ~risky
        sub.qual[idx2[ok].ravel()] = out[ok].ravel()
        done[grp[ok]] = True


def cap_mapq_batch(sub, ref_int: np.ndarray, thres: int) -> np.ndarray:
    """sam_cap_mapq per read (``-C``): the capped mapping quality from
    the mismatch score against the contig's 0-4 codes, or -1 to drop."""
    out = np.zeros(sub.n, np.int64)
    for i in range(sub.n):
        out[i] = _cap_mapq_single(int(sub.pos[i]), sub.cigar_of(i),
                                  sub.seq_of(i),
                                  sub.qual[sub.seq_off[i]:sub.seq_off[i + 1]],
                                  ref_int, ref_int.size, thres)
    return out


def _cap_mapq_single(pos, cigar, seq, qual, ref_int, ref_len, thres) -> int:
    """htslib sam_cap_mapq: t, the quals of the mismatches (each capped at
    33), then its threshold formula."""
    ops = (cigar & 0xF).astype(np.int64)
    lens = (cigar >> 4).astype(np.int64)
    x = pos
    y = 0
    mm = 0
    t = 0.0
    for op, ln in zip(ops, lens):
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            for j in range(ln):
                z = y + j
                if x + j >= ref_len or z >= seq.size:
                    break
                c1 = NT16_INT[seq[z]]
                c2 = ref_int[x + j]
                if c1 != c2 and c1 < 4 and c2 < 4:
                    mm += 1
                    t += qual[z] if qual[z] < 33 else 33
            x += ln
            y += ln
        elif op in (F.CSOFT_CLIP, F.CHARD_CLIP):
            if op == F.CSOFT_CLIP:
                y += ln
        elif op == F.CINS:
            y += ln
        elif op in (F.CDEL, F.CREF_SKIP):
            x += ln
    if t > thres:
        return -1
    t = 1.0 if t < 1.0 else t
    t = math.sqrt(thres / t) * thres - t - 4.343 * math.lgamma(mm + 1)
    return int(t + 0.499) if t > 0 else 0
