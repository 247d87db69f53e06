"""Vectorized window-at-a-time accumulation for `samtools stats`.

Counterpart of samtools_tpu/tools/stats_batch.py.  The per-record oracle
(stats_cmd.Stats.collect) mirrors samtools' collect_stats loop
(stats.c:1212-1515) one alignment at a time.  This module processes a
whole columnar window in a handful of vectorized passes with *identical*
results:

* record filters, flag censuses, insert sizes, indel/length/GC
  histograms: numpy segment-sums;
* the per-base quality and base-per-cycle histograms with each read's GC
  count and qual sum: K12 (ops/stats_kernels.py) on the command's device,
  one launch per chunk; with SAMTPU_DEVICE=0 the host library's
  samtpu_stats_orig_hists (``_orig_read_stats``);
* per-record CRC32 checksums and aux-tag (NM, barcode) lookups: native
  batched C (samtpu_stats_crc32_batch / samtpu_aux_find_batch);
* the order-dependent residue — is_sorted tracking, GC-depth bins, the
  coverage round buffer with its realloc quirks — native sequential C
  (samtpu_stats_cov_gcd), driven here in segments split at buffer-realloc
  records, with fai reference fetches serviced from Python exactly where
  stats.c:1404 does them.

Eligible whenever no per-record-only option is active (target regions,
-I read groups, -p overlap removal, sparse insert sizes, -S splits); the
caller falls back to the oracle otherwise, and SAMTPU_STATS_SCALAR=1
forces the oracle everywhere.  tests/test_torch_stats*.py hold both
paths, on both branches, to the JAX tool's bytes.
"""

from __future__ import annotations

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..io import native
from ..ops import stats_kernels as K

BWA_MIN_RDLEN = 35

# records per vectorized chunk: bounds the flat per-base scratch arrays
# (~100 bytes/record/array) so the working set stays cache/RAM friendly
CHUNK_RECORDS = int(__import__("os").environ.get(
    "SAMTPU_STATS_CHUNK", str(1 << 16)))

_CONSUMES_REF = np.array(F.CIGAR_CONSUMES_REF, np.int64)

# _count_indels icycle advance per op: M/I/S/=/X advance, D/N/H/P don't
_IC_ADV = np.ones(16, np.int64)
for _op in (F.CDEL, F.CREF_SKIP, F.CHARD_CLIP, F.CPAD):
    _IC_ADV[_op] = 0
# _count_mismatches_per_cycle: iref advance (D and M/=/X; N does NOT)
_MREF_ADV = np.zeros(16, np.int64)
for _op in (F.CDEL, F.CMATCH, F.CEQUAL, F.CDIFF):
    _MREF_ADV[_op] = 1
# iread advance (I, S, M/=/X)
_MREAD_ADV = np.zeros(16, np.int64)
for _op in (F.CINS, F.CSOFT_CLIP, F.CMATCH, F.CEQUAL, F.CDIFF):
    _MREAD_ADV[_op] = 1
# icycle advance (I, S, H, M/=/X)
_MCYC_ADV = np.zeros(16, np.int64)
for _op in (F.CINS, F.CSOFT_CLIP, F.CHARD_CLIP, F.CMATCH, F.CEQUAL,
            F.CDIFF):
    _MCYC_ADV[_op] = 1

_MATCHY = np.zeros(16, bool)
for _op in (F.CMATCH, F.CEQUAL, F.CDIFF):
    _MATCHY[_op] = True


def eligible(st) -> bool:
    """Option combinations the batch path covers exactly."""
    return (not st.have_regions and st.rg_set is None
            and not st.info.remove_overlaps and st.isize is not None
            and native.has_stats_native())


def _flat_take(off: np.ndarray, idx: np.ndarray):
    """Flatten ragged segments off[idx[k]]..off[idx[k]+1].

    Returns (flat_idx, seg_id, local, lens, cum) — indices into the flat
    array, owning selected-read ordinal, within-read offset, per-read
    lengths and exclusive cumulative lengths.  Indices are int32 (flat
    columns stay < 2^31 per chunk; CHUNK_RECORDS bounds this) to halve
    memory traffic on the hot per-base phase."""
    lens = (off[idx + 1] - off[idx]).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    total = int(cum[-1])
    dt = np.int32 if int(off[-1]) < 2**31 else np.int64
    seg_id = np.repeat(np.arange(idx.size, dtype=np.int32), lens)
    local = np.arange(total, dtype=dt) - cum.astype(dt)[seg_id]
    flat_idx = off[idx].astype(dt)[seg_id] + local
    return flat_idx, seg_id, local, lens, cum


def _segment_sum(values: np.ndarray, cum: np.ndarray) -> np.ndarray:
    tot = np.concatenate([[0], np.cumsum(values.astype(np.int64))])
    return tot[cum[1:]] - tot[cum[:-1]]


class _AuxShim:
    """Minimal record view for the rare per-record barcode branch."""

    __slots__ = ("aux", "qname")

    def __init__(self, aux, qname):
        self.aux = aux
        self.qname = qname


def _decode_int_aux(aux: np.ndarray, offs: np.ndarray,
                    types: np.ndarray) -> np.ndarray:
    """Vectorized little-endian integer decode at aux[offs] per type."""
    out = np.zeros(offs.size, np.int64)
    a = aux.astype(np.int64)
    for tc, width, signed in (("c", 1, True), ("C", 1, False),
                              ("s", 2, True), ("S", 2, False),
                              ("i", 4, True), ("I", 4, False)):
        m = types == ord(tc)
        if not m.any():
            continue
        o = offs[m]
        v = np.zeros(o.size, np.int64)
        for b in range(width):
            v |= a[o + b] << (8 * b)
        if signed:
            bits = 8 * width
            v = np.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
        out[m] = v
    return out


def collect_batch(st, b, idx) -> None:
    """Accumulate the records b[idx] into st, batch-vectorized.

    Mirrors stats_cmd.Stats.collect exactly; errors raise the same
    StatsError with the same stderr text.  b is a ReadBatch; idx is an
    int64 index array in record order."""
    from . import stats_cmd as S

    info = st.info
    idx = np.asarray(idx, np.int64)
    if idx.size == 0:
        return
    flag = b.flag[idx].astype(np.int64)
    seq_len = (b.seq_off[idx + 1] - b.seq_off[idx]).astype(np.int64)

    # --- filters (stats.c:1224) ------------------------------------------
    keep = np.ones(idx.size, bool)
    if info.flag_require:
        bad = (flag & info.flag_require) != info.flag_require
        st.nreads_filtered += int(bad.sum())
        keep &= ~bad
    if info.flag_filter:
        bad = keep & ((flag & info.flag_filter) != 0)
        st.nreads_filtered += int(bad.sum())
        keep &= ~bad
    if info.filter_readlen != -1:
        keep &= seq_len == info.filter_readlen

    # --- checksums (stats.c:783) -----------------------------------------
    ki = idx[keep]
    if ki.size:
        names, reads, quals = native.stats_crc32_batch(
            b.qname, b.qname_off, b.seq, b.qual, b.seq_off, ki)
        st.chk_names = (st.chk_names + names) & 0xFFFFFFFF
        st.chk_reads = (st.chk_reads + reads) & 0xFFFFFFFF
        st.chk_quals = (st.chk_quals + quals) & 0xFFFFFFFF

    sec = keep & ((flag & F.FSECONDARY) != 0)
    st.nreads_secondary += int(sec.sum())
    rest = keep & ~sec
    st.nreads_supplementary += int((rest
                                    & ((flag & F.FSUPPLEMENTARY) != 0)
                                    ).sum())
    rest &= seq_len > 0
    dup = rest & ((flag & F.FDUP) != 0)
    st.nreads_dup += int(dup.sum())
    st.total_len_dup += int(seq_len[dup].sum())

    order = np.where(
        (flag & F.FPAIRED) != 0,
        ((flag & F.FREAD1) != 0) * 1 + ((flag & F.FREAD2) != 0) * 2,
        S.READ_ORDER_FIRST)

    # unclipped length (bam.c:163 analog)
    allops = (b.cigar & 0xF).astype(np.int64)
    alllens = (b.cigar >> 4).astype(np.int64)
    hc_cum = np.concatenate(
        [[0], np.cumsum(np.where(allops == F.CHARD_CLIP, alllens, 0))])
    read_len = seq_len + (hc_cum[b.cigar_off[idx + 1]]
                          - hc_cum[b.cigar_off[idx]])

    # --- realloc schedule (stats.c:697) ----------------------------------
    # records passing the early gates trigger realloc_buffers when their
    # unclipped length reaches nbases; find the trigger sequence now so
    # histograms can be computed at final size and the native cov pass
    # split at the exact trigger records.
    r_pos = np.flatnonzero(rest)
    r_len = read_len[r_pos]
    # pts: (batch position, trigger read_len, nbases after this realloc)
    pts: list[tuple[int, int, int]] = []
    cur = st.nbases
    scan = 0
    while scan < r_pos.size:
        hit = np.flatnonzero(r_len[scan:] >= cur)
        if hit.size == 0:
            break
        k = scan + int(hit[0])
        cur = 2 * (1 + int(r_len[k]) - cur) + cur
        pts.append((int(r_pos[k]), int(r_len[k]), cur))
        scan = k + 1
    final_nbases = cur
    # per-record nbases in effect (for indel bound errors)
    if pts:
        pt_pos = np.array([p for p, _, _ in pts], np.int64)
        sizes = np.concatenate([[st.nbases],
                                [nn for _, _, nn in pts]]).astype(np.int64)
        nbases_at = sizes[
            np.searchsorted(pt_pos, np.arange(idx.size), side="right")]
    else:
        nbases_at = np.full(idx.size, st.nbases, np.int64)

    # --- scalar counters + mapq ------------------------------------------
    st.max_len = max(st.max_len, int(read_len[rest].max(initial=0)))
    st.max_len_1st = max(
        st.max_len_1st, int(read_len[rest & (order == 1)].max(initial=0)))
    st.max_len_2nd = max(
        st.max_len_2nd, int(read_len[rest & (order == 2)].max(initial=0)))
    mq_mask = rest & ((flag & (F.FUNMAP | F.FSECONDARY | F.FSUPPLEMENTARY
                               | F.FQCFAIL | F.FDUP)) == 0)
    if mq_mask.any():
        st.mapping_qualities += np.bincount(
            b.mapq[idx[mq_mask]].astype(np.int64), minlength=256)[:256]

    # grow the histogram buffers up-front; increments add at final size
    # (growth only zero-pads, so batch-at-final-size == per-record order).
    # The round buffer + rseq buffer are NOT grown here: the native pass
    # below reallocs them at the exact trigger records (byte quirk and
    # mid-file rseq-window sizing included).
    if final_nbases > st.nbases:
        _grow_hists_only(st, final_nbases)
        st.nbases = final_nbases

    orig = rest & ((flag & F.FSUPPLEMENTARY) == 0)
    if orig.any():
        st.read_lengths += np.bincount(read_len[orig],
                                       minlength=st.nbases)[:st.nbases]
        st.read_lengths_1st += np.bincount(
            read_len[orig & (order == 1)], minlength=st.nbases)[:st.nbases]
        st.read_lengths_2nd += np.bincount(
            read_len[orig & (order == 2)], minlength=st.nbases)[:st.nbases]

    gc_count = np.zeros(idx.size, np.int64)
    if orig.any():
        gc_count = _orig_read_stats(st, b, idx, orig, order, flag, seq_len)

    mapped = rest & ((flag & F.FUNMAP) == 0)
    m_pos = np.flatnonzero(mapped)
    if m_pos.size == 0:
        return
    midx = idx[m_pos]

    # mapped read with no cigar -> identical FIXME error (stats.c:1341)
    ncig_per = (b.cigar_off[midx + 1] - b.cigar_off[midx]).astype(np.int64)
    # indels first (scalar order: _count_indels precedes the check, but
    # the check error exits the process either way)
    _count_indels_batch(st, b, midx, order[m_pos], flag[m_pos],
                        seq_len[m_pos], nbases_at[m_pos])

    # insert sizes (stats.c:1302)
    pam = ((flag & F.FPAIRED) != 0) & ((flag & F.FUNMAP) == 0) \
        & ((flag & F.FMUNMAP) == 0)
    _isize_batch(st, b, idx, mapped & pam & orig, flag)

    # NM (stats.c:1330)
    offs, types = native.aux_find_batch(b.aux, b.aux_off, midx, "NM")
    got = offs >= 0
    int_t = np.isin(types, [ord(c) for c in "cCsSiI"])
    easy = got & int_t
    if easy.any():
        st.nmismatches += int(_decode_int_aux(b.aux, offs[easy],
                                              types[easy]).sum())
    hard = np.flatnonzero(got & ~int_t)
    for k in hard:
        gv = auxmod.get_value(b.aux_of(int(midx[k])), "NM")
        if gv is not None:
            st.nmismatches += int(gv[1])

    if (ncig_per == 0).any():
        S.error("FIXME: mapped read with no cigar?\n")

    # bases mapped (cigar) + readlen incl. deletions (stats.c:1337)
    fi, seg, _, _, ccum = _flat_take(b.cigar_off, midx)
    ops = (b.cigar[fi] & 0xF).astype(np.int64)
    lens = (b.cigar[fi] >> 4).astype(np.int64)
    st.nbases_mapped_cigar += int(
        lens[(ops == F.CMATCH) | (ops == F.CINS) | (ops == F.CEQUAL)
             | (ops == F.CDIFF)].sum())
    readlen = seq_len[m_pos] + _segment_sum(
        np.where(ops == F.CDEL, lens, 0), ccum)

    _sorted_block(st, b, idx, m_pos, mapped, gc_count, seq_len, readlen,
                  pts, ops, lens, ccum, fi)


def _grow_hists_only(st, n: int):
    """realloc_buffers minus the round buffer + rseq parts (those are
    grown at exact trigger records by the native pass)."""

    def grow2(a, rows):
        out = np.zeros((rows, a.shape[1]), a.dtype)
        out[: a.shape[0]] = a
        return out

    def grow1(a, rows):
        out = np.zeros(rows, a.dtype)
        out[: a.shape[0]] = a
        return out

    st.quals_1st = grow2(st.quals_1st, n + 1)
    st.quals_2nd = grow2(st.quals_2nd, n + 1)
    if st.mpc_buf is not None:
        st.mpc_buf = grow2(st.mpc_buf, n)
    st.acgtno_cycles_1st = grow2(st.acgtno_cycles_1st, n)
    st.acgtno_cycles_2nd = grow2(st.acgtno_cycles_2nd, n)
    st.acgtno_revcomp = grow2(st.acgtno_revcomp, n)
    st.read_lengths = grow1(st.read_lengths, n)
    st.read_lengths_1st = grow1(st.read_lengths_1st, n)
    st.read_lengths_2nd = grow1(st.read_lengths_2nd, n)
    st.insertions = grow1(st.insertions, n)
    st.deletions = grow1(st.deletions, n)
    st.ins_cycles_1st = grow1(st.ins_cycles_1st, n + 1)
    st.ins_cycles_2nd = grow1(st.ins_cycles_2nd, n + 1)
    st.del_cycles_1st = grow1(st.del_cycles_1st, n + 1)
    st.del_cycles_2nd = grow1(st.del_cycles_2nd, n + 1)


def _orig_read_stats(st, b, idx, orig, order, flag, seq_len) -> np.ndarray:
    """Vectorized _collect_orig_read_stats over orig records; returns
    per-record gc_count (0 for non-orig).  The per-base histograms, GC
    counts and qual sums come from K12 on ``st.info.device``, or from the
    host library's pass when it is None (SAMTPU_DEVICE=0)."""
    info = st.info
    o_pos = np.flatnonzero(orig)
    oidx = idx[o_pos]
    oflag = flag[o_pos]
    olen = seq_len[o_pos]
    oorder = order[o_pos]
    orev = (oflag & F.FREVERSE) != 0

    st.total_len += int(olen.sum())
    st.nreads_QCfailed += int(((oflag & F.FQCFAIL) != 0).sum())
    st.nreads_paired_tech += int(((oflag & F.FPAIRED) != 0).sum())

    if info.device is None:
        # one host pass: hists accumulate in place, per-read GC and qual
        # sums come back for the numpy phases below
        gc_o, qsum_o, mq = native.stats_orig_hists(
            b.seq, b.qual, b.seq_off, oidx, oorder.astype(np.uint8),
            orev.astype(np.uint8), st.nbases, st.quals_1st,
            st.quals_2nd, st.acgtno_cycles_1st, st.acgtno_cycles_2nd,
            st.acgtno_revcomp)
    else:
        # fresh Stats allocate nbases qual rows; realloc'd nbases+1
        # (realloc_buffers quirk); rows past nbases-1 never take counts
        h = K.orig_hists(b.seq, b.qual, b.seq_off, oidx,
                         oorder.astype(np.uint8), orev.astype(np.uint8),
                         st.nbases, st.quals_1st.shape[0], info.device)
        st.quals_1st += h["q1"]
        st.quals_2nd += h["q2"]
        st.acgtno_cycles_1st += h["a1"]
        st.acgtno_cycles_2nd += h["a2"]
        st.acgtno_revcomp += h["ar"]
        gc_o, qsum_o, mq = h["gc"], h["qsum"], int(h["maxq"][0])
    if mq > st.max_qual:
        st.max_qual = mq

    # GC% histograms (diff-array form of the [min,max) slice increment)
    NGC = st.NGC
    for owhich, hist in ((1, st.gc_1st), (2, st.gc_2nd)):
        m = oorder == owhich
        if not m.any():
            continue
        gmin = gc_o[m] * (NGC - 1) // olen[m]
        gmax = np.minimum((gc_o[m] + 1) * (NGC - 1) // olen[m], NGC - 1)
        d = np.zeros(NGC + 1, np.int64)
        np.add.at(d, gmin, 1)
        np.add.at(d, gmax, -1)
        hist += np.cumsum(d)[:NGC]

    m1 = oorder == 1
    m2 = oorder == 2
    st.nreads_1st += int(m1.sum())
    st.nreads_2nd += int(m2.sum())
    st.nreads_other += int((~m1 & ~m2).sum())
    st.total_len_1st += int(olen[m1].sum())
    st.total_len_2nd += int(olen[m2].sum())

    if info.trim_qual > 0:
        fi, _seg, _local, _lens, cum = _flat_take(b.seq_off, oidx)
        st.nbases_trimmed += _bwa_trim_batch(info.trim_qual, b.qual[fi],
                                             olen, orev, cum)

    q12 = m1 | m2
    # sum_qual: per-read float64 adds in record order (C double += )
    if q12.any():
        per_read = qsum_o[q12].astype(np.float64)
        st.sum_qual = float(np.cumsum(
            np.concatenate([[st.sum_qual], per_read]))[-1])

    # barcode tags: batch-probe; only records that have one take the
    # per-record branch (warnings print in record order)
    first = np.flatnonzero(m1)
    if first.size:
        fidx = oidx[first]
        hits = np.zeros(first.size, bool)
        for bc in st.tags_barcode:
            offs, types = native.aux_find_batch(b.aux, b.aux_off, fidx,
                                                bc.tag_name)
            hits |= (offs >= 0) & (types == ord("Z"))
        for k in np.flatnonzero(hits):
            i = int(fidx[k])
            st._collect_barcode_stats(_AuxShim(
                b.aux_of(i), b.qname_str(i).encode("latin-1")))

    unm = (oflag & F.FUNMAP) != 0
    st.nreads_unmapped += int(unm.sum())
    mp = ~unm
    st.nbases_mapped += int(olen[mp].sum())
    st.nreads_mq0 += int((mp & (b.mapq[oidx] == 0)).sum())
    pam = mp & ((oflag & F.FPAIRED) != 0) & ((oflag & F.FMUNMAP) == 0)
    st.nreads_single_mapped += int((mp & ~pam).sum())
    st.nreads_paired_and_mapped += int(pam.sum())
    st.nreads_properly_paired += int(
        (pam & ((oflag & F.FPROPER_PAIR) != 0)).sum())
    st.nreads_anomalous += int(
        (pam & (b.tid[oidx] != b.mtid[oidx])).sum())

    out = np.zeros(idx.size, np.int64)
    out[o_pos] = gc_o
    return out


def _bwa_trim_batch(trim_qual: int, qual: np.ndarray, olen: np.ndarray,
                    orev: np.ndarray, cum: np.ndarray) -> int:
    """Vectorized _bwa_trim_read (stats.c:398) over the flat qual array."""
    n = olen.size
    ok = np.flatnonzero(olen >= BWA_MIN_RDLEN)
    if ok.size == 0:
        return 0
    total = 0
    # build per-read traversal streams: l = 0..max_trimmed-1, reading
    # qual[l] on reverse reads and qual[len-1-l] on forward reads
    mt = (olen[ok] - BWA_MIN_RDLEN + 1).astype(np.int64)
    tcum = np.concatenate([[0], np.cumsum(mt)])
    tot = int(tcum[-1])
    seg = np.repeat(np.arange(ok.size, dtype=np.int64), mt)
    l = np.arange(tot, dtype=np.int64) - tcum[seg]
    base = cum[ok][seg]
    li = np.where(orev[ok][seg], l, olen[ok][seg] - 1 - l)
    terms = np.int64(trim_qual) - qual[base + li].astype(np.int64)
    c = np.cumsum(terms)
    c = c - np.concatenate([[0], c[tcum[1:-1] - 1]])[seg]
    Lmax = int(mt.max())
    BASE = Lmax + 1
    big = np.iinfo(np.int64).max
    neg_l = np.where(c < 0, l, big)
    first_neg = np.minimum.reduceat(neg_l, tcum[:-1])
    valid = l < first_neg[seg]
    pref = np.where(valid, c * BASE + (BASE - 1 - l), -1)
    m = np.maximum.reduceat(pref, tcum[:-1])
    cval = m // BASE
    trimmed = np.where((m >= 0) & (cval > 0), BASE - 1 - (m % BASE), 0)
    total = int(trimmed.sum())
    _ = n
    return total


def _count_indels_batch(st, b, midx, order_m, flag_m, seq_len_m,
                        nbases_at_m):
    """Vectorized _count_indels (stats.c:421) over mapped records."""
    from . import stats_cmd as S

    fi, seg, ci, _, ccum = _flat_take(b.cigar_off, midx)
    if fi.size == 0:
        return
    ops = (b.cigar[fi] & 0xF).astype(np.int64)
    lens = (b.cigar[fi] >> 4).astype(np.int64)
    adv = np.where(lens > 0, _IC_ADV[ops] * lens, 0)
    csum = np.cumsum(adv)
    icycle = csum - adv - np.concatenate(
        [[0], csum[ccum[1:-1] - 1]])[seg]
    fwd = (flag_m & F.FREVERSE) == 0
    fwd_b = fwd[seg]
    rl = seq_len_m[seg]
    nb = nbases_at_m[seg]
    ordb = order_m[seg]

    ins = (ops == F.CINS) & (lens > 0)
    dele = (ops == F.CDEL) & (lens > 0)
    iidx = np.where(fwd_b, icycle, rl - icycle - lens)
    didx = np.where(fwd_b, icycle - 1, rl - icycle - 1)
    # cross-kind first-error in op order (the error exits the process with
    # the same FIXME message the scalar loop prints)
    ins_bad = ins & ((iidx < 0) | (iidx >= nb))
    del_bad = dele & (didx >= 0) & (didx >= nb)
    bad = ins_bad | del_bad
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        v = int(iidx[k]) if ins_bad[k] else int(didx[k])
        S.error("FIXME: %d vs %d\n" % (v, int(nb[k])))
    if ins.any():
        o = ordb
        st.ins_cycles_1st += np.bincount(
            iidx[ins & (o == 1)],
            minlength=st.nbases + 1)[: st.nbases + 1]
        st.ins_cycles_2nd += np.bincount(
            iidx[ins & (o == 2)],
            minlength=st.nbases + 1)[: st.nbases + 1]
        ok = ins & (lens <= st.nindels)
        st.insertions += np.bincount(
            lens[ok] - 1, minlength=st.nbases)[: st.nbases]
    if dele.any():
        keep = dele & (didx >= 0)
        o = ordb
        st.del_cycles_1st += np.bincount(
            didx[keep & (o == 1)],
            minlength=st.nbases + 1)[: st.nbases + 1]
        st.del_cycles_2nd += np.bincount(
            didx[keep & (o == 2)],
            minlength=st.nbases + 1)[: st.nbases + 1]
        ok = keep & (lens <= st.nindels)
        st.deletions += np.bincount(
            lens[ok] - 1, minlength=st.nbases)[: st.nbases]


def _isize_batch(st, b, idx, mask, flag):
    """Vectorized insert-size classification (stats.c:1302), dense mode."""
    info = st.info
    p = np.flatnonzero(mask)
    if p.size == 0:
        return
    pidx = idx[p]
    fl = flag[p]
    isize = np.abs(b.tlen[pidx].astype(np.int64))
    if info.nisize > 0:
        isize = np.minimum(isize, info.nisize)
    use = (isize > 0) | (b.tid[pidx] == b.mtid[pidx])
    if not use.any():
        return
    isize = isize[use]
    fl = fl[use]
    pidx = pidx[use]
    pos_fst = (b.mpos[pidx] - b.pos[pidx]).astype(np.int64)
    is_fst = np.where((fl & F.FREAD1) != 0, 1, -1)
    is_fwd = np.where((fl & F.FREVERSE) != 0, -1, 1)
    is_mfwd = np.where((fl & F.FMREVERSE) != 0, -1, 1)
    ff = is_fst * pos_fst
    col = np.select(
        [is_fwd * is_mfwd > 0,
         (ff > 0) & (is_fst * is_fwd > 0), ff > 0,
         (ff < 0) & (is_fst * is_fwd > 0), ff < 0],
        [2, 0, 1, 1, 0], default=0)
    st.isize += np.bincount(
        isize * 3 + col,
        minlength=(info.nisize + 1) * 3).reshape(-1, 3)[: info.nisize + 1]


def _sorted_block(st, b, idx, m_pos, mapped, gc_count, seq_len, readlen,
                  pts, ops, lens, ccum, fi):
    """Native-driven sorted-block residue + vectorized fai mismatches."""
    from . import stats_cmd as S

    info = st.info
    n = idx.size
    active = np.zeros(n, np.uint8)
    active[m_pos] = 1
    tid_a = np.ascontiguousarray(b.tid[idx], np.int32)
    pos_a = np.ascontiguousarray(b.pos[idx], np.int64)
    rl_a = np.zeros(n, np.int64)
    rl_a[m_pos] = readlen
    gc_term = np.zeros(n, np.float32)
    gc_term[m_pos] = (gc_count[m_pos].astype(np.float32)
                      / seq_len[m_pos].astype(np.float32))

    # absolute [beg,end) spans of M/=/X ops per active record
    matchy = _MATCHY[ops]
    refadv = np.where(_CONSUMES_REF[ops] > 0, lens, 0)
    rcs = np.cumsum(refadv)
    seg = np.repeat(np.arange(m_pos.size, dtype=np.int64),
                    (ccum[1:] - ccum[:-1]))
    op_refoff = rcs - refadv - np.concatenate(
        [[0], rcs[ccum[1:-1] - 1]])[seg]
    abs_beg_all = b.pos[idx[m_pos]].astype(np.int64)[seg] + op_refoff
    sp_beg = abs_beg_all[matchy]
    sp_end = sp_beg + lens[matchy]
    nsp = _segment_sum(matchy, ccum)
    span_off = np.zeros(n + 1, np.int64)
    span_off[m_pos + 1] = nsp
    span_off = np.cumsum(span_off)

    state = np.zeros(16, np.int64)
    state[0] = st.rbuf_start
    state[1] = st.rbuf_pos
    state[2] = st.tid
    state[3] = st.gcd_pos
    state[4] = st.igcd
    state[5] = st.is_sorted
    state[6] = st.pos
    state[7] = 0
    state[8] = -1
    state[12] = -1
    state[13] = st.rseq_pos
    state[14] = st.nrseq_buf

    fai_mode = 1 if info.fai is not None else 0
    gcd_gc = np.array([g for g, _ in st.gcd], np.float32)
    gcd_depth = np.array([d for _, d in st.gcd], np.int64)

    def grow_gcd(need):
        nonlocal gcd_gc, gcd_depth
        cap = max(need + 1, gcd_gc.size * 2, 16)
        gcd_gc = np.concatenate(
            [gcd_gc, np.zeros(cap - gcd_gc.size, np.float32)])
        gcd_depth = np.concatenate(
            [gcd_depth, np.zeros(cap - gcd_depth.size, np.int64)])

    grow_gcd(int(state[4]) + 8)

    # (start record, rseq_pos, nrseq_buf) segments for fai mismatches
    rseq_segs: list[tuple[int, int, int]] = [
        (0, int(state[13]), int(state[14]))]
    unsorted_at = None

    def drive(limit):
        nonlocal unsorted_at
        while state[7] < limit:
            rc = native.stats_cov_gcd(
                limit, state, tid_a, pos_a, rl_a, active, gc_term,
                span_off, sp_beg, sp_end, fai_mode, info.gcd_bin_size,
                st.rbuf, st.cov, info.cov_min, info.cov_max,
                info.cov_step, gcd_gc, gcd_depth)
            if rc == 0:
                break
            if rc == 1:
                _service_fai(int(state[9]))
            elif rc == 3:
                grow_gcd(int(state[4]) + 8)
            elif rc == -1:
                S.error("The read length too big (%d), please increase "
                        "the buffer length (currently %d)\n"
                        % (int(state[10]), int(state[11])))
            elif rc == -3:
                S.error("The reads are not sorted (%d comes after "
                        "%d).\n" % (int(state[10]), int(state[11])))
            elif rc == -4:
                S.error("Expected coordinates in ascending order, got "
                        "%d after %d\n"
                        % (int(state[10]), int(state[11])))
            else:
                raise RuntimeError("native stats pass code %d" % rc)
        if state[12] >= 0 and unsorted_at is None:
            unsorted_at = int(state[12])

    def _service_fai(i):
        """The inc_ref/inc_gcd branch of stats.c:1404, in Python."""
        # sync native state back into st for read_ref_seq/fai_gc_content
        st.rseq_pos = int(state[13])
        st.nrseq_buf = int(state[14])
        st.tid = int(state[2])
        st.gcd_pos = int(state[3])
        st.igcd = int(state[4])
        rtid = int(tid_a[i])
        rpos = int(pos_a[i])
        rlen = int(rl_a[i])
        inc_ref = inc_gcd = 0
        if (st.rseq_pos == -1 or st.tid != rtid
                or st.rseq_pos + st.nrseq_buf < rpos + rlen):
            inc_ref = rpos + rlen
            inc_gcd = 1
        elif st.gcd_pos + info.gcd_bin_size < rpos + rlen:
            inc_gcd = 1
            if st.rseq_pos + st.nrseq_buf < rpos + info.gcd_bin_size:
                inc_ref = rpos + info.gcd_bin_size
        if inc_gcd:
            st.igcd += 1
            if st.igcd + 1 >= gcd_gc.size:
                grow_gcd(st.igcd + 8)
            if inc_ref:
                st.read_ref_seq(rtid, rpos, inc_ref)
            st.gcd_pos = rpos
            gcd_gc[st.igcd] = st.fai_gc_content(st.gcd_pos,
                                                info.gcd_bin_size)
        state[2] = st.tid
        state[3] = st.gcd_pos
        state[4] = st.igcd
        state[8] = i
        state[13] = st.rseq_pos
        state[14] = st.nrseq_buf
        rseq_segs.append((i, st.rseq_pos, st.nrseq_buf))

    steps = [(p, ln, nn) for p, ln, nn in pts] + [(n, None, None)]
    for limit, newlen, newnb in steps:
        drive(limit)
        if newlen is not None:
            # realloc at the exact trigger record, rbuf byte quirk and all
            st.rbuf_start = int(state[0])
            _rbuf_realloc(st, newlen, newnb)
            state[0] = st.rbuf_start

    # final state sync
    st.rbuf_start = int(state[0])
    st.rbuf_pos = int(state[1])
    st.tid = int(state[2])
    st.gcd_pos = int(state[3])
    st.igcd = int(state[4])
    st.is_sorted = int(state[5])
    st.pos = int(state[6])
    st.rseq_pos = int(state[13])
    st.nrseq_buf = int(state[14])
    st.gcd = [[np.float32(gcd_gc[k]), int(gcd_depth[k])]
              for k in range(max(st.igcd + 1, 1))]

    if fai_mode:
        _mismatches_batch(st, b, idx, m_pos, seq_len, unsorted_at,
                          rseq_segs, ops, lens, ccum, fi, seg)


def _rbuf_realloc(st, read_len: int, new_nbases: int):
    """The round-buffer + rseq part of realloc_buffers (stats.c:697) —
    the histogram arrays were already grown batch-wide.  new_nbases is
    the nbases value this realloc step produces (the step sequence was
    precomputed; st.nbases already holds the batch-final value)."""
    new = np.zeros(read_len * 5, np.int32)
    old_b = st.rbuf.view(np.uint8)
    new_b = new.view(np.uint8)
    nb = st.rbuf.size - st.rbuf_start
    src = old_b[st.rbuf_start * 4:]
    new_b[:nb] = src[:nb]
    if st.rbuf_start > 1:
        new_b[nb * 4: nb * 4 + st.rbuf_start] = old_b[: st.rbuf_start]
    st.rbuf = new
    st.rbuf_start = 0
    m = max(new_nbases * 10, st.info.gcd_bin_size)
    if st.mrseq_buf < m:
        buf = np.zeros(m, np.uint8)
        buf[: st.mrseq_buf] = st.rseq_buf
        st.rseq_buf = buf
        st.mrseq_buf = m


def _mismatches_batch(st, b, idx, m_pos, seq_len, unsorted_at, rseq_segs,
                      ops, lens, ccum, fi, seg):
    """Vectorized _count_mismatches_per_cycle (stats.c:477)."""
    from . import stats_cmd as S

    # participating: active records strictly before any unsorted flip
    part = np.ones(m_pos.size, bool)
    if st.is_sorted == 0:
        if unsorted_at is None:
            part[:] = False          # unsorted since a previous batch
        else:
            part = m_pos < unsorted_at
    if not part.any():
        return
    op_part = part[seg]

    bad_op = op_part & ~np.isin(
        ops, [F.CINS, F.CDEL, F.CSOFT_CLIP, F.CHARD_CLIP, F.CREF_SKIP,
              F.CPAD, F.CMATCH, F.CEQUAL, F.CDIFF])
    if bad_op.any():
        S.error("TODO: cigar %d\n" % int(ops[np.flatnonzero(bad_op)[0]]))

    # per-op prefix offsets within each read
    def prefix(advtab):
        a = np.where(lens > 0, advtab[ops] * lens, 0)
        cs = np.cumsum(a)
        return cs - a - np.concatenate([[0], cs[ccum[1:-1] - 1]])[seg]

    iref_off = prefix(_MREF_ADV)
    iread_off = prefix(_MREAD_ADV)
    icyc_off = prefix(_MCYC_ADV)

    matchy = _MATCHY[ops] & op_part
    # bounds check against the rseq window each record saw (FIXME parity)
    recpos = b.pos[idx[m_pos]].astype(np.int64)
    seg_starts = np.array([s for s, _, _ in rseq_segs], np.int64)
    seg_rpos = np.array([r for _, r, _ in rseq_segs], np.int64)
    seg_nbuf = np.array([nb for _, _, nb in rseq_segs], np.int64)
    which = np.searchsorted(seg_starts, m_pos, side="right") - 1
    rec_rpos = seg_rpos[which]
    rec_nbuf = seg_nbuf[which]
    if matchy.any():
        iref_abs = recpos[seg][matchy] + iref_off[matchy]
        over = lens[matchy] + (iref_abs - rec_rpos[seg][matchy]) \
            > rec_nbuf[seg][matchy]
        if over.any():
            k = np.flatnonzero(matchy)[np.flatnonzero(over)[0]]
            S.error("FIXME: %d+%d > %d\n"
                    % (int(lens[k]),
                       int(recpos[seg[k]] + iref_off[k]
                           - rec_rpos[seg[k]]),
                       int(rec_nbuf[seg[k]])))

    mids = np.flatnonzero(matchy)
    if mids.size == 0:
        return
    mlens = lens[mids]
    bcum = np.concatenate([[0], np.cumsum(mlens)])
    total = int(bcum[-1])
    if total == 0:
        return
    bseg = np.repeat(np.arange(mids.size, dtype=np.int64), mlens)
    blocal = np.arange(total, dtype=np.int64) - bcum[bseg]
    oseg = seg[mids][bseg]                      # owning mapped-record row
    ref_abs = (recpos[oseg] + iref_off[mids][bseg] + blocal)
    seq_starts = b.seq_off[idx[m_pos]].astype(np.int64)
    read_i = seq_starts[oseg] + iread_off[mids][bseg] + blocal
    cread = b.seq[read_i].astype(np.int64)
    quals = b.qual[read_i].astype(np.int64)
    cyc = icyc_off[mids][bseg] + blocal
    rl_unclipped = np.zeros(m_pos.size, np.int64)
    # unclipped length again (hard clips)
    hc = (ops == F.CHARD_CLIP)
    rl_unclipped = seq_len[m_pos] + _segment_sum(
        np.where(hc, lens, 0), ccum)
    rev = (b.flag[idx[m_pos]].astype(np.int64) & F.FREVERSE) != 0
    cyc = np.where(rev[oseg], rl_unclipped[oseg] - cyc - 1, cyc)

    # reference codes per tid from the fai (same values as rseq_buf)
    cref = np.zeros(total, np.int64)
    tids = b.tid[idx[m_pos]].astype(np.int64)
    btids = tids[oseg]
    for t in np.unique(btids):
        m = btids == t
        name = st.info.header.ref_name(int(t))
        if not st.info.fai.has(name):
            S.error("Failed to fetch the sequence \"%s\"\n" % name)
        lo = int(ref_abs[m].min())
        hi = int(ref_abs[m].max()) + 1
        raw = st.info.fai.fetch(name, lo, hi)
        codes = S._REF_CODE[np.frombuffer(raw, np.uint8)]
        rel = ref_abs[m] - lo
        got = np.zeros(m.sum(), np.int64)
        inb = rel < codes.size
        got[inb] = codes[rel[inb]]
        cref[m] = got

    is_n = cread == 15
    mpc = st.mpc_buf
    if is_n.any():
        np.add.at(mpc, (cyc[is_n], 0), 1)
    mism = (cref != 0) & (cread != 0) & (cref != cread) & ~is_n
    if mism.any():
        q = (quals[mism] + 1) & 0xFF
        np.add.at(mpc, (cyc[mism], q), 1)
