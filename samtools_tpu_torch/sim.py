"""Seeded read simulation (wgsim analog), numpy only.

Counterpart of samtools_tpu/sim.py (:22-122): the same seed gives the
same batch as the JAX package.  ``simulate_messy`` is a vectorized form
of the JAX package's bench workload with indels and soft clips.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core import flags as F
from .core.batch import ReadBatch, ragged_gather_indices
from .io.header import SamHeader

# nt16 codes for A,C,G,T
_ACGT16 = np.array([1, 2, 4, 8], np.uint8)


def simulate_reference(ref_len: int, seed: int = 0) -> np.ndarray:
    """uint8 ACGT ascii reference of the given length."""
    rng = np.random.RandomState(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, ref_len)]


def make_header(ref_len: int, name: str = "sim1") -> SamHeader:
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{name}\tLN:{ref_len}\n"
    return SamHeader.from_text(text)


def simulate_batch(ref_len: int = 8 << 20, coverage: float = 30.0,
                   read_len: int = 100, seed: int = 42,
                   paired: bool = True, err_rate: float = 0.01,
                   ref: np.ndarray | None = None) -> ReadBatch:
    """Coordinate-sorted single-contig ReadBatch at the given coverage:
    copies of ``ref`` (or random bases if None) with ``err_rate`` random
    substitutions, one full-length M op per read."""
    rng = np.random.RandomState(seed)
    n = int(ref_len * coverage / read_len)
    if paired:
        n &= ~1
    pos = np.sort(rng.randint(0, ref_len - read_len, n)).astype(np.int64)

    b = ReadBatch()
    b.n = n
    b.tid = np.zeros(n, np.int32)
    b.pos = pos
    b.mapq = rng.randint(20, 60, n).astype(np.uint8)
    flag = np.zeros(n, np.uint16)
    rev = rng.rand(n) < 0.5
    flag[rev] |= 0x10
    if paired:
        # mate = the read with the adjacent index after a seeded shuffle
        pairs = rng.permutation(n).reshape(-1, 2)
        mate_of = np.empty(n, np.int64)
        mate_of[pairs[:, 0]] = pairs[:, 1]
        mate_of[pairs[:, 1]] = pairs[:, 0]
        flag |= 0x1 | 0x2
        first = np.zeros(n, bool)
        first[pairs[:, 0]] = True
        flag[first] |= 0x40
        flag[~first] |= 0x80
        flag[rev[mate_of]] |= 0x20
        b.mtid = np.zeros(n, np.int32)
        b.mpos = pos[mate_of]
        b.tlen = np.where(b.mpos >= pos, b.mpos - pos + read_len,
                          -(pos - b.mpos + read_len))
        pair_id = np.empty(n, np.int64)
        pair_id[pairs[:, 0]] = np.arange(n // 2)
        pair_id[pairs[:, 1]] = np.arange(n // 2)
    else:
        b.mtid = np.full(n, -1, np.int32)
        b.mpos = np.full(n, -1, np.int64)
        b.tlen = np.zeros(n, np.int64)
        pair_id = np.arange(n)
    b.flag = flag

    # "simNNNN" names, fixed-width zero-padded digits: a dense byte matrix
    width = max(1, len(str(max(int(pair_id.max(initial=0)), 1))))
    mat = np.empty((n, 3 + width), np.uint8)
    mat[:, 0:3] = np.frombuffer(b"sim", np.uint8)
    v = pair_id.copy()
    for d in range(width - 1, -1, -1):
        mat[:, 3 + d] = 48 + (v % 10)
        v //= 10
    b.qname = mat.ravel()
    b.qname_off = np.arange(0, n * (3 + width) + 1, 3 + width,
                            dtype=np.int64)

    b.cigar = np.full(n, (read_len << 4) | F.CMATCH, np.uint32)
    b.cigar_off = np.arange(n + 1, dtype=np.int64)

    if ref is None:
        codes = _ACGT16[rng.randint(0, 4, n * read_len)]
    else:
        idx = (pos[:, None] + np.arange(read_len)[None, :]).ravel()
        lut = np.zeros(256, np.uint8)
        lut[np.frombuffer(b"ACGT", np.uint8)] = _ACGT16
        codes = lut[ref[idx]]
    if err_rate > 0:
        errs = rng.rand(codes.size) < err_rate
        codes[errs] = _ACGT16[rng.randint(0, 4, int(errs.sum()))]
    b.seq = codes
    b.seq_off = np.arange(0, n * read_len + 1, read_len, dtype=np.int64)
    b.qual = rng.randint(2, 41, n * read_len).astype(np.uint8)
    b.aux = np.empty(0, np.uint8)
    b.aux_off = np.zeros(n + 1, np.int64)
    return b


def simulate_messy(b: ReadBatch, seed: int) -> ReadBatch:
    """Rewrite the cigars of ``b`` in place: ~10% of reads carry a 3 bp
    insertion, ~8% a 2 bp deletion, ~15% an 8 bp leading soft clip (the
    messy workload of the JAX package's bench, drawn the same way)."""
    kind = np.random.default_rng(seed).random(b.n)
    L = b.l_qseq.astype(np.uint32)
    ins = kind < 0.10
    dele = (kind >= 0.10) & (kind < 0.18)
    clip = (kind >= 0.18) & (kind < 0.33)
    nops = np.where(ins | dele, 3, np.where(clip, 2, 1))
    off = np.zeros(b.n + 1, np.int64)
    np.cumsum(nops, out=off[1:])
    cig = np.empty(int(off[-1]), np.uint32)
    s = off[:-1]

    def put(mask, k, ln, op):
        cig[s[mask] + k] = (ln[mask] << 4) | op

    plain = nops == 1
    put(plain, 0, L, F.CMATCH)
    a = L // 3
    put(ins, 0, a, F.CMATCH)
    put(ins, 1, np.full_like(L, 3), F.CINS)
    put(ins, 2, L - a - 3, F.CMATCH)
    a = L // 2
    put(dele, 0, a, F.CMATCH)
    put(dele, 1, np.full_like(L, 2), F.CDEL)
    put(dele, 2, L - a, F.CMATCH)
    put(clip, 0, np.full_like(L, 8), F.CSOFT_CLIP)
    put(clip, 1, L - 8, F.CMATCH)
    b.cigar = cig
    b.cigar_off = off
    return b


def simulate_overlapping_pairs(ref_len: int, coverage: float = 30.0,
                               read_len: int = 100, seed: int = 42,
                               err_rate: float = 0.01,
                               ref: np.ndarray | None = None) -> ReadBatch:
    """Coordinate-sorted properly paired reads whose mates overlap: each
    second mate starts 20-80 bp after its first mate, on the reverse
    strand, with the same qname ("pNNN") and flags 0x1|0x2|0x40 (first,
    with 0x20) or 0x1|0x2|0x80|0x10 (second); then ``simulate_messy``'s
    indels and soft clips.  Copies of ``ref`` (or random bases if None)
    with ``err_rate`` random substitutions."""
    rng = np.random.RandomState(seed)
    n_pairs = int(ref_len * coverage / read_len) // 2
    first = np.sort(rng.randint(0, ref_len - read_len - 80, n_pairs))
    second = first + rng.randint(20, 81, n_pairs)
    pos = np.concatenate([first, second]).astype(np.int64)
    mate = np.concatenate([second, first]).astype(np.int64)
    is_first = np.arange(2 * n_pairs) < n_pairs
    pair_id = np.concatenate([np.arange(n_pairs)] * 2)
    order = np.argsort(pos, kind="stable")
    pos, mate, is_first, pair_id = (pos[order], mate[order], is_first[order],
                                    pair_id[order])
    n = pos.size

    b = ReadBatch(n=n)
    b.tid = np.zeros(n, np.int32)
    b.pos = pos
    b.mapq = rng.randint(20, 60, n).astype(np.uint8)
    b.flag = np.where(is_first, 0x1 | 0x2 | 0x40 | 0x20,
                      0x1 | 0x2 | 0x80 | 0x10).astype(np.uint16)
    b.mtid = np.zeros(n, np.int32)
    b.mpos = mate
    b.tlen = np.where(is_first, mate - pos + read_len,
                      -(pos - mate + read_len))
    width = len(str(max(n_pairs - 1, 1)))
    mat = np.empty((n, 1 + width), np.uint8)
    mat[:, 0] = ord("p")
    v = pair_id.copy()
    for d in range(width, 0, -1):
        mat[:, d] = 48 + (v % 10)
        v //= 10
    b.qname = mat.ravel()
    b.qname_off = np.arange(0, n * (1 + width) + 1, 1 + width, dtype=np.int64)
    if ref is None:
        codes = _ACGT16[rng.randint(0, 4, n * read_len)]
    else:
        lut = np.zeros(256, np.uint8)
        lut[np.frombuffer(b"ACGT", np.uint8)] = _ACGT16
        codes = lut[ref[(pos[:, None] + np.arange(read_len)).ravel()]]
    errs = rng.rand(codes.size) < err_rate
    codes[errs] = _ACGT16[rng.randint(0, 4, int(errs.sum()))]
    b.seq = codes
    b.seq_off = np.arange(0, n * read_len + 1, read_len, dtype=np.int64)
    b.qual = rng.randint(2, 41, n * read_len).astype(np.uint8)
    b.aux_off = np.zeros(n + 1, np.int64)
    return simulate_messy(b, seed)


# pad_reads: about one reference base in this many gets pad columns
_PAD_EVERY = 40


def pad_reads(refs: list, b: ReadBatch, seed: int):
    """A padded copy of unpadded reads, the input of ``depad``: pad
    columns (``*``) go into each contig's reference, one to three at
    about one base in _PAD_EVERY and as many as the longest insertion at
    each insertion site, and each read's CIGAR is rewritten along the
    padded reference with M and D only (``depad`` refuses I and P): an
    inserted base is an M on a pad column, a pad column the read passes
    with no base a D.  A read whose alignment opens with an insertion
    starts on a pad column.  ``refs`` are the contigs' ASCII bases (uint8
    arrays) by tid.  Returns (padded references, padded batch);
    ``depad`` gives back each read's position and reference span."""
    rng = np.random.default_rng(seed)
    gaps = []
    for ref in refs:
        g = np.zeros(len(ref) + 1, np.int64)
        sites = rng.random(len(ref) + 1) < 1.0 / _PAD_EVERY
        sites[0] = False
        g[sites] = rng.integers(1, 4, int(sites.sum()))
        gaps.append(g)
    cigars = [b.cigar_of(i) for i in range(b.n)]
    for i in range(b.n):
        r = int(b.pos[i])
        if b.tid[i] < 0 or r < 0:
            continue
        for c in cigars[i]:
            op, ln = int(c) & 0xF, int(c) >> 4
            if op == F.CINS:
                gaps[b.tid[i]][r] = max(gaps[b.tid[i]][r], ln)
            elif F.CIGAR_CONSUMES_REF[op]:
                r += ln
    # cum[t][u]: pad columns before unpadded base u (gap u included)
    cum = [np.cumsum(g) for g in gaps]
    padded = []
    for ref, c in zip(refs, cum):
        out = np.full(len(ref) + int(c[-1]), ord("*"), np.uint8)
        out[np.arange(len(ref)) + c[:-1]] = ref
        padded.append(out)

    pos = b.pos.copy()
    mpos = b.mpos.copy()
    for t in range(len(refs)):
        m = (b.tid == t) & (b.pos >= 0)
        pos[m] = b.pos[m] + cum[t][b.pos[m]]
        m = (b.mtid == t) & (b.mpos >= 0)
        mpos[m] = b.mpos[m] + cum[t][b.mpos[m]]
    new_cig = []
    for i in range(b.n):
        tid, r = int(b.tid[i]), int(b.pos[i])
        if tid < 0 or r < 0 or not len(cigars[i]):
            new_cig.append(cigars[i])
            continue
        g = gaps[tid]
        ops: list = []

        def put(op, ln):
            if ln <= 0:
                return
            if ops and ops[-1][0] == op:
                ops[-1][1] += ln
            else:
                ops.append([op, ln])
        crossed = r        # gap r lies before the read's first base
        started = False
        for c in cigars[i]:
            op, ln = int(c) & 0xF, int(c) >> 4
            if op in (F.CSOFT_CLIP, F.CHARD_CLIP):
                put(op, ln)
            elif op == F.CINS:
                if started:
                    put(F.CDEL, int(g[r]) - ln)
                else:
                    pos[i] -= ln
                put(F.CMATCH, ln)
                crossed = r
                started = True
            elif F.CIGAR_CONSUMES_REF[op]:
                kind = F.CMATCH if F.CIGAR_CONSUMES_QUERY[op] else F.CDEL
                start = r
                for u in (np.nonzero(g[r:r + ln])[0] + r).tolist():
                    if u != crossed:
                        put(kind, u - start)
                        put(F.CDEL, int(g[u]))
                        start = u
                put(kind, r + ln - start)
                r += ln
                crossed = -1
                started = True
        new_cig.append(np.array([(ln << 4) | op for op, ln in ops],
                                np.uint32))
    out = b.take(np.arange(b.n))
    out.pos = pos
    out.mpos = mpos
    out.cigar = (np.concatenate(new_cig) if new_cig
                 else np.empty(0, np.uint32))
    out.cigar_off = np.concatenate(
        [[0], np.cumsum([len(c) for c in new_cig])]).astype(np.int64)
    return padded, out


# the shape of the ARTIC SARS-CoV-2 V3 scheme: one contig of 29,903 bases
# (its GenBank accession) tiled by 98 overlapping amplicons of about 400
# bases in two pools, primers of 22-26 bases
ARTIC_CONTIG = ("MN908947.3", 29903, 98)
ARTIC_SCHEME = "nCoV-2019"
# an amplicon sample's read length and substitution rate, and the seed of
# the panel every sample shares
AMPLICON_READ_LEN = 150
AMPLICON_ERR_RATE = 0.003
AMPLICON_PANEL_SEED = 0

# nt16 code -> base index 0-3 (A, C, G, T); ASCII base -> nt16 code
_BASE_OF_NT16 = np.zeros(16, np.int64)
_BASE_OF_NT16[_ACGT16] = np.arange(4)
_NT16_OF_ASCII = np.zeros(256, np.uint8)
_NT16_OF_ASCII[np.frombuffer(b"ACGT", np.uint8)] = _ACGT16


@dataclass
class AmpliconPanel:
    """An amplicon panel and one sample's reads (``amplicon_panel``).

    ``bed`` is the primers' 6-column BED text (score: the pool);
    ``lefts`` the (start, end) of each amplicon's left primers, main
    first, by the amplicon's number over all contigs; ``amplicon`` that
    number for each record of ``batch``, the template's (-1 for a
    secondary, supplementary or unplaced record)."""
    header: SamHeader
    bed: str
    lefts: list
    batch: ReadBatch
    amplicon: np.ndarray


def _panel_primers(rng, name: str, length: int, n_amp: int, scheme: str):
    """One contig's amplicons: their left and their right primers, each
    a list of (start, end), the main one first, an alternative one on
    about one amplicon in 16; and the contig's BED rows, amplicon by
    amplicon (left primers, then right)."""
    margin = 30
    step = (length - 2 * margin - 420) / max(n_amp - 1, 1)
    start = margin + np.round(np.arange(n_amp) * step).astype(np.int64)
    end = start + rng.integers(380, 421, n_amp)
    lp = rng.integers(22, 27, n_amp)
    rp = rng.integers(22, 27, n_amp)
    lefts = [[(int(s), int(s + a))] for s, a in zip(start, lp)]
    rights = [[(int(e - a), int(e))] for e, a in zip(end, rp)]
    for i in rng.choice(n_amp, max(1, n_amp // 16), replace=False):
        shift = int(rng.choice([-4, -3, -2, 2, 3, 4]))
        plen = int(rng.integers(22, 27))
        if rng.random() < 0.5:
            s = lefts[i][0][0] + shift
            lefts[i].append((s, s + plen))
        else:
            e = rights[i][0][1] + shift
            rights[i].append((e - plen, e))
    rows = []
    for i in range(n_amp):
        pool = f"{scheme}_{1 + i % 2}"
        for side, prim, strand in (("LEFT", lefts[i], "+"),
                                   ("RIGHT", rights[i], "-")):
            for k, (lo, hi) in enumerate(prim):
                rows.append(f"{name}\t{lo}\t{hi}\t{scheme}_{i + 1}_{side}"
                            f"{'_alt0' if k else ''}\t{pool}\t{strand}\n")
    return lefts, rights, rows


def _offset_draws(rng, n: int, outward: int) -> np.ndarray:
    """How far each of ``n`` fragment ends lies from its primer's outer
    end: 0 in 60%, -5 to 5 in 35%, 6-10 outward (beyond the default
    tolerance of 5) in 5%."""
    u = rng.random(n)
    near = rng.integers(-5, 6, n)
    far = outward * rng.integers(6, 11, n)
    return np.where(u < 0.6, 0, np.where(u < 0.95, near, far))


def _read_ops(kind: int, length: int, a: int, k: int, rev: bool) -> list:
    """A read's CIGAR as (op, length) pairs: all M (kind 0), or an
    insertion (1) or a deletion (2) ``a`` bases from its 5' end, or its
    first ``a`` bases soft-clipped (3); a reverse read's 5' end is its
    right end on the reference."""
    if kind == 0:
        return [(F.CMATCH, length)]
    if kind == 1:
        ops = [(F.CMATCH, a), (F.CINS, k), (F.CMATCH, length - a - k)]
    elif kind == 2:
        ops = [(F.CMATCH, a), (F.CDEL, k), (F.CMATCH, length - a)]
    else:
        ops = [(F.CSOFT_CLIP, a), (F.CMATCH, length - a)]
    return ops[::-1] if rev else ops


def amplicon_panel(n_reads: int, seed: int, contigs=(ARTIC_CONTIG,),
                   sample: str = "sample1") -> AmpliconPanel:
    """An amplicon panel shaped like ARTIC SARS-CoV-2 V3, from
    ``AMPLICON_PANEL_SEED``, and ``n_reads`` reads of one sample on it,
    coordinate-sorted, from ``seed``: the input of ``ampliconclip`` and
    ``ampliconstats``.  Samples with the same ``contigs`` share the
    panel.

    ``contigs`` are (name, length, amplicons): random bases tiled by
    amplicons of 380-420 bases, primers of 22-26 bases, an alternative
    primer shifted 2-4 bases on about one amplicon in 16, two pools (the
    BED's score).  A template is one amplicon (drawn lognormally, by the
    panel's weights times the sample's, one amplicon dropping out) read
    as a 2x150 pair from its ends,
    read 1 forward or reverse at random; its ends lie on the primers
    (main or alternative) as ``_offset_draws`` says, some beyond the
    default tolerance.  One read in 100 is 8-20 bases long (shorter than
    a primer); of the others, one in 50 has an insertion, one a deletion
    and one a soft clip 3-15 bases into its 5' primer; substitutions at
    ``AMPLICON_ERR_RATE``.  One pair in 100 has its reverse mate unmapped, one in
    200 fails QC; 1% more records are secondary alignments at another
    amplicon's left primer and supplementary ones, hard-clipped, at a
    right primer; one template in 200 is an unplaced pair.  Every read
    is in read group ``sample`` (SM ``sample``); mapped ones but one in
    50 carry NM and MD, filled by the port's ``calmd``."""
    from .tools.calmd_cmd import UPDATE_MD, UPDATE_NM, fillmd_batch
    read_len = AMPLICON_READ_LEN
    prng = np.random.default_rng(AMPLICON_PANEL_SEED)
    refs, lefts, rights, tids, bed = [], [], [], [], []
    for t, (name, length, n_amp) in enumerate(contigs):
        refs.append(np.frombuffer(b"ACGT", np.uint8)[
            prng.integers(0, 4, length)])
        lp, rp, rows = _panel_primers(prng, name, length, n_amp,
                                      ARTIC_SCHEME if t == 0 else name)
        lefts += lp
        rights += rp
        tids += [t] * n_amp
        bed += rows
    ref_all = np.concatenate(refs)
    ref_base = np.cumsum([0] + [len(r) for r in refs])
    n_amp = len(tids)
    weight = prng.lognormal(0.0, 0.6, n_amp)
    weight[prng.integers(0, n_amp)] *= 0.02
    rng = np.random.default_rng(seed)
    weight *= rng.lognormal(0.0, 0.3, n_amp)
    n_pairs = int(n_reads * 0.495)
    n_unplaced = max(1, n_pairs // 200)
    n_pairs -= n_unplaced
    n_extra = n_reads - 2 * (n_pairs + n_unplaced)

    # the pairs: read 2p forward from the fragment's start, read 2p + 1
    # reverse to its end
    amps = rng.choice(n_amp, n_pairs, p=weight / weight.sum())
    alt_l = rng.random(n_pairs) < 0.3
    alt_r = rng.random(n_pairs) < 0.3
    lp = np.array([lefts[a][int(x and len(lefts[a]) > 1)]
                   for a, x in zip(amps.tolist(), alt_l.tolist())], np.int64)
    rp = np.array([rights[a][int(x and len(rights[a]) > 1)]
                   for a, x in zip(amps.tolist(), alt_r.tolist())],
                  np.int64)
    lo = lp[:, 0] + _offset_draws(rng, n_pairs, -1)
    hi = rp[:, 1] + _offset_draws(rng, n_pairs, 1)
    n = 2 * n_pairs
    rev = np.tile([False, True], n_pairs)
    tid = np.repeat(np.array(tids, np.int32)[amps], 2)
    length = np.repeat(np.minimum(read_len, hi - lo), 2)
    short = rng.random(n) < 0.01
    length[short] = rng.integers(8, 21, int(short.sum()))
    u = np.where(length >= 40, rng.random(n), 0.0)
    kind = np.select([u < 0.94, u < 0.96, u < 0.98], [0, 1, 2], 3)
    a = rng.integers(3, 16, n)
    k = rng.integers(1, 4, n)
    span = length + np.select([kind == 1, kind == 2, kind == 3],
                              [-k, k, -a], 0)
    clip = np.where(kind == 3, a, 0)
    pos = np.where(rev, np.repeat(hi, 2) - span - clip,
                   np.repeat(lo, 2) + clip)
    ops_l = [_read_ops(*x) for x in zip(kind.tolist(), length.tolist(),
                                        a.tolist(), k.tolist(),
                                        rev.tolist())]

    # bases: the reference's along each read's alignment, random ones
    # inserted or soft-clipped, then substitutions
    seq_off = _offsets(length)
    codes = np.empty(int(seq_off[-1]), np.uint8)
    plain = kind == 0
    gi = ragged_gather_indices((ref_base[tid] + pos)[plain], length[plain])
    codes[ragged_gather_indices(seq_off[:-1][plain], length[plain])] = \
        _NT16_OF_ASCII[ref_all[gi]]
    for i in np.flatnonzero(~plain).tolist():
        q, r = int(seq_off[i]), int(ref_base[tid[i]] + pos[i])
        for op, ln in ops_l[i]:
            if op == F.CMATCH:
                codes[q:q + ln] = _NT16_OF_ASCII[ref_all[r:r + ln]]
            else:
                codes[q:q + ln] = _ACGT16[rng.integers(0, 4, ln)]
            r += ln if F.CIGAR_CONSUMES_REF[op] else 0
            q += ln if F.CIGAR_CONSUMES_QUERY[op] else 0
    err = np.flatnonzero(rng.random(codes.size) < AMPLICON_ERR_RATE)
    codes[err] = _ACGT16[(_BASE_OF_NT16[codes[err]]
                          + rng.integers(1, 4, err.size)) % 4]

    r1_fwd = np.repeat(rng.random(n_pairs) < 0.5, 2)
    flag = (0x1 | 0x2 | np.where(rev, 0x10, 0x20)
            | np.where(rev == r1_fwd, 0x80, 0x40)).astype(np.int64)
    mapq = rng.integers(20, 61, n)
    fate = np.repeat(rng.random(n_pairs), 2)
    # the reverse mate unmapped and placed at its mate, or both failing
    # QC
    lost = (fate < 0.01) & rev
    flag[lost] = (flag[lost] & ~(0x2 | 0x10)) | 0x4
    flag[np.roll(lost, -1)] = (flag[np.roll(lost, -1)] & ~(0x2 | 0x20)) | 0x8
    pos[lost] = pos[np.roll(lost, -1)]
    mapq[lost] = 0
    for i in np.flatnonzero(lost).tolist():
        ops_l[i] = []
    flag[(fate >= 0.01) & (fate < 0.015)] |= 0x200
    mate = np.arange(n) ^ 1
    amp_of = np.repeat(amps, 2)
    pair = np.repeat(np.arange(n_pairs), 2)

    # secondary records at another amplicon's left primer, supplementary
    # (hard-clipped) ones at a right primer, of distinct mapped reads;
    # then the unplaced pairs
    ex = {"tid": [], "pos": [], "flag": [], "mapq": [], "ops": [],
          "codes": [], "pair": [], "mate": []}
    for j, i in enumerate(rng.choice(np.flatnonzero((flag & 0x4) == 0),
                                     n_extra, replace=False).tolist()):
        b = int(rng.integers(0, n_amp))
        keep = int(flag[i]) & (0x1 | 0x8 | 0x20 | 0x40 | 0x80)
        if j % 2 == 0:
            p0, ops, fl = lefts[b][0][0], [(F.CMATCH, read_len)], 0x100
        else:
            h = int(rng.integers(30, 80))
            p0 = rights[b][0][1] - (read_len - h)
            ops = [(F.CHARD_CLIP, h), (F.CMATCH, read_len - h)]
            fl = 0x800 | 0x10
        r = int(ref_base[tids[b]]) + p0
        for key, v in (("tid", tids[b]), ("pos", p0), ("flag", keep | fl),
                       ("mapq", 0 if j % 2 == 0 else 30), ("ops", ops),
                       ("codes", _NT16_OF_ASCII[
                           ref_all[r:r + ops[-1][1]]]),
                       ("pair", int(pair[i])), ("mate", int(mate[i]))):
            ex[key].append(v)
    for p in range(n_pairs, n_pairs + n_unplaced):
        for fl in (0x1 | 0x4 | 0x8 | 0x40, 0x1 | 0x4 | 0x8 | 0x80):
            for key, v in (("tid", -1), ("pos", -1), ("flag", fl),
                           ("mapq", 0), ("ops", []),
                           ("codes", _ACGT16[rng.integers(0, 4,
                                                          read_len)]),
                           ("pair", p), ("mate", -1)):
                ex[key].append(v)
    m = len(ex["tid"])
    tid = np.concatenate([tid, np.array(ex["tid"], np.int32)])
    pos = np.concatenate([pos, np.array(ex["pos"], np.int64)])
    flag = np.concatenate([flag, np.array(ex["flag"], np.int64)])
    mapq = np.concatenate([mapq, np.array(ex["mapq"], np.int64)])
    ops_l += ex["ops"]
    codes = np.concatenate([codes] + ex["codes"])
    seq_off = _offsets(np.concatenate(
        [length, [len(c) for c in ex["codes"]]]).astype(np.int64))
    pair = np.concatenate([pair, np.array(ex["pair"], np.int64)])
    mate = np.concatenate([mate, np.array(ex["mate"], np.int64)])
    amp_of = np.concatenate([amp_of, np.full(m, -1)])
    n += m

    has_mate = mate >= 0
    mtid = np.where(has_mate, tid[np.maximum(mate, 0)], -1).astype(np.int32)
    mpos = np.where(has_mate, pos[np.maximum(mate, 0)], -1)
    span = np.array([sum(ln for op, ln in ops if F.CIGAR_CONSUMES_REF[op])
                     for ops in ops_l], np.int64)
    # TLEN on the primary records of a pair with both mates mapped: the
    # leftmost (on a tie the forward one) positive
    tlen = np.zeros(n, np.int64)
    prim = has_mate & ((flag & 0x90C) == 0)
    mt = mate[prim]
    lo_t = np.minimum(pos[prim], pos[mt])
    hi_t = np.maximum(pos[prim] + span[prim], pos[mt] + span[mt])
    first = (pos[prim] < pos[mt]) | ((pos[prim] == pos[mt])
                                     & ((flag[prim] & 0x10) == 0))
    tlen[prim] = np.where(first, 1, -1) * (hi_t - lo_t)

    # the mapped reads left without NM and MD
    untagged = rng.random(n) < 0.02
    names = [b"amp%07d" % p for p in pair.tolist()]
    header = SamHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(f"@SQ\tSN:{c[0]}\tLN:{c[1]}\n" for c in contigs)
        + f"@RG\tID:{sample}\tSM:{sample}\tPL:ILLUMINA\n"
        "@PG\tID:bwa\tPN:bwa\tVN:0.7.17-r1188\tCL:bwa mem -t 8 ref.fa"
        " r1.fq.gz r2.fq.gz\n")
    b = ReadBatch(n=n)
    b.tid, b.pos = tid, pos
    b.flag = flag.astype(np.uint16)
    b.mapq = mapq.astype(np.uint8)
    b.mtid, b.mpos, b.tlen = mtid, mpos, tlen
    b.qname = np.frombuffer(b"".join(names), np.uint8).copy()
    b.qname_off = _offsets([len(x) for x in names])
    b.cigar = np.array([(ln << 4) | op for ops in ops_l for op, ln in ops],
                       np.uint32)
    b.cigar_off = _offsets([len(ops) for ops in ops_l])
    b.seq = codes
    b.seq_off = seq_off
    b.qual = rng.integers(20, 41, codes.size).astype(np.uint8)
    # NM and MD on the mapped reads but one in 50, then the read group
    aux_out = [np.empty(0, np.uint8)] * n
    for t, (name, _, _) in enumerate(contigs):
        fillmd_batch(b, np.flatnonzero((tid == t) & ((flag & 0x4) == 0)
                                       & ~untagged),
                     refs[t].tobytes(), len(refs[t]), UPDATE_NM | UPDATE_MD,
                     0, True, name, aux_out, aux_native_ok=False)
    rg = np.frombuffer(b"RGZ" + sample.encode() + b"\0", np.uint8)
    auxes = [np.concatenate([a, rg]) for a in aux_out]
    b.aux = np.concatenate(auxes)
    b.aux_off = _offsets([len(x) for x in auxes])
    order = np.lexsort((pos, np.where(tid < 0, len(contigs), tid)))
    return AmpliconPanel(header, "".join(bed), lefts, b.take(order),
                         amp_of[order])


# ace_assembly: its contigs (name, unpadded length, reads), a pad site
# about every this many consensus bases, the bases a line of the ACE's
# sequences
ACE_CONTIGS = (("Contig1", 3000, 40), ("Contig2", 1500, 20))
_ACE_PAD_EVERY = 30
_ACE_LINE = 50


@dataclass
class AceRead:
    """One read of an ACE contig: its padded bases as the ACE holds them
    (complemented when ``complemented``), its AF position (1-based
    padded; below 1 where it hangs off the contig's left end) and its QA
    align clip (``beg`` bases clipped before, ``end`` the last aligned
    one, 1-based)."""
    name: str
    padded: str
    af_pos: int
    complemented: bool
    beg: int
    end: int


@dataclass
class AceAssembly:
    """A phrap-style ACE assembly (``ace_assembly``): its text, each
    contig's padded consensus by name, and its reads in the ACE's
    order."""
    ace: str
    padded: dict
    reads: list


def _ace_lines(seq: str) -> str:
    return "".join(seq[i:i + _ACE_LINE] + "\n"
                   for i in range(0, len(seq), _ACE_LINE))


def ace_assembly(seed: int) -> AceAssembly:
    """A phrap-style ACE, the input of ``ace2sam``: for each of
    ACE_CONTIGS (name, unpadded length, reads), a padded consensus (one
    or two ``*`` columns at a site about every _ACE_PAD_EVERY bases) with
    its BQ qualities, the reads' AF placements (complemented at random;
    the first read of a contig hangs off its left end), BS segments, and
    each read's padded bases, QA clip bounds and DS line; a CT and a WA
    tag at the end.  A read's bases follow the consensus from its AF
    column, with a substitution in 100, a pad on a consensus base (a
    deletion) in 50 and a base on a pad column (an insertion) in 4; its
    clipped ends, 0-30 bases each, hold no pad, and its first and last
    aligned bases lie on consensus bases, so ``ace2sam``'s CIGARs hold as
    many query bases as its sequences, in both of its modes."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out_co, padded_of, reads = [], {}, []
    for name, length, n_reads in ACE_CONTIGS:
        base = acgt[rng.integers(0, 4, length)]
        gaps = np.zeros(length, np.int64)
        sites = rng.random(length) < 1.0 / _ACE_PAD_EVERY
        sites[:20] = sites[-20:] = False
        gaps[sites] = rng.integers(1, 3, int(sites.sum()))
        cols = np.full(length + int(gaps.sum()), ord("*"), np.uint8)
        cols[np.arange(length) + np.cumsum(gaps) - gaps] = base
        cons = cols.tobytes().decode()
        ncol = len(cons)
        padded_of[name] = cons
        contig_reads = []
        for r in range(n_reads):
            n = int(rng.integers(200, 501))
            if r == 0:
                start = -int(rng.integers(2, 12))
            else:
                start = int(rng.integers(0, ncol - n + 1))
            lo = max(int(rng.integers(0, 31)), -start)
            hi = n - int(rng.integers(0, 31))
            # the first and last aligned columns: consensus bases
            while start + lo < ncol and cons[start + lo] == "*":
                lo += 1
            hi = min(hi, ncol - start)
            while cons[start + hi - 1] == "*":
                hi -= 1
            chars = []
            for i in range(n):
                c = start + i
                clipped = i < lo or i >= hi
                if c < 0 or c >= ncol:
                    chars.append("ACGT"[int(rng.integers(0, 4))])
                elif cons[c] == "*":
                    chars.append("ACGT"[int(rng.integers(0, 4))]
                                 if clipped or rng.random() < 0.25 else "*")
                elif (not clipped and lo < i < hi - 1
                      and rng.random() < 0.02):
                    chars.append("*")
                elif rng.random() < 0.01:
                    chars.append("ACGT".replace(cons[c], "")[
                        int(rng.integers(0, 3))])
                else:
                    chars.append(cons[c])
            contig_reads.append(AceRead(
                f"{name}.r{r:03d}", "".join(chars), start + 1,
                bool(rng.random() < 0.5), lo, hi))
        quals = rng.integers(10, 91, length)
        text = [f"CO {name} {ncol} {n_reads} {n_reads} U\n",
                _ace_lines(cons), "\nBQ\n"]
        for i in range(0, length, 25):
            text.append(" " + " ".join(map(str, quals[i:i + 25])) + "\n")
        text.append("\n")
        for rd in contig_reads:
            text.append(f"AF {rd.name} {'C' if rd.complemented else 'U'} "
                        f"{rd.af_pos}\n")
        # base segments: the consensus in runs of 100 columns, each from
        # a read that covers its start (none where no read does)
        for c in range(0, ncol, 100):
            rd = [x.name for x in contig_reads
                  if x.af_pos <= c + 1 < x.af_pos + len(x.padded)]
            if rd:
                text.append(f"BS {c + 1} {min(c + 100, ncol)} {rd[0]}\n")
        text.append("\n")
        for rd in contig_reads:
            text += [f"RD {rd.name} {len(rd.padded)} 0 0\n",
                     _ace_lines(rd.padded),
                     f"\nQA 1 {len(rd.padded)} {rd.beg + 1} {rd.end}\n",
                     f"DS CHROMAT_FILE: {rd.name} PHD_FILE: {rd.name}.phd.1 "
                     "TIME: Thu Jan  1 00:00:00 2026\n\n"]
        out_co.append("".join(text))
        reads += contig_reads
    first = ACE_CONTIGS[0][0]
    tags = (f"CT{{\n{first} repeat consed 10 40 260101:000000\n}}\n\n"
            "WA{\nphrap 1 260101:000000\nphrap reads.fasta.screen "
            "-new_ace\n}\n")
    ace = (f"AS {len(ACE_CONTIGS)} {len(reads)}\n\n" + "".join(out_co)
           + tags)
    return AceAssembly(ace, padded_of, reads)


def _offsets(lens) -> np.ndarray:
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off
