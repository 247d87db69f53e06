"""Seeded read simulation (wgsim analog), numpy only.

Counterpart of samtools_tpu/sim.py (:22-122): the same seed gives the
same batch as the JAX package.  ``simulate_messy`` is a vectorized form
of the JAX package's bench workload with indels and soft clips.
"""

from __future__ import annotations

import numpy as np

from .core import flags as F
from .core.batch import ReadBatch
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
