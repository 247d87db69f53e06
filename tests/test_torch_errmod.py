"""The port's column engines against the JAX package's, on the CPU: the
MAQ error model (``ops/errmod.py``: ``ErrMod.cal``, ``beta``, ``lhet``,
``bcf_call_glfgen``) and tview's level pileup (``ops/lpileup.py``:
``assign_levels``).  Every result must be equal bit for bit: ``gencns``
rounds ``q + 0.499`` and tview sorts the calls, so a difference in the
last bit would print another byte.

Inputs are seeded: packed base arrays (q << 5 | strand << 4 | allele)
for ``cal``, per-read entry tuples for ``bcf_call_glfgen``, and
hand-built read sets (1 bp reads that start and end in one column, deep
columns, gaps longer than ``TV_GAP``, indels and skips) for
``assign_levels``, whose pileup tables come from each package's own
``build_pileup``."""

import dataclasses

import numpy as np
import pytest

from samtools_tpu.core.batch import ReadBatch as JReadBatch
from samtools_tpu.ops import errmod as jem
from samtools_tpu.ops import lpileup as jlp
from samtools_tpu.ops import pileup as jpl
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.ops import errmod as em
from samtools_tpu_torch.ops import lpileup as lp
from samtools_tpu_torch.ops import pileup as pl


def _bases(rng, n: int, m: int, qlo: int = 0, qhi: int = 80) -> np.ndarray:
    q = rng.integers(qlo, qhi, n)
    strand = rng.integers(0, 2, n)
    allele = rng.integers(0, m, n)
    return ((q << 5) | (strand << 4) | allele).astype(np.uint16)


# name -> (number of bases, q range): every q clamp (q < 4, q > 63)
CAL_CASES = {
    "empty": (0, (0, 80)),
    "one": (1, (0, 80)),
    "low_q": (40, (0, 6)),
    "high_q": (40, (60, 80)),
    "mixed": (30, (0, 80)),
    "exactly_255": (255, (0, 80)),
    "more_than_255": (400, (0, 80)),
}


@pytest.mark.parametrize("m", (4, 5))
@pytest.mark.parametrize("case", sorted(CAL_CASES))
def test_errmod_cal_equals_jax(case, m):
    n, (qlo, qhi) = CAL_CASES[case]
    mine, ref = em.ErrMod(1.0 - 0.83), jem.ErrMod(1.0 - 0.83)
    for seed in range(6):
        rng = np.random.default_rng(1000 * seed + n)
        b = _bases(rng, n, m, qlo, qhi)
        if seed == 1 and n:
            b[:] = b[0]            # one allele, one strand
        elif seed == 2 and n:
            b &= ~np.uint16(0x10)  # forward strand only
        got, want = mine.cal(b.copy(), m), ref.cal(b.copy(), m)
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes(), (case, m, seed)


@pytest.mark.parametrize("depcorr", (0.17, 0.0, 0.5))
def test_errmod_tables_equal_jax(depcorr):
    mine, ref = em.ErrMod(depcorr), jem.ErrMod(depcorr)
    assert mine.fk.tobytes() == ref.fk.tobytes()
    for n in (1, 2, 30, 254, 255):
        for q in range(4, 64):
            assert mine.beta(q, n).tobytes() == ref.beta(q, n).tobytes(), \
                (q, n)
    for n in list(range(0, 40)) + [254, 255, 256, 300]:
        for k in range(0, n + 3):
            a, b = mine.lhet(n, k), ref.lhet(n, k)
            assert np.float64(a).tobytes() == np.float64(b).tobytes(), (n, k)


def _entries(rng, n: int):
    """Per-read column tuples (is_del, is_refskip, flag, mapq, qual,
    base16): deletions, ref skips, unmapped flags, mapq 255, quals past
    99 and below the minimum, base code 0 (the reference's) and N."""
    out = []
    for _ in range(n):
        r = rng.random()
        out.append((bool(r < 0.08), bool(0.08 <= r < 0.12),
                    int(rng.choice([0, 16, 4, 20, 1024])),
                    int(rng.choice([0, 5, 20, 37, 60, 61, 254, 255])),
                    int(rng.choice([0, 4, 12, 13, 30, 63, 64, 99, 100, 200])),
                    int(rng.choice([0, 1, 2, 4, 8, 15, 3]))))
    return out


@pytest.mark.parametrize("n", (0, 1, 12, 60, 300))
@pytest.mark.parametrize("theta_minq", ((0.83, 13), (0.0, 0), (0.5, 20)))
def test_bcf_call_glfgen_equals_jax(n, theta_minq):
    mine, ref = em.BcfCallAux(*theta_minq), jem.BcfCallAux(*theta_minq)
    for seed in range(4):
        rng = np.random.default_rng(seed * 7 + n)
        entries = _entries(rng, n)
        for ref_base in (1, 2, 4, 8, 15):
            got = em.bcf_call_glfgen(entries, ref_base, mine)
            want = jem.bcf_call_glfgen(entries, ref_base, ref)
            assert got[0] == want[0]
            assert got[1].tobytes() == want[1].tobytes()
            assert got[2].tobytes() == want[2].tobytes()


def _read_set(reads) -> ReadBatch:
    """A one-contig batch of (pos, [(op, len), ...]) reads, in order."""
    rng = np.random.default_rng(len(reads))
    n = len(reads)
    qlens = [sum(ln for op, ln in ops if op in (0, 1, 4, 7, 8))
             for _, ops in reads]
    b = ReadBatch(n=n)
    b.tid = np.zeros(n, np.int32)
    b.pos = np.array([p for p, _ in reads], np.int64)
    b.mapq = np.full(n, 40, np.uint8)
    b.flag = np.where(rng.random(n) < 0.5, 16, 0).astype(np.uint16)
    b.mtid = np.full(n, -1, np.int32)
    b.mpos = np.full(n, -1, np.int64)
    b.tlen = np.zeros(n, np.int64)
    names = [b"r%d" % i for i in range(n)]
    b.qname = np.frombuffer(b"".join(names), np.uint8).copy()
    b.qname_off = np.concatenate([[0], np.cumsum([len(x) for x in names])])
    b.cigar = np.array([(ln << 4) | op for _, ops in reads
                        for op, ln in ops], np.uint32)
    b.cigar_off = np.concatenate([[0], np.cumsum([len(o) for _, o in reads])])
    b.seq_off = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int64)
    b.seq = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, sum(qlens))]
    b.qual = rng.integers(2, 41, sum(qlens)).astype(np.uint8)
    b.aux = np.empty(0, np.uint8)
    b.aux_off = np.zeros(n + 1, np.int64)
    for f in ("qname_off", "cigar_off"):
        setattr(b, f, getattr(b, f).astype(np.int64))
    return b


def _level_sets():
    rng = np.random.default_rng(3)
    sets = {}
    # 1 bp reads start and end in one column, beside longer reads
    reads = []
    for p in range(0, 400, 3):
        reads.append((p, [(0, 1)]))
        if p % 9 == 0:
            reads.append((p, [(0, int(rng.integers(2, 30)))]))
    sets["one_column_reads"] = reads
    # deep columns: 300 reads over a few positions, varied lengths
    sets["deep"] = sorted(((int(rng.choice([10, 11, 40, 41, 90])),
                            [(0, int(rng.integers(1, 80)))])
                           for _ in range(300)), key=lambda r: r[0])
    # gaps of 0-6 columns between runs of reads (TV_GAP = 2 cooldowns)
    reads, p = [], 0
    for _ in range(200):
        ln = int(rng.integers(1, 12))
        reads.append((p, [(0, ln)]))
        p += int(rng.integers(0, 4)) if rng.random() < 0.7 \
            else ln + int(rng.integers(0, 7))
    sets["gaps"] = reads
    # indels, clips and skips (entries with is_del / is_refskip)
    reads = []
    for i in range(250):
        p = int(rng.integers(0, 600))
        k = rng.random()
        ops = ([(0, 20), (2, 3), (0, 20)] if k < 0.2 else
               [(0, 15), (1, 2), (0, 15)] if k < 0.4 else
               [(4, 5), (0, 25)] if k < 0.6 else
               [(0, 10), (3, 40), (0, 10)] if k < 0.7 else
               [(0, int(rng.integers(1, 60)))])
        reads.append((p, ops))
    sets["indels_skips"] = sorted(reads, key=lambda r: r[0])
    return sets


LEVEL_SETS = _level_sets()


@pytest.mark.parametrize("name", sorted(LEVEL_SETS))
def test_assign_levels_equals_jax(name):
    b = _read_set(LEVEL_SETS[name])
    jb = JReadBatch(**{f.name: getattr(b, f.name)
                       for f in dataclasses.fields(b)})
    mine = lp.assign_levels(pl.build_pileup(b, "cpu"), b.n)
    want = jlp.assign_levels(jpl.build_pileup(jb), jb.n)
    assert mine.dtype == want.dtype
    assert np.array_equal(mine, want)
    assert mine.max() > 3    # several levels in use
