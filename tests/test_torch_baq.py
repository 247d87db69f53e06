"""K4 baq_hmm and K5 baq_finalize (plain versions, as the CPU runs them)
against the JAX package's device BAQ and its f64 host HMM.

The HMM is float32 in both packages, with the sums taken in another
order (the port's D chain is a matmul of another shape), so a posterior
that sits on a phred rounding boundary may round either way: such reads
are flagged ``risky`` and recomputed on the host.  So the HMM is held to
equal ``good`` and equal output-reaching quals (min(bq, qual) on M
bases) on every read neither package flags, and to a risky-set
difference of at most 1% of reads.  Finalize is integer arithmetic:
exact.  The applied quals after the host recompute are byte-equal to
the JAX package's f64 host BAQ."""

import numpy as np
import pytest
import torch

from samtools_tpu.io import native as jnative
from samtools_tpu.ops import baq_device as jbd
from samtools_tpu_torch import sim
from samtools_tpu_torch.io import native
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import mpileup_device as md

torch.set_num_threads(1)

REF_LEN = 1 << 15
N_READS = 384
LQ = 100


def _ref():
    ref = sim.simulate_reference(REF_LEN, seed=7)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return ref, lut[ref]


def _defect_batch(ref):
    """Reads of cigar 8S40M3I49M drawn from ``ref``: an 8-base clip, 40
    reference bases, 3 inserted bases, the next 49 reference bases (1%
    substitutions).  Their M op of ordinal 1 has a non-M base after it."""
    b = sim.simulate_batch(ref_len=REF_LEN, coverage=3.0, read_len=LQ,
                           seed=23, paired=False, err_rate=0.0, ref=ref)
    rng = np.random.default_rng(23)
    nt16 = np.zeros(256, np.uint8)
    nt16[np.frombuffer(b"ACGT", np.uint8)] = [1, 2, 4, 8]
    acgt = np.array([1, 2, 4, 8], np.uint8)
    ref_m = b.pos[:, None] + np.arange(89)[None, :]
    seq = acgt[rng.integers(0, 4, (b.n, LQ))]
    seq[:, 8:48] = nt16[ref[ref_m[:, :40]]]
    seq[:, 51:] = nt16[ref[ref_m[:, 40:]]]
    errs = rng.random(seq.shape) < 0.01
    seq[errs] = acgt[rng.integers(0, 4, int(errs.sum()))]
    b.seq = seq.ravel()
    ops = [(8, 4), (40, 0), (3, 1), (49, 0)]
    b.cigar = np.tile(np.array([(n << 4) | op for n, op in ops], np.uint32),
                      b.n)
    b.cigar_off = np.arange(b.n + 1, dtype=np.int64) * len(ops)
    return b


def _chunk(messy: bool, lq: int = LQ, defect: bool = False):
    """The HMM inputs of one chunk of device-eligible reads of ``lq``
    bases, as the port's pipeline builds them on the CPU, plus the batch
    and rows.  ``defect``: 8S40M3I49M reads (``_defect_batch``)."""
    ref, ref_int = _ref()
    if defect:
        b = _defect_batch(ref)
    else:
        b = sim.simulate_batch(ref_len=REF_LEN, coverage=3.0 * lq / LQ,
                               read_len=lq, seed=21 + messy, paired=False,
                               err_rate=0.01, ref=ref)
    if messy:
        sim.simulate_messy(b, 5)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, lq, REF_LEN)
    dsel = sel[elig][:N_READS]
    pipe = md.DeviceCensusPipeline(ref_int, REF_LEN, l_query=lq,
                                   device="cpu")
    seqm, qual = pipe._gather_rows(b, dsel)
    k = np.nonzero(elig)[0][:N_READS]
    buf = pipe._make_buf(b.pos[dsel].astype(np.int64), lead[k], lref[k],
                         cig8[k], seqm, qual, 0, dsel.size)
    return b, dsel, ref_int, pipe._expand(torch.from_numpy(buf))


# read lengths: 100 (the bench workload) and 151 (Illumina 2x151 runs;
# not a multiple of K4's checkpoint stride, so its last segment is
# partial); the 100-base cases keep their original ids
LENGTHS = [pytest.param(False, 100, id="False"),
           pytest.param(True, 100, id="True"),
           pytest.param(False, 151, id="False-151"),
           pytest.param(True, 151, id="True-151")]


def _hmm_args(x):
    return (x["ref_win"], x["sq"], x["qq"], x["cdT"], x["lref"], x["bMv"],
            x["bIv"])


@pytest.mark.parametrize("messy,lq", LENGTHS)
def test_hmm_plain_equals_jax(messy, lq):
    _, _, _, x = _chunk(messy, lq)
    args = _hmm_args(x)
    LRM = x["ref_win"].shape[1]
    pq, pg, pr = bd.baq_hmm(*args, lq, LRM, 7)
    jq, jg, jr = jbd._probaln_batch(*(a.numpy() for a in args),
                                    l_query=lq, l_ref_max=LRM, bw=7)
    jq = torch.from_numpy(np.asarray(jq)).to(torch.uint8)
    jg = torch.from_numpy(np.asarray(jg))
    jr = torch.from_numpy(np.asarray(jr))
    assert pq.shape == (N_READS, lq) and pq.dtype == torch.uint8
    ok = ~(pr | jr)
    assert int((pr ^ jr).sum()) <= 0.01 * N_READS
    assert torch.equal(pg[ok], jg[ok])
    out_p = bd.bq_reaching_output(pq, x["qq"], x["cdT"])
    out_j = bd.bq_reaching_output(jq, x["qq"], x["cdT"])
    assert torch.equal(out_p[ok], out_j[ok])
    # the flag's own rule: raw bq at or below qual + 1 on M bases is
    # guarded, so where both packages land there it is equal
    qq1 = x["qq"].int() + 1
    low = (x["cdT"].t() < (1 << 19)) & (pq.int() <= qq1) & (jq.int() <= qq1)
    assert torch.equal(pq[ok][low[ok]], jq[ok][low[ok]])
    # the M-base share of the decode is most of the read, and risky is rare
    assert int(pr.sum()) < N_READS // 4
    assert bool(pg.any())


def test_hmm_plain_keeps_callers_tf32_setting():
    x = _chunk(False)[3]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            bd.baq_hmm_plain(*_hmm_args(x), LQ, x["ref_win"].shape[1], 7)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _finalize_inputs(seed=3, B=64, L=LQ, gaps=True):
    """Random finalize inputs.  Cigar-op ordinals: a few M ops per read
    after a leading non-M run; with ``gaps`` the ops are separated by
    non-M runs (so an M op of ordinal >= 1 may have a non-M base after
    it), without, they are adjacent to the row's end."""
    rng = np.random.default_rng(seed)
    bq = rng.integers(0, 100, (B, L)).astype(np.uint8)
    good = rng.random((B, L)) < 0.8
    qual = rng.integers(2, 60, (B, L)).astype(np.uint8)
    seg = np.full((B, L), -1, np.int32)
    for r in range(B):
        p, op = int(rng.integers(0, 5)), 0
        while p < L:
            m = int(rng.integers(3, 40))
            seg[r, p:p + m] = op
            p += m + (int(rng.integers(0, 4)) if gaps else 0)
            op += int(rng.integers(1, 3))
    return bq, good, qual, seg


def _finalize_loop(bq, good, qual, seg):
    """What finalize computes, op by op: an M base gets min(q, min(prefix
    max, suffix max)) of bqv over its own M op; a non-M base min(q, bq)."""
    q = qual.astype(np.int64)
    b = bq.astype(np.int64)
    bqv = np.where(good & (seg >= 0), np.minimum(b, q), 0)
    out = np.minimum(q, b)
    for r in range(seg.shape[0]):
        p = 0
        while p < seg.shape[1]:
            e = p + 1
            while e < seg.shape[1] and seg[r, e] == seg[r, p]:
                e += 1
            if seg[r, p] >= 0:
                v = bqv[r, p:e]
                sm = np.minimum(np.maximum.accumulate(v),
                                np.maximum.accumulate(v[::-1])[::-1])
                out[r, p:e] = np.minimum(q[r, p:e], sm)
            p = e
    return out.astype(np.uint8)


# the JAX package's _finalize loses the suffix max of an M op of ordinal
# >= 1 that has a non-M base after it (ROADMAP.md Queue 3): against it,
# inputs without that shape; against the loop oracle, every input
@pytest.mark.parametrize("seed,oracle", [
    pytest.param(3, "loop", id="3"), pytest.param(4, "loop", id="4"),
    pytest.param(3, "jax", id="jax-3"), pytest.param(4, "jax", id="jax-4")])
def test_finalize_plain_equals_jax(seed, oracle):
    args = _finalize_inputs(seed, gaps=oracle == "loop")
    if oracle == "jax":
        want = np.asarray(jbd._finalize(*args, l_query=LQ))
    else:
        want = _finalize_loop(*args)
    got = bd.baq_finalize(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_finalize_plain_on_defect_shape_equals_host_baq():
    """8S40M3I49M reads: the plain finalize equals the loop oracle, and
    after the host recompute of the risky reads the applied quals equal
    the f64 host BAQ.  The JAX package's _finalize differs on them."""
    b, dsel, ref_int, x = _chunk(False, defect=True)
    assert dsel.size == N_READS
    bq, good, risky = bd.baq_hmm(*_hmm_args(x), LQ, x["ref_win"].shape[1],
                                 7)
    args = [a.numpy() for a in (bq, good, x["qq"], x["seg"])]
    appq = bd.baq_finalize(bq, good, x["qq"], x["seg"]).numpy().copy()
    assert np.array_equal(appq, _finalize_loop(*args))
    jax_out = np.asarray(jbd._finalize(*args, l_query=LQ))
    assert not np.array_equal(jax_out, appq)
    cig = np.concatenate([b.cigar_of(int(r)) for r in dsel])
    coff = np.arange(dsel.size + 1, dtype=np.int64) * 4
    soff = np.arange(dsel.size + 1, dtype=np.int64) * LQ
    seq = np.concatenate([b.seq[b.seq_off[r]:b.seq_off[r] + LQ]
                          for r in dsel])
    host, _ = native.baq_batch(b.pos[dsel].astype(np.int64), cig, coff, seq,
                               x["qq"].numpy().ravel(), soff, ref_int)
    host = host.reshape(-1, LQ)
    risky = risky.numpy()
    assert int(risky.sum()) < N_READS // 4
    # the reads the defect reaches are non-risky reads the host agrees on
    assert (jax_out != host)[~risky].any()
    appq[risky] = host[risky]
    assert np.array_equal(appq, host)


@pytest.mark.parametrize("messy,lq", LENGTHS)
def test_applied_quals_equal_host_baq(messy, lq):
    b, dsel, ref_int, x = _chunk(messy, lq)
    bq, good, risky = bd.baq_hmm(*_hmm_args(x), lq, x["ref_win"].shape[1],
                                 7)
    appq = bd.baq_finalize(bq, good, x["qq"], x["seg"]).numpy().copy()
    risky = risky.numpy()
    # the reads' own columns, in the host libraries' layout
    cl = b.cigar_off[dsel + 1] - b.cigar_off[dsel]
    coff = np.concatenate([[0], np.cumsum(cl)])
    cig = np.concatenate([b.cigar_of(int(r)) for r in dsel])
    soff = np.arange(dsel.size + 1, dtype=np.int64) * lq
    seq = np.concatenate([b.seq[b.seq_off[r]:b.seq_off[r] + lq]
                          for r in dsel])
    qual = x["qq"].numpy().ravel()
    pos = b.pos[dsel].astype(np.int64)
    host, _ = native.baq_batch(pos, cig, coff, seq, qual, soff, ref_int)
    appq[risky] = host.reshape(-1, lq)[risky]
    want, skipped = jnative.baq_batch(pos, cig, coff, seq, qual, soff,
                                      ref_int, flag=3)
    assert not skipped.any()
    assert np.array_equal(host, want)
    assert np.array_equal(appq.ravel(), want)
    assert (appq.ravel() != qual).any()       # BAQ changed some quals
