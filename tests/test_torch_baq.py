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


def _chunk(messy: bool, lq: int = LQ):
    """The HMM inputs of one chunk of device-eligible reads of ``lq``
    bases, as the port's pipeline builds them on the CPU, plus the batch
    and rows."""
    ref, ref_int = _ref()
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


def _finalize_inputs(seed=3, B=64, L=LQ):
    rng = np.random.default_rng(seed)
    bq = rng.integers(0, 100, (B, L)).astype(np.uint8)
    good = rng.random((B, L)) < 0.8
    qual = rng.integers(2, 60, (B, L)).astype(np.uint8)
    # cigar-op ordinals: a few M ops per read, separated by non-M runs
    seg = np.full((B, L), -1, np.int32)
    for r in range(B):
        p, op = int(rng.integers(0, 5)), 0
        while p < L:
            m = int(rng.integers(3, 40))
            seg[r, p:p + m] = op
            p += m + int(rng.integers(0, 4))
            op += int(rng.integers(1, 3))
    return bq, good, qual, seg


@pytest.mark.parametrize("seed", [3, 4])
def test_finalize_plain_equals_jax(seed):
    bq, good, qual, seg = _finalize_inputs(seed)
    want = np.asarray(jbd._finalize(bq, good, qual, seg, l_query=LQ))
    got = bd.baq_finalize(*(torch.from_numpy(a) for a in
                            (bq, good, qual, seg)))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


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
