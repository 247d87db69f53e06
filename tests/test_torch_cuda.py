"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and edge shapes (the main-path shapes are held by
``chip_smoke.py``).  Needs a CUDA card, ``nvcc`` and ``g++``; skips
elsewhere.  On the card, without JAX installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import sys

import numpy as np
import pytest
import torch

import torch_chunk_cases as cc
import torch_k14_shapes as k14
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.ops.segment_kernel import (piece_layout,
                                                   segment_census,
                                                   segment_census_plain,
                                                   segment_contract,
                                                   segment_contract_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _plan(seed, n_reads, L, K, tile, n_tiles):
    rng = np.random.default_rng(seed)
    span = n_tiles * tile
    pos = np.sort(rng.integers(-L, span, n_reads))
    # a deep pile: one slice of 15,000+ items, several pieces of the
    # kernel whatever K
    pos[n_reads // 2:n_reads // 2 + 420] = pos[n_reads // 2]
    rp = (pos[:, None] + np.arange(L)[None, :]).ravel().astype(np.int32)
    W = rng.integers(-128, 128, (rp.size, K)).astype(np.int8)
    starts = np.arange(n_tiles) * tile
    lo = np.searchsorted(pos + L, starts, side="right") * L
    hi = np.searchsorted(pos, starts + tile) * L
    hi = np.maximum(hi, lo)
    hi[3] = lo[3]                                   # an empty tile
    return (torch.from_numpy(rp), torch.from_numpy(W),
            torch.from_numpy(lo.astype(np.int32)),
            torch.from_numpy(hi.astype(np.int32)))


@pytest.mark.parametrize("K,tile", [(1, 128), (6, 256), (32, 512)])
def test_segment_contract_equals_plain(cuda, K, tile):
    rp, W, lo, hi = _plan(K + tile, 900, 37, K, tile, 24)
    P, _ = piece_layout(4 + K, K)
    assert int((hi - lo).max()) > 3 * P
    assert bool((lo % 16 != 0).any())
    want = segment_contract_plain(rp, W, lo, hi, 0, tile)
    base = torch.arange(want.numel(), dtype=torch.int32).reshape(want.shape)
    out = base.to(cuda)
    before = kernels.launches["segment_contract"]
    segment_contract(rp.to(cuda), W.to(cuda), lo.to(cuda), hi.to(cuda), 0,
                     tile, out)
    torch.cuda.synchronize()
    assert kernels.launches["segment_contract"] == before + 1
    assert torch.equal(out.cpu(), base + want)


def _census_case(messy, base):
    """One chunk as the main path hands it to the census form: the
    expanded reads (with a pile of 300 reads at one position), random
    applied quals and risky flags, and the chunk's tile plan; the census
    window starts at ``base``."""
    ref_len = 1 << 16
    ref = sim.simulate_reference(ref_len, seed=4)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = sim.simulate_batch(ref_len=ref_len, coverage=30.0, read_len=100,
                           seed=9 + messy, paired=False, err_rate=0.01,
                           ref=ref)
    b.pos[b.n // 2:b.n // 2 + 300] = b.pos[b.n // 2]
    if messy:
        sim.simulate_messy(b, 3)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, 100, ref_len)
    k = np.nonzero(elig)[0]
    pipe = md.DeviceCensusPipeline(lut[ref], ref_len - base, base=base,
                                   device="cpu", chunk_reads=k.size)
    pos = b.pos[k].astype(np.int64)
    seqm, qual = pipe._gather_rows(b, k)
    x = pipe._expand(torch.from_numpy(pipe._make_buf(
        pos, lead[k], lref[k], cig8[k], seqm, qual, 0, k.size)))
    lo, hi, wbeg, _ = pipe._plan(pos - base)
    rng = np.random.default_rng(messy)
    appq = torch.from_numpy(rng.integers(0, 128, x["sq"].shape)
                            .astype(np.uint8))
    risky = torch.from_numpy(rng.random(k.size) < 0.05)
    return x, appq, risky, torch.from_numpy(lo), torch.from_numpy(hi), wbeg


@pytest.mark.parametrize("messy,base", [(False, 0), (True, 20000)])
def test_segment_census_equals_plain(cuda, messy, base):
    x, appq, risky, lo, hi, wbeg = _census_case(messy, base)
    assert int((hi - lo).max()) > 30000
    lo, hi = lo.to(cuda), hi.to(cuda)
    args = [a.to(cuda) for a in (x["refpos"], x["seg"], x["sq"], appq,
                                 risky)]
    gate = (base, 600, 30000, 13)
    # the plain version on the card too: its einsum is exact in f32
    want = segment_census_plain(*args, *gate, lo, hi, wbeg, 256)
    assert int(want[:, :5].sum()) > 100000
    start = torch.arange(want.numel(), dtype=torch.int32,
                         device=cuda).reshape(want.shape)
    out = start.clone()
    before = kernels.launches["segment_census"]
    segment_census(*args, *gate, lo, hi, wbeg, 256, out)
    torch.cuda.synchronize()
    assert kernels.launches["segment_census"] == before + 1
    assert torch.equal(out, start + want)
    # every input span one base on, so none starts on 16 bytes (the plan
    # then no longer fits the reads, the same way for both versions)
    n1 = args[0].shape[0] - 1
    sub = [a.reshape(-1)[1:1 + n1 * 100].view(n1, 100) for a in args[:4]]
    sub.append(args[4][1:])
    lo1, hi1 = lo.clamp(max=n1 * 100), hi.clamp(max=n1 * 100)
    out1 = torch.zeros_like(out)
    segment_census(*sub, *gate, lo1, hi1, wbeg, 256, out1)
    assert torch.equal(out1, segment_census_plain(*sub, *gate, lo1, hi1,
                                                  wbeg, 256))


def _hmm_inputs(messy, n, lq=100):
    ref = sim.simulate_reference(1 << 14, seed=2)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = sim.simulate_batch(ref_len=1 << 14, coverage=4.0 * lq / 100,
                           read_len=lq, seed=6, paired=False, err_rate=0.02,
                           ref=ref)
    if messy:
        sim.simulate_messy(b, 6)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, lq, 1 << 14)
    k = np.nonzero(elig)[0][:n]
    assert k.size == n
    pipe = md.DeviceCensusPipeline(lut[ref], 1 << 14, l_query=lq,
                                   device="cpu")
    seqm, qual = pipe._gather_rows(b, k)
    buf = pipe._make_buf(b.pos[k].astype(np.int64), lead[k], lref[k],
                         cig8[k], seqm, qual, 0, k.size)
    return pipe._expand(torch.from_numpy(buf))


# read counts that are not a multiple of K4's block or K5's tile give both
# a ragged last block; 37 and 151 bases leave K4 a partial last segment
# for any checkpoint stride, and 151-byte rows leave K5 an unaligned tail
@pytest.mark.parametrize("messy,n,lq", [
    pytest.param(False, 1, 100, id="False-1"),
    pytest.param(False, 130, 100, id="False-130"),
    pytest.param(True, 333, 100, id="True-333"),
    pytest.param(False, 203, 37, id="False-203-37"),
    pytest.param(True, 333, 151, id="True-333-151")])
def test_baq_kernels_equal_plain(cuda, messy, n, lq):
    x = _hmm_inputs(messy, n, lq)
    args = [x[k] for k in ("ref_win", "sq", "qq", "cdT", "lref", "bMv",
                           "bIv")]
    LRM = x["ref_win"].shape[1]
    pq, pg, pr = bd.baq_hmm(*args, lq, LRM, 7)
    kq, kg, kr = bd.baq_hmm(*(a.to(cuda) for a in args), lq, LRM, 7)
    kq, kg, kr = kq.cpu(), kg.cpu(), kr.cpu()
    assert kq.shape == (n, lq) and kg.dtype == torch.bool
    ok = ~(pr | kr)
    assert int((pr ^ kr).sum()) <= max(1, 0.01 * n)
    assert torch.equal(kg[ok], pg[ok])
    assert torch.equal(bd.bq_reaching_output(kq, x["qq"], x["cdT"])[ok],
                       bd.bq_reaching_output(pq, x["qq"], x["cdT"])[ok])
    qq1 = x["qq"].int() + 1
    low = (x["cdT"].t() < (1 << 19)) & (pq.int() <= qq1) & (kq.int() <= qq1)
    assert torch.equal(kq[ok][low[ok]], pq[ok][low[ok]])
    # reads from the second on: K4's input spans start off 16-byte
    # alignment; each read's results stay the same
    if n > 1:
        sub = [a[1:] for a in args]
        sub[3] = args[3][:, 1:].contiguous()
        k1 = bd.baq_hmm(*(a.to(cuda) for a in sub), lq, LRM, 7)
        for got, want in zip(k1, (kq[1:], kg[1:], kr[1:])):
            assert torch.equal(got.cpu(), want)
    fin_args = (kq, kg, x["qq"], x["seg"])
    fin = bd.baq_finalize(*(a.to(cuda) for a in fin_args)).cpu()
    assert torch.equal(fin, bd.baq_finalize(*fin_args))
    # rows from the second on: every span starts off 16-byte alignment
    # (unless the row is a multiple of 16 bytes long)
    fin1 = bd.baq_finalize(*(a[1:].to(cuda) for a in fin_args)).cpu()
    assert torch.equal(fin1, bd.baq_finalize(*(a[1:] for a in fin_args)))


@pytest.mark.parametrize("L", [600, 2000])
def test_finalize_long_rows_equal_plain(cuda, L):
    """Rows too long for a full tile of K5 in shared memory take smaller
    tiles (64 rows of 600 bases need 269 KB, more than a block may take)."""
    rng = np.random.default_rng(L)
    B = 70
    bq = torch.from_numpy(rng.integers(0, 100, (B, L)).astype(np.uint8))
    good = torch.from_numpy(rng.random((B, L)) < 0.8)
    qual = torch.from_numpy(rng.integers(2, 60, (B, L)).astype(np.uint8))
    # cigar-op ordinals: a leading soft clip of 0-8 bases, then M/=/X ops
    # of 3-60 bases, each followed by 0-3 non-M bases (an insertion), the
    # shape 8S40M3I49M has
    seg = np.full((B, L), -1, np.int32)
    for r in range(B):
        p, op = int(rng.integers(0, 9)), 1
        while p < L:
            m = int(rng.integers(3, 60))
            seg[r, p:p + m] = op
            p += m + int(rng.integers(0, 4))
            op += 2
    seg = torch.from_numpy(seg)
    got = bd.baq_finalize(*(a.to(cuda) for a in (bq, good, qual, seg)))
    assert torch.equal(got.cpu(), bd.baq_finalize(bq, good, qual, seg))


@pytest.mark.parametrize("lq", [37, 100, 151])
def test_hmm_scratch_is_the_checkpoints(cuda, lq):
    """K4 keeps one checkpoint (normalized M, I and D of the band) every
    S rows and no forward trace: the memory one call takes beyond its
    outputs is the checkpoint layout's size."""
    n = 203
    x = _hmm_inputs(False, n, lq)
    args = [x[k].to(cuda) for k in ("ref_win", "sq", "qq", "cdT", "lref",
                                    "bMv", "bIv")]
    LRM = x["ref_win"].shape[1]
    lay = bd.hmm_layout(lq, LRM, n)
    assert lay["scratch_bytes"] == (lq - 1) // lay["stride"] * 3 * 15 * 4 * n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    bd.baq_hmm(*args, lq, LRM, 7)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - before

    def blocks(nbytes):                 # the caching allocator's 512 B unit
        return -(-nbytes // 512) * 512
    own = [n * lq, n * lq, n]           # bq, good, risky
    scratch = blocks(lay["scratch_bytes"])
    assert scratch <= extra <= scratch + sum(map(blocks, own))


def test_wrappers_reject_bad_arguments(cuda):
    rp = torch.zeros(4, dtype=torch.int32, device=cuda)
    W = torch.zeros(4, 6, dtype=torch.int8, device=cuda)
    lo = hi = torch.zeros(2, dtype=torch.int32, device=cuda)
    out = torch.zeros(256, 6, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):           # mixed devices
        segment_contract(rp.cpu(), W, lo, hi, 0, 128, out)
    with pytest.raises(TypeError):
        segment_contract(rp, W.int(), lo, hi, 0, 128, out)
    with pytest.raises(ValueError):
        segment_contract(rp, torch.zeros(4, 33, dtype=torch.int8,
                                         device=cuda), lo, hi, 0, 128,
                         torch.zeros(256, 33, dtype=torch.int32,
                                     device=cuda))
    v = rp.reshape(2, 2)
    q = torch.zeros(2, 2, dtype=torch.uint8, device=cuda)
    risky = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):                # appq must be uint8
        segment_census(v, v, q, q.int(), risky, 0, 0, 256, 13, lo, hi, 0,
                       128, out)
    with pytest.raises(ValueError):               # risky: one per read
        segment_census(v, v, q, q, risky[:1], 0, 0, 256, 13, lo, hi, 0,
                       128, out)


def test_pipeline_on_card_equals_cpu(cuda):
    ref = sim.simulate_reference(1 << 15, seed=3)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = sim.simulate_batch(ref_len=1 << 15, coverage=5.0, read_len=100,
                           seed=8, paired=False, err_rate=0.01, ref=ref)
    sim.simulate_messy(b, 8)
    got = {}
    for dev in ("cpu", None):
        kernels.reset_launches()
        pipe = md.DeviceCensusPipeline(lut[ref], 1 << 15, device=dev,
                                       chunk_reads=512)
        pipe.add_batch(b)
        got[dev] = (*pipe.finish(), pipe.finish_checksum())
        assert pipe.device.type == (dev or "cuda")
    # the main path: the census form, never the generic form's (rp, W)
    assert kernels.launches["segment_contract"] == 0
    assert all(kernels.launches[k] > 0 for k in
               ("segment_census", "baq_hmm", "baq_finalize",
                "chunk_expand"))
    assert kernels.launches["census_checksum"] == 1
    assert np.array_equal(got["cpu"][0], got[None][0])
    assert np.array_equal(got["cpu"][1], got[None][1])
    assert got["cpu"][2] == got[None][2]


@pytest.mark.parametrize("which", ["messy", "pairs"])
def test_tool_on_card_equals_cpu(cuda, tmp_path, monkeypatch, which):
    """``mpileup -f ref.fa in.bam`` on the card prints the CPU port's
    bytes (messy single-end reads; overlapping messy pairs), in 16 Kbp
    windows of ~1,000 reads and chunks of 256 reads, so halo reads and
    several chunks per window take part; its census checksums equal too."""
    import json

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.tools import mpileup_cmd
    L = 1 << 17
    ref = sim.simulate_reference(L, seed=7)
    if which == "messy":
        b = sim.simulate_batch(ref_len=L, coverage=6.0, read_len=100, seed=3,
                               paired=False, err_rate=0.01, ref=ref)
        sim.simulate_messy(b, 11)
    else:
        b = sim.simulate_overlapping_pairs(L, coverage=6.0, ref=ref, seed=5)
    bam, fa = str(tmp_path / "in.bam"), str(tmp_path / "ref.fa")
    write_bam(bam, sim.make_header(L), b)
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + b"".join(ref[i:i + 60].tobytes() + b"\n"
                                      for i in range(0, L, 60)))
    monkeypatch.setattr(mpileup_cmd, "WINDOW_COLS", 1 << 14)
    init = md.DeviceCensusPipeline.__init__
    monkeypatch.setattr(md.DeviceCensusPipeline, "__init__",
                        lambda self, *a, **k: init(
                            self, *a, **{**k, "chunk_reads": 256}))
    got = {}
    for dev in (None, "cpu"):
        kernels.reset_launches()
        out, cj = str(tmp_path / f"{dev}.txt"), str(tmp_path / f"{dev}.json")
        assert cli.main(["mpileup", "-f", fa, bam, "-o", out,
                         "--census-out", cj], device=dev) == 0
        with open(out, "rb") as f, open(cj) as g:
            got[dev] = (f.read(), [w["checksum"] for w in
                                   json.load(g)["windows"]])
        launched = dict(kernels.launches)
        if dev is None:
            assert launched["segment_contract"] == 0
            assert all(launched[k] >= 24 for k in
                       ("segment_census", "baq_hmm", "baq_finalize"))
            # K6's front and tail once a chunk, K7 once a window
            assert launched["chunk_expand"] == launched["qual_deltas"] \
                == launched["segment_census"]
            assert launched["census_checksum"] == len(got[dev][1])
    assert got[None][0].count(b"\n") > L // 2
    assert got[None] == got["cpu"]


def _depth_events(seed, n_reads, tile, n_tiles, K):
    """Depth-like items: reads of 100 bases every ~3 positions (a 30x
    stack), two events each (+1 at the start, -1 at the end) and, for K >
    1, random weights in the other lanes.  A piece of the kernel then
    spans more rows than its accumulator holds.  The window is n_tiles *
    tile positions, so the end events at its end fall in no tile."""
    rng = np.random.default_rng(seed)
    L = n_tiles * tile
    pos = np.sort(rng.integers(0, L - 50, n_reads))
    end = np.minimum(pos + 100, L)
    rp = np.empty(2 * n_reads, np.int64)
    rp[0::2], rp[1::2] = pos, end
    W = rng.integers(-128, 128, (rp.size, K)).astype(np.int8)
    W[0::2, 0], W[1::2, 0] = 1, -1
    item_off = np.arange(0, 2 * n_reads + 1, 2)
    from samtools_tpu_torch.ops.pileup_engine import tile_plan
    plan = tile_plan(pos, end + 1, item_off, 0, L, tile)
    return (torch.from_numpy(rp.astype(np.int32)), torch.from_numpy(W),
            torch.from_numpy(plan.lo), torch.from_numpy(plan.hi), end)


@pytest.mark.parametrize("K,tile", [(1, 1024), (3, 512), (4, 128)])
def test_segment_contract_depth_events_equal_plain(cuda, K, tile):
    n_tiles = 40
    rp, W, lo, hi, end = _depth_events(K, 12000, tile, n_tiles, K)
    P, win = piece_layout(4 + K, K)
    # a piece's events span more rows than the accumulator: some items
    # take the global-atomic path
    assert int(rp[P - 1]) - int(rp[0]) > win
    assert (end == n_tiles * tile).any()
    want = segment_contract_plain(rp, W, lo, hi, 0, tile)
    out = torch.zeros(n_tiles * tile, K, dtype=torch.int32, device=cuda)
    segment_contract(rp.to(cuda), W.to(cuda), lo.to(cuda), hi.to(cuda), 0,
                     tile, out)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    depth = torch.cumsum(want[:, 0].long(), 0)
    assert int(depth.min()) >= 0 and int(depth.max()) > 20


def _pileup_inputs(tmp_path):
    from samtools_tpu_torch.io.bam import write_bam
    L = 1 << 17
    ref = sim.simulate_reference(L, seed=7)
    b = sim.simulate_batch(ref_len=L, coverage=6.0, read_len=100, seed=3,
                           paired=False, err_rate=0.01, ref=ref)
    sim.simulate_messy(b, 11)
    b.qual[b.seq_off[7]:b.seq_off[8]] = 0xFF
    bam = str(tmp_path / "in.bam")
    write_bam(bam, sim.make_header(L), b)
    p = sim.simulate_overlapping_pairs(L, coverage=6.0, ref=ref, seed=5)
    pairs = str(tmp_path / "pairs.bam")
    write_bam(pairs, sim.make_header(L), p)
    bed = str(tmp_path / "r.bed")
    with open(bed, "w") as f:
        for s in range(0, L - 5000, 3001):
            f.write(f"sim1\t{s}\t{s + 1000 + s % 4000}\n")
    return bam, pairs, bed


@pytest.mark.parametrize("cmd,argv", [
    ("depth", ["{bam}"]), ("depth", ["-a", "-q", "13", "-J", "{bam}"]),
    ("depth", ["-s", "{pairs}", "{bam}"]),
    ("coverage", ["{bam}", "{pairs}"]),
    ("coverage", ["-r", "sim1:1001-90000", "{bam}"]),
    ("bedcov", ["-c", "-d", "4", "{bed}", "-"])])
def test_pileup_family_on_card_equals_cpu(cuda, tmp_path, monkeypatch, cmd,
                                          argv):
    """depth, coverage and bedcov on the card print the CPU port's bytes
    (the 128 kbp messy BAM with one read stored without qualities, and
    overlapping pairs); depth and coverage in 16 Kbp windows launch K1's
    generic form and K9 (``depth_scan`` for depth and bedcov, a
    ``cov_reduce`` a window for coverage) and no other kernel."""
    import contextlib
    import io

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.tools import coverage_cmd
    bam, pairs, bed = _pileup_inputs(tmp_path)
    args = [a.format(bam=bam, pairs=pairs, bed=bed) for a in argv]
    monkeypatch.setattr(coverage_cmd, "STREAM_COLS", 1 << 14)
    got = {}
    for dev in (None, "cpu"):
        kernels.reset_launches()
        buf = io.StringIO()
        old = sys.stdin
        sys.stdin = io.TextIOWrapper(open(bam, "rb"))
        try:
            with contextlib.redirect_stdout(buf):
                assert cli.main([cmd, *args], device=dev) == 0
        finally:
            sys.stdin.close()
            sys.stdin = old
        got[dev] = buf.getvalue()
        launched = dict(kernels.launches)
        if dev is None:
            assert launched["segment_contract"] >= 1
            k9 = "cov_reduce" if cmd == "coverage" else "depth_scan"
            assert launched[k9] >= 1
            assert {k for k, v in launched.items() if v} == {
                "segment_contract", k9}, launched
        else:
            assert not any(launched.values())
    assert got[None].count("\n") > 1
    assert got[None] == got["cpu"]


def _apply_group(L, n, seed):
    """A uniform group of n all-M reads of L bases on a 64 kbp contig:
    (contig codes, pos, nt16 bases, quals)."""
    ref_len = 1 << 16
    ref = sim.simulate_reference(ref_len, seed=seed)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = sim.simulate_batch(ref_len=ref_len - L - 8,
                           coverage=n * L / (ref_len - L - 8) + 1,
                           read_len=L, seed=seed, paired=False,
                           err_rate=0.02, ref=ref[:ref_len - L - 8])
    k = np.arange(n)
    idx = b.seq_off[k][:, None] + np.arange(L)[None, :]
    return lut[ref], b.pos[k].astype(np.int64), b.seq[idx], b.qual[idx]


@pytest.mark.parametrize("L", [37, 100, 151])
def test_baq_apply_equals_plain(cuda, L):
    """K8 on the card against its plain version on the CPU, in chunks of
    512 reads with a ragged last one: the applied quals equal on every
    read neither flags risky, and at most 1% of reads in the symmetric
    difference of the risky sets."""
    ref_int, pos, seq, qual = _apply_group(L, 1300, L)
    before = kernels.launches["baq_apply"]
    kq, kr = bd.baq_apply_nt16(torch.from_numpy(ref_int).to(cuda), pos, seq,
                               qual, chunk=512)
    assert kernels.launches["baq_apply"] == before + 3
    pq, pr = bd.baq_apply_nt16(torch.from_numpy(ref_int), pos, seq, qual,
                               chunk=512)
    assert kq.shape == (1300, L) and kq.dtype == np.uint8
    ok = ~(kr | pr)
    assert (kr ^ pr).sum() <= 13
    assert np.array_equal(kq[ok], pq[ok])
    assert (kq[ok] != qual[ok]).any()


def test_apply_baq_batch_on_card_equals_host(cuda, monkeypatch):
    """apply_baq_batch with K8 (groups of 256 reads and up): the quals
    equal the host library's f64 HMM byte for byte, risky reads
    recomputed there."""
    from samtools_tpu_torch.io import native
    from samtools_tpu_torch.ops import baq
    monkeypatch.setattr(baq, "DEVICE_GROUP_MIN", 256)
    ref = sim.simulate_reference(1 << 16, seed=21)
    b = sim.simulate_batch(ref_len=1 << 16, coverage=8.0, read_len=100,
                           seed=22, paired=False, err_rate=0.02, ref=ref)
    sim.simulate_messy(b, 22)
    ref_int = baq._ref_ints(ref.tobytes())
    want, _ = native.baq_batch(b.pos, b.cigar, b.cigar_off, b.seq, b.qual,
                               b.seq_off, ref_int, flag=3)
    before = kernels.launches["baq_apply"]
    baq.apply_baq_batch(b, ref_int, device=cuda)
    assert kernels.launches["baq_apply"] > before
    assert np.array_equal(b.qual, want)


def test_stable_order_equals_host_sort(cuda):
    """K13 on the card equals np.argsort(kind="stable") on keys with many
    ties; keys whose span passes int32 take the host's sort and no
    launch."""
    from samtools_tpu_torch.ops import pileup
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 20, 3_000_001).astype(np.int32)
    before = kernels.launches["stable_order"]
    got = pileup.stable_order(torch.from_numpy(keys).to(cuda)).cpu().numpy()
    assert kernels.launches["stable_order"] == before + 1
    assert np.array_equal(got, np.argsort(keys, kind="stable"))
    pos = keys.astype(np.int64) * 4096 + 7
    assert int(pos.max()) - int(pos.min()) >= 1 << 31
    wide = pileup.entry_order(pos, cuda)
    assert kernels.launches["stable_order"] == before + 1
    assert np.array_equal(wide, np.lexsort((np.arange(pos.size), pos)))
    assert np.array_equal(pileup.entry_order(pos[:100000] % 99991, cuda),
                          np.argsort(pos[:100000] % 99991, kind="stable"))


@pytest.mark.parametrize("cmd,argv", [
    ("mpileup", ["-f", "{fa}", "-s", "-O", "{bam}", "{pairs}"]),
    ("mpileup", ["-f", "{fa}", "-r", "sim1:20001-90000", "--output-extra",
                 "FLAG,POS", "{bam}"]),
    ("coverage", ["-m", "{bam}", "{pairs}"])])
def test_general_path_on_card_equals_cpu(cuda, tmp_path, monkeypatch, cmd,
                                         argv):
    """mpileup's general path (two files with -s -O; -r with extra
    columns) and coverage -m on the card print the CPU port's bytes, with
    K13 (and, for mpileup, K8 at groups of 256 reads) launched and K1's
    census form not."""
    import contextlib
    import io

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.ops import baq
    monkeypatch.setattr(baq, "DEVICE_GROUP_MIN", 256)
    bam, pairs, _ = _pileup_inputs(tmp_path)
    fa = str(tmp_path / "ref.fa")
    ref = sim.simulate_reference(1 << 17, seed=7)
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + b"".join(ref[i:i + 60].tobytes() + b"\n"
                                      for i in range(0, ref.size, 60)))
    args = [a.format(bam=bam, pairs=pairs, fa=fa) for a in argv]
    got = {}
    for dev in (None, "cpu"):
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main([cmd, *args], device=dev) == 0
        got[dev] = buf.getvalue()
        launched = dict(kernels.launches)
        if dev is None:
            assert launched["stable_order"] >= 1
            assert (launched["baq_apply"] >= 1) == (cmd == "mpileup")
            assert launched["apply_expand"] == launched["baq_apply"]
            assert launched["segment_census"] == 0
    assert got[None].count("\n") > 10
    assert got[None] == got["cpu"]


def _segsum_case(seed, depths, keep_share=0.95, quals=(1, 101), b6s=6):
    """K10's inputs: columns of the given depths (ragged, some empty) of
    random (b6, q, q2, keep) entries, q and q2 drawn from ``quals`` (a
    range, or the values of a binned scale)."""
    from samtools_tpu_torch.ops import consensus_vec as cv
    from samtools_tpu_torch.tools.consensus_cmd import ConsProbs, Opts
    rng = np.random.default_rng(seed)
    o = Opts()
    cp = ConsProbs(o.P_het, o.P_indel, o.het_scale, o.homopoly_redux,
                   o.qcal, o.mode)
    col_off = np.concatenate([[0], np.cumsum(depths)]).astype(np.int64)
    n = int(col_off[-1])

    def qs():
        if isinstance(quals, tuple):
            return rng.integers(*quals, n)
        return rng.choice(np.asarray(quals), n)
    ent = np.stack([rng.integers(0, b6s, n), qs(), qs(),
                    rng.random(n) < keep_share], 1).astype(np.uint8)
    T = cv.segsum_table(cp, torch.device("cpu"))
    return T, torch.from_numpy(ent), torch.from_numpy(col_off), cp


@pytest.mark.parametrize("case", ["ragged", "deep", "none_kept", "amplicon",
                                  "overflow", "binned"])
def test_consensus_segsum_equals_plain(cuda, case):
    """K10 on the card equals its plain version on the CPU (f64 sums in
    entry order) and the host's f64 gap5_scores bit for bit, counts and
    depth too; on ragged columns with empty ones, a column of 20,000
    entries, keep all false, 2,000 amplicon columns 5,000 deep, q and q2
    uniform on 1-100 (more distinct rows than an SM's L1 holds) and quals
    binned to 4 values."""
    from samtools_tpu_torch.ops import consensus_vec as cv
    rng = np.random.default_rng(3)
    depths = rng.integers(0, 70, 3000)
    depths[::17] = 0
    kw = {}
    if case == "deep":
        depths[1500] = 20000
    elif case == "none_kept":
        kw["keep_share"] = 0.0
    elif case == "amplicon":
        depths = np.full(2000, 5000)
        kw.update(quals=(2, 41), b6s=4)
    elif case == "overflow":
        depths = rng.integers(20, 40, 60_000)
    elif case == "binned":
        kw["quals"] = [2, 12, 23, 37]
    T, ent, off, cp = _segsum_case(4, depths, **kw)
    want = cv.consensus_segsum_plain(T, ent, off)
    kernels.reset_launches()
    got = [t.cpu() for t in cv.consensus_segsum(T.to(cuda), ent.to(cuda),
                                                off.to(cuda))]
    assert kernels.launches["consensus_segsum"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    e = ent.numpy()
    S, counts, depth = cv.gap5_scores(off.numpy(), e[:, 0].astype(np.int64),
                                      e[:, 1].astype(np.int64),
                                      e[:, 2].astype(np.int64),
                                      e[:, 3] != 0, cp)
    assert np.array_equal(got[0].numpy().view(np.uint64), S.view(np.uint64))
    assert np.array_equal(got[1].numpy(), counts)
    assert np.array_equal(got[2].numpy(), depth)
    if case == "none_kept":
        assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("n", [0, 1, 255, 257, 100_003])
def test_flagstat_equals_plain(cuda, n):
    """K11 on the card equals its plain version exactly, at sizes that
    are and are not multiples of its block, and on no records."""
    from samtools_tpu_torch.ops import flagstat as fs
    rng = np.random.default_rng(n)
    args = (torch.from_numpy(rng.integers(0, 1 << 12, n).astype(np.uint16)),
            torch.from_numpy(rng.integers(0, 10, n).astype(np.uint8)),
            torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)))
    want = fs.flagstat_plain(*args)
    kernels.reset_launches()
    got = fs.flagstat_census(*(a.to(cuda) for a in args)).cpu()
    assert torch.equal(got, want)
    assert kernels.launches["flagstat"] == (1 if n else 0)


@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_flagstat_offset_views_equal_plain(cuda, offset):
    """K11 on views that start ``offset`` records into their tensors (a
    base not 16-byte aligned takes the kernel's scalar path), n % 8 != 0:
    the plain version's counts, one launch a call, the same counts on a
    second call (the scratch's ticket is back at zero)."""
    from samtools_tpu_torch.ops import flagstat as fs
    rng = np.random.default_rng(offset)
    n = 360_005
    full = (rng.integers(0, 1 << 12, n + 8).astype(np.uint16),
            rng.integers(0, 10, n + 8).astype(np.uint8),
            rng.integers(-1, 3, n + 8).astype(np.int32),
            rng.integers(-1, 3, n + 8).astype(np.int32))
    want = fs.flagstat_plain(*(torch.from_numpy(a[offset:offset + n])
                               for a in full))
    views = [torch.from_numpy(a).to(cuda)[offset:offset + n] for a in full]
    assert (views[0].data_ptr() % 16 == 0) == (offset % 8 == 0)
    for _ in range(2):
        kernels.reset_launches()
        got = fs.flagstat_census(*views).cpu()
        assert torch.equal(got, want)
        assert kernels.launches["flagstat"] == 1


def test_flagstat_on_card_never_takes_the_plain_version(cuda, monkeypatch):
    from samtools_tpu_torch.ops import flagstat as fs

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")
    monkeypatch.setattr(fs, "flagstat_plain", refuse)
    n = 1000
    got = fs.flagstat_census(
        torch.full((n,), 3, dtype=torch.uint16, device=cuda),
        torch.zeros(n, dtype=torch.uint8, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda))
    assert int(got[0, 0]) == n


def test_flagstat_on_two_streams_equals_plain(cuda):
    """K11 launched on two streams with both launches in flight at once,
    then again on the first: each stream has its own scratch (partials
    and ticket), so every call gives its own input's plain counts."""
    from samtools_tpu_torch.ops import flagstat as fs
    inputs = []
    for seed, n in ((1, 2_000_003), (2, 1_500_001)):
        rng = np.random.default_rng(seed)
        inputs.append((
            torch.from_numpy(rng.integers(0, 1 << 12, n).astype(np.uint16)),
            torch.from_numpy(rng.integers(0, 10, n).astype(np.uint8)),
            torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32))))
    want = [fs.flagstat_plain(*a) for a in inputs]
    on_card = [[t.to(cuda) for t in a] for a in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    kernels.reset_launches()
    got = []
    for _ in range(3):
        for s, a in zip(streams, on_card):
            with torch.cuda.stream(s):
                got.append(fs.flagstat_census(*a))
    torch.cuda.synchronize()
    assert kernels.launches["flagstat"] == 6
    for k, g in enumerate(got):
        assert torch.equal(g.cpu(), want[k % 2])
    assert len({k for k in kernels._SCRATCH if k[0] == "flagstat"}) >= 2


def test_census_narrow_on_two_streams_equals_plain(cuda):
    """K7n on two streams in turns, with types that differ from one call
    to the next (u8/u16, then int32/int32): each stream has its own
    scratch and each call its own maxima, so every call gives the plain
    version's types and bytes in one launch."""
    cens = []
    for seed, hi in ((3, 200), (4, 1 << 20)):
        rng = np.random.default_rng(seed)
        c = rng.integers(0, hi, (2_000_003, 6)).astype(np.int32)
        cens.append(c)
    want = [md.census_narrow_plain(torch.from_numpy(c), len(c))
            for c in cens]
    on_card = [torch.from_numpy(c).to(cuda) for c in cens]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(2):
        for s, c, w in zip(streams, on_card, want):
            kernels.reset_launches()
            with torch.cuda.stream(s):
                got = md.census_narrow(c, c.shape[0])
            assert kernels.launches["census_narrow"] == 1
            assert got[1:] == w[1:]
            assert torch.equal(got[0].cpu(), w[0])
    assert len({k for k in kernels._SCRATCH
                if k[0] == "census_narrow"}) >= 2


def test_census_narrow_from_two_threads_equals_plain(cuda):
    """K7n called from two threads at once on one stream, on censuses of
    other types (u8/u16 and int32/int32): each call reads its own maxima,
    so each gives the plain version's types and bytes."""
    from concurrent.futures import ThreadPoolExecutor
    cens, want = [], []
    for seed, hi in ((5, 200), (6, 1 << 20)):
        rng = np.random.default_rng(seed)
        c = rng.integers(0, hi, (1 << 20, 6)).astype(np.int32)
        want.append(md.census_narrow_plain(torch.from_numpy(c), len(c)))
        cens.append(torch.from_numpy(c).to(cuda))

    def calls(k):
        got = []
        for _ in range(20):
            buf, cdt, qdt = md.census_narrow(cens[k], cens[k].shape[0])
            got.append((buf.cpu(), cdt, qdt))
        return got
    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(calls, (0, 1)))
    for got, w in zip(results, want):
        for buf, cdt, qdt in got:
            assert (cdt, qdt) == w[1:]
            assert torch.equal(buf, w[0])


def _consensus_inputs(tmp_path):
    from samtools_tpu_torch.io.bam import write_bam
    L = 1 << 16
    ref = sim.simulate_reference(L, seed=9)
    b = sim.simulate_batch(ref_len=L, coverage=8.0, read_len=100, seed=10,
                           paired=False, err_rate=0.02, ref=ref)
    sim.simulate_messy(b, 12)
    bam = str(tmp_path / "cons.bam")
    write_bam(bam, sim.make_header(L), b)
    return bam


@pytest.mark.parametrize("argv", [
    ["consensus", "{bam}"],
    ["consensus", "-a", "--show-ins", "yes", "--show-del", "yes", "-f",
     "fastq", "-r", "sim1:1001-50000", "{bam}"],
    ["consensus", "-m", "bayesian_m", "{bam}"],
    ["flagstat", "{bam}"], ["flagstat", "-O", "json", "{bam}"]])
def test_consensus_and_flagstat_on_card_equal_cpu(cuda, tmp_path, argv):
    """consensus and flagstat on the card print the CPU port's bytes;
    consensus launches K10 and K13, flagstat K11."""
    import contextlib
    import io

    from samtools_tpu_torch import cli
    bam = _consensus_inputs(tmp_path)
    args = [a.format(bam=bam) for a in argv]
    got = {}
    for dev in (None, "cpu"):
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(args, device=dev) == 0
        got[dev] = buf.getvalue()
        launched = dict(kernels.launches)
        if dev is None:
            if args[0] == "consensus":
                assert launched["consensus_segsum"] >= 1
                assert launched["stable_order"] >= 1
            else:
                assert launched["flagstat"] >= 1
    assert got[None].count("\n") > 1
    assert got[None] == got["cpu"]


def test_mpileup_checkpoint_resume_on_card(cuda, tmp_path, monkeypatch):
    """mpileup --checkpoint on the card, cut after its middle window and
    resumed: the uninterrupted bytes."""
    import json
    import os

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.tools import mpileup_cmd
    bam = _consensus_inputs(tmp_path)
    fa = str(tmp_path / "ref.fa")
    ref = sim.simulate_reference(1 << 16, seed=9)
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + ref.tobytes() + b"\n")
    monkeypatch.setattr(mpileup_cmd, "WINDOW_COLS", 1 << 13)
    full, out = str(tmp_path / "full.txt"), str(tmp_path / "ck.txt")
    ck = str(tmp_path / "ck.json")
    assert cli.main(["mpileup", "-f", fa, bam, "-o", full]) == 0
    states = []
    orig = os.replace

    def spy(a, b):
        orig(a, b)
        if b == ck:
            with open(ck) as g:
                states.append(json.load(g))
    monkeypatch.setattr(os, "replace", spy)
    assert cli.main(["mpileup", "-f", fa, bam, "-o", out, "--checkpoint",
                     ck]) == 0
    with open(full, "rb") as f:
        truth = f.read()
    with open(out, "rb") as f:
        assert f.read() == truth
    mid = states[len(states) // 2]
    with open(ck, "w") as g:
        json.dump(mid, g)
    with open(out, "r+") as f:
        f.truncate(mid["out_off"])
        f.seek(mid["out_off"])
        f.write("PARTIAL###")
    kernels.reset_launches()
    assert cli.main(["mpileup", "-f", fa, bam, "-o", out, "--checkpoint",
                     ck]) == 0
    assert kernels.launches["segment_census"] >= 1
    with open(out, "rb") as f:
        assert f.read() == truth


def _stats_reads(nbases: int, seed: int, n: int, shape: str = "uniform"):
    """Reads of 1..nbases bases with every nt16 code, quals up to 255,
    orders 0/1/2 and both strands, as flat batch columns.  ``shape``:
    ``binned`` quals on 4 values; ``gaps``, runs of selected reads with
    long gaps between; ``empty``, a quarter of the reads with no bases;
    ``single``, one selected read."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, nbases + 1, n)
    lens[0] = nbases
    if shape == "empty":
        lens[1:][rng.random(n - 1) < 0.25] = 0
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    seq = rng.integers(0, 16, int(off[-1])).astype(np.uint8)
    qual = rng.integers(0, 256, int(off[-1])).astype(np.uint8)
    if shape == "binned":
        qual = np.array([2, 12, 23, 37], np.uint8)[qual % 4]
    oidx = np.flatnonzero(rng.random(n) < 0.9).astype(np.int64)
    if shape == "gaps":
        oidx = oidx[(oidx // 700) % 3 == 0]
    elif shape == "single":
        oidx = oidx[:1]
    order = rng.integers(0, 3, oidx.size).astype(np.uint8)
    rev = rng.integers(0, 2, oidx.size).astype(np.uint8)
    return seq, qual, off, oidx, order, rev


@pytest.mark.parametrize("nbases,n,shape", [
    pytest.param(1, 500, "uniform", id="1-500"),
    pytest.param(100, 20_000, "uniform", id="100-20000"),
    pytest.param(300, 7000, "uniform", id="300-7000"),
    pytest.param(1000, 3000, "uniform", id="1000-3000"),
    pytest.param(40, 0, "uniform", id="40-0"),
    pytest.param(100, 70_000, "binned", id="binned"),
    pytest.param(20_000, 60, "uniform", id="reads-of-20000"),
    pytest.param(150, 20_000, "gaps", id="gaps"),
    pytest.param(150, 20_000, "empty", id="empty-reads"),
    pytest.param(300, 50, "single", id="single-read")])
def test_stats_hists_equals_plain_and_host(cuda, nbases, n, shape):
    """K12 on the card equals its plain version and the host library's
    pass exactly, one launch a chunk (none for no reads); on uniform
    reads, quals binned to 4 values (shared-atomic collisions), reads of
    20,000 bases (a hundred row tiles), gaps in oidx, reads with no bases,
    a single read."""
    from samtools_tpu_torch.io import native
    from samtools_tpu_torch.ops import stats_kernels as sk
    seq, qual, off, oidx, order, rev = _stats_reads(nbases, nbases + n,
                                                    max(n, 1), shape)
    if n == 0:
        oidx = oidx[:0]
        order, rev = order[:0], rev[:0]
    for qrows in (nbases, nbases + 1):
        kernels.reset_launches()
        got = sk.orig_hists(seq, qual, off, oidx, order, rev, nbases, qrows,
                            cuda)
        torch.cuda.synchronize()
        assert kernels.launches["stats_hists"] == (1 if n else 0)
        want = sk.orig_hists(seq, qual, off, oidx, order, rev, nbases,
                             qrows, torch.device("cpu"))
        assert all(np.array_equal(got[k], want[k]) for k in want)
        host = [np.zeros((qrows, 257), np.int64) for _ in range(2)] + [
            np.zeros((nbases, 6), np.int64) for _ in range(3)]
        gc, qsum, mq = native.stats_orig_hists(seq, qual, off, oidx, order,
                                               rev, nbases, *host)
        assert all(np.array_equal(got[k], h) for k, h in
                   zip(("q1", "q2", "a1", "a2", "ar"), host))
        assert np.array_equal(got["gc"], gc)
        assert np.array_equal(got["qsum"], qsum)
        assert int(got["maxq"][0]) == mq


def test_stats_hists_on_card_never_takes_the_plain_version(cuda,
                                                            monkeypatch):
    from samtools_tpu_torch.ops import stats_kernels as sk

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")
    monkeypatch.setattr(sk, "stats_hists_plain", refuse)
    seq, qual, off, oidx, order, rev = _stats_reads(100, 1, 100)
    got = sk.orig_hists(seq, qual, off, oidx, order, rev, 100, 101, cuda)
    assert got["q1"].sum() > 0


@pytest.mark.parametrize("cmax,qmax", [(200, 60_000), (300, 70_000),
                                       (70_000, 100)])
def test_census_narrow_equals_plain(cuda, cmax, qmax):
    """K7n on the card: the plain version's types and bytes, one
    launch."""
    rng = np.random.default_rng(cmax)
    wlen = 200_003
    c = np.zeros((1 << 18, 6), np.int32)
    c[:wlen, :5] = rng.integers(0, cmax + 1, (wlen, 5))
    c[:wlen, 5] = rng.integers(0, qmax + 1, wlen)
    c[5, 1], c[6, 5] = cmax, qmax
    c[wlen + 3] = 1 << 30            # past the window: not fetched
    want = md.census_narrow_plain(torch.from_numpy(c), wlen)
    kernels.reset_launches()
    got = md.census_narrow(torch.from_numpy(c).to(cuda), wlen)
    torch.cuda.synchronize()
    assert kernels.launches["census_narrow"] == 1
    assert got[1:] == want[1:]
    assert torch.equal(got[0].cpu(), want[0])


# (largest count, largest qual sum) at the types' edges
NARROW_EDGES = [(255, 65_535), (256, 65_536), (65_535, 255),
                (65_536, 65_535), (0, 0)]


@pytest.mark.parametrize("wlen", [1, 17, 1 << 20, 2_000_003])
@pytest.mark.parametrize("edge", range(len(NARROW_EDGES)))
def test_census_narrow_edges_equal_plain(cuda, wlen, edge):
    """K7n with the maxima exactly at 255/256 and 65,535/65,536, larger
    values in the rows at and past wlen (ignored); one row, a window of
    1 Mi rows (all staged) and one past the shared memory's capacity
    (unstaged rows, an odd count): the plain version's types and bytes,
    one launch a call, the same on a second call."""
    cmax, qmax = NARROW_EDGES[edge]
    rng = np.random.default_rng(wlen + edge)
    c = np.zeros((wlen + 64, 6), np.int32)
    c[:wlen, :5] = rng.integers(0, cmax + 1, (wlen, 5))
    c[:wlen, 5] = rng.integers(0, qmax + 1, wlen)
    c[wlen - 1, 4], c[0, 5] = cmax, qmax
    c[wlen:] = 1 << 30
    want = md.census_narrow_plain(torch.from_numpy(c), wlen)
    cd = torch.from_numpy(c).to(cuda)
    blocks, rows, staged = md.narrow_plan(wlen,
                                          *md._narrow_limits(cd.device))
    if wlen == 2_000_003:
        assert staged < rows
    for _ in range(2):
        kernels.reset_launches()
        got = md.census_narrow(cd, wlen)
        torch.cuda.synchronize()
        assert kernels.launches["census_narrow"] == 1
        assert got[1:] == want[1:]
        assert torch.equal(got[0].cpu(), want[0])


def test_census_narrow_on_card_never_takes_the_plain_version(cuda,
                                                              monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")
    monkeypatch.setattr(md, "census_narrow_plain", refuse)
    c = torch.ones(4096, 6, dtype=torch.int32, device=cuda)
    buf, cdt, qdt = md.census_narrow(c, 4000)
    assert (cdt, qdt) == (torch.uint8, torch.uint16)
    assert int(buf[:20000].sum()) == 20000


def test_stats_on_card_equals_host_branch(cuda, tmp_path, monkeypatch):
    """stats on the card (K12 every chunk) prints the host branch's
    bytes, with and without -r."""
    import contextlib
    import io

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.tools import stats_batch
    bam = _consensus_inputs(tmp_path)
    fa = str(tmp_path / "ref.fa")
    ref = sim.simulate_reference(1 << 16, seed=9)
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + ref.tobytes() + b"\n")
    monkeypatch.setattr(stats_batch, "CHUNK_RECORDS", 2000)
    for extra in ([], ["-r", fa]):
        got = {}
        for engine in ("card", "host"):
            if engine == "host":
                monkeypatch.setenv("SAMTPU_DEVICE", "0")
            kernels.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["stats", *extra, bam]) == 0
            got[engine] = buf.getvalue()
            if engine == "card":
                assert kernels.launches["stats_hists"] >= 2
            else:
                assert not any(kernels.launches.values())
            monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
        assert got["card"].count("\n") > 100
        assert got["card"] == got["host"]


def test_mpileup_region_through_index_on_card(cuda, tmp_path):
    """``mpileup -r`` on an indexed BAM of more than 50 BGZF blocks reads
    the index's chunks on the card and prints the bytes of the same run on
    an unindexed copy; both launch the census form, K4 and K5."""
    import contextlib
    import io
    import shutil

    from samtools_tpu_torch import cli
    from samtools_tpu_torch.io import bgzf, stream
    from samtools_tpu_torch.io.bam import write_bam
    L = 1 << 17
    ref = sim.simulate_reference(L, seed=7)
    b = sim.simulate_batch(ref_len=L, coverage=20.0, read_len=100, seed=21,
                           paired=False, err_rate=0.01, ref=ref)
    sim.simulate_messy(b, 21)
    bam, fa = str(tmp_path / "in.bam"), str(tmp_path / "ref.fa")
    write_bam(bam, sim.make_header(L), b)
    with open(bam, "rb") as f:
        assert bgzf.scan_blocks(f.read())[0].size > 50
    shutil.copy(bam, str(tmp_path / "whole.bam"))
    assert cli.main(["index", bam]) == 0
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + b"".join(ref[i:i + 60].tobytes() + b"\n"
                                      for i in range(0, L, 60)))
    queried = []
    real = stream.BamStream.query

    def counting(self, *a, **k):
        queried.append(1)
        return real(self, *a, **k)
    got = {}
    for which in ("in", "whole"):
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() \
                as m:
            m.setattr(stream.BamStream, "query", counting)
            assert cli.main(["mpileup", "-f", fa, "-r", "sim1:40001-60000",
                             str(tmp_path / f"{which}.bam")]) == 0
        got[which] = buf.getvalue()
        assert all(kernels.launches[k] > 0 for k in
                   ("segment_census", "baq_hmm", "baq_finalize"))
        assert kernels.launches["segment_contract"] == 0
        assert len(queried) == 1      # the indexed run's one query
    assert got["in"].count("\n") > 19_000
    assert got["in"] == got["whole"]


@pytest.mark.parametrize("cmd,argv,kernels_used", [
    ("targetcut", ["-f", "{dip_fa}", "{dip}"],
     ("baq_apply", "apply_expand", "baq_hmm", "baq_finalize",
      "stable_order")),
    ("phase", ["{dip}"], ("stable_order",)),
    ("tview", ["-d", "T", "-w", "150", "-p", "sim1:3001", "{dip}",
               "{dip_fa}"], ("stable_order",))])
def test_pileup_tools_on_card_equal_host_branch(cuda, tmp_path, monkeypatch,
                                                cmd, argv, kernels_used):
    """targetcut -f, phase and tview on the diploid fixture launch their
    kernels on the card (K8, with its front, K4 and K5, and K13 for
    targetcut -f; K13 for phase and tview) and print the host branch's
    bytes."""
    from torch_tool_fixtures import make_diploid_inputs, run_port_full
    inputs = make_diploid_inputs(str(tmp_path))
    args = [a.format(**inputs) for a in argv]
    monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
    kernels.reset_launches()
    card = run_port_full(cmd, args, device=None)
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    kernels.reset_launches()
    host = run_port_full(cmd, args, device=None)
    assert not any(kernels.launches.values())
    assert card[0] == 0 and card[1].count(b"\n") > 1
    assert card == host
    assert all(launched[k] >= 1 for k in kernels_used), launched
    assert {k for k, v in launched.items() if v} == set(kernels_used)
    if cmd == "tview":
        assert launched["stable_order"] == 1        # one draw
    assert launched["apply_expand"] == launched["baq_apply"]


def _k14_items(seed, n, window):
    """Items over [-window/8, window * 9/8) with the edge lanes -1, 32,
    40, -33 spliced in and a tenth invalid."""
    rng = np.random.default_rng(seed)
    refpos = rng.integers(-window // 8, window + window // 8, n)
    lane = rng.integers(0, 32, n)
    if n >= 40:
        lane[rng.choice(n, 40, replace=False)] = np.repeat([-1, 32, 40, -33],
                                                           10)
    valid = rng.random(n) > 0.1
    qual = rng.integers(0, 61, n)
    return [torch.from_numpy(a) for a in (
        refpos.astype(np.int32), lane.astype(np.int32), valid,
        qual.astype(np.int32))]


@pytest.mark.parametrize("n,window", [(0, 64), (1000, 8), (65536, 1700),
                                      (65536, 1 << 14), (300_000, 1 << 20)])
def test_pileup_scatter_equals_plain(cuda, n, window):
    """K14's scatter entry on random items over small and large windows
    (chunks private below 256 rows, global above), counts and qual sums,
    equal to the plain version exactly."""
    from samtools_tpu_torch.ops import pileup_device as pd
    rp, ln, ok, q = _k14_items(n + window, n, window)
    for weight in (None, q):
        want = pd.pileup_scatter_plain(rp, ln, ok, window, weight)
        before = kernels.launches["pileup_scatter"]
        got = pd.pileup_scatter(rp.to(cuda), ln.to(cuda), ok.to(cuda),
                                window, None if weight is None
                                else weight.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches["pileup_scatter"] == before + (n > 0)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_tiles,B,tile", [(1, 1, 8), (40, 300, 512),
                                            (3, 5000, 128), (2, 100, 4096)])
def test_pileup_tiled_equals_plain(cuda, n_tiles, B, tile):
    """K14's tiled entry (a block a tile; a tile of 4,096 rows zeroes its
    rows in global memory and adds there) equal to the plain version
    exactly."""
    from samtools_tpu_torch.ops import pileup_device as pd
    rng = np.random.default_rng(n_tiles * B)
    posrel = torch.from_numpy(rng.integers(-3, tile + 3, (n_tiles, B))
                              .astype(np.int32))
    lane = torch.from_numpy(rng.integers(-2, 34, (n_tiles, B))
                            .astype(np.int32))
    ok = torch.from_numpy(rng.random((n_tiles, B)) > 0.1)
    want = pd.pileup_tiled_plain(posrel, lane, ok, tile, n_tiles)
    before = kernels.launches["pileup_tiled"]
    got = pd.pileup_counts_tiled(posrel.to(cuda), lane.to(cuda),
                                 ok.to(cuda), tile, n_tiles)
    torch.cuda.synchronize()
    assert kernels.launches["pileup_tiled"] == before + 1
    assert torch.equal(got.cpu(), want)


def _scatter_on_card(cuda, rp, ln, ok, q, window):
    """K14's scatter, counts and qual sums, on the card against the plain
    version on the CPU: one launch a call."""
    from samtools_tpu_torch.ops import pileup_device as pd
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (rp, ln, ok, q)]
    for weight in (None, t[3]):
        want = pd.pileup_scatter_plain(*t[:3], window, weight)
        before = kernels.launches["pileup_scatter"]
        got = pd.pileup_scatter(*(a.to(cuda) for a in t[:3]), window,
                                None if weight is None else weight.to(cuda))
        torch.cuda.synchronize()
        assert kernels.launches["pileup_scatter"] == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", k14.SCATTER_CASES)
def test_pileup_scatter_hard_shapes_equal_plain(cuda, case):
    """The redesigned scatter on its hard shapes (read order, reversed,
    random, 100,000 items on one cell, chunks at the private budget and
    one row over it, ragged and one-item calls, a one-row window, the edge
    lanes), counts and qual sums equal to the plain version."""
    _scatter_on_card(cuda, *k14.scatter_case(case,
                                             kernels.sm_count(cuda)))


@pytest.mark.parametrize("chunk,budget", [(16, 0), (16, 1), (256, 1700),
                                          (2048, 96), (1024, 64)])
def test_pileup_scatter_any_chunk_and_budget_equals_plain(cuda, chunk,
                                                          budget):
    """The C entry with other chunks and budgets than the wrapper's (every
    chunk global; tiny chunks; chunks larger than the items' window) on
    read-order items, and on offset views (staging from unaligned
    addresses), equal to the plain version."""
    from samtools_tpu_torch.ops import pileup_device as pd
    rp, ln, ok, q, window = k14.read_order()
    for off in (0, 1, 3):
        # on the card first, then cut: the views keep the offset
        t = [torch.from_numpy(np.concatenate([a[:off], a])).to(cuda)[off:]
             for a in (rp, ln, ok, q)]
        for weight in (None, t[3]):
            out = torch.zeros(window, 32, dtype=torch.int32, device=cuda)
            rc = kernels._load().samtpu_pileup_scatter(
                t[0].data_ptr(), t[1].data_ptr(),
                None if weight is None else weight.data_ptr(),
                t[2].data_ptr(), t[0].numel(), window, chunk, budget,
                out.data_ptr(), kernels.stream_of(out))
            torch.cuda.synchronize()
            assert rc == 0
            want = pd.pileup_scatter_plain(*(a.cpu() for a in t[:3]),
                                           window, None if weight is None
                                           else weight.cpu())
            assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("chunk,budget", [(4096, 64), (100, 64),
                                          (2048, 5000), (0, 64), (256, -1)])
def test_pileup_scatter_rejects_a_chunk_or_budget_it_does_not_take(
        cuda, chunk, budget):
    """A chunk above 2,048 items or not a multiple of 16, or a budget
    beyond shared memory or negative: cudaErrorInvalidValue, nothing
    launched."""
    t = torch.zeros(64, dtype=torch.int32, device=cuda)
    out = torch.zeros(8, 32, dtype=torch.int32, device=cuda)
    rc = kernels._load().samtpu_pileup_scatter(
        t.data_ptr(), t.data_ptr(), None, t.data_ptr(), 64, 8, chunk,
        budget, out.data_ptr(), kernels.stream_of(out))
    torch.cuda.synchronize()
    assert rc == 1 and int(out.abs().sum()) == 0


@pytest.mark.parametrize("case", k14.TILED_CASES)
@pytest.mark.parametrize("offset", [0, 5])
def test_pileup_tiled_hard_shapes_equal_plain(cuda, case, offset):
    """The redesigned tiled entry on bucketed read-order items (B a
    multiple of 16 and not), 100,000 items on one cell, one-row tiles and
    rows and lanes past both ends, from aligned tensors (16-item groups)
    and from views 5 items in (item by item), equal to the plain
    version."""
    from samtools_tpu_torch.ops import pileup_device as pd
    posrel, lane, ok, tile, n_tiles = k14.tiled_case(case)
    # on the card first, then cut: the views keep the offset
    t = [torch.from_numpy(np.concatenate([a.ravel()[:offset], a.ravel()]))
         .to(cuda)[offset:].view(a.shape) for a in (posrel, lane, ok)]
    want = pd.pileup_tiled_plain(*(a.cpu() for a in t), tile, n_tiles)
    before = kernels.launches["pileup_tiled"]
    got = pd.pileup_counts_tiled(*t, tile, n_tiles)
    torch.cuda.synchronize()
    assert kernels.launches["pileup_tiled"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_mesh_of_the_card_equals_unsharded(cuda):
    """A 4-shard mesh of the one card: the flag census and a depth window
    equal the unsharded card runs; K11 launches once a shard, K1 once a
    shard with items."""
    from samtools_tpu_torch.ops import flagstat as fs
    from samtools_tpu_torch.ops import pileup_engine as pe
    from samtools_tpu_torch.parallel import mesh as M
    L = 1 << 18
    b = sim.simulate_messy(sim.simulate_batch(
        ref_len=L, coverage=10.0, read_len=100, seed=9, paired=False), 9)
    mesh = M.make_mesh(1, 4, [cuda] * 4)
    before = kernels.launches["flagstat"]
    assert M.flagstat_counts_sharded(mesh, b) == fs.flagstat_counts(b, cuda)
    assert kernels.launches["flagstat"] == before + 4 + 1
    sel = np.arange(b.n)
    for min_qual, count_del in ((0, False), (13, True)):
        want = pe.depth_window_device(b, sel, 0, L, min_qual, count_del,
                                      device=cuda)
        before = kernels.launches["segment_contract"]
        got = M.depth_window_sharded(mesh, b, sel, 0, L, min_qual,
                                     count_del)
        assert kernels.launches["segment_contract"] - before == \
            4 * (2 if min_qual else 1)
        assert np.array_equal(got, want)


# ----------------------------------------------- K6's front and tail, K7
TABLE = torch.from_numpy(md.NT16_TO4)


def _on_card_at(t: torch.Tensor, cuda, offset: int = 0) -> torch.Tensor:
    """``t`` copied to the card, its data ``offset`` bytes past an
    allocation's start."""
    flat = torch.empty(t.numel() * t.element_size() + offset,
                       dtype=torch.uint8, device=cuda)
    view = flat[offset:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def _assert_same_tensors(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.float32:      # bit for bit
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), k


def _expand_case(case: str):
    lq = int(case.split("-")[1])
    if case.startswith("synthetic"):
        return (*cc.synthetic_chunk(lq, 1000, ref_len=1 << 14, seed=lq), lq)
    n = 65536 if case.endswith("65536") else 3000
    return (*cc.simulated_chunk(lq, case.startswith("messy"), n,
                                ref_len=1 << 18), lq)


@pytest.mark.parametrize("case", [
    "clean-100-65536", "messy-100-65536", "clean-150-65536",
    "messy-150-3000", "clean-37-3000", "synthetic-37", "synthetic-100",
    "synthetic-150", "synthetic-250"])
def test_chunk_expand_equals_plain(cuda, case):
    """K6's front on the card: the plain version's tensors byte for byte,
    one launch; the same from a buffer one byte past 16-byte alignment
    and from a chunk of one read."""
    buf, ref_int, lq = _expand_case(case)
    b, r = torch.from_numpy(buf), torch.from_numpy(ref_int)
    want = md.chunk_expand_plain(b, r, TABLE, lq)
    rc, tc = r.to(cuda), TABLE.to(cuda)
    for offset in (0, 1):
        before = kernels.launches["chunk_expand"]
        got = md.chunk_expand(_on_card_at(b, cuda, offset), rc, tc, lq)
        torch.cuda.synchronize()
        assert kernels.launches["chunk_expand"] == before + 1
        _assert_same_tensors(got, want)
    one = md.chunk_expand(b[:1].to(cuda), rc, tc, lq)
    _assert_same_tensors(one, md.chunk_expand_plain(b[:1], r, TABLE, lq))


@pytest.mark.parametrize("n_reads,lq,changed", [
    (65536, 100, "3%"), (65536, 100, "cap+1"), (65536, 150, "10%"),
    (65536, 100, 0), (65536, 100, "all"), (3001, 37, "cap"),
    (7, 37, "cap-1"), (1, 8, 3)])
def test_qual_deltas_equals_plain(cuda, n_reads, lq, changed):
    """K6's tail on the card: the plain version's count, list and values
    byte for byte (under, at and over capacity; nothing and everything
    changed; a capacity of 0), one launch, no host sync before the
    count is read."""
    n = n_reads * lq
    cap = n // 16
    d = {"3%": n * 3 // 100, "10%": n // 10, "cap-1": cap - 1, "cap": cap,
         "cap+1": cap + 1, "all": n}.get(changed, changed)
    appq, qq = cc.changed_quals(n_reads, lq, d, seed=n_reads + lq)
    a, q = torch.from_numpy(appq), torch.from_numpy(qq)
    want = md.qual_deltas_plain(a, q, cap)
    before = kernels.launches["qual_deltas"]
    got = md.qual_deltas(a.to(cuda), q.to(cuda), cap)
    assert kernels.launches["qual_deltas"] == before + 1
    assert int(got[0]) == int(want[0]) == d
    assert got[0].dim() == 0 and got[0].dtype == torch.int32
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    if n >= 32:
        with pytest.raises(ValueError):         # 16-byte aligned only
            md.qual_deltas(_on_card_at(a, cuda, 1), q.to(cuda), cap)


@pytest.mark.parametrize("wlen", [0, 1, 4095, 4096, 1 << 20,
                                  (8 << 20) + 3])
@pytest.mark.parametrize("negative", [False, True])
def test_census_checksum_equals_plain(cuda, wlen, negative):
    """K7 on the card: the plain version's two lanes (the host's
    ``census_checksum`` past 4,096 rows), rows past wlen ignored, one
    launch (none for no rows)."""
    c = cc.census_with_pad(wlen, wlen + 5, seed=wlen, negative=negative)
    if wlen <= 4096:
        want = md.census_checksum_plain(torch.from_numpy(c), wlen)
    else:
        want = md.census_checksum(c[:wlen, :5], c[:wlen, 5])
    before = kernels.launches["census_checksum"]
    assert md.census_checksum_dev(torch.from_numpy(c).to(cuda), wlen) == \
        want
    assert kernels.launches["census_checksum"] == before + (wlen > 0)


def test_chunk_kernels_on_two_streams_equal_plain(cuda):
    """K6's front and tail and K7 launched on two streams in turns, on
    inputs that differ: each call gives its own input's plain result."""
    cases = []
    for k, lq in enumerate((100, 150)):
        buf, ref_int = cc.simulated_chunk(lq, bool(k), 4000, ref_len=1 << 18)
        appq, qq = cc.changed_quals(4000, lq, 1000 * (k + 1), seed=k)
        wlen = 50_000 + k
        census = cc.census_with_pad(wlen, 60_000, seed=k)
        t = [torch.from_numpy(a) for a in (buf, ref_int, appq, qq, census)]
        want = (md.chunk_expand_plain(t[0], t[1], TABLE, lq),
                md.qual_deltas_plain(t[2], t[3], 4000 * lq // 16),
                md.census_checksum(census[:wlen, :5], census[:wlen, 5]))
        cases.append((lq, wlen, [a.to(cuda) for a in t], want))
    tc = TABLE.to(cuda)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(2):
        for s, (lq, wlen, (b, r, a, q, c), _) in zip(streams, cases):
            with torch.cuda.stream(s):
                got.append((md.chunk_expand(b, r, tc, lq),
                            md.qual_deltas(a, q, a.numel() // 16),
                            md.census_checksum_dev(c, wlen)))
    torch.cuda.synchronize()
    for k, (x, d, ck) in enumerate(got):
        want = cases[k % 2][3]
        _assert_same_tensors(x, want[0])
        assert int(d[0]) == int(want[1][0])
        assert torch.equal(d[1].cpu(), want[1][1])
        assert torch.equal(d[2].cpu(), want[1][2])
        assert ck == want[2]


def test_chunk_kernels_on_card_never_take_the_plain_version(cuda,
                                                            monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")
    for name in ("chunk_expand_plain", "qual_deltas_plain",
                 "census_checksum_plain"):
        monkeypatch.setattr(md, name, refuse)
    buf, ref_int = cc.synthetic_chunk(100, 64, ref_len=1 << 12)
    x = md.chunk_expand(torch.from_numpy(buf).to(cuda),
                        torch.from_numpy(ref_int).to(cuda), TABLE.to(cuda),
                        100)
    assert x["seg"].shape == (64, 100)
    q = torch.zeros(64, 100, dtype=torch.uint8, device=cuda)
    assert int(md.qual_deltas(q + 1, q, 400)[0]) == 6400
    c = torch.ones(4096, 6, dtype=torch.int32, device=cuda)
    assert md.census_checksum_dev(c, 4000) == md.census_checksum(
        np.ones((4000, 5), np.int64), np.ones(4000, np.int64))


# ------------------------------------------------ K8's front, K9's kernels
@pytest.mark.parametrize("L", [37, 100, 151])
def test_apply_expand_equals_plain(cuda, L):
    """K8's front on the card equals its plain version byte for byte on
    1,300 reads (rows of an odd L are not 4-byte aligned), with reads at
    and past the contig's last base and before its first (the clamps),
    and bytes that are no nt16 base."""
    from samtools_tpu_torch.ops import baq_device as bd
    ref_int, pos, seq, qual = _apply_group(L, 1300, L)
    pos[:4] = [ref_int.size - 1, ref_int.size + 500, -7, 1 << 30]
    seq[5, :7] = [0, 3, 5, 9, 15, 16, 255]
    buf = torch.from_numpy(cc.apply_buf(pos, seq, qual))
    ref = torch.from_numpy(ref_int)
    before = kernels.launches["apply_expand"]
    got = bd.apply_expand(ref.to(cuda), buf.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["apply_expand"] == before + 1
    seq[5, :7] = [0, 3, 5, 9, 15, 15, 15]     # the plain's table has 16
    want = bd.apply_expand_plain(
        ref, torch.from_numpy(cc.apply_buf(pos, seq, qual)))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[0][1] == ref_int[-1]).all())


def test_baq_apply_two_chunks_equals_plain(cuda):
    """K8 on APPLY_CHUNK + 1 reads: two chunks, the second of one read,
    whose per-read constants are views of the first's at its shape; the
    applied quals equal the plain version's (on the card) on every read
    neither flags risky, at most 1% in the symmetric difference of the
    risky sets, one front launch a chunk."""
    from samtools_tpu_torch.device import h2d
    from samtools_tpu_torch.ops import baq_device as bd
    n = bd.APPLY_CHUNK + 1
    ref_int, pos, seq, qual = _apply_group(100, n, 8)
    ref = torch.from_numpy(ref_int).to(cuda)
    before = dict(kernels.launches)
    kq, kr = bd.baq_apply_nt16(ref, pos, seq, qual)
    for k in ("apply_expand", "baq_apply", "baq_hmm", "baq_finalize"):
        assert kernels.launches[k] == before[k] + 2, k
    buf = cc.apply_buf(pos, seq, qual)
    parts = [bd.baq_apply_plain(ref, h2d(buf[lo:lo + bd.APPLY_CHUNK], cuda))
             for lo in (0, bd.APPLY_CHUNK)]
    pq = torch.cat([p[0] for p in parts]).cpu().numpy()
    pr = torch.cat([p[1] for p in parts]).cpu().numpy()
    ok = ~(kr | pr)
    assert (kr ^ pr).sum() <= n // 100
    assert kq.shape == (n, 100) and np.array_equal(kq[ok], pq[ok])


@pytest.mark.parametrize("edge", range(len(cc.apply_depth_script().EDGES)))
def test_depth_scan_edges_equal_plain(cuda, edge):
    """K9's depth scan on the card equals its plain version at the
    narrowing edges (maxima 255, 256, 32,767, 32,768, inside rows [0, L)
    or only past them, sums that wrap), with either column absent.  The
    contract holds for negative depths too, which K1's columns never
    give: under a max below 2^15 both return them wrapped to the width
    the max picks (uint8 or int16), as the JAX fetch narrows them."""
    from samtools_tpu_torch.ops import pileup_engine as pe
    script = cc.apply_depth_script()
    top, where, cols = script.EDGES[edge]
    rows = 3 * pe.DEPTH_TILE + 4100
    L = rows - 2000
    args = [None if c is None else torch.from_numpy(c[:, None])
            for c in script.edge_columns(rows, L, top, where, cols,
                                         np.random.default_rng(edge))]
    before = kernels.launches["depth_scan"]
    got = pe.depth_scan(*[None if a is None else a.to(cuda) for a in args],
                        L)
    assert kernels.launches["depth_scan"] == before + 1
    assert got.dtype == np.int32 and got.shape == (L,)
    assert np.array_equal(got, pe.depth_scan_plain(*args, L))


@pytest.mark.parametrize("rows,L", [(1, 1), (8192, 8192), (8193, 8193),
                                    (3 * 8192 + 5, 1000), (1 << 20, 999_999)])
def test_depth_scan_equals_plain(cuda, rows, L):
    """K9's depth scan on the card equals its plain version on random
    depths (0-59, none negative, as K1's columns give) at tile edges (one
    row, a tile, a tile and one, L well short of the rows), split between
    the two columns, or all in one."""
    from samtools_tpu_torch.ops import pileup_engine as pe
    rng = np.random.default_rng(rows)
    dep = rng.integers(0, 60, rows)
    part = np.minimum(rng.integers(0, 4, rows), dep)
    for cols in ((np.diff(dep - part, prepend=0), part),
                 (np.diff(dep, prepend=0), None), (None, dep)):
        args = [None if c is None else
                torch.from_numpy(c.astype(np.int32)[:, None]) for c in cols]
        got = pe.depth_scan(*[None if a is None else a.to(cuda)
                              for a in args], L)
        assert np.array_equal(got, pe.depth_scan_plain(*args, L))
        assert np.array_equal(got, dep[:L])


@pytest.mark.parametrize("case", range(5))
def test_cov_reduce_edges_equal_plain(cuda, case):
    """K9's coverage reduction on the card equals its plain version:
    rows not a multiple of sub, the min_depth gate, a subwindow's quality
    sum past 2^31, one row, sub past the rows."""
    from samtools_tpu_torch.ops import pileup_engine as pe
    script = cc.apply_depth_script()
    rows, sub, md_ = script.COV_EDGES[case]
    census = torch.from_numpy(script.cov_edge_census(
        rows, np.random.default_rng(case)))
    before = kernels.launches["cov_reduce"]
    got = pe.cov_reduce(census.to(cuda), sub, md_)
    assert kernels.launches["cov_reduce"] == before + 1
    assert torch.equal(got.cpu(), pe.cov_reduce_plain(census, sub, md_))
    # the tickets are left at zero: a second call gives the same
    assert torch.equal(pe.cov_reduce(census.to(cuda), sub, md_).cpu(),
                       got.cpu())


def test_k9_on_card_never_takes_the_plain_version(cuda, monkeypatch):
    """On CUDA tensors the K9 wrappers launch or raise: with the plain
    versions made to fail they still give the plain's results."""
    from samtools_tpu_torch.ops import baq_device as bd
    from samtools_tpu_torch.ops import pileup_engine as pe

    def boom(*a, **k):
        raise AssertionError("plain version called on the card")
    col = torch.ones(100, 1, dtype=torch.int32, device=cuda)
    census = torch.ones(100, 4, dtype=torch.int32, device=cuda)
    ref = torch.zeros(64, dtype=torch.uint8, device=cuda)
    buf = torch.zeros(3, 24, dtype=torch.uint8, device=cuda)
    monkeypatch.setattr(pe, "depth_scan_plain", boom)
    monkeypatch.setattr(pe, "cov_reduce_plain", boom)
    monkeypatch.setattr(bd, "apply_expand_plain", boom)
    assert pe.depth_scan(col, None, 10).tolist() == list(range(1, 11))
    assert pe.cov_reduce(census, 64, 1).tolist() == [[64, 64 * 129, 64],
                                                     [36, 36 * 129, 36]]
    assert bd.apply_expand(ref, buf)[1].shape == (3, 10)
    with pytest.raises(ValueError):
        pe.depth_scan(col[1:], None, 10)       # not 16-byte aligned
