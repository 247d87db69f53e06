"""K1 segment_contract (the port's census contraction) against the JAX
package's Pallas kernel, run in interpret mode on the CPU, and against its
XLA segment_matmul over tile plans with several passes and item slices
that do not start on a 512-item block; the CUDA kernel's cut into pieces
of consecutive items, emulated in numpy, against the same; and the census
form against the JAX package's fused chunk step and the host census.
Integer sums: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samtools_tpu.ops import mpileup_device as jmd
from samtools_tpu.ops import pileup_engine as jpe
from samtools_tpu.ops import pileup_pallas as pp
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.ops.segment_kernel import (piece_layout,
                                                   segment_census,
                                                   segment_contract,
                                                   segment_contract_plain)

torch.set_num_threads(1)


def _pallas_case(kind):
    rng = np.random.RandomState(7 if kind == "random" else 3)
    if kind == "random":   # as tests/test_pileup_engine.py:103
        n, K, wlen = 700, 5, 300
        n_tiles = (wlen + pp.TILE - 1) // pp.TILE
        pos = np.sort(rng.randint(0, wlen, n)).astype(np.int32)
        W = rng.randint(-2, 3, (n, K)).astype(np.int8)
        lo = np.searchsorted(pos, np.arange(n_tiles) * pp.TILE)
        hi = np.searchsorted(pos, (np.arange(n_tiles) + 1) * pp.TILE)
    else:                  # one slice of three blocks and a tail
        n = 3 * pp.KB + 17
        n_tiles = 1
        pos = np.zeros(n, np.int32)
        W = rng.randint(0, 2, (n, 1)).astype(np.int8)
        lo, hi = np.array([0]), np.array([n])
    return pos, W, lo.astype(np.int32), hi.astype(np.int32), n_tiles


@pytest.mark.parametrize("kind", ["random", "deep"])
def test_plain_equals_pallas_interpret(monkeypatch, kind):
    monkeypatch.setenv("SAMTPU_PALLAS", "interpret")
    pos, W, lo, hi, n_tiles = _pallas_case(kind)
    B = int((hi - lo).max()) if kind == "random" else pp.KB
    ref = np.asarray(pp.segment_matmul_pallas(pos, W, lo, hi, 0, n_tiles, B))
    out = torch.zeros(n_tiles * pp.TILE, W.shape[1], dtype=torch.int32)
    segment_contract(torch.from_numpy(pos), torch.from_numpy(W),
                     torch.from_numpy(lo), torch.from_numpy(hi), 0, pp.TILE,
                     out)
    assert np.array_equal(out.numpy(), ref.astype(np.int64))


def _reads(seed, n_reads=220, span=2000, L=50, K=6):
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, span, n_reads))
    pos[100:160] = pos[100]              # a deep pile: long slices
    item_off = np.arange(n_reads + 1, dtype=np.int64) * L
    refpos = (pos[:, None] + np.arange(L)[None, :]).ravel()
    W = rng.integers(0, 4, (refpos.size, K)).astype(np.int8)
    return pos, pos + L, item_off, refpos, W


@pytest.mark.parametrize("seed,wbeg", [(1, 0), (2, 300)])
def test_equals_jax_segment_matmul(seed, wbeg):
    pos, end, item_off, refpos, W = _reads(seed)
    wlen = 2100 - wbeg
    # a 256-item window makes the JAX plan take several passes
    jplan = jpe.tile_plan(pos, end, item_off, wbeg, wlen, max_b=256,
                          tile=128)
    plan = pe.tile_plan(pos, end, item_off, wbeg, wlen, tile=128)
    assert np.array_equal(plan.lo, jplan.lo)
    assert np.array_equal(plan.hi, jplan.hi)
    assert jplan.passes > 1
    assert (plan.lo % 512 != 0).any()
    ref = np.asarray(jpe.segment_matmul(refpos.astype(np.int32), W, jplan))
    ntp = pe.padded_tiles(plan.n_tiles)
    lo = np.zeros(ntp, np.int32)
    hi = np.zeros(ntp, np.int32)
    lo[:plan.n_tiles], hi[:plan.n_tiles] = plan.lo, plan.hi
    out = torch.zeros(ntp * plan.tile, W.shape[1], dtype=torch.int32)
    segment_contract(torch.from_numpy(refpos.astype(np.int32)),
                     torch.from_numpy(W), torch.from_numpy(lo),
                     torch.from_numpy(hi), wbeg, plan.tile, out)
    assert out.shape == ref.shape
    assert np.array_equal(out.numpy(), ref)
    # and every item inside the window is counted once (np.add.at oracle)
    host = np.zeros((out.shape[0], W.shape[1]), np.int64)
    ok = (refpos >= wbeg) & (refpos < wbeg + out.shape[0])
    np.add.at(host, refpos[ok] - wbeg, W[ok].astype(np.int64))
    assert np.array_equal(out.numpy(), host)


def test_wrapper_accumulates_and_validates():
    pos, end, item_off, refpos, W = _reads(3)
    plan = pe.tile_plan(pos, end, item_off, 0, 2048, tile=128)
    rp = torch.from_numpy(refpos.astype(np.int32))
    Wt = torch.from_numpy(W)
    lo, hi = torch.from_numpy(plan.lo), torch.from_numpy(plan.hi)
    once = segment_contract_plain(rp, Wt, lo, hi, 0, 128)
    out = torch.zeros_like(once)
    before = dict(kernels.launches)
    segment_contract(rp, Wt, lo, hi, 0, 128, out)
    segment_contract(rp, Wt, lo, hi, 0, 128, out)
    assert torch.equal(out, 2 * once)
    assert kernels.launches == before      # CPU tensors: plain version
    with pytest.raises(TypeError):
        segment_contract(rp.long(), Wt, lo, hi, 0, 128, out)
    with pytest.raises(ValueError):
        segment_contract(rp, Wt, lo, hi, 0, 64, out)
    with pytest.raises(ValueError):
        segment_contract(rp, Wt[:, :3].t(), lo, hi, 0, 128, out)


def _pieces(rp, W, lo, hi, wbeg, tile, P, win):
    """csrc/segment_contract.cu's cut, in numpy: pieces of P consecutive
    items; an item is live when its position lies in the plan and its
    index in its tile's slice; a piece's live items add into a win-row
    accumulator from the piece's least live row, or straight into out
    past it, and the accumulator is added into out."""
    n_rows = lo.size * tile
    out = np.zeros((n_rows, W.shape[1]), np.int64)
    for b0 in range(0, rp.size, P):
        b = np.arange(b0, min(b0 + P, rp.size))
        r = rp[b].astype(np.int64) - wbeg
        live = (r >= 0) & (r < n_rows)
        t = np.where(live, r // tile, 0)
        live &= (b >= lo[t]) & (b < hi[t])
        if not live.any():
            continue
        rmin = int(r[live].min())
        span = min(win, int(r[live].max()) - rmin + 1)
        near = live & (r - rmin < span)
        acc = np.zeros((span, W.shape[1]), np.int64)
        np.add.at(acc, r[near] - rmin, W[b[near]])
        np.add.at(out, r[live & ~near], W[b[live & ~near]])
        out[rmin:rmin + span] += acc
    return out


@pytest.mark.parametrize("P,win", [(64, 16), (256, 1024), (97, 5),
                                   piece_layout(4 + 6, 6)])
def test_pieces_equal_jax_segment_matmul(P, win):
    """Pieces far narrower than the widest slice (a 60-read pile), an
    accumulator too short for a piece's rows (items past it go straight
    to out), slices that start off a 512-item block, and an emptied tile
    whose items then count nowhere."""
    pos, end, item_off, refpos, W = _reads(4)
    jplan = jpe.tile_plan(pos, end, item_off, 0, 2100, max_b=256,
                          tile=128)
    full = int(np.argmax(jplan.hi - jplan.lo))
    busy = np.nonzero(jplan.hi > jplan.lo)[0]
    empty = int(busy[busy != full][busy.size // 2])
    jplan.hi[empty] = jplan.lo[empty]
    assert int((jplan.hi - jplan.lo).max()) > P
    assert (jplan.lo % 512 != 0).any()
    ref = np.asarray(jpe.segment_matmul(refpos.astype(np.int32), W, jplan))
    got = _pieces(refpos, W, jplan.lo, jplan.hi, 0, 128, P, win)
    assert np.array_equal(got, ref[:got.shape[0]])   # ref: padded tiles
    assert not ref[got.shape[0]:].any()
    assert not got[empty * 128:(empty + 1) * 128].any()


# ---------------------------------------------------------------- census
CENSUS_LEN = 1 << 14


def _census_chunk(messy):
    """A chunk of device-eligible reads through the JAX package's fused
    chunk step (XLA segment contraction, quals collected), and the port's
    expansion and tile plan of the same reads."""
    ref = sim.simulate_reference(CENSUS_LEN, seed=11)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    ref_int = lut[ref]
    b = sim.simulate_batch(ref_len=CENSUS_LEN, coverage=4.0, read_len=100,
                           seed=31 + messy, paired=False, err_rate=0.01,
                           ref=ref)
    if messy:
        sim.simulate_messy(b, 7)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, 100, CENSUS_LEN)
    k = np.nonzero(elig)[0][:512]
    dsel, n = sel[k], k.size
    pos = b.pos[dsel].astype(np.int64)
    pipe = md.DeviceCensusPipeline(ref_int, CENSUS_LEN, device="cpu",
                                   chunk_reads=n)
    seqm, qual = pipe._gather_rows(b, dsel)
    x = pipe._expand(torch.from_numpy(pipe._make_buf(
        pos, lead[k], lref[k], cig8[k], seqm, qual, 0, n)))
    lo, hi, wbeg, ntp = pipe._plan(pos)

    jpipe = jmd.DeviceCensusPipeline(ref_int, CENSUS_LEN, chunk_reads=n)
    buf, pc = jpipe._make_buf(pos, lead[k], lref[k], cig8[k], seqm, qual,
                              0, n, n)
    jlo, jhi, jwbeg, jntp, B, passes = jpipe._plan(pc[:n], n, n)
    assert (jwbeg, jntp) == (wbeg, ntp)
    census, risky, appq, _, _, _ = jmd._get_chunk_step()(
        jpipe.census_dev, jpipe.ref_dev, jax.device_put(buf), np.int32(n),
        jlo, jhi, jnp.int32(jwbeg), jnp.int32(0), jnp.int32(0),
        jnp.int32(CENSUS_LEN), 100, 100 + md.LREF_PAD, 7, jntp, B, 256, 16,
        passes, 13, 1, True, False)
    return (b, dsel, pipe, x, lo, hi, wbeg, np.asarray(census),
            np.asarray(risky), np.asarray(appq))


@pytest.mark.parametrize("messy", [False, True])
def test_census_plain_equals_jax_chunk_and_host(messy):
    b, dsel, pipe, x, lo, hi, wbeg, jcensus, risky, appq = \
        _census_chunk(messy)
    assert 0 < risky.sum() < risky.size // 4 or not risky.any()
    out = torch.zeros(jcensus.shape, dtype=torch.int32)
    out[wbeg:wbeg + lo.size * 256] = 7        # added into, not overwritten
    before = dict(kernels.launches)
    segment_census(x["refpos"], x["seg"], x["sq"], torch.from_numpy(appq),
                   torch.from_numpy(risky), 0, 0, CENSUS_LEN, 13,
                   torch.from_numpy(lo), torch.from_numpy(hi), wbeg, 256,
                   out[wbeg:wbeg + lo.size * 256])
    assert kernels.launches == before        # CPU tensors: plain version
    out[wbeg:wbeg + lo.size * 256] -= 7
    assert np.array_equal(out.numpy(), jcensus)
    assert jcensus[:, :5].sum() > 0.4 * dsel.size * 100
    # the f64 host path over the reads neither package flags risky
    pipe._host_reads(b, dsel[~risky])
    c = out.numpy()[:CENSUS_LEN].astype(np.int64)
    assert np.array_equal(c[:, :5], pipe.host_census)
    assert np.array_equal(c[:, 5], pipe.host_qsum)
