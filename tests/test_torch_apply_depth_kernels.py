"""K8's front and K9 on the CPU: ``apply_expand``, ``baq_apply``,
``depth_scan`` and ``cov_reduce`` (their plain versions, which the
wrappers take for CPU tensors) against the JAX package.

``depth_scan_plain`` equals the JAX ``_depth_cumsum_jit`` with
``_fetch_narrow`` exactly, at maxima of 255, 256, 32,767 and 32,768,
with more rows than L, a max that lies only past row L, sums that wrap,
and either column absent (the JAX function is given zeros there).
``cov_reduce_plain`` equals the JAX ``_cov_reduce_jit`` on the three
lanes it has (the quality lane below 128: lane 3 zero), with rows not a
multiple of the subwindow (padded as the JAX caller pads them) and the
min-depth gate, and sums a subwindow's quality past 2^31 exactly where
the JAX one wraps.  ``baq_apply_plain`` equals the JAX
``baq_apply_device_nt16`` at L = 37, 100 and 151 on every read neither
flags risky, with reads at and past the contig's last base (the clamps);
``apply_expand_plain``'s windows and codes equal the JAX front's
formulas.  Each wrapper's argument checks raise before anything
launches, and CPU tensors count no launch.  The kernels' own
decompositions are walked in tests/test_torch_kernel_plans.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_chunk_cases as cc
from samtools_tpu.ops import baq_device as jbd
from samtools_tpu.ops import pileup_engine as jpe
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import pileup_engine as pe

SCRIPT = cc.apply_depth_script()


def _jax_depth(diff, direct, L):
    """The JAX package's depth scan and fetch of the two columns (zeros
    for an absent one)."""
    rows = (diff if diff is not None else direct).shape[0]
    zero = np.zeros(rows, np.int32)
    d, mx = jpe._depth_cumsum_jit()(
        jnp.asarray((diff if diff is not None else zero)[:, None]),
        jnp.asarray((direct if direct is not None else zero)[:, None]))
    return jpe._fetch_narrow(d, int(mx), L), int(mx)


@pytest.mark.parametrize("edge", range(len(SCRIPT.EDGES)))
@pytest.mark.parametrize("rows,L", [(3 * 8192 + 4100, 3 * 8192 + 2100),
                                    (20_011, 19_000)])
def test_depth_scan_plain_equals_jax(edge, rows, L):
    top, where, cols = SCRIPT.EDGES[edge]
    diff, direct = SCRIPT.edge_columns(rows, L, top, where, cols,
                                       np.random.default_rng(edge))
    want, mx = _jax_depth(diff, direct, L)
    args = [None if c is None else torch.from_numpy(c[:, None])
            for c in (diff, direct)]
    before = dict(kernels.launches)
    for fn in (pe.depth_scan_plain, pe.depth_scan):
        got = fn(*args, L)
        assert got.dtype == np.int32 and got.shape == (L,)
        assert np.array_equal(got, want.astype(np.int32))
    assert kernels.launches == before
    if where == "pad":      # the max past L widens the fetch to int32
        assert mx == top and want.dtype == np.int32 and got.max() < 10
    else:
        assert mx == top


def test_depth_window_passes_no_zero_column(monkeypatch, tmp_path):
    """A window with no direct weights hands the scan None, not a
    column of zeros, and one with no difference events likewise; the
    depth equals the JAX device function's."""
    from samtools_tpu.io.files import read_alignments as jread
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.files import read_alignments
    seen = []
    real = pe.depth_scan

    def spy(diff, direct, L):
        seen.append((diff is None, direct is None))
        return real(diff, direct, L)
    monkeypatch.setattr(pe, "depth_scan", spy)
    ref = sim.simulate_reference(20_000, seed=3)
    path = str(tmp_path / "in.bam")
    write_bam(path, sim.make_header(20_000), sim.simulate_batch(
        ref_len=20_000, coverage=8.0, read_len=100, seed=3, paired=False,
        ref=ref))
    b, jb = read_alignments(path).batch, jread(path).batch
    sel = np.arange(b.n)
    for min_qual in (0, 13):
        got = pe.depth_window_device(b, sel, 100, 19_000, min_qual, False,
                                     device="cpu")
        assert np.array_equal(got, jpe.depth_window_device(
            jb, sel, 100, 19_000, min_qual, False))
    assert seen == [(False, True), (True, False)]


@pytest.mark.parametrize("rows,sub,min_depth", [
    (3 * 4096 + 17, 4096, 1), (2 * 4096 + 5, 4096, 25), (1, 4096, 1),
    (5000, 1 << 16, 0), (4096, 4096, 1)])
def test_cov_reduce_plain_equals_jax(rows, sub, min_depth):
    rng = np.random.default_rng(rows)
    census = SCRIPT.cov_edge_census(rows, rng)
    census[:, 1] &= 127
    census[:, 3] = 0
    pad = (-rows) % sub
    jcensus = jnp.asarray(np.pad(census[:, :3], ((0, pad), (0, 0))))
    want = np.asarray(jpe._cov_reduce_jit()(jcensus, sub, min_depth))
    t = torch.from_numpy(census)
    before = dict(kernels.launches)
    for fn in (pe.cov_reduce_plain, pe.cov_reduce):
        got = fn(t, sub, min_depth)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert kernels.launches == before


def test_cov_reduce_sums_past_2_31_where_jax_wraps():
    rows = 1 << 16
    census = SCRIPT.cov_edge_census(rows, None)
    census[:5, 3] = 2          # quality >> 7 counts 128 each
    got = pe.cov_reduce(torch.from_numpy(census), rows, 1)
    assert got.tolist() == [[1000 * rows, 40_000 * rows + 5 * 256, rows]]
    jgot = np.asarray(jpe._cov_reduce_jit()(jnp.asarray(census[:, :3]),
                                            rows, 1))
    assert int(jgot[0, 1]) != 40_000 * rows
    assert int(jgot[0, 1]) % (1 << 32) == (40_000 * rows) % (1 << 32)


def _group(L: int, n: int, seed: int):
    """(ref_int, pos, nt16 seq, qual) of n all-M reads of L bases on a
    24 kbp contig, the first three at its last base, past it and at 0."""
    ref, ref_int = cc.reference(24_000, seed=seed)
    b = sim.simulate_batch(ref_len=24_000, coverage=n * L / 24_000 + 1,
                           read_len=L, seed=seed, paired=False,
                           err_rate=0.02, ref=ref)
    k = np.arange(n)
    idx = b.seq_off[k][:, None] + np.arange(L)[None, :]
    pos = b.pos[k].astype(np.int64)
    pos[:3] = [ref_int.size - 1, ref_int.size + 40, 0]
    return ref_int, pos, b.seq[idx], b.qual[idx]


@pytest.mark.parametrize("L", [37, 100, 151])
def test_baq_apply_plain_equals_jax(L):
    """K8's plain version against the JAX fused apply on its CPU backend:
    the applied quals equal on every read neither flags risky, at most one
    read in the symmetric difference of the risky sets."""
    ref_int, pos, seq, qual = _group(L, 60, L)
    before = dict(kernels.launches)
    got, risky = bd.baq_apply_nt16(torch.from_numpy(ref_int), pos, seq,
                                   qual, chunk=25)
    assert kernels.launches == before
    want, jrisky = jbd.baq_apply_device_nt16(ref_int, pos, seq, qual, L)
    ok = ~(risky | jrisky)
    assert (risky ^ jrisky).sum() <= 1 and ok.sum() >= 55
    assert np.array_equal(got[ok], want[ok])
    assert (got != qual).any()


@pytest.mark.parametrize("L", [37, 100, 151])
def test_apply_expand_plain_equals_jax_front(L):
    """The front's windows and codes by the JAX fused apply's formulas
    (pos little-endian, min(pos, last) + j clipped to the contig, the
    nt16 where-chain), in numpy."""
    ref_int, pos, seq, qual = _group(L, 60, L + 1)
    buf = cc.apply_buf(pos, seq, qual)
    ref_win, sq, qq = bd.apply_expand(torch.from_numpy(ref_int),
                                      torch.from_numpy(buf))
    pc = buf[:, :4].astype(np.int32)
    pc = pc[:, 0] | (pc[:, 1] << 8) | (pc[:, 2] << 16) | (pc[:, 3] << 24)
    last = ref_int.size - 1
    idx = np.minimum(pc, last)[:, None] + np.arange(L + bd.APPLY_PAD)
    assert np.array_equal(ref_win.numpy(), ref_int[np.clip(idx, 0, last)])
    nt = buf[:, 4:4 + L]
    code = np.where(nt == 1, 0, np.where(nt == 2, 1, np.where(
        nt == 4, 2, np.where(nt == 8, 3, 4))))
    assert np.array_equal(sq.numpy(), code)
    assert np.array_equal(qq.numpy(), qual)
    assert (ref_win.numpy()[1] == ref_int[-1]).all()


def _raises(exc, fn, *args):
    before = dict(kernels.launches)
    with pytest.raises(exc):
        fn(*args)
    assert kernels.launches == before


def test_wrappers_check_arguments_before_launch():
    meta = torch.device("meta")
    ref = torch.zeros(64, dtype=torch.uint8)
    buf = torch.zeros(4, 4 + 2 * 10, dtype=torch.uint8)
    for fn in (bd.apply_expand, bd.baq_apply):
        _raises(TypeError, fn, ref.int(), buf)
        _raises(TypeError, fn, ref, buf.to(torch.int8))
        _raises(ValueError, fn, ref, buf[:, :-1].contiguous())  # odd row
        _raises(ValueError, fn, ref, buf[:, :4].contiguous())   # L = 0
        _raises(ValueError, fn, ref, buf[:0])               # no reads
        _raises(ValueError, fn, ref[:0], buf)               # no contig
        _raises(ValueError, fn, ref.reshape(8, 8), buf)
        _raises(ValueError, fn, ref, buf[:, ::2])           # not contiguous
        _raises(ValueError, fn, ref.to(meta), buf)          # mixed devices

    col = torch.zeros(100, 1, dtype=torch.int32)
    ds = pe.depth_scan
    _raises(ValueError, ds, None, None, 10)
    _raises(TypeError, ds, col.long(), None, 10)
    _raises(ValueError, ds, col, torch.zeros(99, 1, dtype=torch.int32), 10)
    _raises(ValueError, ds, torch.zeros(100, 2, dtype=torch.int32), None, 10)
    _raises(ValueError, ds, col, None, 0)
    _raises(ValueError, ds, col, None, 101)
    _raises(ValueError, ds, torch.zeros(100, 2, dtype=torch.int32)[:, :1],
            None, 10)                                       # not contiguous
    _raises(ValueError, ds, col.to(meta), None, 10)

    census = torch.zeros(100, 4, dtype=torch.int32)
    cr = pe.cov_reduce
    _raises(TypeError, cr, census.long(), 16, 1)
    _raises(ValueError, cr, census[:, :3], 16, 1)
    _raises(ValueError, cr, census[:0], 16, 1)
    _raises(ValueError, cr, census, 0, 1)
    _raises(ValueError, cr, census, 16, 1 << 31)
    _raises(ValueError, cr, census.t().contiguous().t(), 16, 1)
    _raises(ValueError, cr, census.to(meta), 16, 1)
