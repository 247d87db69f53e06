"""K15 (``parallel/mesh.py``) against the JAX package's mesh on its 8
virtual CPU devices and against the JAX host oracles, on 8 CPU shards
(the plain versions of K11 and K1):

* ``flagstat_sharded`` and ``flagstat_counts_sharded`` equal the JAX mesh
  functions and ``ops/flagstat.flagstat_numpy`` on seeded flags (every
  flag bit, unmapped mates, other contigs), with a record count that is
  not a multiple of the shard count and with no records;
* ``segment_matmul_sharded`` equals the JAX one and a numpy scatter on
  random plans (as ``tests/test_multichip.py``'s), on several meshes;
* ``depth_window_sharded`` with (min_qual, count_del) in {(0, False),
  (13, True)} equals the JAX one and ``ops/depth.depth_window`` on a
  messy simulated batch, and gives zeros for an empty selection;
* ``make_mesh`` and ``shard_batch_arrays`` keep the JAX layout;
* ``kernels.launch`` and ``kernels.query`` call their C entry with the
  card they are given as the current one (a mesh shard may lie on
  another card than the current one), and K14's wrappers give it their
  tensors' card."""

import types

import numpy as np
import pytest
import torch

from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.ops import depth as jdepth
from samtools_tpu.ops import flagstat as jfs
from samtools_tpu.ops.pileup_engine import tile_plan as jtile_plan
from samtools_tpu.parallel import mesh as jmesh
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.core import flags as F
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import flagstat as fs
from samtools_tpu_torch.ops import pileup_device as pd
from samtools_tpu_torch.ops.pileup_engine import tile_plan
from samtools_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def jmesh8():
    import jax
    assert len(jax.devices()) >= 8
    return jmesh.make_mesh(n_data=4, n_region=2)


def _flags(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return types.SimpleNamespace(
        n=n, flag=rng.randint(0, 1 << 12, n).astype(np.uint16),
        mapq=rng.randint(0, 60, n).astype(np.uint8),
        tid=rng.randint(-1, 3, n).astype(np.int32),
        mtid=rng.randint(-1, 3, n).astype(np.int32))


def test_make_mesh_and_shards():
    mesh = M.make_mesh(4, 2, CPU8)
    assert mesh.shape == {"data": 4, "region": 2}
    assert mesh.axis_names == ("data", "region") and mesh.size == 8
    assert M.make_mesh(n_region=2, devices=CPU8[:6]).shape == {
        "data": 3, "region": 2}
    with pytest.raises(ValueError):
        M.make_mesh(4, 4, CPU8)
    a = np.arange(10, dtype=np.int32)
    (parts,) = M.shard_batch_arrays(mesh, a)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                           [9, 0, 0]]
    (flat,) = M.shard_batch_arrays(mesh, a, axis=None)
    assert len(flat) == 8 and torch.cat(flat)[:10].tolist() == a.tolist()


def test_make_mesh_needs_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh(2)


@pytest.mark.parametrize("n", [4099, 8, 0])
def test_flagstat_sharded_equals_jax_and_host(jmesh8, n):
    b = _flags(n, seed=n)
    mesh = M.make_mesh(4, 2, CPU8)
    valid = np.ones(n, bool)
    got = M.flagstat_sharded(mesh, b.flag, b.mapq, b.tid, b.mtid, valid)
    assert got.dtype == torch.int64 and got.shape == (16, 2)
    host = jfs.flagstat_numpy(b)
    assert fs._as_dict(got.numpy()) == host
    if n:
        want = np.asarray(jmesh.flagstat_sharded(
            jmesh8, *jmesh.shard_batch_arrays(jmesh8, b.flag, b.mapq, b.tid,
                                              b.mtid, valid)))
        assert np.array_equal(got.numpy(), want)
    for shape in ((8, 1), (1, 8), (4, 2)):
        m = M.make_mesh(*shape, CPU8)
        assert M.flagstat_counts_sharded(m, b) == host
    assert jmesh.flagstat_counts_sharded(jmesh8, b) == host


def _random_plan(seed: int, wlen: int, tile: int, n_reads: int,
                 span: int = 40, items_per: int = 7):
    rng = np.random.RandomState(seed)
    rpos = np.sort(rng.randint(0, wlen - span, n_reads)).astype(np.int64)
    pos = (rpos[:, None] + rng.randint(0, span, (n_reads, items_per))
           ).ravel()
    W = rng.randint(-3, 4, (pos.size, 5)).astype(np.int8)
    off = np.arange(0, pos.size + 1, items_per, dtype=np.int64)
    return rpos, pos, W, off


@pytest.mark.parametrize("seed,wlen,tile,n_reads,shape", [
    (5, 2048, 128, 300, (8, 1)), (6, 8192, 128, 900, (4, 2)),
    (7, 3000, 128, 250, (1, 3)), (8, 100000, 512, 2000, (2, 2))])
def test_segment_matmul_sharded_equals_jax(jmesh8, seed, wlen, tile,
                                           n_reads, shape):
    rpos, pos, W, off = _random_plan(seed, wlen, tile, n_reads)
    plan = tile_plan(rpos, rpos + 41, off, 0, wlen, tile)
    got = M.segment_matmul_sharded(M.make_mesh(*shape, CPU8[:8]), pos, W,
                                   plan)
    assert got.dtype == torch.int32
    assert got.shape == (plan.n_tiles * tile, 5)
    ref = np.zeros((plan.n_tiles * tile, 5), np.int64)
    np.add.at(ref, pos, W.astype(np.int64))
    assert np.array_equal(got.numpy().astype(np.int64), ref)
    jplan = jtile_plan(rpos, rpos + 41, off, 0, wlen, tile=tile)
    want = jmesh.segment_matmul_sharded(jmesh8, pos, W, jplan)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def messy(tmp_path_factory):
    L = 1 << 15
    ref = sim.simulate_reference(L, seed=3)
    b = sim.simulate_messy(sim.simulate_batch(
        ref_len=L, coverage=6.0, paired=False, seed=4, ref=ref), 4)
    rng = np.random.default_rng(4)
    b.flag[rng.random(b.n) < 0.05] |= F.FDUP
    path = str(tmp_path_factory.mktemp("mesh") / "messy.bam")
    write_bam(path, sim.make_header(L), b)
    mine, theirs = read_alignments(path).batch, jread(path).batch
    excl = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
    sel = np.nonzero(((mine.flag & excl) == 0) & (mine.tid == 0))[0]
    return mine, theirs, sel


@pytest.mark.parametrize("min_qual,count_del", [(0, False), (13, True)])
def test_depth_window_sharded_equals_jax_and_host(jmesh8, messy, min_qual,
                                                  count_del):
    mine, theirs, sel = messy
    wbeg = int(mine.pos[sel].min())
    wend = int(mine.end_pos()[sel].max())
    host = jdepth.depth_window(theirs, sel, wbeg, wend, min_qual, count_del)
    want = jmesh.depth_window_sharded(jmesh8, theirs, sel, wbeg, wend,
                                      min_qual, count_del)
    assert np.array_equal(np.asarray(want, np.int64), host.astype(np.int64))
    for shape in ((1, 8), (4, 2), (1, 3)):
        got = M.depth_window_sharded(M.make_mesh(*shape, CPU8), mine, sel,
                                     wbeg, wend, min_qual, count_del)
        assert got.dtype == np.int32
        assert np.array_equal(got.astype(np.int64), host.astype(np.int64))
    # a window inside the reads, and no reads at all
    got = M.depth_window_sharded(M.make_mesh(1, 8, CPU8), mine, sel,
                                 wbeg + 777, wbeg + 9000, min_qual,
                                 count_del)
    assert np.array_equal(got, jdepth.depth_window(
        theirs, sel, wbeg + 777, wbeg + 9000, min_qual, count_del))
    empty = M.depth_window_sharded(M.make_mesh(1, 8, CPU8), mine,
                                   sel[:0], wbeg, wend, min_qual, count_del)
    assert empty.dtype == np.int32 and not empty.any()
    assert empty.size == wend - wbeg


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in for the card: ``torch.cuda.device`` records the card it
    makes current and the C library records each call, with the card
    current at the time."""
    seen = []
    current = [None]

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        def __getattr__(self, entry):
            return lambda *args: seen.append((entry, current[0])) or 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(kernels, "_load", Lib)
    monkeypatch.setattr(kernels, "launches", dict(kernels.launches, x=0))
    return seen


def test_launch_and_query_make_the_card_current(fake_card):
    card1 = torch.device("cuda", 1)
    kernels.launch("x", "samtpu_x", 1, 2, device=card1)
    kernels.query("samtpu_census_narrow_limits", 3, card1)
    assert fake_card == [("samtpu_x", card1),
                         ("samtpu_census_narrow_limits", card1)]
    assert kernels.launches["x"] == 1
    with pytest.raises(TypeError):
        kernels.launch("x", "samtpu_x", 1, 2)


def test_k14_wrappers_launch_on_their_tensors_card(fake_card, monkeypatch):
    """The K14 wrappers' launches run with their tensors' card current
    (here CPU tensors taken for a card's)."""
    monkeypatch.setattr(kernels, "on_card", lambda *ts: True)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    # the scatter's chunk follows the card's SM count
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    cpu = torch.device("cpu")
    items = [torch.zeros(4, dtype=torch.int32)] * 2 \
        + [torch.ones(4, dtype=torch.bool)]
    pd.pileup_counts(*items, 8)
    pd.pileup_qual_sums(items[0], items[1], items[0], items[2], 8)
    pd.pileup_counts_tiled(*(t.view(2, 2) for t in items), 4, 2)
    assert fake_card == [("samtpu_pileup_scatter", cpu)] * 2 \
        + [("samtpu_pileup_tiled", cpu)]
