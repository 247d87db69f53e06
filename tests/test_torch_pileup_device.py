"""K14 (``ops/pileup_device.py``) and the sharded pileup against the JAX
package, on the CPU (the plain versions of the port's kernels):

* ``pileup_counts``, ``pileup_qual_sums`` and ``pileup_counts_tiled``
  equal the JAX functions exactly on seeded inputs with invalid items,
  out-of-window positions and the lanes -1, 31, 32, 40 and -33 (a
  negative lane wraps once in the scatter forms and is dropped in the
  tiled form; a lane of 32 or more is dropped everywhere);
  ``bucket_bases`` and ``expand_to_device_arrays`` equal theirs;
* ``make_sharded_pileup`` on CPU meshes of (2, 2) and (4, 2) equals the
  JAX one on its (4, 2) mesh of virtual devices and the unsharded counts;
* ``graft_entry.entry()`` equals the JAX ``__graft_entry__.entry()``, and
  ``dryrun_multichip(8, device="cpu")`` runs."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.ops import pileup_device as jpd
from samtools_tpu.parallel import mesh as jmesh
from samtools_tpu_torch import graft_entry, kernels, sim
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.ops import pileup_device as pd
from samtools_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

EDGE_LANES = np.array([-1, 31, 32, 40, -33], np.int32)


def _items(seed: int, n: int, window: int):
    """refpos over [-window/8, window * 9/8), random lanes with the edge
    lanes spliced in, a tenth of the items invalid, quals 0-60."""
    rng = np.random.default_rng(seed)
    refpos = rng.integers(-window // 8, window + window // 8, n).astype(
        np.int32)
    lane = rng.integers(0, 32, n).astype(np.int32)
    lane[rng.choice(n, 5 * 8, replace=False)] = np.repeat(EDGE_LANES, 8)
    valid = rng.random(n) > 0.1
    qual = rng.integers(0, 61, n).astype(np.int32)
    return refpos, lane, valid, qual


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,n,window", [(1, 5000, 700), (2, 20000, 4096)])
def test_scatter_forms_equal_jax(seed, n, window):
    refpos, lane, valid, qual = _items(seed, n, window)
    kernels.reset_launches()
    got = pd.pileup_counts(*_t(refpos, lane, valid), window)
    want = np.asarray(jpd.pileup_counts(refpos, lane, valid, window))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    gq = pd.pileup_qual_sums(*_t(refpos, lane, qual, valid), window)
    wq = np.asarray(jpd.pileup_qual_sums(refpos, lane, qual, valid, window))
    assert np.array_equal(gq.numpy(), wq)
    # the wrapped lane -1 lands in lane 31, 32 and up and -33 nowhere
    keep = valid & (refpos >= 0) & (refpos < window) & (lane >= -32) \
        & (lane < 32)
    assert int(got.sum()) == int(keep.sum())
    assert int(got[:, 31].sum()) == int((keep & ((lane == 31)
                                                 | (lane == -1))).sum())
    assert np.array_equal(pd.depth_from_counts(got).numpy(),
                          np.asarray(jpd.depth_from_counts(want)))
    assert kernels.launches["pileup_scatter"] == 0


def test_edge_lanes_at_four_rows():
    """Lanes -1, 31, 32, 5 at rows 0-3 of an 8-row window count 3 in the
    scatter form (-1 wraps to 31, 32 drops) and 2 in the tiled form."""
    rp = np.arange(4, dtype=np.int32)
    ln = np.array([-1, 31, 32, 5], np.int32)
    ok = np.ones(4, bool)
    got = pd.pileup_counts(*_t(rp, ln, ok), 8)
    assert int(got.sum()) == 3 and int(got[0, 31]) == 1
    assert np.array_equal(got.numpy(),
                          np.asarray(jpd.pileup_counts(rp, ln, ok, 8)))
    tiled = pd.pileup_counts_tiled(*_t(rp[None], ln[None], ok[None]), 8, 1)
    assert int(tiled.sum()) == 2
    assert np.array_equal(tiled.numpy(), np.asarray(
        jpd.pileup_counts_tiled(rp[None], ln[None], ok[None], 8, 1)))


@pytest.mark.parametrize("seed,n,window,tile,cap", [
    (4, 6000, 2048, 512, None), (5, 3000, 1000, 128, 8)])
def test_tiled_form_equals_jax(seed, n, window, tile, cap):
    refpos, lane, valid, _ = _items(seed, n, window)
    inwin = (refpos >= 0) & (refpos < window)
    refpos, lane, valid = refpos[inwin], lane[inwin], valid[inwin]
    posrel, lanes, ok = pd.bucket_bases(refpos, lane, window, tile, cap)
    jpos, jlanes, jok = jpd.bucket_bases(refpos, lane, window, tile, cap)
    for a, b in ((posrel, jpos), (lanes, jlanes), (ok, jok)):
        assert np.array_equal(a, b)
    # some bucketed items invalid
    ok &= np.random.default_rng(seed).random(ok.shape) > 0.1
    n_tiles = posrel.shape[0]
    got = pd.pileup_counts_tiled(*_t(posrel, lanes, ok), tile, n_tiles)
    want = np.asarray(jpd.pileup_counts_tiled(posrel, lanes, ok, tile,
                                              n_tiles))
    assert np.array_equal(got.numpy(), want)
    # the tiled form drops lane -1, where the scatter form wraps it
    assert int(got.sum()) == int((ok & (lanes >= 0) & (lanes < 32)).sum())


def test_kernel_arguments_are_checked():
    t = _t(np.zeros(4, np.int32), np.zeros(4, np.int32), np.ones(4, bool))
    with pytest.raises(TypeError):
        pd.pileup_counts(t[0].long(), t[1], t[2], 8)
    with pytest.raises(ValueError):
        pd.pileup_counts(t[0], t[1][:3], t[2], 8)
    with pytest.raises(TypeError):
        pd.pileup_counts_tiled(t[0].reshape(2, 2), t[1].reshape(2, 2),
                               t[2].reshape(2, 2).int(), 4, 2)


def test_expand_to_device_arrays_equals_jax(tmp_path):
    L = 1 << 14
    b = sim.simulate_batch(ref_len=L, coverage=4.0, read_len=60, seed=3,
                           paired=False)
    path = str(tmp_path / "e.bam")
    write_bam(path, sim.make_header(L), b)
    mine, theirs = read_alignments(path).batch, jread(path).batch
    sel = np.arange(0, mine.n, 3)
    got = pd.expand_to_device_arrays(mine, sel, 1000, 4096)
    want = jpd.expand_to_device_arrays(theirs, sel, 1000, 4096)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and np.array_equal(a, b_)
    counts = pd.pileup_qual_sums(*_t(got[0], got[1], got[2], got[3]), 4096)
    assert np.array_equal(counts.numpy(), np.asarray(jpd.pileup_qual_sums(
        *want, 4096)))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_pileup_equals_jax_and_unsharded(shape):
    n_data, n_region = shape
    wps = 1024
    refpos, lane, valid, _ = _items(6, 4099, n_region * wps)
    mesh = make_mesh(n_data, n_region, [torch.device("cpu")] * 8)
    fn, total = pd.make_sharded_pileup(mesh, wps)
    assert total == n_region * wps
    got = fn(refpos, lane, valid)
    whole = pd.pileup_counts(*_t(refpos, lane, valid), total)
    assert torch.equal(got, whole)
    jm = jmesh.make_mesh(n_data=4, n_region=2)
    jfn, jtotal = jpd.make_sharded_pileup(jm, wps)
    assert jtotal == total
    want = np.asarray(jfn(*jmesh.shard_batch_arrays(jm, refpos, lane,
                                                      valid)))
    assert np.array_equal(got.numpy(), want)


def test_graft_entry_equals_jax():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jgraft.entry()
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), b)
    got = fn(*args)
    assert got.shape == (1 << 14, 32)
    assert np.array_equal(got.numpy(), np.asarray(jfn(*jargs)))


def test_dryrun_multichip_on_cpu_shards():
    graft_entry.dryrun_multichip(8, device="cpu")
