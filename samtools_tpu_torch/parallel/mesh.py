"""K15: the device mesh and the reductions between its shards.

Counterpart of samtools_tpu/parallel/mesh.py (:28-215).  A mesh is a
(data, region) grid of torch devices: ``data`` shards read batches,
``region`` genomic positions.  A device may appear more than once, so
shards can share one card (or the CPU, as the tests run them), the way
the JAX package's tests run its mesh on 8 virtual CPU devices.

Where JAX shard_maps a local step and lets XLA insert a ``psum`` or an
``all_gather``, each shard here runs its local step on its own device --
K11 ``flagstat`` (ops/flagstat.py) or K1 ``segment_contract``
(ops/pileup_engine.py), and K14 in ops/pileup_device.py's
``make_sharded_pileup`` -- and the reductions are explicit: the shards'
partial counts add, and their output slices join in shard order, on the
mesh's first device.  When ``torch.distributed`` runs with two or more
processes (parallel/dist.py), each process holds the shards of its own
devices and the data axis spans the processes: the sums ``all_reduce``
and the joined slices ``all_gather`` over the process group, in rank
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from .dist import process_info

AXES = ("data", "region")


class Mesh:
    """A (n_data, n_region) object array of torch devices with the axis
    names ("data", "region")."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """Where the reductions land."""
        return self.devices[0, 0]

    def flat(self) -> list:
        """The devices, row by row (both axes flattened)."""
        return list(self.devices.reshape(-1))


def make_mesh(n_data: int | None = None, n_region: int = 1,
              devices=None) -> Mesh:
    """A (data, region) mesh over ``devices`` (None: every CUDA card;
    raises without CUDA).  A device may be listed several times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_region
    need = n_data * n_region
    if n_data < 1 or n_region < 1 or need > len(devices):
        raise ValueError(f"a {n_data} x {n_region} mesh needs {need} "
                         f"devices, {len(devices)} given")
    grid = np.empty(need, object)
    for i, d in enumerate(devices[:need]):
        grid[i] = d
    return Mesh(grid.reshape(n_data, n_region))


def _axis_devices(mesh: Mesh, axis: str | None) -> list:
    """The devices that hold one shard each along ``axis`` (None: every
    device, both axes flattened); a data shard lies on its row's first
    device."""
    if axis is None:
        return mesh.flat()
    if axis == "data":
        return list(mesh.devices[:, 0])
    return list(mesh.devices[0, :])


def shard_batch_arrays(mesh: Mesh, *arrays, axis: str | None = "data"):
    """Record-wise arrays (numpy or tensors, records on the first axis)
    split over ``axis``: each padded with zeros to a multiple of the
    shard count, for each array a list of this process's shards, each on
    its device.  With several processes the shard count is theirs
    together, and process k takes the k-th run of them."""
    devs = _axis_devices(mesh, axis)
    rank, world = process_info()
    n_all = len(devs) * world
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        pad = (-t.shape[0]) % n_all
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        per = t.shape[0] // n_all
        first = rank * len(devs)
        out.append([t[(first + i) * per:(first + i + 1) * per].to(d)
                    for i, d in enumerate(devs)])
    return out


def local_sum(mesh: Mesh, parts: list) -> torch.Tensor:
    """This process's shards' partials added on the mesh's first
    device."""
    total = parts[0].to(mesh.first, copy=True)
    for p in parts[1:]:
        total += p.to(mesh.first)
    return total


def psum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group (in place), when there is
    one."""
    if process_info()[1] > 1:
        tdist.all_reduce(t)
    return t


def gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) joined in rank order along
    the first axis, when there is a process group; else ``t``."""
    world = process_info()[1]
    if world == 1:
        return t
    got = [torch.empty_like(t) for _ in range(world)]
    tdist.all_gather(got, t.contiguous())
    return torch.cat(got)


def _k11(flag, mapq, tid, mtid, valid) -> torch.Tensor:
    """The local step: K11 over the shard's valid records (K11 takes no
    mask; the uint16 flags are selected as int16, which every torch
    indexing kernel takes)."""
    from ..ops.flagstat import flagstat_census
    return flagstat_census(flag.view(torch.int16)[valid].view(torch.uint16),
                           mapq[valid], tid[valid], mtid[valid])


def flagstat_sharded(mesh: Mesh, flag, mapq, tid, mtid, valid
                     ) -> torch.Tensor:
    """Multi-shard flagstat: the records (flag uint16, mapq uint8,
    tid/mtid int32, valid bool, numpy or tensors) split over the data
    axis, K11 on each shard, the [16, 2] int64 partials summed on the
    mesh's first device."""
    shards = shard_batch_arrays(mesh, flag, mapq, tid, mtid, valid)
    return psum(local_sum(mesh, [_k11(*s) for s in zip(*shards)]))


def flagstat_counts_sharded(mesh: Mesh, batch) -> dict:
    """Tool-level mesh flagstat: a ReadBatch window -> the {counter:
    (qc_pass, qc_fail)} dict, records sharded over every mesh device
    (both axes flattened into the data dimension), padded as the JAX
    package pads them (tid and mtid -1, valid False).  ``flagstat`` runs
    its batches here when SAMTPU_SHARDS meshes over more than one
    device."""
    from ..ops.flagstat import COUNTERS
    if batch.n == 0:
        return {name: (0, 0) for name in COUNTERS}
    n = batch.n
    rank, world = process_info()
    size = n + (-n) % (mesh.size * world)

    def padded(a, dtype, fill=0):
        out = np.full(size, fill, dtype)
        out[:n] = a[:n]
        return out

    valid = np.zeros(size, bool)
    valid[:n] = True
    shards = shard_batch_arrays(
        mesh, padded(batch.flag, np.uint16), padded(batch.mapq, np.uint8),
        padded(batch.tid, np.int32, -1), padded(batch.mtid, np.int32, -1),
        valid, axis=None)
    total = psum(local_sum(mesh, [_k11(*s) for s in zip(*shards)]))
    total = total.cpu().numpy()
    return {name: (int(total[i, 0]), int(total[i, 1]))
            for i, name in enumerate(COUNTERS)}


def segment_matmul_sharded(mesh: Mesh, refpos: np.ndarray, W: np.ndarray,
                           plan, chunk: int = 16) -> torch.Tensor:
    """Region-sharded pileup contraction: the plan's genomic tiles spread
    in order over every shard (both axes flattened; with several
    processes, over theirs together), the tile count padded up to a
    multiple of shards x ``chunk`` (the JAX package pads to a power of
    two for its compile cache).  Each shard runs K1 over its own tile
    range, on the items its tiles' slices cover, and the shards' output
    rows join in shard order on the mesh's first device.  K1 covers each
    tile's slice whole, so there are no passes (the JAX ``plan.passes``
    loop, :189-195, has no counterpart).  Returns int32
    [plan.n_tiles * plan.tile, K]."""
    from ..ops.pileup_engine import TilePlan, segment_matmul

    devs = mesh.flat()
    rank, world = process_info()
    n_all = len(devs) * world
    tile = plan.tile
    step = n_all * chunk
    n_pad = -(-plan.n_tiles // step) * step
    lo = np.zeros(n_pad, np.int64)
    hi = np.zeros(n_pad, np.int64)
    lo[:plan.n_tiles] = plan.lo
    hi[:plan.n_tiles] = plan.hi
    per = n_pad // n_all
    K = W.shape[1]
    outs = []
    for i, dev in enumerate(devs):
        t0 = (rank * len(devs) + i) * per
        s_lo, s_hi = lo[t0:t0 + per], hi[t0:t0 + per]
        live = s_hi > s_lo
        out = torch.zeros(per * tile, K, dtype=torch.int32, device=dev)
        if live.any():
            a, b = int(s_lo[live].min()), int(s_hi[live].max())
            sub = TilePlan(np.where(live, s_lo - a, 0).astype(np.int32),
                           np.where(live, s_hi - a, 0).astype(np.int32),
                           per, plan.wbeg + t0 * tile, per * tile, tile)
            segment_matmul(refpos[a:b], W[a:b], sub, dev, out)
        outs.append(out.to(mesh.first))
    return gather_cat(torch.cat(outs))[:plan.n_tiles * tile]


def depth_window_sharded(mesh: Mesh, batch, sel: np.ndarray, wbeg: int,
                         wend: int, min_qual: int, count_del: bool,
                         clips: np.ndarray | None = None) -> np.ndarray:
    """Multi-shard depth: the contract of ops.depth.depth_window and
    pileup_engine.depth_window_device, with the tile axis sharded over
    the mesh (``segment_matmul_sharded``); the depth scan runs once, on
    the joined rows on the mesh's first device, since its cumulative sum
    crosses the shards."""
    from ..ops import pileup_engine as pe

    if sel.size == 0:
        return np.zeros(wend - wbeg, np.int32)

    def sharded_segmm(pos, w, plan):
        return segment_matmul_sharded(mesh, pos, w, plan)

    return pe.depth_window_device(batch, sel, wbeg, wend, min_qual,
                                  count_del, clips, device=mesh.first,
                                  segmm_fn=sharded_segmm)
