"""K14 pileup_counts: dense [window, 32] pileup tensors, and their sharded
form over a device mesh.

Counterpart of samtools_tpu/ops/pileup_device.py: per aligned base a
(window-relative position, lane = nt16 code | reverse << 4) pair scatters
into a dense [window, 32] count tensor (16 base codes x 2 strands).
``pileup_counts``, ``pileup_qual_sums`` and ``pileup_counts_tiled`` are
the JAX package's XLA functions (:29, :44, :55); each has a plain
PyTorch version (``index_put_`` with ``accumulate=True`` on the masked
items) and a wrapper that launches K14 (csrc/pileup_counts.cu: entries
``pileup_scatter`` and ``pileup_tiled``) for CUDA tensors.  The edge
cases are the JAX ones: in the scatter forms a negative lane has 32
added once (JAX normalises a negative index before the scatter) and a
lane still outside [0, 32) is dropped; the tiled form's one-hot drops
every lane outside [0, 32).  A position outside the window (tile) or an
invalid item adds nothing.

``make_sharded_pileup`` is the mesh form (:131): reads shard over the
mesh's ``data`` axis, the window over ``region``; each shard runs K14 on
its reads and its window slice, and the data shards' counts add on the
mesh's first device (the JAX ``psum``), with ``all_reduce`` over the
process group when ``torch.distributed`` runs (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import flags as F
from ..core.batch import ragged_gather_indices
from .cigar import expand_ops

N_LANES = 32  # 16 base codes x 2 strands

# K14's scatter walks chunks of consecutive items, a block a chunk: the
# largest and smallest chunk (items, multiples of 16; the kernel takes
# at most 2,048), and the rows of a block's private shared-memory
# accumulator (32 KiB: with a chunk's two stages, three blocks an SM for
# counts, two for qual sums).  A chunk whose adding items span more rows
# adds through global atomics.
SCATTER_CHUNK = 2048
SCATTER_CHUNK_MIN = 256
SCATTER_BUDGET_ROWS = 256


def _check_items(refpos, lane, valid, extra=()):
    n = refpos.numel()
    kernels.check(refpos, "refpos", torch.int32, (n,))
    kernels.check(lane, "lane", torch.int32, (n,))
    kernels.check(valid, "valid", torch.bool, (n,))
    for t, name in extra:
        kernels.check(t, name, torch.int32, (n,))


def pileup_scatter_plain(refpos: torch.Tensor, lane: torch.Tensor,
                         valid: torch.Tensor, window: int,
                         weight: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """K14's scatter entry in plain PyTorch: int32 [window, 32] of the
    valid in-window items' weights (1 when ``weight`` is None), a
    negative lane taken + 32 and a lane outside [0, 32) dropped."""
    ln = torch.where(lane < 0, lane + N_LANES, lane)
    ok = valid & (refpos >= 0) & (refpos < window) & (ln >= 0) \
        & (ln < N_LANES)
    out = torch.zeros(window, N_LANES, dtype=torch.int32,
                      device=refpos.device)
    w = (torch.ones_like(refpos) if weight is None else weight)[ok]
    out.index_put_((refpos[ok].long(), ln[ok].long()), w.to(torch.int32),
                   accumulate=True)
    return out


def scatter_chunk(n: int, sms: int) -> int:
    """Items a chunk of K14's scatter for ``n`` items on a card of ``sms``
    SMs: SCATTER_CHUNK, halved down to SCATTER_CHUNK_MIN while there are
    fewer than two chunks an SM (a small call still fills the card)."""
    c = SCATTER_CHUNK
    while c > SCATTER_CHUNK_MIN and -(-n // c) < 2 * sms:
        c //= 2
    return c


def pileup_scatter(refpos: torch.Tensor, lane: torch.Tensor,
                   valid: torch.Tensor, window: int,
                   weight: torch.Tensor | None = None) -> torch.Tensor:
    """K14 ``pileup_scatter``: int32 [window, 32] counts (``weight``
    None) or weight sums.  refpos/lane int32[n], valid bool[n], weight
    int32[n].  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check_items(refpos, lane, valid,
                 () if weight is None else ((weight, "weight"),))
    ts = (refpos, lane, valid) + (() if weight is None else (weight,))
    if not kernels.on_card(*ts):
        return pileup_scatter_plain(refpos, lane, valid, window, weight)
    out = torch.zeros(window, N_LANES, dtype=torch.int32,
                      device=refpos.device)
    n = refpos.numel()
    if n and window > 0:
        kernels.launch("pileup_scatter", "samtpu_pileup_scatter",
                       refpos.data_ptr(), lane.data_ptr(),
                       None if weight is None else weight.data_ptr(),
                       valid.data_ptr(), n, window,
                       scatter_chunk(n, kernels.sm_count(out.device)),
                       SCATTER_BUDGET_ROWS, out.data_ptr(),
                       kernels.stream_of(out), device=out.device)
    return out


def pileup_counts(refpos: torch.Tensor, lane: torch.Tensor,
                  valid: torch.Tensor, window: int) -> torch.Tensor:
    """[window, 32] int32 counts from per-base (refpos, lane) pairs.

    refpos: int32[n] positions relative to the window start (out of the
            window: masked)
    lane:   int32[n] = base_code | (is_reverse << 4)
    valid:  bool[n]
    """
    return pileup_scatter(refpos, lane, valid, window)


def pileup_qual_sums(refpos: torch.Tensor, lane: torch.Tensor,
                     qual: torch.Tensor, valid: torch.Tensor,
                     window: int) -> torch.Tensor:
    """[window, 32] int32 summed base qualities per lane (qual int32[n])."""
    return pileup_scatter(refpos, lane, valid, window, weight=qual)


def pileup_tiled_plain(posrel: torch.Tensor, lane: torch.Tensor,
                       valid: torch.Tensor, tile: int,
                       n_tiles: int) -> torch.Tensor:
    """K14's tiled entry in plain PyTorch: int32 [n_tiles * tile, 32]."""
    ok = valid & (posrel >= 0) & (posrel < tile) & (lane >= 0) \
        & (lane < N_LANES)
    rows = torch.arange(n_tiles, device=posrel.device)[:, None] * tile \
        + posrel
    out = torch.zeros(n_tiles * tile, N_LANES, dtype=torch.int32,
                      device=posrel.device)
    out.index_put_((rows[ok].long(), lane[ok].long()),
                   torch.ones(int(ok.sum()), dtype=torch.int32,
                              device=posrel.device), accumulate=True)
    return out


def pileup_counts_tiled(posrel: torch.Tensor, lane: torch.Tensor,
                        valid: torch.Tensor, tile: int,
                        n_tiles: int) -> torch.Tensor:
    """The tiled form of the scatter over bases bucketed by position
    tile (``bucket_bases``): [n_tiles * tile, 32] int32 counts.

    posrel: int32[n_tiles, B] position within the tile (out of the tile:
            invalid)
    lane:   int32[n_tiles, B]
    valid:  bool[n_tiles, B]
    CPU tensors take the plain version; CUDA tensors launch K14's
    ``pileup_tiled`` (a block a tile, which writes every row of its
    tile: the output needs no zero fill)."""
    B = posrel.shape[1] if posrel.dim() == 2 else -1
    kernels.check(posrel, "posrel", torch.int32, (n_tiles, B))
    kernels.check(lane, "lane", torch.int32, (n_tiles, B))
    kernels.check(valid, "valid", torch.bool, (n_tiles, B))
    if not kernels.on_card(posrel, lane, valid):
        return pileup_tiled_plain(posrel, lane, valid, tile, n_tiles)
    if not (n_tiles and B and tile > 0):
        return torch.zeros(n_tiles * tile, N_LANES,
                           dtype=torch.int32, device=posrel.device)
    out = torch.empty(n_tiles * tile, N_LANES, dtype=torch.int32,
                      device=posrel.device)
    kernels.launch("pileup_tiled", "samtpu_pileup_tiled",
                   posrel.data_ptr(), lane.data_ptr(), valid.data_ptr(),
                   n_tiles, B, tile, out.data_ptr(), kernels.stream_of(out),
                   device=out.device)
    return out


def bucket_bases(refpos: np.ndarray, lane: np.ndarray, window: int,
                 tile: int = 512, max_per_tile: int | None = None):
    """Host-side bucketing of (sorted-ish) per-base arrays into fixed
    [n_tiles, B] blocks for pileup_counts_tiled.  Returns (posrel, lane,
    valid) padded arrays."""
    order = np.argsort(refpos, kind="stable")
    rp = refpos[order]
    ln = lane[order]
    n_tiles = (window + tile - 1) // tile
    edges = np.searchsorted(rp, np.arange(n_tiles + 1) * tile)
    per = np.diff(edges)
    B = int(per.max()) if max_per_tile is None else max_per_tile
    B = max(B, 1)
    posrel = np.full((n_tiles, B), -1, np.int32)
    lanes = np.zeros((n_tiles, B), np.int32)
    valid = np.zeros((n_tiles, B), bool)
    # index within the tile
    within = np.arange(rp.size) - edges[:-1].repeat(per)
    keep = within < B
    trow = np.repeat(np.arange(n_tiles), per)[keep]
    tcol = within[keep]
    posrel[trow, tcol] = (rp[keep] - trow * tile).astype(np.int32)
    lanes[trow, tcol] = ln[keep]
    valid[trow, tcol] = True
    return posrel, lanes, valid


def depth_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """[window] depth from the count tensor."""
    return counts.sum(-1)


def expand_to_device_arrays(batch, sel, wbeg: int, window: int):
    """Host-side: the selected reads' M/=/X bases -> (refpos, lane, qual,
    valid) numpy arrays ready for the kernels (``window`` is not used, as
    in the JAX package: positions outside it are masked there)."""
    sub = batch.take(np.asarray(sel, np.int64))
    t = expand_ops(sub)
    m = np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF))
    lens = t.oplen[m]
    refpos = ragged_gather_indices(t.rpos[m], lens) - wbeg
    qoff_in = ragged_gather_indices(t.qpos[m], lens)
    rid = np.repeat(t.rid[m], lens)
    qoff = sub.seq_off[rid] + qoff_in
    base = sub.seq[qoff].astype(np.int32)
    rev = ((sub.flag[rid] & F.FREVERSE) != 0).astype(np.int32)
    lane = base | (rev << 4)
    qual = sub.qual[qoff].astype(np.int32)
    valid = np.ones(refpos.size, bool)
    return (refpos.astype(np.int32), lane.astype(np.int32), qual, valid)


def make_sharded_pileup(mesh, window_per_shard: int):
    """(fn, total_window): ``fn(refpos, lane, valid)`` gives the
    region-sharded pileup counts int32 [n_region * window_per_shard, 32]
    on the mesh's first device, the reads (numpy arrays or tensors of the
    whole batch) sharded over ``data``.  Shard (d, r) runs K14 on data
    shard d's items relative to region r's window slice, on its device;
    the data shards' counts add (the JAX ``psum`` over ``data``) and the
    region slices join in order."""
    from ..parallel import mesh as M

    n_region = mesh.shape["region"]
    total_window = n_region * window_per_shard

    def fn(refpos, lane, valid):
        rp_s, ln_s, ok_s = M.shard_batch_arrays(
            mesh, torch.as_tensor(refpos).to(torch.int32),
            torch.as_tensor(lane).to(torch.int32),
            torch.as_tensor(valid).to(torch.bool))
        slices = []
        for r in range(n_region):
            parts = []
            for d, (rp, ln, ok) in enumerate(zip(rp_s, ln_s, ok_s)):
                dev = mesh.devices[d, r]
                parts.append(pileup_counts(
                    (rp.to(dev) - r * window_per_shard).to(torch.int32),
                    ln.to(dev), ok.to(dev), window_per_shard))
            slices.append(M.local_sum(mesh, parts))
        return M.psum(torch.cat(slices))

    return fn, total_window
