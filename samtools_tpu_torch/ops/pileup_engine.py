"""Pileup segment-contraction engine: the host tile plan.

Counterpart of samtools_tpu/ops/pileup_engine.py (:51-122, :186-194).
The genome window is cut into tiles of ``tile`` positions; because the
input is coordinate-sorted and each read emits its items in order, every
tile's contributing items live in one contiguous slice [lo_t, hi_t) of
the flat item arrays.  ``tile_plan`` finds those slices on the host; the
contraction itself is K1 (ops/segment_kernel.py).
"""

from __future__ import annotations

import numpy as np


class TilePlan:
    """Per-tile contiguous item slices.

    lo, hi : int32[n_tiles] item index range per tile (K1 covers each
             slice whole, so the plan carries no item window or passes)
    n_tiles: ceil(window_len / tile)
    """

    __slots__ = ("lo", "hi", "n_tiles", "wbeg", "wlen", "tile")

    def __init__(self, lo, hi, n_tiles, wbeg, wlen, tile):
        self.lo, self.hi = lo, hi
        self.n_tiles = n_tiles
        self.wbeg, self.wlen = wbeg, wlen
        self.tile = tile


def tile_plan(read_pos: np.ndarray, read_end: np.ndarray,
              item_off: np.ndarray, wbeg: int, wlen: int,
              tile: int) -> TilePlan:
    """Per-tile item slices for a window [wbeg, wbeg+wlen).

    read_pos/read_end: per-read reference start / exclusive end, reads in
    coordinate order.  item_off: int64[n_reads+1] offsets of each read's
    items in the flat item arrays; a read's items must carry positions
    within [read_pos, read_end]."""
    n_tiles = max(1, (wlen + tile - 1) // tile)
    starts = wbeg + np.arange(n_tiles, dtype=np.int64) * tile
    if read_pos.size == 0:
        lo = np.zeros(n_tiles, np.int32)
        return TilePlan(lo, lo.copy(), n_tiles, wbeg, wlen, tile)
    cummax_end = np.maximum.accumulate(read_end)
    # first read that can still touch the tile (end >= tile start)
    lo_read = np.searchsorted(cummax_end, starts, side="left")
    # first read starting at/after the tile end
    hi_read = np.searchsorted(read_pos, starts + tile, side="left")
    hi_read = np.maximum(hi_read, lo_read)
    lo = item_off[lo_read].astype(np.int64)
    hi = item_off[hi_read].astype(np.int64)
    return TilePlan(lo.astype(np.int32), hi.astype(np.int32),
                    n_tiles, wbeg, wlen, tile)


def padded_tiles(n_tiles: int, chunk: int = 16) -> int:
    """The next power of two >= n_tiles that is a multiple of chunk."""
    n = max(n_tiles, chunk)
    p = chunk
    while p < n:
        p <<= 1
    return p

