"""Pileup segment-contraction engine: the host tile plan, and the device
paths of ``depth``, ``coverage`` and ``bedcov``.

Counterpart of samtools_tpu/ops/pileup_engine.py (:51-122, :186-194,
:197-250, :253-436, :439-542).  The genome window is cut into tiles of
``tile`` positions; because the input is coordinate-sorted and each read
emits its items in order, every tile's contributing items live in one
contiguous slice [lo_t, hi_t) of the flat item arrays.  ``tile_plan``
finds those slices on the host; the contraction itself is K1's generic
form (ops/segment_kernel.py::segment_contract), which covers each slice
whole, so the plan needs no item window, no passes and no padding of the
items.

Around K1, the JAX package's K9 (XLA there) is two hand-written kernels
on the card: the depth scan ``depth_scan`` (csrc/depth_scan.cu: cumsum
+ direct in a reduce-then-scan, the first L values written as int32
straight into pinned host memory, wrapped as the plain's narrowing
wraps them where it would) and the coverage reduction
``cov_reduce`` (csrc/cov_reduce.cu: the min-depth gate and the
per-subwindow sums, in int64, so deep windows do not wrap), each beside
its plain torch version.  ``coverage_items`` keeps each
base's quality whole: lane 1 holds q & 127 and lane 3 q >> 7, where the
JAX package caps the quality at 127 in one int8 lane.

K1 indexes items with int32.  A window whose reads would make MAX_ITEMS
items or more is cut at tile boundaries into sub-windows of fewer
(``item_cuts``), planned from per-read item counts before any item is
built, and run one after another: depth concatenates their columns,
coverage adds their sums.  The JAX package's device branch wraps
silently there; its host branch is the output held.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import flags as F
from ..core import metrics
from ..core.batch import ragged_gather_indices
from ..device import d2h, resolve
from .cigar import expand_ops
from .segment_kernel import segment_contract

# K1 indexes items with int32 (the plan's lo/hi and the kernel's n)
MAX_ITEMS = (1 << 31) - 1
# coverage census lanes: okq count, qual & 127, entry count, qual >> 7
COV_K = 4


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


def pick_tile(wlen: int) -> int:
    """Tile size by window length, as the JAX package picks it."""
    if wlen >= 1 << 21:
        return 1024
    if wlen >= 1 << 17:
        return 512
    return 128


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


def segment_matmul(refpos: np.ndarray, W: np.ndarray, plan: TilePlan,
                   device, out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 over a tile plan: uploads ``refpos`` as int32 and ``W`` as int8
    [n, K] and adds the contraction into ``out`` (a fresh int32
    [n_tiles*tile, K] on ``device`` when None), which it returns.  Raises
    at 2^31 items or more, where the plan's int32 indices would wrap."""
    with metrics.stage("device.segment_matmul", refpos.size, "events"):
        return _segment_matmul(refpos, W, plan, device, out)


def _segment_matmul(refpos: np.ndarray, W: np.ndarray, plan: TilePlan,
                    device, out: torch.Tensor | None) -> torch.Tensor:
    K = W.shape[1]
    if out is None:
        out = torch.zeros(plan.n_tiles * plan.tile, K, dtype=torch.int32,
                          device=device)
    n = refpos.size
    if n > MAX_ITEMS:
        raise ValueError(f"{n} items in one window: K1 indexes items with "
                         f"int32 (at most {MAX_ITEMS})")
    if n == 0:
        return out
    rp = torch.from_numpy(np.ascontiguousarray(refpos, np.int32)).to(device)
    Wt = torch.from_numpy(np.ascontiguousarray(W, np.int8)).to(device)
    lo = torch.from_numpy(plan.lo).to(device)
    hi = torch.from_numpy(plan.hi).to(device)
    return segment_contract(rp, Wt, lo, hi, plan.wbeg, plan.tile, out)


# ---------------------------------------------------------------- depth
def _read_plan(nreads: int, rid: np.ndarray, rpos_b, rend_b, wbeg: int,
               L: int, tile: int):
    """Sort items by read when they are not already grouped (stable), and
    plan them: (order or None, plan)."""
    order = None
    if rid.size and (np.diff(rid) < 0).any():
        order = np.argsort(rid, kind="stable")
        rid = rid[order]
    off = np.zeros(nreads + 1, np.int64)
    np.cumsum(np.bincount(rid, minlength=nreads), out=off[1:])
    return order, tile_plan(rpos_b, rend_b, off, wbeg, L, tile)


def depth_items(batch, sel: np.ndarray, wbeg: int, wend: int,
                min_qual: int, count_del: bool,
                clips: np.ndarray | None = None):
    """The host half of ``depth_window_device``: K1's items for the
    selected reads of one file over [wbeg, wend), as two (refpos, W,
    plan) triples, or None where there are none: ``diff``, +-1 events at
    the ends of the M/=/X spans (min_qual == 0) and the -J deletions;
    ``direct``, a 0/1 weight per M base (min_qual > 0)."""
    ragged = ("cigar", "qual") if min_qual else ("cigar",)
    sub = batch.take(sel, ragged=ragged)
    t = expand_ops(sub)
    clip = (clips[sel] if clips is not None else np.zeros(sel.size, np.int64))
    L = wend - wbeg
    ev_pos, ev_w, ev_rid = [], [], []
    direct = None
    m = np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF))
    if min_qual == 0:
        if m.any():
            rs = t.rpos[m]
            opclip = clip[t.rid[m]]
            s = np.clip(np.maximum(rs, opclip), wbeg, wend)
            e = np.clip(np.maximum(rs + t.oplen[m], opclip), wbeg, wend)
            # drop empty spans: every event then lies in its read's
            # [pos, end] span, as tile_plan needs
            nz = s < e
            s, e, rm = s[nz], e[nz], t.rid[m][nz]
            # (+start, -end) interleaved per op: rid stays nondecreasing
            k = s.size
            pos = np.empty(2 * k, s.dtype)
            pos[0::2], pos[1::2] = s, e
            w = np.empty(2 * k, np.int8)
            w[0::2], w[1::2] = 1, -1
            ev_pos.append(pos)
            ev_w.append(w)
            ev_rid.append(np.repeat(rm, 2))
    elif m.any():
        lens = t.oplen[m]
        refpos = ragged_gather_indices(t.rpos[m], lens)
        qoff = ragged_gather_indices(t.qpos[m], lens)
        rid = np.repeat(t.rid[m], lens)
        qual = sub.qual[sub.seq_off[rid] + qoff]
        ok = (qual >= min_qual) & (refpos >= clip[rid])
        direct = (refpos, ok.astype(np.int8)[:, None], rid)

    if count_del:
        d = t.op == F.CDEL
        if d.any():
            rs = t.rpos[d]
            opclip = clip[t.rid[d]]
            qpos = t.qpos[d]
            rid = t.rid[d]
            ok = np.ones(rs.size, bool)
            if min_qual:
                has_q = qpos < sub.l_qseq[rid]
                qv = np.zeros(rs.size, np.int64)
                qv[has_q] = sub.qual[sub.seq_off[rid[has_q]]
                                     + qpos[has_q]].astype(np.int64)
                ok = ~has_q | (qv >= min_qual)
            s = np.clip(np.maximum(rs, opclip), wbeg, wend)[ok]
            e = np.clip(np.maximum(rs + t.oplen[d], opclip), wbeg, wend)[ok]
            rm = rid[ok]
            nz = s < e
            s, e, rm = s[nz], e[nz], rm[nz]
            ev_pos += [s, e]
            ev_w += [np.ones(s.size, np.int8), -np.ones(e.size, np.int8)]
            ev_rid += [rm, rm]

    # events are clipped into [wbeg, wend]: widen the read bounds to match
    rpos_b = np.minimum(np.maximum(sub.pos, wbeg), wend)
    rend_b = np.minimum(np.maximum(sub.end_pos(), wbeg), wend) + 1
    tile = pick_tile(L)

    def planned(pos, w, rid):
        order, plan = _read_plan(sub.n, rid, rpos_b, rend_b, wbeg, L, tile)
        if order is not None:
            pos, w = pos[order], w[order]
        return pos, w, plan

    diff = (planned(np.concatenate(ev_pos), np.concatenate(ev_w)[:, None],
                    np.concatenate(ev_rid)) if ev_pos else None)
    return diff, (planned(*direct) if direct is not None else None)


def depth_scan_plain(diff: torch.Tensor | None,
                     direct: torch.Tensor | None, L: int) -> np.ndarray:
    """K9's depth step in torch ops: depth = cumsum(diff) + direct as
    int32 over the plan's rows (an absent column counts as zeros), its
    max, and the first L rows narrowed to the narrowest type that holds
    that max (uint8, int16, or int32 as it is) before the one
    device-to-host copy.  Returns int32[L]."""
    d = torch.cumsum(diff[:, 0], 0) if diff is not None else 0
    if direct is not None:
        d = d + direct[:, 0]
    d = d.to(torch.int32)
    mx = int(d.max())
    d = d[:L]
    if mx < 256:
        d = d.to(torch.uint8)
    elif mx < 1 << 15:
        d = d.to(torch.int16)
    return d.cpu().numpy().astype(np.int32)


# K9's depth scan (csrc/depth_scan.cu): rows a block of its grids
DEPTH_TILE = 8192


def depth_plan(rows: int) -> int:
    """Blocks of each grid of the depth scan over ``rows`` rows: one a
    tile of DEPTH_TILE."""
    return -(-rows // DEPTH_TILE)


def depth_scan(diff: torch.Tensor | None, direct: torch.Tensor | None,
               L: int) -> np.ndarray:
    """K9's depth step: ``depth_scan_plain``'s int32[L] from K1's
    difference and direct columns (int32 [rows, 1] each, either may be
    None, not both).  CPU tensors take the plain version; CUDA tensors
    launch csrc/depth_scan.cu, a reduce-then-scan over tiles of
    DEPTH_TILE rows that writes the first L values as int32 straight into
    pinned host memory: one sync and the host reads them, with no
    widening (the int32 transport measured faster on the card than narrow
    bytes widened on the host).  The scan also keeps the max over all
    rows and the min of the first L; where the plain's narrowing to the
    width of that max would wrap a value (a negative depth, which K1's
    columns never give), a last grid rewrites them as it would."""
    cols = [c for c in (diff, direct) if c is not None]
    if not cols:
        raise ValueError("depth_scan needs a difference or a direct column")
    rows = cols[0].shape[0]
    for name, c in (("diff", diff), ("direct", direct)):
        if c is not None:
            kernels.check(c, name, torch.int32, (rows, 1))
    if not 0 < L <= rows < (1 << 31):
        raise ValueError(f"depth_scan takes 0 < L <= rows < 2^31, got L {L},"
                         f" {rows} rows")
    if not kernels.on_card(*cols):
        return depth_scan_plain(diff, direct, L)
    if any(c.data_ptr() % 16 for c in cols):
        raise ValueError("depth_scan needs 16-byte aligned columns")
    dev = cols[0].device
    tiles = depth_plan(rows)
    scratch = torch.empty(tiles + 2, dtype=torch.int32, device=dev)
    out = torch.empty(L, dtype=torch.int32, pin_memory=True)
    stream = torch.cuda.current_stream(dev)
    kernels.launch("depth_scan", "samtpu_depth_scan",
                   diff.data_ptr() if diff is not None else None,
                   direct.data_ptr() if direct is not None else None,
                   rows, L, tiles, scratch.data_ptr(), out.data_ptr(),
                   stream.cuda_stream, device=dev)
    stream.synchronize()
    return out.numpy()


def _cigar_counts(batch, sel: np.ndarray):
    """Per selected read: (M/=/X ops of nonzero length, M/=/X bases, D
    ops), from its CIGAR alone."""
    ncig = batch.cigar_off[sel + 1] - batch.cigar_off[sel]
    cig = batch.cigar[ragged_gather_indices(batch.cigar_off[sel], ncig)]
    rid = np.repeat(np.arange(sel.size), ncig)
    ops = cig & 0xF
    lens = (cig >> 4).astype(np.int64)
    m = (ops == F.CMATCH) | (ops == F.CEQUAL) | (ops == F.CDIFF)
    n = sel.size
    return (np.bincount(rid[m & (lens > 0)], minlength=n),
            np.bincount(rid[m], weights=lens[m], minlength=n).astype(
                np.int64),
            np.bincount(rid[ops == F.CDEL], minlength=n))


def item_cuts(files, wbeg: int, wend: int, tile: int) -> list:
    """Sub-windows [a, b) of [wbeg, wend), cut at multiples of ``tile``
    from wbeg, in each of which every file's reads that overlap it make
    fewer than MAX_ITEMS items.  files: (read start, read end, items per
    read) per file, reads in coordinate order; a read's items are counted
    whole in every sub-window it overlaps.  Raises where one tile alone
    holds MAX_ITEMS items."""
    n_tiles = max(1, (wend - wbeg + tile - 1) // tile)
    planned = []
    for pos, end, items in files:
        inw = (pos < wend) & (end > wbeg)
        a = np.clip(pos[inw], wbeg, wend) - wbeg
        e = np.clip(end[inw], wbeg, wend) - wbeg
        c = items[inw].astype(np.float64)
        # items of the reads whose first tile is below B, and of those
        # whose last tile is below A: count(A, B) = by_first[B] - by_last[A]
        by_first = np.concatenate([[0], np.cumsum(np.bincount(
            a // tile, weights=c, minlength=n_tiles))]).astype(np.int64)
        by_last = np.concatenate([[0], np.cumsum(np.bincount(
            (e - 1) // tile, weights=c, minlength=n_tiles))]).astype(np.int64)
        planned.append((by_first, by_last))
    cuts, A = [], 0
    while A < n_tiles:
        B = min(int(np.searchsorted(f, MAX_ITEMS + int(d[A]), side="left"))
                - 1 for f, d in planned)
        if B <= A:
            raise ValueError(f"tile {A} of the window at {wbeg} holds "
                             f"{MAX_ITEMS} items or more")
        B = min(B, n_tiles)
        cuts.append((wbeg + A * tile, min(wbeg + B * tile, wend)))
        A = B
    return cuts


def depth_window_device(batch, sel: np.ndarray, wbeg: int, wend: int,
                        min_qual: int, count_del: bool,
                        clips: np.ndarray | None = None,
                        device=None, segmm_fn=None) -> np.ndarray:
    """ops.depth.depth_window's integers with the contraction and the
    scan on ``device`` (a torch device; a CPU device takes the plain
    versions): the spans become +-1 difference events and, with a
    quality gate, each M base a 0/1 weight, K1 adds both per position
    and ``depth_scan`` gives int32[wend - wbeg].  ``device`` None means
    the CUDA card.  ``segmm_fn(refpos, W, plan)``, when given, makes the
    contraction in K1's place and returns its int32 [n_tiles * tile, K]
    rows on ``device`` (parallel/mesh.py's sharded form).  A window of
    MAX_ITEMS items or more runs as ``item_cuts``' sub-windows, their
    columns concatenated."""
    device = resolve(device)
    if segmm_fn is None:
        def segmm_fn(pos, w, plan):
            return segment_matmul(pos, w, plan, device)
    if sel.size == 0:
        return np.zeros(wend - wbeg, np.int32)
    # items per read, bounded from above: 2 events per M span (or one per
    # M base with a quality gate) and 2 per deletion with -J
    spans, bases, dels = _cigar_counts(batch, sel)
    items = (bases if min_qual else 2 * spans) + (2 * dels if count_del
                                                  else 0)
    if int(items.sum()) < MAX_ITEMS:
        return _depth_window(batch, sel, wbeg, wend, min_qual, count_del,
                             clips, device, segmm_fn)
    pos, end = batch.pos[sel], batch.end_pos()[sel]
    return np.concatenate([
        _depth_window(batch, sel[(pos < b) & (end > a)], a, b, min_qual,
                      count_del, clips, device, segmm_fn)
        for a, b in item_cuts([(pos, end, items)], wbeg, wend,
                              pick_tile(wend - wbeg))])


def _depth_window(batch, sel, wbeg, wend, min_qual, count_del, clips,
                  device, segmm_fn) -> np.ndarray:
    L = wend - wbeg
    if sel.size == 0:
        return np.zeros(L, np.int32)
    diff, direct = depth_items(batch, sel, wbeg, wend, min_qual, count_del,
                               clips)
    if diff is None and direct is None:
        return np.zeros(L, np.int32)
    cols = [segmm_fn(*it) if it is not None else None
            for it in (diff, direct)]
    return depth_scan(cols[0], cols[1], L)


# ------------------------------------------------------------- coverage
def coverage_items(batch, sel: np.ndarray, wbeg: int, wend: int,
                   min_baseq: int):
    """K1's items for one file's coverage census over [wbeg, wend):
    (refpos, W int8[n, COV_K], plan), one item per M/=/X/D/N base.
    Lanes: 0, 1 for an M base of quality >= min_baseq; 1, its quality &
    127 under the same gate; 2, 1 for every base (the pileup entries);
    3, its quality >> 7 under the gate.  Items outside the window weigh
    nothing."""
    L = wend - wbeg
    sb = batch.take(np.asarray(sel, np.int64), ragged=("cigar", "qual"))
    t = expand_ops(sb)
    emit = np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF, F.CDEL,
                          F.CREF_SKIP))
    e_ops = np.nonzero(emit)[0]
    e_len = t.oplen[e_ops]
    pos = ragged_gather_indices(t.rpos[e_ops], e_len)
    is_m_e = np.repeat(np.isin(t.op[e_ops], (F.CMATCH, F.CEQUAL, F.CDIFF)),
                       e_len)
    rid = np.repeat(t.rid[e_ops], e_len)
    qpos = ragged_gather_indices(t.qpos[e_ops], e_len)
    W = np.zeros((pos.size, COV_K), np.int8)
    W[:, 2] = 1
    qm = sb.qual[sb.seq_off[rid[is_m_e]] + qpos[is_m_e]]
    okq = qm >= min_baseq
    q = np.where(okq, qm, 0).astype(np.uint8)
    W[is_m_e, 0] = okq
    W[is_m_e, 1] = q & 127
    W[is_m_e, 3] = q >> 7
    W[(pos < wbeg) | (pos >= wend)] = 0
    off = np.zeros(sb.n + 1, np.int64)
    np.cumsum(np.bincount(t.rid[e_ops], weights=e_len, minlength=sb.n)
              .astype(np.int64), out=off[1:])
    plan = tile_plan(np.minimum(np.maximum(sb.pos, wbeg), wend),
                     np.minimum(np.maximum(sb.end_pos(), wbeg), wend) + 1,
                     off, wbeg, L, pick_tile(L))
    return np.clip(pos, wbeg, wend - 1), W, plan


def cov_reduce_plain(census: torch.Tensor, sub: int, min_depth: int
                     ) -> torch.Tensor:
    """K9's coverage step in torch ops: census int32 [rows, COV_K] ->
    int64 [ceil(rows/sub), 3] per-subwindow sums of (okq count, quality
    sum, 1) over the positions that pass the gate: some pileup entry,
    okq count > 0 and >= min_depth (coverage.c's covered / meandepth /
    meanbaseq accumulators).  Summed in int64: a deep window's quality
    sum passes 2^31."""
    c0 = census[:, 0].long()
    ok = (census[:, 2] > 0) & (c0 > 0) & (c0 >= min_depth)
    qsum = census[:, 1].long() + 128 * census[:, 3].long()
    cols = torch.stack([c0, qsum, torch.ones_like(c0)], 1) * ok[:, None]
    rows = cols.shape[0]
    if rows % sub:
        cols = torch.cat([cols, cols.new_zeros(sub - rows % sub, 3)])
    return cols.reshape(-1, sub, 3).sum(1)


# K9's coverage reduction (csrc/cov_reduce.cu): blocks an SM in all, and
# the fewest rows a block takes
COV_BLOCKS_PER_SM = 4
COV_MIN_ROWS = 1024


def cov_plan(rows: int, sub: int, sms: int) -> tuple[int, int]:
    """(G, chunk) of the coverage reduction over ``rows`` census rows in
    subwindows of ``sub`` on a card of ``sms`` SMs: G blocks a subwindow,
    each over ``chunk`` consecutive rows of it, about COV_BLOCKS_PER_SM
    blocks an SM in all and COV_MIN_ROWS rows a block at least."""
    nsub = -(-rows // sub)
    span = min(sub, rows)
    G = max(1, min(-(-COV_BLOCKS_PER_SM * sms // nsub),
                   -(-span // COV_MIN_ROWS)))
    return G, -(-span // G)


def cov_reduce(census: torch.Tensor, sub: int, min_depth: int
               ) -> torch.Tensor:
    """K9's coverage step: ``cov_reduce_plain``'s int64 [ceil(rows/sub),
    3].  CPU tensors take the plain version; CUDA tensors launch
    csrc/cov_reduce.cu once (``cov_plan``'s G blocks a subwindow, 16-byte
    row loads, int64 partials, the last block of a subwindow adding its
    blocks' sums), which builds nothing of [rows, 3]."""
    kernels.check(census, "census", torch.int32, (None, COV_K))
    rows = census.shape[0]
    if rows < 1 or sub < 1:
        raise ValueError(f"cov_reduce takes rows >= 1 and sub >= 1, got "
                         f"{rows}, {sub}")
    if not -(1 << 31) <= min_depth < (1 << 31):
        raise ValueError(f"min_depth {min_depth} outside int32")
    if not kernels.on_card(census):
        return cov_reduce_plain(census, sub, min_depth)
    if census.data_ptr() % 16:
        raise ValueError("cov_reduce needs a 16-byte aligned census")
    dev = census.device
    nsub = -(-rows // sub)
    G, chunk = cov_plan(rows, sub, kernels.sm_count(dev))
    out = torch.empty(nsub, 3, dtype=torch.int64, device=dev)
    partial = torch.empty(nsub * G * 3 if G > 1 else 1, dtype=torch.int64,
                          device=dev)
    stream = kernels.stream_of(census)
    kernels.launch("cov_reduce", "samtpu_cov_reduce", census.data_ptr(),
                   rows, sub, chunk, G, min_depth, partial.data_ptr(),
                   kernels.scratch("cov_reduce", dev, stream,
                                   nsub).data_ptr(),
                   out.data_ptr(), stream, device=dev)
    return out


def coverage_window_device(parts, wbeg: int, wend: int, min_baseq: int,
                           min_depth: int, device=None,
                           sub: int = 1 << 16) -> np.ndarray:
    """Coverage statistics of one window across input files, computed on
    ``device``: int64 (n_cov_bases, summed_cov, summed_baseq).  Every
    file's items add into one census (the same window gives every file's
    plan the same rows), gated at full resolution and reduced by
    ``cov_reduce``; only the subwindow sums come back.  ``device`` None
    means the CUDA card.

    parts: iterable of (batch, sel) pairs, one per input file.  Where a
    file's reads would make MAX_ITEMS items or more, the window runs as
    ``item_cuts``' sub-windows and their int64 sums add."""
    device = resolve(device)
    parts = [(b, s) for b, s in parts if s.size]
    # a read's items: one per base of its reference span
    files = [(b.pos[s], b.end_pos()[s], b.ref_span()[s]) for b, s in parts]
    if all(int(f[2].sum()) < MAX_ITEMS for f in files):
        return _coverage_window(parts, wbeg, wend, min_baseq, min_depth,
                                device, sub)
    acc = np.zeros(3, np.int64)
    for a, b in item_cuts(files, wbeg, wend, pick_tile(wend - wbeg)):
        acc += _coverage_window(
            [(bt, s[(p < b) & (e > a)]) for (bt, s), (p, e, _) in
             zip(parts, files)], a, b, min_baseq, min_depth, device, sub)
    return acc


def _coverage_window(parts, wbeg, wend, min_baseq, min_depth, device, sub):
    census = None
    for batch, sel in parts:
        if sel.size == 0:
            continue
        census = segment_matmul(*coverage_items(batch, sel, wbeg, wend,
                                                min_baseq), device, census)
    if census is None:
        return np.zeros(3, np.int64)
    tot = d2h(cov_reduce(census, sub, min_depth)).sum(0)
    # [0] okq count over gated positions -> summed_cov, [1] quality sums
    # -> summed_baseq, [2] gated positions -> covbases
    return np.array([tot[2], tot[0], tot[1]], np.int64)
