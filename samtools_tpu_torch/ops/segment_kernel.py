"""K1 segment_contract and its census form segment_census: the census
segment contraction, their CUDA wrappers and their plain PyTorch versions.

Computes, for each genomic tile t of a tile plan,

    out[t*tile + p, k] += sum_{b in [lo_t, hi_t)} 1[rp_b == wbeg + t*tile + p] * W[b, k]

exactly in int32.  Replaces samtools_tpu/ops/pileup_pallas.py::_build
(the repository's Pallas kernel, ``pl.pallas_call`` at :134); the plain
version mirrors the XLA one-hot einsum samtools_tpu/ops/
pileup_engine.py::_segmm_jit (:126-173).  The census form takes the
chunk step's per-base tensors instead of (rp, W): it is the counterpart
of ``census_pallas`` (:252) together with the weight build of the fused
chunk step (samtools_tpu/ops/mpileup_device.py:214-225) and
``pack_census`` (K2, pileup_pallas.py:178-186), and its plain version is
that weight build (``census_weights``) followed by
``segment_contract_plain``.

On the H100 the contraction is bound by bytes.  Both kernels
(csrc/segment_contract.cu) share one body: one thread block takes a
piece of consecutive items, stages it in shared memory, finds each
item's tile and checks the item against that tile's slice, and adds into
a shared-memory accumulator that it flushes with global atomics
(``piece_layout`` sizes the pieces and the accumulator).
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_K = 32
CENSUS_K = 6      # A,C,G,T,other counts + qual-sum lane
STAGE_BYTES = 24 << 10   # a piece's staged item bytes, at most
ACC_WORDS = 2048         # int32 words of a block's row accumulator


def piece_layout(item_bytes: int, K: int) -> tuple[int, int]:
    """K1's block geometry for items of ``item_bytes`` staged bytes and K
    weight lanes: (P, win), P items per block (the largest power of two
    whose staged bytes fit STAGE_BYTES) and win accumulator rows (as many
    rows of K int32 lanes as ACC_WORDS holds)."""
    P = 1
    while 2 * P * item_bytes <= STAGE_BYTES:
        P *= 2
    return P, ACC_WORDS // K


def segment_contract_plain(rp: torch.Tensor, W: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor, wbeg: int,
                           tile: int) -> torch.Tensor:
    """One-hot einsum over the tile plan (the _segmm_jit form): returns a
    fresh int32 [n_tiles*tile, K].  Tiles go 16 at a time; the widest
    slice of the 16 sets their item window, walked in blocks that keep
    the [16, block, tile] one-hot near 256 MB, so one pass covers each
    slice whole and a deep pile costs only its own tiles.  Tiles with an
    empty slice stay zero.  Each block's f32 sums (products of 0/1 and
    int8, below 2^24) are exact and add up in int32."""
    n_tiles = lo.numel()
    K = W.shape[1]
    n = rp.numel()
    dev = rp.device
    out = torch.zeros(n_tiles, tile, K, dtype=torch.int32, device=dev)
    width = hi.long() - lo.long()
    tiles = torch.nonzero(width > 0).flatten()
    if tiles.numel() == 0 or n == 0:
        return out.reshape(-1, K)
    cls_ids = torch.arange(tile, device=dev)
    for c0 in range(0, tiles.numel(), 16):
        tid = tiles[c0:c0 + 16]
        B = int(width[tid].max())
        step = max(1, min(B, (1 << 26) // (tid.numel() * tile)))
        jb = torch.arange(step, device=dev)
        for j0 in range(0, B, step):
            idx = lo[tid].long()[:, None] + j0 + jb[None, :]
            live = idx < hi[tid].long()[:, None]
            idxc = idx.clamp(0, n - 1)
            posrel = rp[idxc].long() - (wbeg + tid[:, None] * tile)
            ok = live & (posrel >= 0) & (posrel < tile)
            onehot = ((posrel[:, :, None] == cls_ids)
                      & ok[:, :, None]).float()
            o = torch.einsum("cbt,cbk->ctk", onehot, W[idxc].float())
            out[tid] += o.round().to(torch.int32)
    return out.reshape(-1, K)


def segment_contract(rp: torch.Tensor, W: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, wbeg: int, tile: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Add the contraction into ``out`` (int32 [n_tiles*tile, K], e.g. a
    row slice of a resident census) in place and return it.

    rp int32[n] item positions, W int8[n, K<=32] item weights, lo/hi
    int32[n_tiles] item slice of each tile, wbeg the position of tile 0.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    n_tiles = lo.numel()
    K = W.shape[1] if W.dim() == 2 else -1
    kernels.check(rp, "rp", torch.int32, (None,))
    kernels.check(W, "W", torch.int8, (rp.numel(), None))
    kernels.check(lo, "lo", torch.int32, (n_tiles,))
    kernels.check(hi, "hi", torch.int32, (n_tiles,))
    kernels.check(out, "out", torch.int32, (n_tiles * tile, K))
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside [1, {MAX_K}]")
    if not kernels.on_card(rp, W, lo, hi, out):
        out += segment_contract_plain(rp, W, lo, hi, wbeg, tile)
        return out
    P, win = piece_layout(4 + K, K)
    kernels.launch("segment_contract", "samtpu_segment_contract",
                   rp.data_ptr(), W.data_ptr(), K, rp.numel(), lo.data_ptr(),
                   hi.data_ptr(), n_tiles, int(wbeg), tile, P, win,
                   out.data_ptr(), kernels.stream_of(out), device=out.device)
    return out


def census_weights(refpos, seg, sq, appq, risky, base: int, gate_lo: int,
                   gate_hi: int, min_baseq: int):
    """The census form's items as the generic form takes them: (rp
    int32[C*LQ] window-relative position, W int8[C*LQ, 6] = one-hot base
    + applied qual), zero weight where the base is not an M base, falls
    below min_baseq, lies outside [gate_lo, gate_hi) or belongs to a
    risky read."""
    is_m = seg >= 0
    rp = torch.where(is_m, refpos - base, gate_hi)
    gate = (is_m & (appq >= min_baseq) & ~risky[:, None]
            & (rp >= gate_lo) & (rp < gate_hi))
    lanes = torch.arange(5, dtype=torch.uint8, device=appq.device)
    W = torch.cat([(sq.reshape(-1, 1) == lanes).to(torch.int8),
                   appq.reshape(-1, 1).to(torch.int8)], 1)
    return rp.reshape(-1).to(torch.int32), W * gate.reshape(-1, 1)


def segment_census_plain(refpos, seg, sq, appq, risky, base: int,
                         gate_lo: int, gate_hi: int, min_baseq: int, lo, hi,
                         wbeg: int, tile: int) -> torch.Tensor:
    """``census_weights`` then ``segment_contract_plain``: a fresh int32
    [n_tiles*tile, 6]."""
    rp, W = census_weights(refpos, seg, sq, appq, risky, base, gate_lo,
                           gate_hi, min_baseq)
    return segment_contract_plain(rp, W, lo, hi, wbeg, tile)


def segment_census(refpos: torch.Tensor, seg: torch.Tensor,
                   sq: torch.Tensor, appq: torch.Tensor, risky: torch.Tensor,
                   base: int, gate_lo: int, gate_hi: int, min_baseq: int,
                   lo: torch.Tensor, hi: torch.Tensor, wbeg: int, tile: int,
                   out: torch.Tensor) -> torch.Tensor:
    """Add the census of one chunk into ``out`` (int32 [n_tiles*tile, 6])
    in place and return it: lanes 0-4 count the A,C,G,T,other bases and
    lane 5 sums the applied quals of the gated bases of each position.

    refpos int32[C, LQ] each base's reference position, seg int32[C, LQ]
    its M-op ordinal (-1 off M), sq uint8[C, LQ] its 0-4 code, appq
    uint8[C, LQ] its applied qual, risky bool[C]; a base counts at
    window-relative position refpos - base when that lies in [gate_lo,
    gate_hi) and appq >= min_baseq.  lo/hi/wbeg/tile: the chunk's tile
    plan, as ``segment_contract``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    C, LQ = refpos.shape if refpos.dim() == 2 else (-1, -1)
    n_tiles = lo.numel()
    kernels.check(refpos, "refpos", torch.int32, (C, LQ))
    kernels.check(seg, "seg", torch.int32, (C, LQ))
    kernels.check(sq, "sq", torch.uint8, (C, LQ))
    kernels.check(appq, "appq", torch.uint8, (C, LQ))
    kernels.check(risky, "risky", torch.bool, (C,))
    kernels.check(lo, "lo", torch.int32, (n_tiles,))
    kernels.check(hi, "hi", torch.int32, (n_tiles,))
    kernels.check(out, "out", torch.int32, (n_tiles * tile, CENSUS_K))
    if not kernels.on_card(refpos, seg, sq, appq, risky, lo, hi, out):
        out += segment_census_plain(refpos, seg, sq, appq, risky, base,
                                    gate_lo, gate_hi, min_baseq, lo, hi,
                                    wbeg, tile)
        return out
    # staged bytes per base: refpos 4, seg 4, sq 1, appq 1
    P, win = piece_layout(10, CENSUS_K)
    kernels.launch("segment_census", "samtpu_segment_census",
                   refpos.data_ptr(), seg.data_ptr(), sq.data_ptr(),
                   appq.data_ptr(), risky.data_ptr(), C * LQ, LQ, int(base),
                   int(gate_lo), int(gate_hi), int(min_baseq),
                   lo.data_ptr(), hi.data_ptr(), n_tiles, int(wbeg), tile, P,
                   win, out.data_ptr(), kernels.stream_of(out),
                   device=out.device)
    return out
