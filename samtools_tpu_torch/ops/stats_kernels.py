"""K12 stats_hists: the per-base histograms of samtools stats, on the card
or in plain PyTorch.

Replaces samtools_tpu/ops/stats_kernels.py::_device_fn (:77-109), the JAX
scatter-add over a flat per-base stream that its host built with numpy
(``base_hists_device``, :112), and the host pass it stands beside,
``samtpu_stats_orig_hists`` (collect_orig_read_stats, stats.c:917).  For
the selected reads of a chunk, from the chunk's flat nt16 ``seq`` and
``qual`` columns:

* ``q1``, ``q2`` [qrows, 257]: (cycle, qual) of first / last fragments;
* ``a1``, ``a2`` [nbases, 6]: (cycle, A/C/G/T/N/other column) of first /
  last fragments;
* ``ar`` [nbases, 6]: (cycle, column complemented on reverse reads) of
  the A/C/G/T bases of first and last fragments;
* per read its GC count and (first and last fragments only) its qual
  sum; the largest qual of first and last fragments.

The cycle of base j of a read of length len is j, or len - 1 - j on the
reverse strand; the kernel takes the column map and that rule in its
own body, so the host ships the reads' bases as they lie in the batch.
Both versions return one flat int64 tensor (``split_hists`` names its
parts); every count is an integer, so kernel, plain version and host
pass agree exactly.

The JAX package runs its device branch only under
``SAMTPU_STATS_DEVICE=1`` and gives way to numpy when it fails
(``base_hists``, :144-150).  Here the command's device decides: on the
card K12 launches or raises, and ``SAMTPU_DEVICE=0`` runs the host pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

NQUALS = 257
NCOLS = 6
# nt16 code -> column of the acgtno arrays (A, C, G, T, N, other)
ACGTNO_COL = np.array([5, 0, 1, 5, 2, 5, 5, 5, 3, 5, 5, 5, 5, 5, 5, 4],
                      np.int64)


def hist_layout(no: int, nbases: int, qrows: int) -> list:
    """(name, offset, shape) of each part of the flat output: the
    histograms and maxq first (the part K12 zeroes and adds into), then
    the per-read gc and qsum (which it writes)."""
    parts = [("q1", (qrows, NQUALS)), ("q2", (qrows, NQUALS)),
             ("a1", (nbases, NCOLS)), ("a2", (nbases, NCOLS)),
             ("ar", (nbases, NCOLS)), ("maxq", (1,)), ("gc", (no,)),
             ("qsum", (no,))]
    out, off = [], 0
    for name, shape in parts:
        out.append((name, off, shape))
        off += int(np.prod(shape))
    return out


def hist_words(no: int, nbases: int, qrows: int) -> int:
    """int64 words of the flat output."""
    return 2 * qrows * NQUALS + 3 * nbases * NCOLS + 2 * no + 1


# K12's launch geometry, as csrc/stats_hists.cu fixes it: one block of
# 1,024 threads an SM, at most 104 cycle rows a tile (the int32 cells of
# 104 rows fill a block's shared memory)
RT_MAX = 104


def hists_plan(no: int, max_len: int, sms: int) -> tuple[int, int, int,
                                                         int]:
    """K12's plan for ``no`` reads of at most ``max_len`` bases on a card
    of ``sms`` SMs: (tiles, rt, groups, per_block).  Cycle rows are cut
    into ``tiles`` tiles of ``rt`` rows (a multiple of 8, at most
    RT_MAX); reads into ``groups`` runs of ``per_block`` (the last run
    shorter); the grid is tiles x groups, about one block an SM.  All zero
    when there is nothing to count."""
    if no <= 0 or max_len <= 0:
        return 0, 0, 0, 0
    tiles = -(-max_len // RT_MAX)
    rt = -(-max_len // tiles)
    rt += -rt % 8
    groups = min(max(1, sms // tiles), no)
    per_block = -(-no // groups)
    return tiles, rt, -(-no // per_block), per_block


def split_hists(flat, no: int, nbases: int, qrows: int) -> dict:
    """The named parts of a flat output (tensor or array), as views."""
    return {name: flat[off:off + int(np.prod(shape))].reshape(shape)
            for name, off, shape in hist_layout(no, nbases, qrows)}


def _check(seq, qual, seq_off, oidx, order, rev, nbases, qrows):
    nb, no = seq.numel(), oidx.numel()
    kernels.check(seq, "seq", torch.uint8, (nb,))
    kernels.check(qual, "qual", torch.uint8, (nb,))
    kernels.check(seq_off, "seq_off", torch.int64, (None,))
    kernels.check(oidx, "oidx", torch.int64, (no,))
    kernels.check(order, "order", torch.uint8, (no,))
    kernels.check(rev, "rev", torch.uint8, (no,))
    if not 1 <= nbases <= qrows <= nbases + 1:
        raise ValueError(f"nbases {nbases}, qrows {qrows}: expected "
                         "qrows = nbases or nbases + 1")


def stats_hists_plain(seq: torch.Tensor, qual: torch.Tensor,
                      seq_off: torch.Tensor, oidx: torch.Tensor,
                      order: torch.Tensor, rev: torch.Tensor, nbases: int,
                      qrows: int) -> torch.Tensor:
    """K12's plain version: the flat int64 output (``hist_layout``) by
    ``index_put_(accumulate=True)`` over the flattened bases.  seq and
    qual u8[nb]; seq_off int64 (read i's bases are [seq_off[i],
    seq_off[i+1])); oidx int64[no] the selected reads; order u8[no] (0,
    1 first, 2 last fragment); rev u8[no] (1 on the reverse strand)."""
    _check(seq, qual, seq_off, oidx, order, rev, nbases, qrows)
    dev, no = seq.device, oidx.numel()
    flat = torch.zeros(hist_words(no, nbases, qrows), dtype=torch.int64,
                       device=dev)
    h = split_hists(flat, no, nbases, qrows)
    starts = seq_off[oidx]
    lens = seq_off[oidx + 1] - starts
    if no == 0 or int(lens.sum()) == 0:
        return flat
    if int(lens.max()) > nbases:
        raise ValueError(f"a read of {int(lens.max())} bases exceeds "
                         f"nbases {nbases}")
    seg = torch.repeat_interleave(torch.arange(no, device=dev), lens)
    cum = torch.cumsum(lens, 0) - lens
    local = torch.arange(seg.numel(), device=dev) - cum[seg]
    b = seq[starts[seg] + local].long()
    q = qual[starts[seg] + local].long()
    col = torch.from_numpy(ACGTNO_COL).to(dev)[b & 15]
    rv = rev.bool()[seg]
    cyc = torch.where(rv, lens[seg] - 1 - local, local)
    ordb = order[seg]
    one = torch.ones_like(cyc)
    h["gc"].index_add_(0, seg, ((b == 2) | (b == 4)).long())
    for o, qk, ak in ((1, "q1", "a1"), (2, "q2", "a2")):
        m = ordb == o
        h[qk].index_put_((cyc[m], q[m]), one[m], accumulate=True)
        h[ak].index_put_((cyc[m], col[m]), one[m], accumulate=True)
    q12 = (ordb == 1) | (ordb == 2)
    acgt = q12 & (col < 4)
    h["ar"].index_put_((cyc[acgt], torch.where(rv, 3 - col, col)[acgt]),
                       one[acgt], accumulate=True)
    h["qsum"].index_add_(0, seg[q12], q[q12])
    if bool(q12.any()):
        h["maxq"][0] = q[q12].max()
    return flat


def stats_hists(seq: torch.Tensor, qual: torch.Tensor,
                seq_off: torch.Tensor, oidx: torch.Tensor,
                order: torch.Tensor, rev: torch.Tensor, nbases: int,
                qrows: int, max_len: int) -> torch.Tensor:
    """K12: the flat int64 output of ``stats_hists_plain`` (same
    arguments).  ``max_len``: the longest selected read, at most nbases
    (the kernel's grid covers rows below it).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (``csrc/stats_hists.cu``:
    persistent blocks of ``hists_plan``, a warp a read, its bases loaded
    while the read before it is counted, the histograms in shared int32
    cells, flushed once a block), which zeroes the histograms and writes
    every read's gc and qsum itself."""
    _check(seq, qual, seq_off, oidx, order, rev, nbases, qrows)
    if max_len > nbases:
        raise ValueError(f"max_len {max_len} exceeds nbases {nbases}")
    if not kernels.on_card(seq, qual, seq_off, oidx, order, rev):
        return stats_hists_plain(seq, qual, seq_off, oidx, order, rev,
                                 nbases, qrows)
    no = oidx.numel()
    flat = torch.empty(hist_words(no, nbases, qrows), dtype=torch.int64,
                       device=seq.device)
    if no == 0 or max_len <= 0:
        return flat.zero_()
    kernels.launch(
        "stats_hists", "samtpu_stats_hists", seq.data_ptr(), qual.data_ptr(),
        seq_off.data_ptr(), oidx.data_ptr(), order.data_ptr(),
        rev.data_ptr(), no, nbases, qrows, max_len,
        *hists_plan(no, max_len, kernels.sm_count(seq.device)),
        flat.data_ptr(), kernels.stream_of(seq), device=seq.device)
    return flat


def chunk_inputs(seq: np.ndarray, qual: np.ndarray, seq_off: np.ndarray,
                 oidx: np.ndarray, order: np.ndarray, rev: np.ndarray,
                 device: torch.device):
    """K12's arguments for the reads ``oidx`` (ascending) of a batch's
    flat columns, on ``device``: the span of bases from the first to the
    last selected read, offsets rebased to it, in one host->device copy
    (through pinned memory to the card).  Returns (seq, qual, seq_off,
    oidx, order, rev) tensors."""
    no = oidx.size
    r0 = int(oidx[0]) if no else 0
    r1 = int(oidx[-1]) + 1 if no else 0
    lo, hi = int(seq_off[r0]), int(seq_off[r1])
    nb, m = hi - lo, r1 - r0 + 1
    words = m + no
    total = 8 * words + 2 * nb + 2 * no
    if device.type == "cuda":
        pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        buf = pinned.numpy()
    else:
        buf = np.empty(total, np.uint8)
    i64 = buf[:8 * words].view(np.int64)
    np.subtract(seq_off[r0:r1 + 1], lo, out=i64[:m])
    np.subtract(oidx, r0, out=i64[m:])
    u8 = buf[8 * words:]
    u8[:nb] = seq[lo:hi]
    u8[nb:2 * nb] = qual[lo:hi]
    u8[2 * nb:2 * nb + no] = order
    u8[2 * nb + no:] = rev
    t = pinned.to(device, non_blocking=True) if device.type == "cuda" \
        else torch.from_numpy(buf)
    i64t = t[:8 * words].view(torch.int64)
    u8t = t[8 * words:]
    return (u8t[:nb], u8t[nb:2 * nb], i64t[:m], i64t[m:],
            u8t[2 * nb:2 * nb + no], u8t[2 * nb + no:])


def orig_hists(seq: np.ndarray, qual: np.ndarray, seq_off: np.ndarray,
               oidx: np.ndarray, order: np.ndarray, rev: np.ndarray,
               nbases: int, qrows: int, device: torch.device) -> dict:
    """The selected reads' histograms through K12 on ``device`` (the CPU
    takes the plain version), fetched in one copy: a dict of int64 numpy
    arrays named as in ``hist_layout``."""
    args = chunk_inputs(seq, qual, seq_off, oidx, order, rev, device)
    lens = seq_off[oidx + 1] - seq_off[oidx]
    max_len = int(lens.max()) if lens.size else 0
    flat = stats_hists(*args, nbases, qrows, max_len).cpu().numpy()
    return split_hists(flat, oidx.size, nbases, qrows)
