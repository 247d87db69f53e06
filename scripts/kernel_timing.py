"""Timing and bound helpers shared by chip_smoke.py and the kernel scripts
in this directory: CUDA-event times of single and back-to-back calls,
device time through a CUDA graph, and a kernel's least time on the card
from the bytes it moves and the operations it does."""

from __future__ import annotations

import statistics

# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# its host link, PCIe Gen5 x16: 128 GB/s both ways together, 64 each way
LINK_BYTES_PER_S = 64e9
F32_OPS_PER_S = 67e12


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 5, per: int = 1) -> float:
    """CUDA-event time of one call of ``fn``: the median over ``reps``
    groups, each a pair of events around ``per`` calls made back to back,
    after one warm-up call.  per = 1 times single calls, the wrapper's
    host time included; with per > 1 the host's time overlaps the card's
    work, as on the main path."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``, without the host's: ``calls``
    calls captured in one CUDA graph, replayed between CUDA events; the
    median of ``reps`` replays, over ``calls``.  ``fn`` calls a kernel's
    bare C entry point on preallocated outputs (no wrapper, no count)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
