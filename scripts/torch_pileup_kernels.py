"""K14 (``pileup_scatter``, ``pileup_tiled``) alone on one CUDA card, at
``graft_entry.entry()``'s shape and on clean's first 1 Mbp, beside the
form it had before its redesign, without the rest of chip_smoke.py.

    python3 scripts/torch_pileup_kernels.py [--variants] [--out PATH.json]

Shapes: ``entry`` (65,536 random items, a 16,384-row window) and
``clean_1mbp`` (the M bases of the reads that start in the first 1 Mbp of
chip_smoke.py's clean contig, 8 Mbp x 30x x 100 bp, seed 42 on reference
seed 7: about 31.5 M items in read order, a 1 Mi-row window).  On each:
the scatter (counts and qual sums) and the tiled entry (the in-window
items bucketed in tiles of 512), each held against its plain version and
the first form, and timed: ``ms`` (single calls, the wrapper's host time
included), ``b2b_ms`` (back to back) and ``device_ms`` (a CUDA graph of
bare C-entry calls on a preallocated output, no zero fill), beside
``index_put_(accumulate=True)`` on the same cells and the bound from
bytes (``item_bytes``: each item's valid flag, the other fields of the
valid items, the output written once; a tile's padded slots count their
flag only).  ``paths`` gives the scatter's chunks by path (private,
global, empty), from ``scatter_paths``, the kernel's rule in torch ops.

``OLD_CU`` below is a copy of the first form (the window privatised in
shared memory up to ~1,800 rows, else a global atomic an item; a block a
tile walking its items one byte-tested slot at a time), its entry points
renamed.  It is built with nvcc into ``_build/others/`` and timed on the
same tensors in the same process (``first_form``): its ``device_ms``,
and both forms' ``ms``, ``b2b_ms`` through one wrapper copy and the
host time of a bare scatter call (``enqueue_us``), in turn, twice
(``same_wrapper``).  ``--variants``: the scatter's C entry
with other chunks and budgets (``VARIANTS``; they are arguments, no
rebuild), ``device_ms`` and paths only, and ``SOURCE_VARIANTS`` (the
source patched: a deeper ring of stages, more threads, the tiled walk
item by item or without the warp fold), ``device_ms`` only, each output
checked.  The JSON goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kernel_timing as kt  # noqa: E402

# K14 as first built, its entry points renamed
OLD_CU = r"""
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int NT = 256;
constexpr int LANES = 32;
// items a thread takes, at least, before a privatised block's zeroing and
// flush of the whole window pay off
constexpr int ITEMS_PER_THREAD = 16;

__device__ __forceinline__ int jax_lane(int lane) {
  if (lane < 0) lane += LANES;
  return lane < LANES ? lane : -1;  // still negative: -1 as well
}

// the item's cell in a [rows, 32] table, or -1
__device__ __forceinline__ int64_t scatter_cell(
    int64_t i, const int32_t* __restrict__ refpos,
    const int32_t* __restrict__ lane, const uint8_t* __restrict__ valid,
    int window) {
  if (!__ldg(valid + i)) return -1;
  const int r = __ldg(refpos + i);
  if (r < 0 || r >= window) return -1;
  const int l = jax_lane(__ldg(lane + i));
  if (l < 0) return -1;
  return (int64_t)r * LANES + l;
}

__global__ void __launch_bounds__(NT) scatter_shared(
    const int32_t* __restrict__ refpos, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ weight, const uint8_t* __restrict__ valid,
    int64_t n, int window, int32_t* __restrict__ out) {
  extern __shared__ int32_t acc[];
  const int cells = window * LANES;
  for (int c = threadIdx.x; c < cells; c += NT) acc[c] = 0;
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += step) {
    const int64_t c = scatter_cell(i, refpos, lane, valid, window);
    if (c < 0) continue;
    const int w = weight ? __ldg(weight + i) : 1;
    if (w) atomicAdd(acc + c, w);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += NT) {
    const int v = acc[c];
    if (v) atomicAdd(out + c, v);
  }
}

__global__ void __launch_bounds__(NT) scatter_global(
    const int32_t* __restrict__ refpos, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ weight, const uint8_t* __restrict__ valid,
    int64_t n, int window, int32_t* __restrict__ out) {
  const int64_t step = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += step) {
    const int64_t c = scatter_cell(i, refpos, lane, valid, window);
    if (c < 0) continue;
    const int w = weight ? __ldg(weight + i) : 1;
    if (w) atomicAdd(out + c, w);
  }
}

// the item's cell within its tile's [tile, 32] rows, or -1
__device__ __forceinline__ int tiled_cell(int64_t i,
                                          const int32_t* __restrict__ posrel,
                                          const int32_t* __restrict__ lane,
                                          const uint8_t* __restrict__ valid,
                                          int tile) {
  if (!__ldg(valid + i)) return -1;
  const int p = __ldg(posrel + i);
  if (p < 0 || p >= tile) return -1;
  const int l = __ldg(lane + i);
  if (l < 0 || l >= LANES) return -1;
  return p * LANES + l;
}

__global__ void __launch_bounds__(NT) tiled_shared(
    const int32_t* __restrict__ posrel, const int32_t* __restrict__ lane,
    const uint8_t* __restrict__ valid, int B, int tile,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t acc[];
  const int cells = tile * LANES;
  for (int c = threadIdx.x; c < cells; c += NT) acc[c] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * B;
  for (int j = threadIdx.x; j < B; j += NT) {
    const int c = tiled_cell(base + j, posrel, lane, valid, tile);
    if (c >= 0) atomicAdd(acc + c, 1);
  }
  __syncthreads();
  int32_t* o = out + (int64_t)blockIdx.x * cells;
  for (int c = threadIdx.x; c < cells; c += NT) o[c] = acc[c];
}

__global__ void __launch_bounds__(NT) tiled_global(
    const int32_t* __restrict__ posrel, const int32_t* __restrict__ lane,
    const uint8_t* __restrict__ valid, int64_t n, int B, int tile,
    int32_t* __restrict__ out) {
  const int64_t step = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += step) {
    const int c = tiled_cell(i, posrel, lane, valid, tile);
    if (c >= 0) atomicAdd(out + (i / B) * tile * LANES + c, 1);
  }
}

// the current card's opt-in shared memory a block and its SM count
// (kernels.launch makes the tensors' card the current one)
cudaError_t device_limits(int* smem, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

}  // namespace

// refpos/lane int32[n], weight int32[n] or null (each item weighs 1),
// valid uint8[n] (bool); out int32[window, 32], zeroed by the caller and
// added into.  Returns cudaGetLastError().
extern "C" int samtpu_pileup_scatter_first(const void* refpos, const void* lane,
                                     const void* weight, const void* valid,
                                     int64_t n, int window, void* out,
                                     void* stream) {
  if (n <= 0 || window <= 0) return 0;
  int smem = 0, sms = 0;
  cudaError_t e = device_limits(&smem, &sms);
  if (e != cudaSuccess) return (int)e;
  const int64_t bytes = (int64_t)window * LANES * 4;
  const int64_t by_items = (n + NT - 1) / NT;
  if (bytes <= smem) {
    static std::atomic<bool> ready[kMaxDevices];
    e = allow_smem(scatter_shared, ready);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = min64(
        (n + (int64_t)NT * ITEMS_PER_THREAD - 1) / (NT * ITEMS_PER_THREAD),
        sms);
    scatter_shared<<<(unsigned)blocks, NT, (size_t)bytes,
                     (cudaStream_t)stream>>>(
        (const int32_t*)refpos, (const int32_t*)lane, (const int32_t*)weight,
        (const uint8_t*)valid, n, window, (int32_t*)out);
  } else {
    scatter_global<<<(unsigned)min64(by_items, 8LL * sms), NT, 0,
                     (cudaStream_t)stream>>>(
        (const int32_t*)refpos, (const int32_t*)lane, (const int32_t*)weight,
        (const uint8_t*)valid, n, window, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// posrel/lane int32[n_tiles, B], valid uint8[n_tiles, B] (bool); out
// int32[n_tiles * tile, 32], zeroed by the caller.  Returns
// cudaGetLastError().
extern "C" int samtpu_pileup_tiled_first(const void* posrel, const void* lane,
                                   const void* valid, int n_tiles, int B,
                                   int tile, void* out, void* stream) {
  if (n_tiles <= 0 || B <= 0 || tile <= 0) return 0;
  int smem = 0, sms = 0;
  cudaError_t e = device_limits(&smem, &sms);
  if (e != cudaSuccess) return (int)e;
  const int64_t bytes = (int64_t)tile * LANES * 4;
  if (bytes <= smem) {
    static std::atomic<bool> ready[kMaxDevices];
    e = allow_smem(tiled_shared, ready);
    if (e != cudaSuccess) return (int)e;
    tiled_shared<<<n_tiles, NT, (size_t)bytes, (cudaStream_t)stream>>>(
        (const int32_t*)posrel, (const int32_t*)lane, (const uint8_t*)valid,
        B, tile, (int32_t*)out);
  } else {
    const int64_t n = (int64_t)n_tiles * B;
    tiled_global<<<(unsigned)min64((n + NT - 1) / NT, 8LL * sms), NT, 0,
                   (cudaStream_t)stream>>>(
        (const int32_t*)posrel, (const int32_t*)lane, (const uint8_t*)valid,
        n, B, tile, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
"""
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
OLD_SIGNATURES = {
    "samtpu_pileup_scatter_first": [_P, _P, _P, _P, _L, _I, _P, _P],
    "samtpu_pileup_tiled_first": [_P, _P, _P, _I, _I, _I, _P, _P],
}
# the scatter's (chunk, budget rows) beside the wrapper's (a chunk of
# 0: the wrapper's for the shape)
VARIANTS = {"chunk_128": (128, 384), "chunk_1024": (1024, 384),
            "chunk_1536": (1536, 384), "budget_0": (0, 0),
            "budget_192": (0, 192), "budget_256": (0, 256),
            "budget_768": (0, 768), "chunk_1024_budget_192": (1024, 192),
            "chunk_1536_budget_192": (1536, 192),
            "chunk_1536_budget_256": (1536, 256)}
# csrc/pileup_counts.cu patched: (replacements, budgets the scatter is
# timed at); each text must occur in the source
SOURCE_VARIANTS = {
    "ring_3": ([("constexpr int RING = 2;", "constexpr int RING = 3;")],
               (256, 192)),
    "tiled_256_threads": ([("constexpr int TNT = 512;",
                            "constexpr int TNT = 256;")], ()),
    "tiled_item_by_item": ([(
        "const bool vec = aligned16(posrel) && aligned16(lane) && "
        "aligned16(valid);", "const bool vec = false;")], ()),
    "tiled_no_fold": ([("  runs.fold(sink);\n", "  runs.flush(sink);\n")],
                      ()),
    # a block with one chunk staged like the others, not loaded straight
    # into registers
    "one_chunk_staged": ([("const bool staged = nchunks > G;",
                           "const bool staged = true;")], (256,)),
    # a block with one chunk adds through global atomics without the
    # block's row reduction
    "one_chunk_no_reduce": ([
        ("    // the chunk's lowest and highest row that adds\n",
         "    if (!staged) { lo = 0; hi = a.window - 1; } else {\n"),
        ("      hi = max(hi, s_hi[q]);\n    }\n",
         "      hi = max(hi, s_hi[q]);\n    }\n    }\n")], (256,)),
}
TILE = 512


def old_lib():
    """``OLD_CU`` built and loaded, its entry points typed."""
    import torch_flagstat_narrow_kernels as fnk
    L = fnk._nvcc_lib("old_k14", OLD_CU)
    for name, args in OLD_SIGNATURES.items():
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return L


def variant_lib(name: str):
    """SOURCE_VARIANTS[name] built and loaded, its entries typed as the
    source's."""
    import torch_flagstat_narrow_kernels as fnk
    from samtools_tpu_torch import build, kernels
    with open(os.path.join(build.ROOT, "csrc", "pileup_counts.cu")) as f:
        text = f.read()
    for old, new in SOURCE_VARIANTS[name][0]:
        assert old in text, (name, old)
        text = text.replace(old, new)
    L = fnk._nvcc_lib(f"k14_{name}", text)
    for entry in ("samtpu_pileup_scatter", "samtpu_pileup_tiled"):
        fn = getattr(L, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = kernels._SIGNATURES[entry]
    return L


def scatter_bare(rp, ln, ok, window: int, weight=None, chunk=None,
                 budget=None, fn=None, first=False):
    """A call of the scatter's C entry (``fn``: a variant's; ``first``:
    the first form's, which takes no chunk or budget) on a preallocated
    output: no wrapper, no zero fill, no count.  Chunk and budget default
    to the wrapper's."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_device as pd
    out = torch.zeros(window, 32, dtype=torch.int32, device=rp.device)
    n = rp.numel()
    w = None if weight is None else weight.data_ptr()
    if first:
        def bare():
            return fn(rp.data_ptr(), ln.data_ptr(), w, ok.data_ptr(), n,
                      window, out.data_ptr(), kernels.stream_of(out))
    else:
        lib = fn or kernels._load().samtpu_pileup_scatter
        chunk = chunk or pd.scatter_chunk(n, kernels.sm_count(rp.device))
        budget = pd.SCATTER_BUDGET_ROWS if budget is None else budget

        def bare():
            return lib(rp.data_ptr(), ln.data_ptr(), w, ok.data_ptr(), n,
                       window, chunk, budget, out.data_ptr(),
                       kernels.stream_of(out))
    bare.out = out
    return bare


def tiled_bare(tt, tile: int, fn=None):
    """A call of the tiled entry's C entry (``fn``: the first form's) on
    a preallocated output."""
    import torch
    from samtools_tpu_torch import kernels
    n_tiles, B = tt[0].shape
    out = torch.zeros(n_tiles * tile, 32, dtype=torch.int32,
                      device=tt[0].device)
    fn = fn or kernels._load().samtpu_pileup_tiled

    def bare():
        return fn(tt[0].data_ptr(), tt[1].data_ptr(), tt[2].data_ptr(),
                  n_tiles, B, tile, out.data_ptr(), kernels.stream_of(out))
    bare.out = out
    return bare


def wrapper_copy(fn, head, rows: int, dev, zero: bool = True):
    """A copy of a K14 wrapper around the C entry ``fn``: an int32
    [rows, 32] output (zeroed, or left as allocated where the form writes
    every cell), one call with the arguments ``head`` then the output and
    the stream, the return code checked.  Both forms' calls go through
    this same Python, so that their ``ms`` and ``b2b_ms`` compare."""
    import torch
    from samtools_tpu_torch import kernels
    alloc = torch.zeros if zero else torch.empty

    def call():
        out = alloc(rows, 32, dtype=torch.int32, device=dev)
        rc = fn(*head, out.data_ptr(), kernels.stream_of(out))
        kt.require(rc == 0, "a K14 C entry failed")
        return out
    return call


def old_form(L, rp, ln, ok, q, window: int, tt, tile: int, want) -> dict:
    """The first form on the same tensors, equal to ``want`` (counts, qual
    sums, tiled), beside the redesign: ``device_ms`` of its bare C
    entries; then, for both forms in turn (first form, redesign, twice
    over), ``ms`` and ``b2b_ms`` through the same wrapper copy
    (``wrapper_copy``: the scatter's output zeroed in both, the tiled
    one's only in the first form, as their wrappers do) and the host
    microseconds a bare scatter call takes to return (``enqueue_us``)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_device as pd
    dev, n = rp.device, rp.numel()
    new = kernels._load()
    chunk = pd.scatter_chunk(n, kernels.sm_count(dev))
    n_tiles, B = tt[0].shape

    def head(weight, form):
        h = (rp.data_ptr(), ln.data_ptr(),
             None if weight is None else weight.data_ptr(), ok.data_ptr(),
             n, window)
        return h if form == "first_form" else h + (chunk,
                                                   pd.SCATTER_BUDGET_ROWS)
    fns = {"first_form": (L.samtpu_pileup_scatter_first,
                          L.samtpu_pileup_tiled_first),
           "redesign": (new.samtpu_pileup_scatter, new.samtpu_pileup_tiled)}
    theads = (tt[0].data_ptr(), tt[1].data_ptr(), tt[2].data_ptr(),
              n_tiles, B, tile)
    calls = {form: {
        "scatter": wrapper_copy(f[0], head(None, form), window, dev),
        "qual_sums": wrapper_copy(f[0], head(q, form), window, dev),
        "tiled": wrapper_copy(f[1], theads, n_tiles * tile, dev,
                              zero=form == "first_form")}
        for form, f in fns.items()}
    old = calls["first_form"]
    kt.require(torch.equal(old["scatter"](), want[0])
               and torch.equal(old["qual_sums"](), want[1])
               and torch.equal(old["tiled"](), want[2]),
               "the first form differs from the redesign")
    res = {"device_ms": kt.graph_ms(scatter_bare(
               rp, ln, ok, window, fn=L.samtpu_pileup_scatter_first,
               first=True)),
           "qual_device_ms": kt.graph_ms(scatter_bare(
               rp, ln, ok, window, q, fn=L.samtpu_pileup_scatter_first,
               first=True)),
           "tiled": {"device_ms": kt.graph_ms(tiled_bare(
               tt, tile, L.samtpu_pileup_tiled_first))}}
    same = {form: {k: {"ms": [], "b2b_ms": []} for k in calls[form]}
            | {"enqueue_us": []} for form in calls}
    for _ in range(2):
        for form, c in calls.items():
            for k, call in c.items():
                same[form][k]["ms"].append(kt.cuda_ms(call))
                same[form][k]["b2b_ms"].append(kt.cuda_ms(call, per=10))
            same[form]["enqueue_us"].append(enqueue_us(scatter_bare(
                rp, ln, ok, window, fn=fns[form][0],
                first=form == "first_form")))
    res["same_wrapper"] = same
    return res


def enqueue_us(fn, calls: int = 500) -> float:
    """Host microseconds a call of ``fn`` takes to return (the launch
    enqueued, the card not waited for), over ``calls`` calls (fewer than
    the launches a stream queues before the host waits for the card)."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def item_bytes(n: int, valid: int, per_item: int) -> int:
    """Bytes K14 must read of ``n`` items (or slots), ``valid`` of them
    valid: every item's one-byte valid flag, and the other fields of the
    valid ones (``per_item`` bytes an item with the flag: 9, or 13 with
    a weight).  An invalid item adds nothing, whatever its fields."""
    return valid * per_item + (n - valid)


def scatter_paths(refpos, lane, valid, window: int, chunk: int,
                  budget: int | None = None) -> dict:
    """The chunks of K14's scatter by the path each takes (the kernel's
    rule, csrc/pileup_counts.cu): ``private`` (the adding items' rows
    span at most ``budget`` rows, by default the wrapper's), ``global``
    (more) and ``empty`` (no item adds); torch ops on the items'
    device."""
    import torch
    from samtools_tpu_torch.ops import pileup_device as pd
    budget = pd.SCATTER_BUDGET_ROWS if budget is None else budget
    n = refpos.numel()
    chunks = -(-n // chunk)
    ln = torch.where(lane < 0, lane + 32, lane)
    ok = valid & (refpos >= 0) & (refpos < window) & (ln >= 0) & (ln < 32)
    pad = chunks * chunk - n
    rows = refpos.to(torch.int64)
    lo = torch.nn.functional.pad(torch.where(ok, rows, window), (0, pad),
                                 value=window).view(chunks, chunk).amin(1)
    hi = torch.nn.functional.pad(torch.where(ok, rows, -1), (0, pad),
                                 value=-1).view(chunks, chunk).amax(1)
    adds = hi >= lo
    private = adds & (hi - lo < budget)
    return {"chunk": chunk, "budget": budget, "private": int(private.sum()),
            "global": int((adds & ~private).sum()),
            "empty": int((~adds).sum())}


def variants_of(libs: dict, rp, ln, ok, q, window: int, tt, tile: int,
                want) -> dict:
    """``device_ms`` of the VARIANTS and of the SOURCE_VARIANTS (``libs``)
    on one shape, their outputs checked against ``want`` (counts, qual
    sums, tiled)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_device as pd
    n = rp.numel()
    default = pd.scatter_chunk(n, kernels.sm_count(rp.device))
    got = {}
    for k, (c, b) in VARIANTS.items():
        c = c or default
        got[k] = {"device_ms": kt.graph_ms(scatter_bare(
                      rp, ln, ok, window, chunk=c, budget=b)),
                  "qual_device_ms": kt.graph_ms(scatter_bare(
                      rp, ln, ok, window, q, chunk=c, budget=b)),
                  "paths": scatter_paths(rp, ln, ok, window, c, b)}
    for k, L in libs.items():
        r = {}
        for b in SOURCE_VARIANTS[k][1]:
            for w, key in ((None, "device_ms"), (q, "qual_device_ms")):
                bare = scatter_bare(rp, ln, ok, window, w, budget=b,
                                    fn=L.samtpu_pileup_scatter)
                rc = bare()
                if rc:  # a chunk the variant does not take
                    r[f"budget_{b}_{key}"] = f"error {rc}"
                    continue
                torch.cuda.synchronize()
                kt.require(torch.equal(bare.out, want[0 if w is None
                                                       else 1]),
                           f"{k}: the scatter differs")
                r[f"budget_{b}_{key}"] = kt.graph_ms(bare)
        r["enqueue_us"] = enqueue_us(scatter_bare(
            rp, ln, ok, window, fn=L.samtpu_pileup_scatter))
        tb = tiled_bare(tt, tile, L.samtpu_pileup_tiled)
        kt.require(tb() == 0, f"{k}: the tiled entry failed")
        torch.cuda.synchronize()
        kt.require(torch.equal(tb.out, want[2]), f"{k}: tiled differs")
        r["tiled_device_ms"] = kt.graph_ms(tb)
        got[k] = r
    return got


def measure(L, refpos, lane, valid, qual, window: int, tile: int = TILE,
            libs: dict | None = None) -> dict:
    """K14's entries on one set of items (numpy), on the card: each equal
    to its plain version, ``index_put_`` and the first form (``L``), with
    their times, the bounds and the scatter's chunk paths."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_device as pd
    dev = torch.device("cuda")
    rp, ln, ok, q = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (refpos, lane, valid, qual))
    n = rp.numel()
    counts = pd.pileup_counts(rp, ln, ok, window)
    sums = pd.pileup_qual_sums(rp, ln, q, ok, window)
    kt.require(torch.equal(counts, pd.pileup_scatter_plain(rp, ln, ok,
                                                           window))
               and torch.equal(sums, pd.pileup_scatter_plain(
                   rp, ln, ok, window, q)),
               "K14's scatter differs from its plain version")
    ln_j = torch.where(ln < 0, ln + 32, ln)
    keep = ok & (rp >= 0) & (rp < window) & (ln_j >= 0) & (ln_j < 32)
    cells = (rp[keep].long(), ln_j[keep].long())
    ones = torch.ones(cells[0].numel(), dtype=torch.int32, device=dev)
    lib = torch.zeros_like(counts)
    lib.index_put_(cells, ones, accumulate=True)
    kt.require(torch.equal(lib, counts), "index_put_ differs from K14")
    out_bytes = window * 32 * 4
    chunk = pd.scatter_chunk(n, kernels.sm_count(dev))
    nv = int(ok.sum())
    res = {"items": n, "valid": nv, "window": window,
           "paths": scatter_paths(rp, ln, ok, window, chunk),
           "ms": kt.cuda_ms(lambda: pd.pileup_counts(rp, ln, ok, window)),
           "b2b_ms": kt.cuda_ms(lambda: pd.pileup_counts(rp, ln, ok,
                                                         window), per=10),
           "device_ms": kt.graph_ms(scatter_bare(rp, ln, ok, window)),
           "qual_ms": kt.cuda_ms(lambda: pd.pileup_qual_sums(rp, ln, q, ok,
                                                             window)),
           "qual_device_ms": kt.graph_ms(scatter_bare(rp, ln, ok, window,
                                                      q)),
           "library_ms": kt.cuda_ms(lambda: lib.index_put_(
               cells, ones, accumulate=True)),
           "bound_ms": kt.bound(item_bytes(n, nv, 9) + out_bytes, 0)[0],
           "qual_bound_ms": kt.bound(item_bytes(n, nv, 13) + out_bytes,
                                     0)[0]}
    inwin = (refpos >= 0) & (refpos < window) & valid
    tt = [torch.from_numpy(a).to(dev) for a in pd.bucket_bases(
        refpos[inwin], lane[inwin], window, tile)]
    n_tiles, B = tt[0].shape
    tiled = pd.pileup_counts_tiled(*tt, tile, n_tiles)
    kt.require(torch.equal(tiled, pd.pileup_tiled_plain(*tt, tile,
                                                        n_tiles)),
               "K14's tiled entry differs from its plain version")
    res["tiled"] = {
        "tiles": n_tiles, "B": B, "valid": int(tt[2].sum()),
        "ms": kt.cuda_ms(lambda: pd.pileup_counts_tiled(*tt, tile,
                                                        n_tiles)),
        "b2b_ms": kt.cuda_ms(lambda: pd.pileup_counts_tiled(*tt, tile,
                                                            n_tiles),
                             per=10),
        "device_ms": kt.graph_ms(tiled_bare(tt, tile)),
        "bound_ms": kt.bound(item_bytes(tt[0].numel(), int(tt[2].sum()), 9)
                             + n_tiles * tile * 128, 0)[0]}
    res["first_form"] = old_form(L, rp, ln, ok, q, window, tt, tile,
                                (counts, sums, tiled))
    if libs is not None:
        res["variants"] = variants_of(libs, rp, ln, ok, q, window, tt, tile,
                                      (counts, sums, tiled))
    return res


def clean_1mbp():
    """(refpos, lane, valid, qual, window): the M bases of the reads of
    chip_smoke.py's clean contig that start in its first 1 Mbp."""
    from samtools_tpu_torch.ops import pileup_device as pd
    from samtools_tpu_torch.sim import simulate_batch, simulate_reference
    ref = simulate_reference(8 << 20, seed=7)
    b = simulate_batch(ref_len=8 << 20, coverage=30.0, read_len=100,
                       seed=42, paired=False, err_rate=0.01, ref=ref)
    rp, ln, q, ok = pd.expand_to_device_arrays(
        b, np.nonzero(b.pos < 1 << 20)[0], 0, 1 << 20)
    return rp, ln, ok, q, 1 << 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from samtools_tpu_torch import build, graft_entry
    build.build(("cuda",))
    with open(build.lib_path("cuda")[:-3] + ".log") as f:
        text = f.read()
    ptxas = [ln.strip() for ln in text[text.index("pileup_counts.cu"):]
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln][:9]
    L = old_lib()
    libs = {k: variant_lib(k) for k in SOURCE_VARIANTS} if a.variants \
        else None
    res = {"ptxas": ptxas, "card": torch.cuda.get_device_name(0)}
    _, (rp, ln, ok) = graft_entry.entry()
    qual = np.random.default_rng(41).integers(2, 41, rp.numel()).astype(
        np.int32)
    shapes = {"entry": lambda: (rp.cpu().numpy(), ln.cpu().numpy(),
                                ok.cpu().numpy(), qual, 1 << 14),
              "clean_1mbp": clean_1mbp}
    for name, make in shapes.items():
        res[name] = measure(L, *make(), libs=libs)
        print(json.dumps({"shape": name, **res[name]}), flush=True)
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
