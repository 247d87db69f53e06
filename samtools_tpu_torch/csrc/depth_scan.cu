// K9's depth step, depth_scan: the depth column of one window from K1's
// difference and direct rows, the first L values delivered to the host.
//
// Replaces samtools_tpu/ops/pileup_engine.py::_depth_cumsum_jit (:254,
// d = int32(cumsum(diff[:, 0]) + direct[:, 0]) over all the plan's rows,
// and their max) and _fetch_narrow (:270, the first L values fetched
// narrowed to the width that max needs: uint8 below 256, int16 below
// 2^15), which the port ran as torch ops (ops/pileup_engine.py::
// depth_scan_plain: an int64 cumsum, a cast, a sync for the max, a
// narrowing cast, a copy to pageable memory and a widening on the host).
// Sums wrap as int32 does, and a value the narrowing cannot hold wraps as
// the cast does (a negative depth under a max below 2^15): the result
// equals the plain version's on every input.
//
// What bounds it on the H100: the host link.  The columns are read once
// from HBM (4 B a row a column: 0.010 ms on clean's 8 Mi-row window, one
// column); the L values cross the link once.  They go as int32, not
// narrowed: narrow bytes would have to be widened on the host, which costs
// more than the link bytes saved (PERF.md, K9: the transports measured on
// the card).  A prefix sum crosses every block, which run in no order.
//
// Design: reduce-then-scan, then a fix-up, three grids behind one entry.
// Grids 1 and 2 take the same tile of 8,192 rows a block (32 a thread,
// read as 16-byte vectors).  Grid 1 writes each tile's sum of diff.  Grid
// 2: each block sums the sums of the tiles before its own (1,024 from L2
// at 8 Mi rows), scans its threads' totals (a warp shuffle scan, then the
// warps' totals), each thread runs through its 32 rows adding direct, and
// the tile's values go through shared memory (rows padded to 33 words, no
// bank conflicts) to `out` as 16-byte stores.  `out` may lie in the
// caller's pinned host memory: then the stores cross the link while the
// scan runs, and the host reads them after one sync.  Grid 2 also keeps
// the max over every row (not only [0, L)) and the min over rows [0, L),
// each in one word by a warp reduction and an atomicMax a block, on the
// values biased by 2^31 so that unsigned order is signed order (the min
// as the max of the complements; both words start at 0).  Grid 3 reads
// the two words: only where the width the max picks cannot hold the min
// (a negative depth under a max below 256, or below -2^15 under a max
// below 2^15, which K1's columns never give) does it rewrite rows [0, L)
// of `out` wrapped to that width; else each block returns at once.  A
// null diff or direct is a column of zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int PER = 32;          // rows a thread
constexpr int TILE = TPB * PER;  // rows a block
constexpr int ROW = PER + 1;     // a thread's rows in shared memory, padded
constexpr int FIXUP_BLOCKS = 264; // grid 3: two blocks an SM of the H100
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t BIAS = 0x80000000u;

// rows [e, e + PER) of col (zeros past `rows`, or for a null col)
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ col,
                                          int64_t e, int64_t rows,
                                          uint32_t v[PER]) {
  if (col != nullptr && e + PER <= rows) {
    const uint4* p = reinterpret_cast<const uint4*>(col + e);
#pragma unroll
    for (int k = 0; k < PER / 4; ++k) {
      const uint4 x = __ldg(p + k);
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      v[j] = (col != nullptr && e + j < rows) ? (uint32_t)col[e + j] : 0u;
  }
}

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(TPB)
tile_sum_kernel(const int32_t* __restrict__ diff, int64_t rows,
                uint32_t* __restrict__ tsum) {
  __shared__ uint32_t red[WARPS];
  uint32_t v[PER];
  load_rows(diff, (int64_t)blockIdx.x * TILE + threadIdx.x * PER, rows, v);
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) s += v[j];
  s = block_sum(s, red);
  if (threadIdx.x == 0) tsum[blockIdx.x] = s;
}

__global__ void __launch_bounds__(TPB)
scan_kernel(const int32_t* __restrict__ diff,
            const int32_t* __restrict__ direct, int64_t rows, int64_t L,
            const uint32_t* __restrict__ tsum, int32_t* __restrict__ out,
            uint32_t* __restrict__ ext) {
  __shared__ uint32_t red[WARPS];
  __shared__ uint32_t warp_tot[WARPS];
  __shared__ int32_t tile[TPB * ROW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int64_t row0 = (int64_t)b * TILE;
  const int64_t e = row0 + (int64_t)t * PER;
  uint32_t v[PER], w[PER];
  load_rows(diff, e, rows, v);
  load_rows(direct, e, rows, w);
  uint32_t before = 0;
  if (diff != nullptr) {
    for (int k = t; k < b; k += TPB) before += tsum[k];
    before = block_sum(before, red);
  }
  // this thread's exclusive prefix in the tile
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) c += v[j];
  uint32_t inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  uint32_t run = before + inc - c;
  for (int k = 0; k < warp; ++k) run += warp_tot[k];
  // biased max of this thread's rows below `rows`, and complement of the
  // biased min of those below L
  uint32_t top = 0, low = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    run += v[j];
    const uint32_t d = run + w[j];
    tile[t * ROW + j] = (int32_t)d;
    if (e + j < rows) top = max(top, d ^ BIAS);
    if (e + j < L) low = max(low, ~(d ^ BIAS));
  }
  top = __reduce_max_sync(FULL, top);
  low = __reduce_max_sync(FULL, low);
  if (lane == 0 && top) atomicMax(ext, top);
  if (lane == 0 && low) atomicMax(ext + 1, low);
  __syncthreads();
  // rows [row0, row0 + TILE) of [0, L), 16-byte stores where whole
  const int64_t n = min((int64_t)TILE, L - row0);
  for (int g = t; 4 * g < n; g += TPB) {
    const int i = 4 * g;
    const int32_t* s = tile + (i / PER) * ROW + (i % PER);
    if (i + 4 <= n) {
      *reinterpret_cast<int4*>(out + row0 + i) = make_int4(s[0], s[1], s[2],
                                                           s[3]);
    } else {
      for (int k = 0; i + k < n; ++k) out[row0 + i + k] = s[k];
    }
  }
}

// v as the narrowing to the width of max m leaves it, widened back
__device__ __forceinline__ int32_t narrowed(int32_t v, int32_t m) {
  if (m < 256) return v & 0xFF;
  if (m < (1 << 15)) return (int32_t)(int16_t)v;
  return v;
}

__global__ void __launch_bounds__(TPB)
fixup_kernel(int32_t* __restrict__ out, int64_t L,
             const uint32_t* __restrict__ ext) {
  const int32_t m = (int32_t)(ext[0] ^ BIAS);
  const int32_t lo = (int32_t)(~ext[1] ^ BIAS);
  if (!((m < 256 && lo < 0) || (m < (1 << 15) && lo < -(1 << 15)))) return;
  for (int64_t i = (int64_t)blockIdx.x * TPB + threadIdx.x; i < L;
       i += (int64_t)gridDim.x * TPB)
    out[i] = narrowed(out[i], m);
}

}  // namespace

// diff and direct int32[rows] (a K1 column; either may be null, each
// 16-byte aligned), 0 < L <= rows < 2^31; tiles = ceil(rows / 8192)
// (ops/pileup_engine.py::depth_plan); scratch int32[tiles + 2] of card
// memory; out int32[L] (16-byte aligned; card or pinned host memory).
// Returns the first CUDA error of the launches, or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int samtpu_depth_scan(const void* diff, const void* direct,
                                 int64_t rows, int64_t L, int tiles,
                                 void* scratch, void* out, void* stream) {
  if (rows <= 0 || rows > INT32_MAX || L <= 0 || L > rows
      || (int64_t)tiles != (rows + TILE - 1) / TILE
      || (uintptr_t)diff % 16 || (uintptr_t)direct % 16
      || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  uint32_t* tsum = (uint32_t*)scratch;
  uint32_t* ext = tsum + tiles;  // the biased max, the min's complement
  cudaError_t e = cudaMemsetAsync(ext, 0, 2 * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (diff != nullptr) {
    tile_sum_kernel<<<tiles, TPB, 0, s>>>((const int32_t*)diff, rows, tsum);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<<<tiles, TPB, 0, s>>>((const int32_t*)diff,
                                    (const int32_t*)direct, rows, L, tsum,
                                    (int32_t*)out, ext);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fixup_kernel<<<FIXUP_BLOCKS, TPB, 0, s>>>((int32_t*)out, L, ext);
  return (int)cudaGetLastError();
}
