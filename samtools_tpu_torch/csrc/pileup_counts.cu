// K14 pileup_counts: the dense [window, 32] pileup scatter, on Hopper.
//
// Replaces samtools_tpu/ops/pileup_device.py's XLA functions
// pileup_counts (:29), pileup_qual_sums (:44) and pileup_counts_tiled
// (:55), which make_sharded_pileup (:131) runs on every mesh shard.  Each
// item is one aligned base: a window-relative position and a lane
// (nt16 code | reverse << 4).  Two entries:
//
// * pileup_scatter: out[refpos_i, lane_i] += w_i (w = 1, or the base's
//   quality) for every valid item whose position lies in [0, window).  A
//   lane is taken as JAX takes the index of a scatter: a negative lane
//   has 32 added once, and a lane still outside [0, 32) adds nothing.
// * pileup_tiled: items bucketed by tile ([n_tiles, B] blocks, posrel
//   within the tile); out[t * tile + posrel, lane] += 1 for every valid
//   item with posrel in [0, tile) and lane in [0, 32) (the one-hot x
//   one-hot product of the JAX form, which drops a negative lane).
//
// Integer sums are exact in any order, so both equal the JAX f32 sums
// (exact below 2^24 a cell) and the plain PyTorch versions bit for bit.
//
// What bounds it on the H100: bytes (13 or 9 bytes an item read, the
// window's int32 cells written once).  Each design keeps the adds off
// global memory where the rows fit in shared memory:
//
// * scatter: when window * 32 * 4 bytes fit the block's opt-in shared
//   memory (about 1,800 rows), a few blocks each keep a private copy of
//   the window, add their items with shared-memory atomics and flush the
//   nonzero cells with global atomics; a larger window adds each item
//   with a global int32 atomic.
// * tiled: one block a tile, a shared [tile, 32] accumulator (64 KB at
//   the JAX default tile of 512), the tile's B items walked by the block,
//   then the tile's rows written once (no atomics: the block owns them);
//   a tile too large for shared memory adds with global atomics.
// `out` is zeroed by the caller.

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
extern "C" int samtpu_pileup_scatter(const void* refpos, const void* lane,
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
extern "C" int samtpu_pileup_tiled(const void* posrel, const void* lane,
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
