// K1 segment_contract and its census form segment_census, on Hopper.
//
// Replaces samtools_tpu/ops/pileup_pallas.py::_build.kernel (the Pallas
// TPU kernel, pl.pallas_call at :134), reached from segment_matmul_pallas
// (:228), census_pallas (:252) and the fused chunk step
// (ops/mpileup_device.py:226-251).  Both forms compute, for each genomic
// tile t of a tile plan,
//
//   out[t*tile + p, k] += sum_{b in [lo_t, hi_t)} 1[rp_b == wbeg + t*tile + p] * W[b, k]
//
// with exact int32 sums.  The generic form reads rp int32[n] and
// W int8[n, K].  The census form also replaces the weight build of the
// chunk step (mpileup_device.py:214-225) and pack_census (K2,
// pileup_pallas.py:178-186): it reads each base's reference position, M-op
// ordinal, 0-4 base code and applied quality, gates the base (M base,
// quality >= min_baseq, read not risky, window-relative position in
// [gate_lo, gate_hi)) and adds 1 to the base's lane and its quality to
// lane 5, so rp and W never exist in device memory.
//
// What bounds it on the H100: bytes.  Each item is read once (4 + K bytes,
// or 10 for the census) and does at most K integer adds (2 for the census).
//
// Design.  The item array is cut into pieces of P consecutive items (a few
// thousand: a piece's staged inputs take about 20 KB of shared memory), one
// thread block per piece:
//
// 1. The block copies its piece's contiguous span of every input into
//    shared memory with 16-byte cp.async copies, all of them in flight at
//    once (byte copies for an unaligned head and tail).
// 2. Each item finds its tile t from its position and is live if its
//    position lies in the plan and lo_t <= b < hi_t (and, for the census,
//    the base passes the gate).  That is the plan's own rule (item b counts
//    in tile t exactly when it is in t's slice and its position in t), so
//    the result equals the tile-major contraction; but each item is read
//    once, where a tile-major walk reads every item whose read straddles a
//    tile edge twice, and a deep pile (one tile's slice of 30,000+ items)
//    spreads over many blocks instead of serialising one.  The block
//    reduces the least and the greatest output row of its live items.
// 3. Items add into an int32 shared-memory accumulator of `win` rows from
//    the least row on, with shared-memory atomics (exact integers, so the
//    order does not matter), skipping zero weights; an item past the
//    accumulator's rows (a read with a long skip) adds straight into `out`
//    with global atomics.
// 4. The block adds its accumulator's rows into `out` with global integer
//    atomics, skipping zeros: neighbouring pieces share rows.
//
// The generic kernel is instantiated for each K in [1, 32], so an item's K
// weights are read and added in an unrolled loop.  No fixed item window or
// pass count exists, so the TPU path's pass-count undercount cannot occur.
// P and win come from the caller (ops/segment_kernel.py::piece_layout).

#include <cuda_runtime.h>

#include <array>
#include <atomic>
#include <climits>
#include <cstdint>
#include <utility>

#include "staging.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int CENSUS_K = 6;
constexpr int MAX_K = 32;  // the generic kernel is instantiated for K <= 32

__host__ __device__ constexpr int64_t align16(int64_t n) {
  return (n + 15) & ~(int64_t)15;
}

// one staged span of P items of `bytes` each, with room for its offset
__host__ __device__ constexpr int64_t span_buf(int P, int bytes) {
  return align16((int64_t)P * bytes + 16);
}

// the least (lo) and greatest (hi) value over the block
__device__ void block_min_max(int& lo, int& hi) {
  __shared__ int red[2][NT / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = lo;
    red[1][w] = hi;
  }
  __syncthreads();
  for (int k = 0; k < NT / 32; ++k) {
    lo = min(lo, red[0][k]);
    hi = max(hi, red[1][k]);
  }
}

// Output row of item b at position rp, or -1: the row must lie in the
// plan's n_tiles * tile rows and b in its tile's slice.
__device__ __forceinline__ int plan_row(int64_t rp, int32_t wbeg, int b,
                                        const int32_t* __restrict__ lo,
                                        const int32_t* __restrict__ hi,
                                        int n_tiles, int tile) {
  const int64_t r = rp - wbeg;
  if (r < 0 || r >= (int64_t)n_tiles * tile) return -1;
  const unsigned t = (unsigned)r / (unsigned)tile;
  return (b >= __ldg(lo + t) && b < __ldg(hi + t)) ? (int)r : -1;
}

// Steps 3 and 4 for the np items of a piece whose rows (or -1) are in
// row[]: `items.add(i, p)` adds item i's weights into the K lanes at p.
template <class Items>
__device__ void accumulate(const Items& items, const int32_t* row, int np,
                           int rmin, int rmax, int K, int win, int32_t* acc,
                           int32_t* __restrict__ out) {
  const int span = min(win, rmax - rmin + 1);
  for (int i = threadIdx.x; i < span * K; i += NT) acc[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += NT) {
    const int r = row[i];
    if (r < 0) continue;
    if (r - rmin < span)
      items.add(i, acc + (r - rmin) * K);
    else
      items.add(i, out + (int64_t)r * K);
  }
  __syncthreads();
  int32_t* o = out + (int64_t)rmin * K;
  for (int i = threadIdx.x; i < span * K; i += NT) {
    const int v = acc[i];
    if (v) atomicAdd(o + i, v);
  }
}

template <int K>
struct GenericItems {
  const int8_t* w;  // staged [np, K]
  __device__ void add(int i, int32_t* p) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = w[i * K + k];
      if (v) atomicAdd(p + k, v);
    }
  }
};

struct CensusItems {
  const uint8_t* sq;  // staged 0-4 base codes
  const uint8_t* aq;  // staged applied qualities
  __device__ void add(int i, int32_t* p) const {
    const int lane = sq[i];
    if (lane < 5) atomicAdd(p + lane, 1);
    const int q = (int8_t)aq[i];  // the weight is int8, as W's lane 5
    if (q) atomicAdd(p + 5, q);
  }
};

template <int K>
__global__ void __launch_bounds__(NT) segment_contract_kernel(
    const int32_t* __restrict__ rp, const int8_t* __restrict__ w,
    int n, const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int n_tiles, int32_t wbeg, int tile, int P, int win,
    int32_t* __restrict__ out) {
  extern __shared__ uint4 sh4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(sh4);
  int32_t* acc = reinterpret_cast<int32_t*>(sm);
  uint8_t* srp = sm + align16((int64_t)win * K * 4);
  uint8_t* sw = srp + span_buf(P, 4);
  const int b0 = blockIdx.x * P;
  const int np = min(P, n - b0);
  const int mr = copy_span_async(
      srp, reinterpret_cast<const uint8_t*>(rp + b0), np * 4, NT);
  const int mw = copy_span_async(
      sw, reinterpret_cast<const uint8_t*>(w) + (int64_t)b0 * K, np * K, NT);
  cp_async_wait_all();
  __syncthreads();
  int32_t* row = reinterpret_cast<int32_t*>(srp + mr);  // rp, then rows
  const GenericItems<K> items{reinterpret_cast<const int8_t*>(sw + mw)};
  int rmin = INT_MAX, rmax = -1;
  for (int i = threadIdx.x; i < np; i += NT) {
    const int r = plan_row(row[i], wbeg, b0 + i, lo, hi, n_tiles, tile);
    row[i] = r;
    if (r >= 0) {
      rmin = min(rmin, r);
      rmax = max(rmax, r);
    }
  }
  block_min_max(rmin, rmax);
  if (rmax < 0) return;
  accumulate(items, row, np, rmin, rmax, K, win, acc, out);
}

__global__ void __launch_bounds__(NT) segment_census_kernel(
    const int32_t* __restrict__ refpos, const int32_t* __restrict__ seg,
    const uint8_t* __restrict__ sq, const uint8_t* __restrict__ appq,
    const uint8_t* __restrict__ risky, int n, int lq, int32_t base,
    int32_t gate_lo, int32_t gate_hi, int min_baseq,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int n_tiles, int32_t wbeg, int tile, int P, int win,
    int32_t* __restrict__ out) {
  extern __shared__ uint4 sh4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(sh4);
  int32_t* acc = reinterpret_cast<int32_t*>(sm);
  uint8_t* srp = sm + align16((int64_t)win * CENSUS_K * 4);
  uint8_t* sseg = srp + span_buf(P, 4);
  uint8_t* ssq = sseg + span_buf(P, 4);
  uint8_t* saq = ssq + span_buf(P, 1);
  const int b0 = blockIdx.x * P;
  const int np = min(P, n - b0);
  const int mr = copy_span_async(
      srp, reinterpret_cast<const uint8_t*>(refpos + b0), np * 4, NT);
  const int ms = copy_span_async(
      sseg, reinterpret_cast<const uint8_t*>(seg + b0), np * 4, NT);
  const int mq = copy_span_async(ssq, sq + b0, np, NT);
  const int ma = copy_span_async(saq, appq + b0, np, NT);
  cp_async_wait_all();
  __syncthreads();
  int32_t* row = reinterpret_cast<int32_t*>(srp + mr);  // refpos, then rows
  const int32_t* sg = reinterpret_cast<const int32_t*>(sseg + ms);
  const CensusItems items{ssq + mq, saq + ma};
  int rmin = INT_MAX, rmax = -1;
  for (int i = threadIdx.x; i < np; i += NT) {
    const int b = b0 + i;
    const int64_t p = (int64_t)row[i] - base;
    int r = -1;
    if (sg[i] >= 0 && items.aq[i] >= min_baseq && p >= gate_lo &&
        p < gate_hi && !__ldg(risky + (unsigned)b / (unsigned)lq))
      r = plan_row(p, wbeg, b, lo, hi, n_tiles, tile);
    row[i] = r;
    if (r >= 0) {
      rmin = min(rmin, r);
      rmax = max(rmax, r);
    }
  }
  block_min_max(rmin, rmax);
  if (rmax < 0) return;
  accumulate(items, row, np, rmin, rmax, CENSUS_K, win, acc, out);
}

using ContractKernel = void (*)(const int32_t*, const int8_t*, int,
                                const int32_t*, const int32_t*, int, int32_t,
                                int, int, int, int32_t*);

template <int... Ks>
std::array<ContractKernel, sizeof...(Ks)> contract_kernels(
    std::integer_sequence<int, Ks...>) {
  return {segment_contract_kernel<Ks + 1>...};
}

}  // namespace

extern "C" const char* samtpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// rp int32[n], w int8[n, K] row-major (1 <= K <= 32), lo/hi int32[n_tiles],
// out int32[n_tiles * tile, K] (added into); P items per block and win
// accumulator rows.  Returns cudaGetLastError().
extern "C" int samtpu_segment_contract(const void* rp, const void* w, int K,
                                       int n, const void* lo, const void* hi,
                                       int n_tiles, int wbeg, int tile, int P,
                                       int win, void* out, void* stream) {
  if (n <= 0 || n_tiles <= 0) return 0;
  if (K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  static const auto kernels =
      contract_kernels(std::make_integer_sequence<int, MAX_K>());
  static std::atomic<bool> ready[MAX_K][kMaxDevices];
  const cudaError_t e = allow_smem(kernels[K - 1], ready[K - 1]);
  if (e != cudaSuccess) return (int)e;
  const int64_t smem =
      align16((int64_t)win * K * 4) + span_buf(P, 4) + span_buf(P, K);
  kernels[K - 1]<<<(n + P - 1) / P, NT, (size_t)smem,
                   (cudaStream_t)stream>>>(
      (const int32_t*)rp, (const int8_t*)w, n, (const int32_t*)lo,
      (const int32_t*)hi, n_tiles, wbeg, tile, P, win, (int32_t*)out);
  return (int)cudaGetLastError();
}

// refpos/seg int32[n], sq/appq uint8[n] (n = reads * lq, read-major),
// risky uint8[reads]; lo/hi int32[n_tiles]; out int32[n_tiles * tile, 6]
// (added into).  Returns cudaGetLastError().
extern "C" int samtpu_segment_census(const void* refpos, const void* seg,
                                     const void* sq, const void* appq,
                                     const void* risky, int n, int lq,
                                     int base, int gate_lo, int gate_hi,
                                     int min_baseq, const void* lo,
                                     const void* hi, int n_tiles, int wbeg,
                                     int tile, int P, int win, void* out,
                                     void* stream) {
  if (n <= 0 || n_tiles <= 0) return 0;
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t e = allow_smem(segment_census_kernel, ready);
  if (e != cudaSuccess) return (int)e;
  const int64_t smem = align16((int64_t)win * CENSUS_K * 4) +
                       2 * span_buf(P, 4) + 2 * span_buf(P, 1);
  segment_census_kernel<<<(n + P - 1) / P, NT, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const int32_t*)refpos, (const int32_t*)seg, (const uint8_t*)sq,
      (const uint8_t*)appq, (const uint8_t*)risky, n, lq, base, gate_lo,
      gate_hi, min_baseq, (const int32_t*)lo, (const int32_t*)hi, n_tiles,
      wbeg, tile, P, win, (int32_t*)out);
  return (int)cudaGetLastError();
}
