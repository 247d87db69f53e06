// K6's tail, qual_deltas: the quals BAQ changed in one chunk, compacted
// in order into a fixed-capacity list on the card, without a host sync.
//
// Replaces the collect_quals branch of samtools_tpu/ops/mpileup_device.py::
// _chunk_jit (:273-279 of chunk_step: jnp.nonzero of appq != qq at size
// cap = C LQ / 16, fill value 0), which the port ran as a cumsum, a where,
// a scatter and a gather over the flat [C LQ] quals (ops/mpileup_device.py
// ::qual_deltas_plain).  Outputs: dcount int32 (the changed count, which
// may exceed cap), didx int32[cap] (the first min(dcount, cap) changed
// flat indices in ascending order, then 0), dval uint8[cap] (appq at each
// didx: past dcount, appq's first qual).
//
// What bounds it on the H100: bytes, the two quals read once and the list
// written once, 2 C LQ + 5 cap + 4 bytes (0.0045 ms at 65,536 reads of
// 100 bases).  The order of the list is a prefix sum over the whole
// chunk, which blocks running in no order cannot carry from one to the
// next.
//
// Design: two grids behind one entry, each block over the same tile of
// 8,192 flat quals (32 a thread: two 16-byte loads of each input, the
// bytes compared four at a time with __vcmpne4 into a 32-bit mask).  The
// first grid writes each tile's changed count.  The second grid: each
// block sums the counts of the tiles before its own and of all tiles (at
// 6.5 M quals, 800 counts from L2), scans its threads' counts in shared
// memory, and each thread writes its changed quals in ascending order at
// their ranks while a rank is below cap (a tile whose first rank is past
// cap writes nothing); then all blocks fill the slots from min(dcount,
// cap) to cap together (0 and appq's first qual), and block 0 writes
// dcount.  The ranks come from the scan, not from atomics, so the list
// is the same on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int PER = 32;             // quals a thread
constexpr int TILE = TPB * PER;     // quals a block
constexpr unsigned FULL = 0xFFFFFFFFu;

// bit j: byte j of x differs from byte j of y
__device__ __forceinline__ uint32_t ne4(uint32_t x, uint32_t y) {
  const uint32_t d = __vcmpne4(x, y);
  return (d & 1u) | ((d >> 7) & 2u) | ((d >> 14) & 4u) | ((d >> 21) & 8u);
}

// bit j: flat qual e + j changed (e a multiple of 32; none past n)
__device__ __forceinline__ uint32_t changed(const uint8_t* __restrict__ a,
                                            const uint8_t* __restrict__ q,
                                            int64_t e, int64_t n) {
  if (e >= n) return 0;
  if (e + PER <= n) {
    const uint4* av = reinterpret_cast<const uint4*>(a + e);
    const uint4* qv = reinterpret_cast<const uint4*>(q + e);
    const uint4 a0 = __ldg(av), a1 = __ldg(av + 1);
    const uint4 q0 = __ldg(qv), q1 = __ldg(qv + 1);
    return ne4(a0.x, q0.x) | (ne4(a0.y, q0.y) << 4)
        | (ne4(a0.z, q0.z) << 8) | (ne4(a0.w, q0.w) << 12)
        | (ne4(a1.x, q1.x) << 16) | (ne4(a1.y, q1.y) << 20)
        | (ne4(a1.z, q1.z) << 24) | (ne4(a1.w, q1.w) << 28);
  }
  uint32_t m = 0;
  for (int j = 0; e + j < n; ++j) m |= (uint32_t)(a[e + j] != q[e + j]) << j;
  return m;
}

// the block's sum of v (every thread gets it)
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(TPB)
count_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ q,
             int64_t n, int32_t* __restrict__ counts) {
  __shared__ int red[WARPS];
  const int64_t e = (int64_t)blockIdx.x * TILE + threadIdx.x * PER;
  const int s = block_sum(__popc(changed(a, q, e, n)), red);
  if (threadIdx.x == 0) counts[blockIdx.x] = s;
}

__global__ void __launch_bounds__(TPB)
write_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ q,
             int64_t n, const int32_t* __restrict__ counts, int cap,
             int32_t* __restrict__ dcount, int32_t* __restrict__ didx,
             uint8_t* __restrict__ dval) {
  __shared__ int red[WARPS];
  __shared__ int warp_pre[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  int before = 0, all = 0;
  for (int k = t; k < (int)gridDim.x; k += TPB) {
    const int c = counts[k];
    all += c;
    if (k < b) before += c;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);

  if (before < cap) {
    const int64_t e = (int64_t)b * TILE + t * PER;
    uint32_t m = changed(a, q, e, n);
    // this thread's exclusive rank in the block: a warp scan, then the
    // warps' totals
    const int c = __popc(m);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) warp_pre[warp] = inc;
    __syncthreads();
    int pre = inc - c;
    for (int w = 0; w < warp; ++w) pre += warp_pre[w];
    for (int slot = before + pre; m && slot < cap; ++slot) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      didx[slot] = (int32_t)(e + j);
      dval[slot] = a[e + j];
    }
  }
  const uint8_t a0 = a[0];
  for (int64_t s = (int64_t)min(all, cap) + (int64_t)b * TPB + t; s < cap;
       s += (int64_t)gridDim.x * TPB) {
    didx[s] = 0;
    dval[s] = a0;
  }
  if (b == 0 && t == 0) *dcount = all;
}

}  // namespace

// appq and qq uint8[n] (16-byte aligned, 0 < n < 2^31), cap >= 0;
// blocks = ceil(n / 8192) (ops/mpileup_device.py::deltas_plan); counts
// int32[blocks] scratch; outputs dcount int32[1], didx int32[cap], dval
// uint8[cap].  Returns the first CUDA error of the two launches, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int samtpu_qual_deltas(const void* appq, const void* qq,
                                  int64_t n, int cap, int blocks,
                                  void* counts, void* dcount, void* didx,
                                  void* dval, void* stream) {
  if (n <= 0 || n > INT32_MAX || cap < 0
      || (int64_t)blocks != (n + TILE - 1) / TILE
      || (uintptr_t)appq % 16 || (uintptr_t)qq % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<blocks, TPB, 0, s>>>((const uint8_t*)appq,
                                      (const uint8_t*)qq, n,
                                      (int32_t*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  write_kernel<<<blocks, TPB, 0, s>>>(
      (const uint8_t*)appq, (const uint8_t*)qq, n, (const int32_t*)counts,
      cap, (int32_t*)dcount, (int32_t*)didx, (uint8_t*)dval);
  return (int)cudaGetLastError();
}
