// K9's coverage step, cov_reduce: the min-depth gate and the per-subwindow
// int64 sums of one window's coverage census, in one launch.
//
// Replaces samtools_tpu/ops/pileup_engine.py::_cov_reduce_jit (:443),
// which coverage_window_device (:501) runs once a window, and which the
// port ran as torch ops (ops/pileup_engine.py::cov_reduce_plain: int64
// columns, a [rows, 3] int64 stack, a pad and a sum).  Input: the census
// int32[rows, 4] (okq count c0, qual & 127 c1, entry count c2, qual >> 7
// c3).  Output: int64[ceil(rows / sub), 3], per subwindow of `sub` rows
// the sums of (c0, c1 + 128 c3, 1) over the rows that pass the gate c2 >
// 0, c0 > 0, c0 >= min_depth (coverage.c's covered, meandepth and
// meanbaseq accumulators).  In int64: a deep window's quality sum passes
// 2^31, where the JAX function's int32 sum wraps.
//
// What bounds it on the H100: bytes, 16 a row read once (16.8 MB, 0.0050
// ms, at the 1 Mi-row window of streamed coverage) and 24 a subwindow
// written.  A window has few subwindows (16 at 1 Mi rows), too few to
// fill the card a block each.
//
// Design: a fixed group of G blocks a subwindow (ops/pileup_engine.py::
// cov_plan: about 4 blocks an SM in all), each over `chunk` consecutive
// rows of it; a thread reads a row as one 16-byte load, four rows in
// flight, and keeps three int64 partials; a warp shuffle reduction, then
// the warps' partials in shared memory.  Each block writes its three sums
// to `partial`, and the last of the subwindow's G blocks to take a ticket
// adds the G partials in order and writes the subwindow's row, then
// resets the ticket, so the scratch of tickets is zero again for the next
// call (zeroed once, kernels.py::scratch).  Integer sums: neither the
// order of the blocks nor that of the tickets changes the result.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int U = 4;  // rows in flight a thread
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void add_row(const int4& c, int min_depth,
                                        long long& s0, long long& s1,
                                        long long& s2) {
  if (c.z > 0 && c.x > 0 && c.x >= min_depth) {
    s0 += c.x;
    s1 += (long long)c.y + 128LL * (long long)c.w;
    s2 += 1;
  }
}

__global__ void __launch_bounds__(TPB)
cov_reduce_kernel(const int4* __restrict__ census, int64_t rows, int64_t sub,
                  int64_t chunk, int G, int min_depth,
                  long long* __restrict__ partial, int* __restrict__ tickets,
                  long long* __restrict__ out) {
  __shared__ long long red[3][WARPS];
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  const int64_t base = (int64_t)s * sub;
  const int64_t lo = base + (int64_t)g * chunk;
  const int64_t hi = min(base + min((int64_t)(g + 1) * chunk, sub), rows);
  long long s0 = 0, s1 = 0, s2 = 0;
  for (int64_t r0 = lo + t; r0 < hi; r0 += U * TPB) {
    int4 c[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * TPB < hi) c[u] = __ldg(census + r0 + u * TPB);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * TPB < hi) add_row(c[u], min_depth, s0, s1, s2);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s0 += __shfl_xor_sync(FULL, s0, o);
    s1 += __shfl_xor_sync(FULL, s1, o);
    s2 += __shfl_xor_sync(FULL, s2, o);
  }
  if (lane == 0) {
    red[0][warp] = s0;
    red[1][warp] = s1;
    red[2][warp] = s2;
  }
  __syncthreads();
  long long mine = 0;
  if (t < 3) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mine += red[t][w];
  }
  if (G == 1) {
    if (t < 3) out[3 * s + t] = mine;
    return;
  }
  if (t < 3) partial[3 * (int64_t)blockIdx.x + t] = mine;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + s, 1) == G - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < 3) {
    const volatile long long* p = partial + 3 * (int64_t)s * G;
    long long tot = 0;
    for (int k = 0; k < G; ++k) tot += p[3 * k + t];
    out[3 * s + t] = tot;
  }
  if (t == 0) tickets[s] = 0;
}

}  // namespace

// census int32[rows, 4] (16-byte aligned, rows > 0), sub > 0; G blocks a
// subwindow over `chunk` rows each, G x chunk >= min(sub, rows)
// (ops/pileup_engine.py::cov_plan); partial int64[nsub x G x 3] scratch;
// tickets int32[nsub], zero on entry and left zero; out int64[nsub, 3],
// nsub = ceil(rows / sub).  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int samtpu_cov_reduce(const void* census, int64_t rows,
                                 int64_t sub, int64_t chunk, int G,
                                 int min_depth, void* partial, void* tickets,
                                 void* out, void* stream) {
  if (rows <= 0 || sub <= 0 || G < 1 || chunk < 1
      || (int64_t)G * chunk < (sub < rows ? sub : rows)
      || (uintptr_t)census % 16 || (uintptr_t)partial % 8
      || (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  const int64_t nsub = (rows + sub - 1) / sub;
  const int64_t blocks = nsub * G;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cov_reduce_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
      (const int4*)census, rows, sub, chunk, G, min_depth,
      (long long*)partial, (int*)tickets, (long long*)out);
  return (int)cudaGetLastError();
}
