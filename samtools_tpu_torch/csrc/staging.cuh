// Shared-memory staging used by K1 segment_contract / segment_census, K4
// baq_hmm and K5 baq_finalize: a block's items or reads are one contiguous
// span of each input, copied into shared memory 16 bytes at a time.  K10
// consensus_segsum and K12 stats_hists use its wait and attribute helpers.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

// n bytes at g -> sm, byte k landing at sm[mis + k], mis = g mod 16, so
// the 16-byte vector stores stay aligned; byte loads for the head and
// tail.  All nt threads of the block take part (nt = blockDim.x).
__device__ __forceinline__ int load_span(uint8_t* sm,
                                         const uint8_t* __restrict__ g, int n,
                                         int nt) {
  const int t = threadIdx.x;
  const int mis = (int)((uintptr_t)g & 15);
  const int head = min(n, (16 - mis) & 15);
  for (int k = t; k < head; k += nt) sm[mis + k] = g[k];
  const int nv = (n - head) / 16;
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  uint4* sv = reinterpret_cast<uint4*>(sm + mis + head);
  // U loads in flight per thread before their stores
  constexpr int U = 8;
  for (int k0 = t; k0 < nv; k0 += U * nt) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u * nt < nv) v[u] = gv[k0 + u * nt];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u * nt < nv) sv[k0 + u * nt] = v[u];
  }
  for (int k = head + 16 * nv + t; k < n; k += nt) sm[mis + k] = g[k];
  return mis;
}

// load_span's layout, with the 16-byte part copied by cp.async: the copies
// take no registers and every copy the block issues is in flight at once,
// however many spans it stages.  The caller waits with cp_async_wait_all()
// and then __syncthreads().
__device__ __forceinline__ int copy_span_async(uint8_t* sm,
                                               const uint8_t* __restrict__ g,
                                               int n, int nt) {
  const int t = threadIdx.x;
  const int mis = (int)((uintptr_t)g & 15);
  const int head = min(n, (16 - mis) & 15);
  for (int k = t; k < head; k += nt) sm[mis + k] = g[k];
  const int nv = (n - head) / 16;
  const uint8_t* gv = g + head;
  uint8_t* sv = sm + mis + head;
  for (int k = t; k < nv; k += nt) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sv + 16 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gv + 16 * k)
                 : "memory");
  }
  for (int k = head + 16 * nv + t; k < n; k += nt) sm[mis + k] = g[k];
  return mis;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;

// Lets `kernel` launch with up to the device's opt-in maximum of dynamic
// shared memory per block, with the largest shared-memory carveout (shared
// memory bounds the blocks per SM).  The attributes are set once per
// device: ready[d] records device d.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool>* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int most = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  // the kernel's static shared memory counts against the same limit
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess && dev < kMaxDevices)
    ready[dev].store(true, std::memory_order_release);
  return e;
}
