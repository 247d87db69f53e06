// K5 baq_finalize: BAQ state-check zeroing, qual cap, per-M-op smoothing
// and the applied qual, on Hopper.
//
// Replaces samtools_tpu/ops/baq_device.py::_finalize (:302-328), an XLA
// device function of the fused chunk step.  Per base:
//   bqv = (good && M) ? min(bq, q) : 0
//   M bases:     out = min(q, min(prefix max, suffix max of bqv within
//                                 the base's cigar op))
//   other bases: out = min(q, bq)
//
// What bounds it on the H100: bytes (read bq, good, qual 1 B and seg 4 B
// per base, write 1 B); a handful of integer ops per base.  The sweeps
// are serial along a read, so a thread per read is the natural unit; but
// a thread walking its own row in device memory touches a new 32-byte
// sector on every byte of every warp-wide access.
//
// Design: a block takes a tile of up to 64 consecutive reads (fewer where
// their rows would not fit in shared memory), whose rows are
// one contiguous span of each input.  The block copies each span into
// shared memory with 16-byte vector loads (byte loads for an unaligned
// head and tail; each byte buffer starts at the span's own offset modulo
// 16, so the vector stores stay aligned), seg rows padded to an odd word
// stride so the per-thread walks hit distinct banks.  Each thread then
// runs the two segmented sweeps on its row in shared memory: the forward
// pass keeps the running prefix max of the current M segment (it
// restarts whenever the segment id changes) and parks bqv in the bq slot
// and the prefix max in the good slot; the backward pass keeps the
// running suffix max and writes the applied qual into the qual slot.  The
// qual span is then written back coalesced.  This replaces the TPU
// version's cummax over bqv + 256*seg offsets; both are exact integer
// arithmetic, so the results are equal.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int TPB = 64;          // reads per tile, one thread each, at most
constexpr int SMEM_MAX = 232448;  // shared memory one block may take

__host__ __device__ constexpr int seg_stride(int L) { return L | 1; }

// one u8 span of a tile of nt reads, with room for its 16-byte offset
__host__ __device__ constexpr int64_t byte_buf(int L, int nt) {
  return ((int64_t)nt * L + 16 + 15) & ~(int64_t)15;
}

__host__ __device__ constexpr int64_t smem_bytes(int L, int nt) {
  return (((int64_t)nt * seg_stride(L) * 4 + 15) & ~(int64_t)15) +
         3 * byte_buf(L, nt);
}

// reads per tile: TPB, or as many as shared memory holds for long rows
int tile_reads(int L) {
  int nt = TPB;
  while (nt > 1 && smem_bytes(L, nt) > SMEM_MAX) --nt;
  return nt;
}

// shared-memory slot of element e of a tile's seg span: row e / L of
// stride Ls; M = ceil(2^32 / L) turns e / L into a multiply and a shift,
// exact for e < 2^32 / L (a tile's span holds fewer than 2^16 elements)
__device__ __forceinline__ int seg_slot(int e, int L, int Ls, uint64_t M) {
  const int row = (int)(((uint64_t)e * M) >> 32);
  return row * Ls + (e - row * L);
}

// n bytes sm[mis + k] -> g[k]; vector stores where g lines up with sm
__device__ __forceinline__ void store_span(uint8_t* __restrict__ g,
                                           const uint8_t* sm, int mis, int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((int)((uintptr_t)g & 15) == mis) {
    const int head = min(n, (16 - mis) & 15);
    for (int k = t; k < head; k += nt) g[k] = sm[mis + k];
    const int nv = (n - head) / 16;
    uint4* gv = reinterpret_cast<uint4*>(g + head);
    const uint4* sv = reinterpret_cast<const uint4*>(sm + mis + head);
    for (int k = t; k < nv; k += nt) gv[k] = sv[k];
    done = head + 16 * nv;
  }
  for (int k = done + t; k < n; k += nt) g[k] = sm[mis + k];
}

__global__ void __launch_bounds__(TPB) baq_finalize_kernel(
    const uint8_t* __restrict__ bq, const uint8_t* __restrict__ good,
    const uint8_t* __restrict__ qual, const int32_t* __restrict__ seg, int n,
    int L, uint8_t* __restrict__ out) {
  extern __shared__ uint4 sh4[];
  const int Ls = seg_stride(L);
  const int t = threadIdx.x, nt = blockDim.x;
  int32_t* sseg = reinterpret_cast<int32_t*>(sh4);
  uint8_t* sbq = reinterpret_cast<uint8_t*>(sh4) +
                 (((int64_t)nt * Ls * 4 + 15) & ~(int64_t)15);
  uint8_t* sgood = sbq + byte_buf(L, nt);
  uint8_t* squal = sgood + byte_buf(L, nt);
  const int r0 = blockIdx.x * nt;
  const int nb = min(nt, n - r0) * L;
  const int64_t off = (int64_t)r0 * L;

  // ---- the tile's spans into shared memory
  const int mb = load_span(sbq, bq + off, nb, nt);
  const int mg = load_span(sgood, good + off, nb, nt);
  const int mq = load_span(squal, qual + off, nb, nt);
  {
    const uint64_t M = 0xFFFFFFFFull / (uint64_t)L + 1;
    const int32_t* g = seg + off;
    const int head = min(nb, (int)((4 - (((uintptr_t)g >> 2) & 3)) & 3));
    for (int k = t; k < head; k += nt) sseg[seg_slot(k, L, Ls, M)] = g[k];
    const int nv = (nb - head) / 4;
    const int4* gv = reinterpret_cast<const int4*>(g + head);
    constexpr int U = 8;
    for (int k0 = t; k0 < nv; k0 += U * nt) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u * nt < nv) v[u] = gv[k0 + u * nt];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u * nt >= nv) break;
        const int e = head + 4 * (k0 + u * nt);
        sseg[seg_slot(e, L, Ls, M)] = v[u].x;
        sseg[seg_slot(e + 1, L, Ls, M)] = v[u].y;
        sseg[seg_slot(e + 2, L, Ls, M)] = v[u].z;
        sseg[seg_slot(e + 3, L, Ls, M)] = v[u].w;
      }
    }
    for (int k = head + 4 * nv + t; k < nb; k += nt)
      sseg[seg_slot(k, L, Ls, M)] = g[k];
  }
  __syncthreads();

  // ---- the two sweeps, one thread per read
  if (r0 + t < n) {
    const int32_t* sg = sseg + t * Ls;
    uint8_t* b = sbq + mb + t * L;    // bq, then bqv on M bases
    uint8_t* gd = sgood + mg + t * L;  // good, then the prefix max
    uint8_t* q = squal + mq + t * L;   // qual, then the applied qual
    int run = 0, prev = -2;
    for (int p = 0; p < L; ++p) {
      const int s = sg[p];
      if (s >= 0) {
        const int qq = q[p], bb = b[p];
        const int v = gd[p] ? (bb < qq ? bb : qq) : 0;
        run = (s == prev && v < run) ? run : v;
        b[p] = (uint8_t)v;
        gd[p] = (uint8_t)run;
      }
      prev = s;
    }
    run = 0;
    int next = -2;
    for (int p = L - 1; p >= 0; --p) {
      const int s = sg[p];
      const int qq = q[p], bb = b[p];
      if (s >= 0) {
        run = (s == next && bb < run) ? run : bb;
        const int left = gd[p];
        const int sm = left < run ? left : run;
        q[p] = (uint8_t)(qq < sm ? qq : sm);
      } else {
        q[p] = (uint8_t)(qq < bb ? qq : bb);
      }
      next = s;
    }
  }
  __syncthreads();
  store_span(out + off, squal, mq, nb);
}

}  // namespace

// bq/good/qual uint8[n, L], seg int32[n, L] (negative = non-M base),
// out uint8[n, L].  Returns cudaGetLastError().
extern "C" int samtpu_baq_finalize(const void* bq, const void* good,
                                   const void* qual, const void* seg, int n,
                                   int L, void* out, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  const int nt = tile_reads(L);
  const int64_t smem = smem_bytes(L, nt);
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t e = allow_smem(baq_finalize_kernel, ready);
  if (e != cudaSuccess) return (int)e;
  baq_finalize_kernel<<<(n + nt - 1) / nt, nt, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)bq, (const uint8_t*)good, (const uint8_t*)qual,
      (const int32_t*)seg, n, L, (uint8_t*)out);
  return (int)cudaGetLastError();
}
