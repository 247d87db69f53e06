// K8's front, apply_expand: one chunk of BAQ apply's packed host->device
// buffer unpacked into the inputs of K4, in one launch.
//
// Replaces the front of samtools_tpu/ops/baq_device.py::_get_fused_apply
// (:350-362 of fused: the little-endian pos, the nt16 -> 0-4 codes, the
// quals and the reference-window gather), which the port ran as about a
// dozen torch ops (ops/baq_device.py::apply_expand_plain).  Input: buf
// uint8[B, 4 + 2L], a row a read: LE i32 pos | L nt16 bases | L quals.
// Outputs, as the plain version's: ref_win u8[B, L + 3] (the contig's
// codes at clamp(min(pos, last) + j, 0, last), last = ref_len - 1, the
// plain's two clamps in its order, in int64), sq u8[B, L] (nt16 1, 2, 4,
// 8 -> 0, 1, 2, 3; any other byte -> 4), qq u8[B, L] (the quals).
//
// What bounds it on the H100: bytes, B x (4 + 2L) read and B x (3L + 3)
// written (33.2 MB, 0.0099 ms, at 65,536 reads of 100 bases; the contig's
// bytes under the windows are not counted).  A row is 4 + 2L bytes, so
// for an odd L most rows are not 4-byte aligned, and the plain version
// reinterprets the pos bytes, builds an int64 [B, L + 3] index, clamps it
// twice and gathers through it.
//
// Design, after csrc/chunk_expand.cu: a block takes `reads` consecutive
// reads (ops/baq_device.py::apply_plan: 32, fewer for long reads, so the
// rows fit 32 KB); their rows are one contiguous span of buf, copied into
// shared memory 16 bytes a thread with every load in flight before its
// store (staging.cuh::load_span).  The block's rows of sq, qq and ref_win
// are one span of each output: thread t writes the 4 output bytes from
// 4 (t + k TPB), neighbouring threads on neighbouring words (a 4-byte
// store where the span is 4-byte aligned, else byte stores), each group's
// read and column found by one division.  The bases and quals come from
// shared memory; the windows are gathered from the contig a byte at a
// time, two groups (8 loads) in flight a thread before their stores.

#include <cuda_runtime.h>

#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int TPB = 256;
constexpr int MAX_READS = 32;  // reads a block at most
constexpr int PAD = 3;         // window bytes past the read's L
constexpr int GROUP = 4;       // output bytes a thread a step
constexpr int U = 2;           // window groups in flight a thread

__device__ __forceinline__ uint8_t nt16_to4(uint8_t b) {
  return b == 1 ? 0 : b == 2 ? 1 : b == 4 ? 2 : b == 8 ? 3 : 4;
}

// the GROUP bytes from flat e of a span of rows of `width` bytes:
// v[k] = f(row, column) of byte e + k, for e + k < n
template <typename F>
__device__ __forceinline__ void group_bytes(int e, int n, int width,
                                            uint8_t v[GROUP], F f) {
  int r = e / width, c = e - r * width;
#pragma unroll
  for (int k = 0; k < GROUP; ++k) {
    if (e + k < n) v[k] = f(r, c);
    if (++c == width) {
      c = 0;
      ++r;
    }
  }
}

__device__ __forceinline__ void store_group(uint8_t* out, int e, int n,
                                            bool aligned,
                                            const uint8_t v[GROUP]) {
  if (aligned && e + GROUP <= n) {
    *reinterpret_cast<uchar4*>(out + e) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if (e + k < n) out[e + k] = v[k];
  }
}

__global__ void __launch_bounds__(TPB) apply_expand_kernel(
    const uint8_t* __restrict__ buf, int B, int L, int reads,
    const uint8_t* __restrict__ ref, int64_t ref_len,
    uint8_t* __restrict__ ref_win, uint8_t* __restrict__ sq,
    uint8_t* __restrict__ qq) {
  extern __shared__ __align__(16) uint8_t rows_sm[];
  __shared__ int64_t start[MAX_READS];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * reads;
  const int nr = min(reads, B - r0);
  const int RS = 4 + 2 * L;
  const int mis = load_span(rows_sm, buf + (int64_t)r0 * RS, nr * RS, TPB);
  __syncthreads();
  const uint8_t* sm = rows_sm + mis;
  const int64_t last = ref_len - 1;
  if (t < nr) {
    const uint8_t* p = sm + t * RS;
    const int32_t pos = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8)
                                  | ((uint32_t)p[2] << 16)
                                  | ((uint32_t)p[3] << 24));
    start[t] = min((int64_t)pos, last);
  }
  __syncthreads();

  // the bases and quals, from shared memory
  const int n_q = nr * L;
  uint8_t* osq = sq + (int64_t)r0 * L;
  uint8_t* oqq = qq + (int64_t)r0 * L;
  const bool q_aligned = ((uintptr_t)osq % 4 == 0) && ((uintptr_t)oqq % 4 == 0);
  for (int e = GROUP * t; e < n_q; e += GROUP * TPB) {
    uint8_t b[GROUP], q[GROUP];
    group_bytes(e, n_q, L, b,
                [&](int r, int c) { return nt16_to4(sm[r * RS + 4 + c]); });
    group_bytes(e, n_q, L, q,
                [&](int r, int c) { return sm[r * RS + 4 + L + c]; });
    store_group(osq, e, n_q, q_aligned, b);
    store_group(oqq, e, n_q, q_aligned, q);
  }

  // the reference windows, gathered from the contig
  const int W = L + PAD;
  const int n_win = nr * W;
  uint8_t* ow = ref_win + (int64_t)r0 * W;
  const bool w_aligned = (uintptr_t)ow % 4 == 0;
  auto gather = [&](int r, int c) {
    int64_t i = start[r] + c;
    i = i < 0 ? 0 : (i > last ? last : i);
    return ref[i];
  };
  for (int e0 = GROUP * t; e0 < n_win; e0 += U * GROUP * TPB) {
    uint8_t v[U][GROUP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * GROUP * TPB;
      if (e < n_win) group_bytes(e, n_win, W, v[u], gather);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * GROUP * TPB;
      if (e < n_win) store_group(ow, e, n_win, w_aligned, v[u]);
    }
  }
}

}  // namespace

// buf uint8[B, 4 + 2L]; ref uint8[ref_len] (0-4 codes); `reads` reads a
// block (ops/baq_device.py::apply_plan: 1 to 32, reads x (4 + 2L) at most
// 32,768); outputs ref_win uint8[B, L + 3], sq and qq uint8[B, L].
// Returns the launch's CUDA error, or cudaErrorInvalidValue for arguments
// it does not take.
extern "C" int samtpu_apply_expand(const void* buf, int B, int L, int reads,
                                   const void* ref, int64_t ref_len,
                                   void* ref_win, void* sq, void* qq,
                                   void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || ref_len < 1 || reads < 1 || reads > MAX_READS
      || (int64_t)reads * (4 + 2 * (int64_t)L) > 32768)
    return (int)cudaErrorInvalidValue;
  const int smem = reads * (4 + 2 * L) + 16;
  apply_expand_kernel<<<(B + reads - 1) / reads, TPB, smem,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)buf, B, L, reads, (const uint8_t*)ref, ref_len,
      (uint8_t*)ref_win, (uint8_t*)sq, (uint8_t*)qq);
  return (int)cudaGetLastError();
}
