// K7n census_narrow: the census fetch narrowed on the card before its one
// device->host copy.
//
// Replaces samtools_tpu/ops/mpileup_device.py::_split_jit (:401-420) as
// DeviceCensusPipeline.finish uses it (:855-873): the column maxima of the
// resident int32 census [pad_len, 6] (counts in lanes 0-4, the qual sum in
// lane 5), then each part cast to the smallest lossless type: counts u8
// below 256, u16 below 65,536, else int32; the qual sum u16 below 65,536,
// else int32.  Two passes, because the host must know the types to size
// the fetch:
//
// 1. census_max: a grid-stride pass over the window's rows; each thread
//    keeps the two maxima, a warp folds them with shuffles and one lane
//    per warp does an atomicMax into the two int32 results (the values
//    are non-negative counts and sums);
// 2. census_cast: one thread per row writes its five narrowed counts to
//    the front of one byte buffer and its narrowed qual sum behind them
//    (at a 4-byte aligned offset, the bytes between them zero), so the
//    host fetches one buffer.
//
// What bounds it on the H100: bytes, the census read twice (24 B a row)
// and the narrowed copy written once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int MAX_BLOCKS = 1056;  // 8 per SM on the H100's 132 SMs

__global__ void __launch_bounds__(TPB)
census_max_kernel(const int32_t* __restrict__ c, int64_t n,
                  int32_t* __restrict__ out) {
  int cm = 0, qm = 0;
  const int64_t stride = (int64_t)gridDim.x * TPB;
  for (int64_t x = (int64_t)blockIdx.x * TPB + threadIdx.x; x < n * 6;
       x += stride) {
    const int v = c[x];
    if (x % 6 == 5)
      qm = max(qm, v);
    else
      cm = max(cm, v);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    cm = max(cm, __shfl_xor_sync(0xFFFFFFFFu, cm, o));
    qm = max(qm, __shfl_xor_sync(0xFFFFFFFFu, qm, o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (cm) atomicMax(&out[0], cm);
    if (qm) atomicMax(&out[1], qm);
  }
}

template <typename CT, typename QT>
__global__ void __launch_bounds__(TPB)
census_cast_kernel(const int32_t* __restrict__ c, int64_t n,
                   uint8_t* __restrict__ out, int64_t q_off) {
  CT* counts = reinterpret_cast<CT*>(out);
  QT* qsum = reinterpret_cast<QT*>(out + q_off);
  // the 0-3 bytes between the counts and the qual sums read as zero
  const int64_t pad0 = n * 5 * (int64_t)sizeof(CT);
  if (blockIdx.x == 0 && pad0 + threadIdx.x < q_off)
    out[pad0 + threadIdx.x] = 0;
  const int64_t stride = (int64_t)gridDim.x * TPB;
  for (int64_t r = (int64_t)blockIdx.x * TPB + threadIdx.x; r < n;
       r += stride) {
    const int32_t* row = c + r * 6;
#pragma unroll
    for (int k = 0; k < 5; ++k) counts[r * 5 + k] = (CT)row[k];
    qsum[r] = (QT)row[5];
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + TPB - 1) / TPB;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return b < 1 ? 1 : (int)b;
}

template <typename CT>
void cast_q(const int32_t* c, int64_t n, uint8_t* out, int64_t q_off,
            int qsize, cudaStream_t s) {
  if (qsize == 2)
    census_cast_kernel<CT, uint16_t>
        <<<blocks_for(n), TPB, 0, s>>>(c, n, out, q_off);
  else
    census_cast_kernel<CT, int32_t>
        <<<blocks_for(n), TPB, 0, s>>>(c, n, out, q_off);
}

}  // namespace

// census int32[>= n, 6]; out int32[2], zeroed by the caller: the largest
// count (lanes 0-4) and the largest qual sum (lane 5) of rows [0, n).
// Returns cudaGetLastError().
extern "C" int samtpu_census_max(const void* census, int64_t n, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  census_max_kernel<<<blocks_for(n * 6), TPB, 0, (cudaStream_t)stream>>>(
      (const int32_t*)census, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Rows [0, n) of census int32[>= n, 6] into out: counts [n, 5] of csize
// bytes each (1: u8, 2: u16, 4: int32) at byte 0, qual sums [n] of qsize
// bytes (2: u16, 4: int32) at byte q_off.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a size it does not take.
extern "C" int samtpu_census_cast(const void* census, int64_t n, int csize,
                                  int qsize, void* out, int64_t q_off,
                                  void* stream) {
  if ((csize != 1 && csize != 2 && csize != 4) || (qsize != 2 && qsize != 4)
      || q_off % 4)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int32_t* c = (const int32_t*)census;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (csize == 1)
    cast_q<uint8_t>(c, n, o, q_off, qsize, s);
  else if (csize == 2)
    cast_q<uint16_t>(c, n, o, q_off, qsize, s);
  else
    cast_q<int32_t>(c, n, o, q_off, qsize, s);
  return (int)cudaGetLastError();
}
