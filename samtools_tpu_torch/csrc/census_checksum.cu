// K7 census_checksum: the two-lane weighted checksum of the census core's
// resident census, on the card.
//
// Replaces samtools_tpu/ops/mpileup_device.py::_ck_jit (:376-395), which
// DeviceCensusPipeline.finish_checksum (:840-852) runs once a window:
// rows [0, wlen) of the int32 census [pad_len, 6] as uint32 v (an int32
// reinterpreted), the counts [wlen, 5] first in row-major order (idx =
// 5 r + k), then the qual sums (idx = 5 wlen + r), and
//   s1 = sum v * (idx * 2654435761),  s2 = sum v * ((idx + 0x9E3779B9) *
//   40503),
// every product and sum mod 2^32.
//
// What bounds it on the H100: bytes, the rows read once (24 B a row: 201
// MB, 0.060 ms at the census core's 8 Mi rows); four 32-bit multiply-adds
// a word are far below the card's integer rate.  Its plain version
// (census_checksum_plain) widens every word to int64, splits each product
// into 16-bit halves so that none leaves int64, and sums with two host
// syncs: about 25 passes over 8 B a word.
//
// Design: a grid-stride loop over the census's flat int32 words [0,
// 6 wlen) as 16-byte vectors (neighbouring threads on neighbouring
// vectors, every load coalesced; 6 wlen words are even, so at most two
// words are left for a scalar tail).  Each word's row and lane come from
// its flat index (the division by 6 of a uint32 is a multiply and a
// shift), its weights from native uint32 arithmetic, which wraps mod 2^32
// as the plain's masks do.  Two uint32 sums a thread, a warp shuffle
// reduction, a block reduction in shared memory, and one atomicAdd a
// lane a block into the 2-word output that the wrapper zeroed.  Addition
// mod 2^32 is commutative and associative, so neither the order of the
// sums nor that of the atomics changes the result.  The grid
// (ops/mpileup_device.py::checksum_plan) is at most 4 blocks of 256
// threads an SM, fewer when the rows are fewer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr uint32_t W1 = 2654435761u, W2 = 40503u, W2_OFF = 0x9E3779B9u;
constexpr unsigned FULL = 0xFFFFFFFFu;

// word e of the flat census (row e / 6, lane e % 6) with value v
__device__ __forceinline__ void add_word(uint32_t v, uint32_t e,
                                         uint32_t wlen, uint32_t& s1,
                                         uint32_t& s2) {
  const uint32_t r = e / 6u, k = e - 6u * r;
  const uint32_t idx = k < 5u ? 5u * r + k : 5u * wlen + r;
  s1 += v * (idx * W1);
  s2 += v * ((idx + W2_OFF) * W2);
}

__global__ void __launch_bounds__(TPB)
census_checksum_kernel(const int32_t* __restrict__ census, uint32_t wlen,
                       uint32_t* __restrict__ out) {
  const uint32_t words = 6u * wlen;
  const uint32_t nv = words / 4u;
  const uint32_t stride = gridDim.x * TPB;
  const uint4* cv = reinterpret_cast<const uint4*>(census);
  uint32_t s1 = 0, s2 = 0;
  for (uint32_t k = blockIdx.x * TPB + threadIdx.x; k < nv; k += stride) {
    const uint4 v = __ldg(cv + k);
    const uint32_t e = 4u * k;
    add_word(v.x, e, wlen, s1, s2);
    add_word(v.y, e + 1u, wlen, s1, s2);
    add_word(v.z, e + 2u, wlen, s1, s2);
    add_word(v.w, e + 3u, wlen, s1, s2);
  }
  for (uint64_t e = 4ull * nv + blockIdx.x * TPB + threadIdx.x; e < words;
       e += stride)
    add_word((uint32_t)__ldg(census + e), (uint32_t)e, wlen, s1, s2);

#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s1 += __shfl_xor_sync(FULL, s1, o);
    s2 += __shfl_xor_sync(FULL, s2, o);
  }
  __shared__ uint32_t red[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[threadIdx.x][w];
    atomicAdd(out + threadIdx.x, s);
  }
}

}  // namespace

// Adds the checksum of rows [0, wlen) of census int32[>= wlen, 6] (16-byte
// aligned; 6 wlen < 2^32) into out uint32[2] (zero it first), on `blocks`
// blocks (ops/mpileup_device.py::checksum_plan).  Returns the launch's
// CUDA error, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int samtpu_census_checksum(const void* census, int64_t wlen,
                                      int blocks, void* out, void* stream) {
  if (wlen <= 0) return 0;
  if (blocks < 1 || 6 * wlen > (int64_t)UINT32_MAX
      || (uintptr_t)census % 16 || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  census_checksum_kernel<<<blocks, TPB, 0, (cudaStream_t)stream>>>(
      (const int32_t*)census, (uint32_t)wlen, (uint32_t*)out);
  return (int)cudaGetLastError();
}
