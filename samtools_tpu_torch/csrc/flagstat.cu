// K11 flagstat: the 16 flag-census counters of samtools flagstat, split
// by QC-pass and QC-fail, on Hopper.
//
// Replaces samtools_tpu/ops/flagstat.py::flagstat_device (:67-80) and its
// padded-chunk caller flagstat_counts (:83-107): an XLA einsum of an
// [n, 16] condition matrix with an [n, 2] QC one-hot.  Here no padding,
// no mask and no float: the counts are integers and exact.
//
// Per record: 16 conditions (bam_stat.c:48-79's chain of flag tests, in
// ops/flagstat.py's COUNTERS order) and the QC-fail bit make a 32-bit
// mask, bit 2c + qcfail for counter c.  A warp adds its 32 records' masks
// bit by bit with __ballot_sync + __popc; lane b keeps the running count
// of bit b in a register.  At the end each warp adds its lanes' counts
// into the block's 32 shared counters, and one warp adds those to the
// 64-bit global counters with one atomic each.
//
// What bounds it on the H100: bytes (flag 2 B, mapq 1 B, tid and mtid
// 4 B each, read once); 32 ballots per 32 records is a few operations per
// record.  Blocks stride over the records, so each block's shared
// counters see at most n / gridDim records (< 2^32).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int MAX_BLOCKS = 1056;  // 8 per SM on the H100's 132 SMs

// flag bits (SAM spec)
constexpr uint32_t FPAIRED = 1, FPROPER_PAIR = 2, FUNMAP = 4, FMUNMAP = 8,
                   FREAD1 = 64, FREAD2 = 128, FSECONDARY = 256,
                   FQCFAIL = 512, FDUP = 1024, FSUPPLEMENTARY = 2048;

__device__ __forceinline__ uint32_t record_mask(uint32_t f, int mapq,
                                                int32_t tid, int32_t mtid) {
  const bool secondary = f & FSECONDARY, supp = f & FSUPPLEMENTARY;
  const bool primary = !secondary && !supp;
  const bool unmap = f & FUNMAP, munmap = f & FMUNMAP;
  const bool dup = f & FDUP;
  const bool pair_all = primary && (f & FPAIRED);
  const bool pair_map = pair_all && !unmap && !munmap;
  const bool diffchr = pair_map && mtid != tid;
  const uint32_t c = 1u                                      // n_reads
      | (uint32_t)primary << 1                               // n_primary
      | (uint32_t)secondary << 2                             // n_secondary
      | (uint32_t)supp << 3                                  // n_supp
      | (uint32_t)dup << 4                                   // n_dup
      | (uint32_t)(primary && dup) << 5                      // n_pdup
      | (uint32_t)!unmap << 6                                // n_mapped
      | (uint32_t)(primary && !unmap) << 7                   // n_pmapped
      | (uint32_t)pair_all << 8                              // n_pair_all
      | (uint32_t)(pair_all && (f & FREAD1)) << 9            // n_read1
      | (uint32_t)(pair_all && (f & FREAD2)) << 10           // n_read2
      | (uint32_t)(pair_all && (f & FPROPER_PAIR) && !unmap) << 11
      | (uint32_t)pair_map << 12                             // n_pair_map
      | (uint32_t)(pair_all && munmap && !unmap) << 13       // n_sgltn
      | (uint32_t)diffchr << 14                              // n_diffchr
      | (uint32_t)(diffchr && mapq >= 5) << 15;              // n_diffhigh
  // spread counter c to bit 2c (QC-pass) or 2c + 1 (QC-fail)
  uint32_t x = c;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return (f & FQCFAIL) ? x << 1 : x;
}

__global__ void __launch_bounds__(TPB)
flagstat_kernel(const uint16_t* __restrict__ flag,
                const uint8_t* __restrict__ mapq,
                const int32_t* __restrict__ tid,
                const int32_t* __restrict__ mtid, int64_t n,
                unsigned long long* __restrict__ out) {
  __shared__ unsigned int acc[32];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) acc[threadIdx.x] = 0;
  __syncthreads();
  unsigned int mine = 0;  // this lane's count of mask bit `lane`
  const int64_t stride = (int64_t)gridDim.x * TPB;
  // whole warps iterate together so every ballot sees all 32 lanes
  const int64_t n_round = (n + 31) & ~(int64_t)31;
  for (int64_t i = (int64_t)blockIdx.x * TPB + threadIdx.x; i < n_round;
       i += stride) {
    const uint32_t m =
        i < n ? record_mask(flag[i], mapq[i], tid[i], mtid[i]) : 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned int c = __popc(__ballot_sync(0xFFFFFFFFu, (m >> b) & 1u));
      if (lane == b) mine += c;
    }
  }
  atomicAdd(&acc[lane], mine);
  __syncthreads();
  if (threadIdx.x < 32 && acc[threadIdx.x])
    atomicAdd(&out[threadIdx.x], (unsigned long long)acc[threadIdx.x]);
}

}  // namespace

// flag uint16[n], mapq uint8[n], tid/mtid int32[n]; out int64[16, 2]
// (counter-major: out[2c] QC-pass, out[2c + 1] QC-fail), added into.
// Returns cudaGetLastError().
extern "C" int samtpu_flagstat(const void* flag, const void* mapq,
                               const void* tid, const void* mtid, int64_t n,
                               void* out, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + TPB - 1) / TPB;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  flagstat_kernel<<<(int)blocks, TPB, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flag, (const uint8_t*)mapq, (const int32_t*)tid,
      (const int32_t*)mtid, n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
