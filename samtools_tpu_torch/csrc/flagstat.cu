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
// mask, bit 2c + qcfail for counter c.  All but the last two counters
// depend on 10 flag bits only: each block tabulates those 1,024 masks in
// shared memory first, and a record's mask is one table read plus the
// mate-on-another-contig bits (n_diffchr, n_diffhigh).
//
// What bounds it on the H100: bytes (flag 2 B, mapq 1 B, tid and mtid
// 4 B each, read once: 11 B a record).  The design keeps the per-record
// work to a few instructions a thread and the cross-block reduction off
// the global atomics:
//
// * one wave of persistent blocks (ops/flagstat.py::flagstat_plan: two
//   256-thread blocks an SM, fewer for a small batch);
// * each thread takes 8 records a step with 16-byte loads (8 flags, 8
//   mapq as one 8-byte load, 8 tid and 8 mtid as two 16-byte loads
//   each); where a base pointer is not aligned for them the same kernel
//   takes one record a step with scalar loads, and the n % 8 tail always
//   goes that way;
// * bit-sliced counters: a thread keeps its counts of the 32 mask bits
//   as 8 bit planes (bit b of plane j is bit j of the count of mask bit
//   b), so counts reach 255.  A step's 8 masks go through a carry-save
//   tree to a 4-bit count per bit position, rippled into the planes
//   (~50 logic operations for 8 records);
// * the drain, every 31 steps (248 records) and at the end: per plane a
//   warp transposes its 32 x 32 bit matrix with 5 shuffle stages, so lane
//   b holds bit b of plane j of every lane and adds popc << j;
// * each block writes its 32 uint32 partials to scratch; the last block
//   to take a ticket (after a __threadfence) sums them in 64 bits,
//   writes out and resets the ticket.  No 64-bit global atomics; out is
//   written, not added into.
//
// A block's partials are uint32: a block counts fewer than 2^32 records
// (n < 2^32 x blocks).  scratch is one stream's at a time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int VEC = 8;          // records a thread takes a vector step
constexpr int PLANES = 8;       // bit planes: counts up to 255
constexpr int VEC_STEPS = 31;   // vector steps between drains (248 records)
constexpr int SCALAR_STEPS = 255;
constexpr unsigned FULL = 0xFFFFFFFFu;

// flag bits (SAM spec)
constexpr uint32_t FPAIRED = 1, FPROPER_PAIR = 2, FUNMAP = 4, FMUNMAP = 8,
                   FREAD1 = 64, FREAD2 = 128, FSECONDARY = 256,
                   FQCFAIL = 512, FDUP = 1024, FSUPPLEMENTARY = 2048;

__device__ __forceinline__ uint32_t record_mask(uint32_t f, uint32_t mapq,
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

// full adder on 32 bit positions at once
__device__ __forceinline__ void full_add(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t& sum, uint32_t& carry) {
  const uint32_t u = a ^ b;
  sum = u ^ c;
  carry = (a & b) | (u & c);
}

// one mask into the planes: a ripple of half adders
__device__ __forceinline__ void add1(uint32_t (&p)[PLANES], uint32_t m) {
#pragma unroll
  for (int j = 0; j < PLANES; ++j) {
    const uint32_t t = p[j] & m;
    p[j] ^= m;
    m = t;
  }
}

// eight masks into the planes: a carry-save tree to a 4-bit count per
// bit position (b3 b2 b1 b0, at most 8), then one ripple
__device__ __forceinline__ void add8(uint32_t (&p)[PLANES],
                                     const uint32_t (&m)[VEC]) {
  uint32_t sa, ca, sb, cb, s0, cc, s1, c4a;
  full_add(m[0], m[1], m[2], sa, ca);
  full_add(m[3], m[4], m[5], sb, cb);
  full_add(sa, sb, m[6], s0, cc);
  const uint32_t b0 = s0 ^ m[7], cd = s0 & m[7];
  full_add(ca, cb, cc, s1, c4a);
  const uint32_t b1 = s1 ^ cd, c4b = s1 & cd;
  const uint32_t b2 = c4a ^ c4b, b3 = c4a & c4b;
  uint32_t carry = p[0] & b0;
  p[0] ^= b0;
  full_add(p[1], b1, carry, p[1], carry);
  full_add(p[2], b2, carry, p[2], carry);
  full_add(p[3], b3, carry, p[3], carry);
#pragma unroll
  for (int j = 4; j < PLANES; ++j) {
    const uint32_t t = p[j] & carry;
    p[j] ^= carry;
    carry = t;
  }
}

// 32 x 32 bit transpose across a warp: bit b of lane l -> bit l of lane b.
// Each stage swaps the off-diagonal blocks of every 2s x 2s block.
__device__ __forceinline__ uint32_t transpose32(uint32_t v, int lane) {
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    // the low s bits of every 2s bits
    const uint32_t m = s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu
        : s == 4 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(FULL, v, s);
    v = (lane & s) ? ((v & ~m) | ((y >> s) & m))
                   : ((v & m) | ((y << s) & ~m));
  }
  return v;
}

// the warp's counts, lane b getting mask bit b's; the planes are cleared
__device__ __forceinline__ uint32_t drain(uint32_t (&p)[PLANES], int lane) {
  uint32_t total = 0;
#pragma unroll
  for (int j = 0; j < PLANES; ++j) {
    if (__any_sync(FULL, p[j]))
      total += (uint32_t)__popc(transpose32(p[j], lane)) << j;
    p[j] = 0;
  }
  return total;
}

// the flag bits the table reads: 0-3 (paired, proper pair, unmapped,
// mate unmapped) and 6-11 (read 1, read 2, secondary, QC-fail,
// duplicate, supplementary), as a 10-bit index
constexpr int LUT = 1024;

__device__ __forceinline__ uint32_t lut_flag(int i) {
  return (uint32_t)((i & 0xF) | ((i & 0x3F0) << 2));
}

// record_mask from the block's table: bits 28-31 (n_diffchr, n_diffhigh)
// are 0 in the table (tid == mtid there) and set here
__device__ __forceinline__ uint32_t mask_of(const uint32_t* lut, uint32_t f,
                                            uint32_t mapq, int32_t tid,
                                            int32_t mtid) {
  const uint32_t m = lut[(f & 0xFu) | ((f >> 2) & 0x3F0u)];
  const bool pair_map = (f & (FSECONDARY | FSUPPLEMENTARY | FPAIRED | FUNMAP
                              | FMUNMAP)) == FPAIRED;
  const uint32_t d = pair_map && tid != mtid
      ? (mapq >= 5 ? 0x50000000u : 0x10000000u) : 0u;
  return m | (d << ((f >> 9) & 1u));
}

__device__ __forceinline__ uint32_t mask_at(
    const uint32_t* lut, const uint16_t* __restrict__ flag,
    const uint8_t* __restrict__ mapq, const int32_t* __restrict__ tid,
    const int32_t* __restrict__ mtid, int64_t i) {
  return mask_of(lut, __ldg(flag + i), __ldg(mapq + i), __ldg(tid + i),
                 __ldg(mtid + i));
}

// the 8 masks of records [8g, 8g + 8) by 16-byte loads
__device__ __forceinline__ void masks8(
    const uint32_t* lut, const uint16_t* __restrict__ flag,
    const uint8_t* __restrict__ mapq,
    const int32_t* __restrict__ tid, const int32_t* __restrict__ mtid,
    int64_t g, uint32_t (&m)[VEC]) {
  const uint4 f = __ldg(reinterpret_cast<const uint4*>(flag) + g);
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(mapq) + g);
  const int4 t0 = __ldg(reinterpret_cast<const int4*>(tid) + 2 * g);
  const int4 t1 = __ldg(reinterpret_cast<const int4*>(tid) + 2 * g + 1);
  const int4 u0 = __ldg(reinterpret_cast<const int4*>(mtid) + 2 * g);
  const int4 u1 = __ldg(reinterpret_cast<const int4*>(mtid) + 2 * g + 1);
  const uint32_t fw[4] = {f.x, f.y, f.z, f.w};
  const int32_t tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  const int32_t uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const uint32_t fk = (fw[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
    const uint32_t qk = ((k < 4 ? q.x : q.y) >> (8 * (k & 3))) & 0xFFu;
    m[k] = mask_of(lut, fk, qk, tv[k], uv[k]);
  }
}

__global__ void __launch_bounds__(TPB)
flagstat_kernel(const uint16_t* __restrict__ flag,
                const uint8_t* __restrict__ mapq,
                const int32_t* __restrict__ tid,
                const int32_t* __restrict__ mtid, int64_t n, int vec,
                unsigned int* __restrict__ scratch,
                unsigned long long* __restrict__ out) {
  __shared__ uint32_t lut[LUT];
  __shared__ unsigned int acc[32];
  __shared__ unsigned long long sum[TPB / 8][32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 32) acc[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < LUT; i += TPB)
    lut[i] = record_mask(lut_flag(i), 0, 0, 0);
  __syncthreads();

  uint32_t p[PLANES] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t total = 0;  // this lane's drained count of mask bit `lane`
  const int64_t stride = (int64_t)gridDim.x * TPB;
  // work units: groups of 8 records, or single records without alignment
  const int64_t units = vec ? n / VEC : n;
  int steps = 0;
  // whole warps iterate together so every drain sees all 32 lanes
  const int64_t first = (int64_t)blockIdx.x * TPB + warp * 32;
  if (vec) {
    // a lane past the end re-reads the last group (no branch, so all
    // the step's loads go out before its masks) and counts nothing
    for (int64_t base = first; base < units; base += stride) {
      const int64_t u = base + lane;
      uint32_t m[VEC];
      masks8(lut, flag, mapq, tid, mtid, u < units ? u : units - 1, m);
      const uint32_t keep = u < units ? FULL : 0u;
#pragma unroll
      for (int k = 0; k < VEC; ++k) m[k] &= keep;
      add8(p, m);
      if (++steps == VEC_STEPS) {
        total += drain(p, lane);
        steps = 0;
      }
    }
  } else {
    for (int64_t base = first; base < units; base += stride) {
      const int64_t u = base + lane;
      add1(p, u < units ? mask_at(lut, flag, mapq, tid, mtid, u) : 0u);
      if (++steps == SCALAR_STEPS) {
        total += drain(p, lane);
        steps = 0;
      }
    }
  }
  // the n % 8 tail of the vector path: at most 7 records, to the first
  // thread (its planes hold at most 30 x 8 records here)
  if (vec && blockIdx.x == 0 && threadIdx.x == 0)
    for (int64_t i = units * VEC; i < n; ++i)
      add1(p, mask_at(lut, flag, mapq, tid, mtid, i));
  total += drain(p, lane);
  atomicAdd(&acc[lane], total);
  __syncthreads();

  // the block's partials, then a ticket; the last block sums them all
  unsigned int* ticket = scratch;
  unsigned int* partial = scratch + 32;  // 128 B in: 16-byte aligned
  if (threadIdx.x < 32) {
    partial[(int64_t)blockIdx.x * 32 + threadIdx.x] = acc[threadIdx.x];
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials as 16-byte vectors: vector k holds lanes 4 (k % 8) to
  // 4 (k % 8) + 3 of block k / 8, and thread t takes vectors t, t + TPB,
  // ... (TPB a multiple of 8), so always the same four lanes
  const uint4* pv = reinterpret_cast<const uint4*>(partial);
  unsigned long long s4[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int k = threadIdx.x; k < (int)gridDim.x * 8; k += TPB) {
    const uint4 v = __ldcg(pv + k);
    s4[0] += v.x;
    s4[1] += v.y;
    s4[2] += v.z;
    s4[3] += v.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sum[threadIdx.x / 8][4 * (threadIdx.x % 8) + i] = s4[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned long long t = 0;
#pragma unroll
    for (int r = 0; r < TPB / 8; ++r) t += sum[r][threadIdx.x];
    out[threadIdx.x] = t;
    if (threadIdx.x == 0) *ticket = 0;
  }
}

}  // namespace

// flag uint16[n], mapq uint8[n], tid/mtid int32[n]; out int64[16, 2]
// (counter-major: out[2c] QC-pass, out[2c + 1] QC-fail), written (not
// added into).  blocks: ops/flagstat.py::flagstat_plan; scratch: uint32
// [32 + 32 * blocks], zero before the first call (the kernel leaves its
// ticket, scratch[0], at zero again).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int samtpu_flagstat(const void* flag, const void* mapq,
                               const void* tid, const void* mtid, int64_t n,
                               int blocks, void* scratch, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)flag % 16 == 0) && ((uintptr_t)mapq % 8 == 0)
      && ((uintptr_t)tid % 16 == 0) && ((uintptr_t)mtid % 16 == 0);
  flagstat_kernel<<<blocks, TPB, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flag, (const uint8_t*)mapq, (const int32_t*)tid,
      (const int32_t*)mtid, n, vec ? 1 : 0, (unsigned int*)scratch,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
