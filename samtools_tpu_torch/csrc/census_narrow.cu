// K7n census_narrow: the census fetch narrowed on the card before its one
// device->host copy.
//
// Replaces samtools_tpu/ops/mpileup_device.py::_split_jit (:401-420) as
// DeviceCensusPipeline.finish uses it (:855-873): the column maxima of the
// resident int32 census [pad_len, 6] (counts in lanes 0-4, the qual sum in
// lane 5), then each part cast to the smallest lossless type: counts u8
// below 256, u16 below 65,536, else int32; the qual sum u16 below 65,536,
// else int32.  The counts go to the front of one byte buffer, the qual
// sums behind them at the next 4-byte boundary (the bytes between zero),
// so the host fetches one buffer.
//
// What bounds it on the H100: bytes, the census read once (24 B a row)
// and the narrowed copy written once.  The types depend on maxima over
// the whole census, so the cast cannot be known to be right before every
// row has been read.  One cooperative kernel (a block an SM,
// ops/mpileup_device.py::narrow_plan) does both phases around one
// grid-wide barrier:
//
// 1. each block copies the first rows of its contiguous range [r0, r1)
//    (r0 a multiple of 16) into shared memory with 16-byte cp.async
//    loads, as many as its shared memory holds.  The rest streams
//    through a ring of 3 tiles of 2,048 rows behind them (cp.async, two
//    tiles in flight while one is worked on), each tile folded into the
//    maxima.  The maxima fold 16-byte vectors (a row pair is 48 B, three
//    vectors: vector k's qual lane is fixed by k mod 3, no division); one
//    atomicMax per maximum a block;
// 2. after the barrier every block reads the maxima, picks the types
//    (a branch uniform across the grid) and casts its staged rows from
//    shared memory, then the rest, read again through the ring, last
//    tile first (the rows phase 1 read last are the likeliest still in
//    L2).  Counts go out with 16-byte stores (every span starts at a
//    multiple of 16 rows, 80 counts, so 16-byte aligned), qual sums with
//    4-byte stores.  The last block to take a ticket writes the maxima
//    straight into the caller's pinned host memory (one sync and the
//    host reads them: no copy) and resets the scratch.
//
// At the mpileup tool's window (1 Mi rows, 25.2 MB) the census fits the
// 132 SMs' shared memory and is read from HBM once.  At the census core's
// 8 Mi rows about 5% is staged (the ring takes 144 KB of each block's
// shared memory) and the rest is read twice.  Nothing is carried from
// one call to the next but the scratch's zeros.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TPB = 1024;
constexpr int WARPS = TPB / 32;
constexpr int ROW_INTS = 6;
constexpr int ROW_BYTES = 24;
constexpr int ROW_GRAIN = 16;   // a block's rows start at a multiple of 16
constexpr int TILE = 2048;      // rows of a phase-2 tile
constexpr int RING = 3;         // phase-2 tiles in shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;

// scratch int32[3], zero between calls: [0] largest count, [1] largest
// qual sum (both folded with atomicMax), [2] ticket
constexpr int S_CMAX = 0, S_QMAX = 1, S_TICKET = 2;

// the two maxima over 16-byte vector v, vector k of rows that start at a
// row pair: k3 = k mod 3 places the qual lane (ints 4k.. mod 6)
__device__ __forceinline__ void fold(const uint4 v, int k3, int& cm,
                                     int& qm) {
  const int x = (int)v.x, y = (int)v.y, z = (int)v.z, w = (int)v.w;
  cm = max(cm, max(x, z));
  cm = max(cm, k3 == 1 ? 0 : y);
  cm = max(cm, k3 == 2 ? 0 : w);
  qm = max(qm, k3 == 1 ? y : (k3 == 2 ? w : 0));
}

__device__ __forceinline__ int next3(int k3) {
  // (k + TPB) mod 3 from k mod 3; TPB mod 3 == 1
  static_assert(TPB % 3 == 1, "next3 steps by TPB mod 3 == 1");
  return k3 == 2 ? 0 : k3 + 1;
}

__device__ __forceinline__ void cp16(uint4* sm, const uint4* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sm);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [a, a + cnt) of the block's range (a a multiple of 16) into shared
// memory at sm: 16-byte cp.async loads, and the last 8 bytes of an odd
// count (lanes 4 and 5 of its last row) by plain loads and stores
__device__ __forceinline__ void stage_rows(uint4* sm,
                                           const int32_t* __restrict__ g,
                                           int a, int cnt) {
  const uint4* src = reinterpret_cast<const uint4*>(g) + a * 3 / 2;
  const int nv = cnt * 3 / 2;
  for (int k = threadIdx.x; k < nv; k += TPB) cp16(sm + k, src + k);
  if ((cnt & 1) && threadIdx.x == 0) {
    int32_t* si = reinterpret_cast<int32_t*>(sm);
    const int32_t* gr = g + (int64_t)(a + cnt - 1) * ROW_INTS;
    si[(cnt - 1) * ROW_INTS + 4] = __ldg(gr + 4);
    si[(cnt - 1) * ROW_INTS + 5] = __ldg(gr + 5);
  }
}

// rows [r, r + cnt) of the census (r a multiple of 16), in shared memory
// at rows, cast into out
template <typename CT, typename QT>
__device__ void cast_span(const int32_t* __restrict__ rows, int64_t r,
                          int cnt, uint8_t* __restrict__ out,
                          int64_t q_off) {
  constexpr int V = 16 / (int)sizeof(CT);   // counts a 16-byte store
  constexpr int PER_WORD = 4 / (int)sizeof(CT);
  constexpr int BITS = 8 * (int)sizeof(CT);
  constexpr uint32_t MASK = sizeof(CT) == 4 ? 0xFFFFFFFFu
                                            : (1u << BITS) - 1u;
  const int t = threadIdx.x;
  const int elems = 5 * cnt;
  const int nvec = elems / V;
  // counts: span element e is lane e % 5 of row e / 5
  uint4* ov = reinterpret_cast<uint4*>(out + r * 5 * (int64_t)sizeof(CT));
  for (int k = t; k < nvec; k += TPB) {
    const int e = k * V;
    int row = e / 5, lane = e - 5 * (e / 5);
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t v = (uint32_t)rows[row * ROW_INTS + lane] & MASK;
      w[j / PER_WORD] |= v << (BITS * (j % PER_WORD));
      if (++lane == 5) {
        lane = 0;
        ++row;
      }
    }
    ov[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  CT* oc = reinterpret_cast<CT*>(out) + r * 5;
  for (int e = nvec * V + t; e < elems; e += TPB)
    oc[e] = (CT)rows[e / 5 * ROW_INTS + e % 5];
  // qual sums: 4-byte stores (q_off is 4-byte aligned, r even)
  QT* oq = reinterpret_cast<QT*>(out + q_off) + r;
  if (sizeof(QT) == 2) {
    uint32_t* oq2 = reinterpret_cast<uint32_t*>(oq);
    for (int p = t; p < cnt / 2; p += TPB)
      oq2[p] = ((uint32_t)rows[2 * p * ROW_INTS + 5] & 0xFFFFu)
          | ((uint32_t)rows[(2 * p + 1) * ROW_INTS + 5] << 16);
    if ((cnt & 1) && t == 0)
      oq[cnt - 1] = (QT)rows[(cnt - 1) * ROW_INTS + 5];
  } else {
    for (int i = t; i < cnt; i += TPB) oq[i] = (QT)rows[i * ROW_INTS + 5];
  }
}

// the smallest lossless types of counts and qual sums (bytes each), as
// ops/mpileup_device.py::narrow_types picks them
struct Types {
  int cs, qs;
};

__device__ __forceinline__ Types types_of(int cmax, int qmax) {
  return {cmax < 256 ? 1 : cmax < 65536 ? 2 : 4, qmax < 65536 ? 2 : 4};
}

// cast_span with the types chosen at run time (a branch uniform across
// the grid)
__device__ void cast_any(Types ty, const int32_t* __restrict__ rows,
                         int64_t r, int cnt, int64_t wlen,
                         uint8_t* __restrict__ out) {
  const int64_t q_off = (wlen * 5 * ty.cs + 3) & ~(int64_t)3;
  if (ty.cs == 1 && ty.qs == 2)
    cast_span<uint8_t, uint16_t>(rows, r, cnt, out, q_off);
  else if (ty.cs == 1)
    cast_span<uint8_t, int32_t>(rows, r, cnt, out, q_off);
  else if (ty.cs == 2 && ty.qs == 2)
    cast_span<uint16_t, uint16_t>(rows, r, cnt, out, q_off);
  else if (ty.cs == 2)
    cast_span<uint16_t, int32_t>(rows, r, cnt, out, q_off);
  else if (ty.qs == 2)
    cast_span<int32_t, uint16_t>(rows, r, cnt, out, q_off);
  else
    cast_span<int32_t, int32_t>(rows, r, cnt, out, q_off);
}

// the two maxima over cnt rows in shared memory
__device__ __forceinline__ void fold_rows(const uint4* v, int cnt, int& cm,
                                          int& qm) {
  const int nv = cnt * 3 / 2;
  int k3 = threadIdx.x % 3;
  for (int k = threadIdx.x; k < nv; k += TPB) {
    fold(v[k], k3, cm, qm);
    k3 = next3(k3);
  }
  if ((cnt & 1) && threadIdx.x == 0) {
    const int32_t* si = reinterpret_cast<const int32_t*>(v);
    cm = max(cm, si[(cnt - 1) * ROW_INTS + 4]);
    qm = max(qm, si[(cnt - 1) * ROW_INTS + 5]);
  }
}

// the rows [staged, n) of a block through the ring, a tile of TILE rows
// at a time (first to last, or last to first), each loaded by cp.async
// RING - 1 tiles ahead; visit(tile in shared memory, first row, rows)
// runs between two barriers.  Earlier cp.async groups complete before
// the first visit.
template <typename Visit>
__device__ void walk_ring(uint4* ring, const int32_t* __restrict__ g,
                          int n, int staged, bool backward, Visit visit) {
  constexpr int TILE_V = TILE * 3 / 2;
  const int ntiles = (n - staged + TILE - 1) / TILE;
  auto first = [&](int j) {
    return staged + (backward ? ntiles - 1 - j : j) * TILE;
  };
  auto fetch = [&](int j) {
    if (j < ntiles) {
      const int a = first(j);
      stage_rows(ring + (j % RING) * TILE_V, g, a, min(TILE, n - a));
    }
    cp_async_commit();  // one group a tile (empty past the last)
  };
  for (int j = 0; j < RING - 1; ++j) fetch(j);
  for (int j = 0; j < ntiles; ++j) {
    fetch(j + RING - 1);
    cp_async_wait_group<RING - 1>();  // tile j's group is complete
    __syncthreads();
    const int a = first(j);
    visit(ring + (j % RING) * TILE_V, a, min(TILE, n - a));
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TPB, 1)
census_narrow_kernel(const int32_t* __restrict__ census, int64_t wlen,
                     int64_t rows_per_block, int staged_rows,
                     uint8_t* __restrict__ out, int32_t* __restrict__ scratch,
                     int32_t* host_max) {
  extern __shared__ __align__(16) uint4 stage[];
  __shared__ int red[2][WARPS];
  __shared__ int maxima[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int n = (int)(r0 + rows_per_block < wlen ? rows_per_block
                                                  : wlen - r0);
  const int staged = min(n, staged_rows);
  const int32_t* g = census + r0 * ROW_INTS;
  // the ring sits behind the staged rows (staged_rows is a multiple of
  // 16, so 1.5 x staged_rows vectors)
  uint4* ring = stage + staged_rows * 3 / 2;

  // phase 1: stage; the rest through the ring, folded
  stage_rows(stage, g, 0, staged);
  cp_async_commit();
  int cm = 0, qm = 0;
  walk_ring(ring, g, n, staged, false,
            [&](const uint4* tile, int, int cnt) {
              fold_rows(tile, cnt, cm, qm);
            });
  cp_async_wait_group<0>();
  __syncthreads();
  fold_rows(stage, staged, cm, qm);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    cm = max(cm, __shfl_xor_sync(FULL, cm, o));
    qm = max(qm, __shfl_xor_sync(FULL, qm, o));
  }
  if (lane == 0) {
    red[0][warp] = cm;
    red[1][warp] = qm;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < WARPS; ++w) {
      cm = max(cm, red[0][w]);
      qm = max(qm, red[1][w]);
    }
    if (cm) atomicMax(&scratch[S_CMAX], cm);
    if (qm) atomicMax(&scratch[S_QMAX], qm);
  }

  cg::this_grid().sync();

  // phase 2: the maxima; the staged rows cast, then the rest through the
  // ring, last tile first; then a ticket
  if (t == 0) {
    maxima[0] = *(volatile int32_t*)&scratch[S_CMAX];
    maxima[1] = *(volatile int32_t*)&scratch[S_QMAX];
  }
  __syncthreads();
  const int cmax = maxima[0], qmax = maxima[1];
  const Types ty = types_of(cmax, qmax);
  cast_any(ty, reinterpret_cast<const int32_t*>(stage), r0, staged, wlen,
           out);
  walk_ring(ring, g, n, staged, true,
            [&](const uint4* tile, int a, int cnt) {
              cast_any(ty, reinterpret_cast<const int32_t*>(tile), r0 + a,
                       cnt, wlen, out);
            });
  if (r0 + n == wlen) {  // the bytes between the counts and the qual sums
    const int64_t q_off = (wlen * 5 * ty.cs + 3) & ~(int64_t)3;
    for (int64_t x = wlen * 5 * ty.cs + t; x < q_off; x += TPB) out[x] = 0;
  }
  // every block has read the maxima before its ticket: the last one
  // publishes them and resets the scratch
  if (t == 0) {
    __threadfence();
    if (atomicAdd(&scratch[S_TICKET], 1) == (int)gridDim.x - 1) {
      host_max[0] = cmax;
      host_max[1] = qmax;
      scratch[S_CMAX] = 0;
      scratch[S_QMAX] = 0;
      scratch[S_TICKET] = 0;
    }
  }
}

std::atomic<bool> ready[kMaxDevices];

}  // namespace

// out int64[3]: the card's SM count, the dynamic shared memory (bytes) a
// block of the kernel may take, and the bytes of the phase-2 ring (it
// sits behind the staged rows when a block cannot stage all its rows):
// narrow_plan's inputs.  Returns a CUDA error code.
extern "C" int samtpu_census_narrow_limits(int64_t* out) {
  int dev = 0, sms = 0;
  cudaError_t e = allow_smem(census_narrow_kernel, ready);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, census_narrow_kernel);
  out[0] = sms;
  out[1] = e == cudaSuccess ? attr.maxDynamicSharedSizeBytes : 0;
  out[2] = (int64_t)RING * TILE * ROW_BYTES;
  return (int)e;
}

// Rows [0, wlen) of census int32[>= wlen, 6] (16-byte aligned) narrowed
// into out (16-byte aligned, at least wlen * 24 + 16 bytes): counts
// [wlen, 5] at byte 0, qual sums [wlen] at the next 4-byte boundary, the
// types chosen on the card from the maxima, which it writes to host_max
// (int32[2] of pinned host memory: read it after the stream's work is
// done).  The plan (blocks of rows_per_block rows, a multiple of 16, the
// first staged_rows of them, a multiple of 16, staged in shared memory)
// is ops/mpileup_device.py::narrow_plan's.  scratch: int32[3], zero
// before the call and left at zero (reuse it only on the same stream).  A cooperative launch: every block must be
// resident at once.  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for a plan or alignment it does not take.
extern "C" int samtpu_census_narrow(const void* census, int64_t wlen,
                                    int blocks, int64_t rows_per_block,
                                    int staged_rows, void* out,
                                    void* scratch, void* host_max,
                                    void* stream) {
  if (wlen <= 0) return 0;
  if (blocks < 1 || rows_per_block % ROW_GRAIN || staged_rows % ROW_GRAIN
      || staged_rows < 0 || (int64_t)blocks * rows_per_block < wlen
      || (int64_t)(blocks - 1) * rows_per_block >= wlen
      || rows_per_block * 3 / 2 > INT32_MAX
      || (uintptr_t)census % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(census_narrow_kernel, ready);
  void* dev_max = nullptr;
  if (e == cudaSuccess) e = cudaHostGetDevicePointer(&dev_max, host_max, 0);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(TPB);
  cfg.dynamicSmemBytes = (size_t)ROW_BYTES
      * (staged_rows + (staged_rows < rows_per_block ? RING * TILE : 0));
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, census_narrow_kernel, (const int32_t*)census, wlen,
      rows_per_block, staged_rows, (uint8_t*)out, (int32_t*)scratch,
      (int32_t*)dev_max);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}
