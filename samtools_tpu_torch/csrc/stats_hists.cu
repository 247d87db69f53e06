// K12 stats_hists: the per-base histograms of samtools stats on Hopper.
//
// Replaces samtools_tpu/ops/stats_kernels.py::_device_fn (:77-109), five
// XLA scatter-adds over a flat per-base stream (cycle, qual, column,
// order, strand) that the JAX host builds with numpy, and the host pass
// samtpu_stats_orig_hists beside it: one launch takes the reads' bases as
// they lie in the batch and gives the five histograms plus, per read, its
// GC count and qual sum, and the largest qual.
//
// What bounds it on the H100: bytes, 2 B a base (seq and qual) read once,
// 8 B of offset and index and 2 B of order and strand a read, and the
// int64 outputs; at 65,536 reads of 100 bases that is ~17 MB, 5 us at
// 3.35 TB/s.  The operations are two shared atomics a base.
//
// Design (redesigned for the H100; the first form split every read over
// 16-row tiles and paid ~1.5 M global atomics a chunk):
// * Persistent blocks of 1,024 threads, one an SM, grid (row tiles, read
//   groups).  Each block keeps its tile of rt cycle rows of all
//   histograms in shared memory as int32, so 100-base reads need one
//   tile of 104 rows (219 KB).  Reads longer than rt rows (rt <= 104) are
//   cut over the grid's x dimension.  (16-bit cells packed two to a word
//   fit twice the rows, but their shifts and masks made every base's
//   atomics dearer: 8% slower on a chunk of 100-base reads.)
// * The base columns are kept split by order and strand (4 x 6 cells a
//   row): one shared atomic a base gives a1, a2 and the strand-folded ar
//   at the flush, so a base costs two shared atomics (qual, column).
// * A warp takes a contiguous run of its block's reads, one read at a
//   time, lane l the cycles r0 + 32 s + l of it: no two lanes of a warp
//   add to one row.  The run's oidx, offsets, orders and strands are
//   loaded 32 reads at a time, one read per lane, the next 32 while the
//   current ones are counted; each read's bases are loaded into registers
//   while the read before it is counted, so no load waits on another.  (A
//   ring of reads staged into shared memory by cp.async, 2 to 8 reads
//   ahead, timed 30-50% slower on the H100: its bookkeeping, paid by the
//   whole warp for every read, cost more than the waits it saved.)
// * GC count and qual sum are summed with __reduce_add_sync and stored
//   once (with one tile), with no atomic and 0 for a read with no bases;
//   only reads cut over several tiles add them with atomics.
// * At its end a block adds its nonzero cells to the int64 histograms
//   with global atomics: blocks x nonzero cells, independent of reads.
// * Timed on the H100, a chunk of 65,536 100-base reads: 0.029 ms of
//   device time against the first form's 0.077.  Leaving the flush out
//   saves 0.006 ms of it and the shared atomics 0.004: the rest is the
//   warps' per-read and per-step work.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int TPB = 1024;
constexpr int WARPS = TPB / 32;
constexpr int NQ = 257;
constexpr int NC = 6;
// int32 cells of one cycle row: q1 | q2 (257 each), then the base columns
// of (order 1, forward), (order 1, reverse), (order 2, forward), (order
// 2, reverse), 6 each
constexpr int QCELLS = 2 * NQ;
constexpr int ROW_CELLS = QCELLS + 4 * NC;
constexpr int RT_MAX = 104;  // 104 rows x 2,152 B = 219 KB
constexpr int STEPS = (RT_MAX + 31) / 32;
// nt16 code -> column (A, C, G, T, N, other), a nibble each:
// 5 0 1 5 2 5 5 5 3 5 5 5 5 5 5 4
constexpr unsigned long long kColLut = 0x4555555355525105ull;

__device__ __forceinline__ int col_of(int b) {
  return (int)((kColLut >> (4 * (b & 15))) & 15);
}


// a read as the warp's lanes see it: lane l holds read kb + l of a batch
struct Meta {
  int64_t st;
  int len, ord, rv;
};

__device__ __forceinline__ Meta load_meta(const int64_t* __restrict__ seq_off,
                                          const int64_t* __restrict__ oidx,
                                          const uint8_t* __restrict__ order,
                                          const uint8_t* __restrict__ rev,
                                          int64_t k, int64_t kz) {
  Meta m{0, 0, 0, 0};
  if (k < kz) {
    const int64_t i = oidx[k];
    m.st = seq_off[i];
    m.len = (int)(seq_off[i + 1] - m.st);
    m.ord = order[k];
    m.rv = rev[k];
  }
  return m;
}

// read r of a batch, broadcast from lane r
__device__ __forceinline__ Meta read_of(const Meta& m, int r) {
  Meta x;
  x.st = __shfl_sync(0xFFFFFFFFu, m.st, r);
  x.len = __shfl_sync(0xFFFFFFFFu, m.len, r);
  x.ord = __shfl_sync(0xFFFFFFFFu, m.ord, r);
  x.rv = __shfl_sync(0xFFFFFFFFu, m.rv, r);
  return x;
}

// a read's bases at cycles r0 + 32 s + lane below min(len, r0 + rt);
// b = -1 past them
struct Bases {
  int b[STEPS], q[STEPS];
};

__device__ __forceinline__ Bases load_bases(const uint8_t* __restrict__ seq,
                                            const uint8_t* __restrict__ qual,
                                            const Meta& x, int r0, int rt,
                                            int lane) {
  const int hi = min(x.len, r0 + rt);
  Bases y;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int cyc = r0 + 32 * s + lane;
    y.b[s] = -1;
    y.q[s] = 0;
    if (cyc < hi) {
      const int64_t j = x.st + (x.rv ? x.len - 1 - cyc : cyc);
      y.b[s] = seq[j];
      y.q[s] = qual[j];
    }
  }
  return y;
}

__global__ void __launch_bounds__(TPB, 1)
stats_hists_kernel(const uint8_t* __restrict__ seq,
                   const uint8_t* __restrict__ qual,
                   const int64_t* __restrict__ seq_off,
                   const int64_t* __restrict__ oidx,
                   const uint8_t* __restrict__ order,
                   const uint8_t* __restrict__ rev, int64_t no,
                   int64_t per_block, int rt, int split,
                   unsigned long long* __restrict__ q1,
                   unsigned long long* __restrict__ q2,
                   unsigned long long* __restrict__ a1,
                   unsigned long long* __restrict__ a2,
                   unsigned long long* __restrict__ ar,
                   unsigned long long* __restrict__ gc,
                   unsigned long long* __restrict__ qsum,
                   unsigned long long* __restrict__ maxq) {
  extern __shared__ int hist[];  // rt rows of ROW_CELLS
  __shared__ int bmax;
  for (int x = threadIdx.x; x < rt * ROW_CELLS; x += TPB) hist[x] = 0;
  if (threadIdx.x == 0) bmax = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rt;
  const int64_t b0 = (int64_t)blockIdx.y * per_block;
  const int64_t nb = max((int64_t)0, min(no, b0 + per_block) - b0);
  const int64_t per_warp = (nb + WARPS - 1) / WARPS;
  const int64_t ka = b0 + min(nb, warp * per_warp);
  const int64_t kz = b0 + min(nb, (warp + 1) * per_warp);
  int mymax = 0;

  Meta m = load_meta(seq_off, oidx, order, rev, ka + lane, kz);
  for (int64_t kb = ka; kb < kz; kb += 32) {
    const int n = (int)min((int64_t)32, kz - kb);
    const Meta mn = load_meta(seq_off, oidx, order, rev, kb + 32 + lane, kz);
    Meta nx = read_of(m, 0);
    Bases nxt = load_bases(seq, qual, nx, r0, rt, lane);
    for (int r = 0; r < n; ++r) {
      const Meta x = nx;
      const Bases cur = nxt;
      if (r + 1 < n) {
        nx = read_of(m, r + 1);
        nxt = load_bases(seq, qual, nx, r0, rt, lane);
      }
      int g = 0, qs = 0;
      const bool counted = x.ord == 1 || x.ord == 2;
      const int qcell = (x.ord - 1) * NQ;
      const int acell = QCELLS + ((x.ord - 1) * 2 + x.rv) * NC;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int b = cur.b[s];
        if (b >= 0) {
          g += (b == 2) | (b == 4);
          if (counted) {
            const int cell = (32 * s + lane) * ROW_CELLS;
            const int q = cur.q[s];
            atomicAdd(&hist[cell + qcell + q], 1);
            atomicAdd(&hist[cell + acell + col_of(b)], 1);
            qs += q;
            mymax = max(mymax, q);
          }
        }
      }
      g = __reduce_add_sync(0xFFFFFFFFu, g);
      qs = __reduce_add_sync(0xFFFFFFFFu, qs);
      if (lane == 0) {
        const int64_t k = kb + r;
        if (!split) {
          gc[k] = (unsigned long long)g;
          qsum[k] = (unsigned long long)qs;
        } else {
          if (g) atomicAdd(&gc[k], (unsigned long long)g);
          if (qs) atomicAdd(&qsum[k], (unsigned long long)qs);
        }
      }
    }
    m = mn;
  }
  if (mymax) atomicMax(&bmax, mymax);
  __syncthreads();

  // flush: qual cells, then the base columns folded into a1, a2, ar
  for (int x = threadIdx.x; x < rt * QCELLS; x += TPB) {
    const int row = x / QCELLS, c = x - row * QCELLS;
    const int v = hist[row * ROW_CELLS + c];
    if (v) {
      const int w = c >= NQ;
      atomicAdd(&(w ? q2 : q1)[(int64_t)(r0 + row) * NQ + c - w * NQ],
                (unsigned long long)v);
    }
  }
  for (int x = threadIdx.x; x < rt * NC; x += TPB) {
    const int row = x / NC, c = x - row * NC;
    const int base = row * ROW_CELLS + QCELLS;
    const int f1 = hist[base + c], r1 = hist[base + NC + c];
    const int f2 = hist[base + 2 * NC + c], r2 = hist[base + 3 * NC + c];
    const int64_t at = (int64_t)(r0 + row) * NC + c;
    if (f1 + r1) atomicAdd(&a1[at], (unsigned long long)(f1 + r1));
    if (f2 + r2) atomicAdd(&a2[at], (unsigned long long)(f2 + r2));
    if (c < 4) {
      // ar: forward bases as they are, reverse ones complemented
      const int vr = f1 + f2 + hist[base + NC + 3 - c] +
                     hist[base + 3 * NC + 3 - c];
      if (vr) atomicAdd(&ar[at], (unsigned long long)vr);
    }
  }
  if (threadIdx.x == 0 && bmax)
    atomicMax(maxq, (unsigned long long)bmax);
}

}  // namespace

// seq, qual u8[nb]; seq_off int64; oidx int64[no]; order, rev u8[no];
// out int64, the flat output [q1, q2 (qrows x 257) | a1, a2, ar (nbases
// x 6) | maxq (1) | gc, qsum (no)], written whole (the histograms and
// maxq zeroed here, then added into).  The plan (ops/stats_kernels.py
// hists_plan): tiles row tiles of rt rows, groups read groups of
// per_block reads; every selected read is at most max_len <= tiles * rt
// bases long.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a plan the kernel cannot take.
extern "C" int samtpu_stats_hists(const void* seq, const void* qual,
                                  const void* seq_off, const void* oidx,
                                  const void* order, const void* rev,
                                  int64_t no, int nbases, int qrows,
                                  int max_len, int tiles, int rt,
                                  int64_t groups, int64_t per_block,
                                  void* out, void* stream) {
  if (no <= 0 || max_len <= 0) return 0;
  if (rt <= 0 || rt > RT_MAX || (int64_t)tiles * rt < max_len ||
      max_len > nbases || qrows < nbases || per_block <= 0 ||
      groups > 65535 || groups * per_block < no)
    return (int)cudaErrorInvalidValue;
  static std::atomic<bool> ready[kMaxDevices];
  cudaError_t e = allow_smem(stats_hists_kernel, ready);
  if (e != cudaSuccess) return (int)e;
  const int split = tiles > 1;
  const cudaStream_t s = (cudaStream_t)stream;
  // the histograms and maxq; gc and qsum too where tiles add into them
  const int64_t zero = 2 * (int64_t)qrows * NQ + 3 * (int64_t)nbases * NC
                       + 1 + (split ? 2 * no : 0);
  e = cudaMemsetAsync(out, 0, zero * 8, s);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* q1 = (unsigned long long*)out;
  unsigned long long* q2 = q1 + (int64_t)qrows * NQ;
  unsigned long long* a1 = q2 + (int64_t)qrows * NQ;
  unsigned long long* a2 = a1 + (int64_t)nbases * NC;
  unsigned long long* ar = a2 + (int64_t)nbases * NC;
  unsigned long long* maxq = ar + (int64_t)nbases * NC;
  unsigned long long* gc = maxq + 1;
  stats_hists_kernel<<<dim3((unsigned)tiles, (unsigned)groups), TPB,
                       (size_t)rt * ROW_CELLS * 4, s>>>(
      (const uint8_t*)seq, (const uint8_t*)qual, (const int64_t*)seq_off,
      (const int64_t*)oidx, (const uint8_t*)order, (const uint8_t*)rev, no,
      per_block, rt, split, q1, q2, a1, a2, ar, gc, gc + no, maxq);
  return (int)cudaGetLastError();
}
