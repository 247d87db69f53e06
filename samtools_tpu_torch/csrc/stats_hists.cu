// K12 stats_hists: the per-base histograms of samtools stats on Hopper.
//
// Replaces samtools_tpu/ops/stats_kernels.py::_device_fn (:77-109), five
// XLA scatter-adds over a flat per-base stream (cycle, qual, column,
// order, strand) that the JAX host builds with numpy, and the host pass
// samtpu_stats_orig_hists beside it: one launch takes the reads' bases as
// they lie in the batch and gives the five histograms plus, per read, its
// GC count and qual sum, and the largest qual.
//
// The histograms have one row per cycle, and a stats run starts at 300
// rows and grows past the longest read: two [rows, 257] quality matrices
// do not fit one block's shared memory.  So each block owns a tile of R
// cycle rows (blockIdx.x) and a range of reads (blockIdx.y), and keeps
// its tile of all five histograms in shared memory as int32.  A half-warp
// takes one read: lane r of it the base at cycle r0 + r, which is j =
// r0 + r on the forward strand and len - 1 - (r0 + r) on the reverse; no
// two lanes of a warp add to the same row, so shared atomics collide only
// across warps.  The per-read GC count and qual sum are added over the
// half-warp with shuffles and into the read's int64 slots with one atomic
// per tile; at the end each block adds its nonzero shared cells into the
// int64 histograms with global atomics.  Rows at or past max_len take no
// count, so the grid covers ceil(max_len / R) tiles whatever nbases is.
//
// What bounds it on the H100: bytes, 2 B a base (seq and qual) read
// once, plus the per-read arrays; the operations are a few shared
// atomics a base.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 16;            // cycle rows a block owns (a half-warp)
constexpr int TPB = 256;
constexpr int HALVES = TPB / R;  // reads in flight per block
constexpr int NQ = 257;
constexpr int NC = 6;
constexpr int TARGET_BLOCKS = 792;  // 6 blocks of 34 KB per SM, 132 SMs

__constant__ uint8_t kCol[16] = {5, 0, 1, 5, 2, 5, 5, 5,
                                 3, 5, 5, 5, 5, 5, 5, 4};

__global__ void __launch_bounds__(TPB)
stats_hists_kernel(const uint8_t* __restrict__ seq,
                   const uint8_t* __restrict__ qual,
                   const int64_t* __restrict__ seq_off,
                   const int64_t* __restrict__ oidx,
                   const uint8_t* __restrict__ order,
                   const uint8_t* __restrict__ rev, int64_t no,
                   int64_t per_block, int nbases, int qrows,
                   unsigned long long* __restrict__ q1,
                   unsigned long long* __restrict__ q2,
                   unsigned long long* __restrict__ a1,
                   unsigned long long* __restrict__ a2,
                   unsigned long long* __restrict__ ar,
                   unsigned long long* __restrict__ gc,
                   unsigned long long* __restrict__ qsum,
                   unsigned long long* __restrict__ maxq) {
  // [q1 | q2] R x 257 each, then [a1 | a2 | ar] R x 6 each
  __shared__ int hq[2 * R * NQ];
  __shared__ int ha[3 * R * NC];
  __shared__ int bmax;
  for (int x = threadIdx.x; x < 2 * R * NQ; x += TPB) hq[x] = 0;
  for (int x = threadIdx.x; x < 3 * R * NC; x += TPB) ha[x] = 0;
  if (threadIdx.x == 0) bmax = 0;
  __syncthreads();

  const int r0 = blockIdx.x * R;
  const int lr = threadIdx.x & (R - 1);
  const int half = threadIdx.x / R;
  const int row = r0 + lr;
  const int64_t k0 = (int64_t)blockIdx.y * per_block;
  const int64_t k1 = min(no, k0 + per_block);
  int mymax = 0;
  // every half-warp runs the same trip count, so both halves of a warp
  // reach the shuffles together
  for (int64_t kb = k0; kb < k1; kb += HALVES) {
    const int64_t k = kb + half;
    int g = 0, qs = 0;
    if (k < k1) {
      const int64_t i = oidx[k];
      const int64_t s0 = seq_off[i];
      const int len = (int)(seq_off[i + 1] - s0);
      if (row < len) {
        const bool rv = rev[k] != 0;
        const int64_t j = s0 + (rv ? len - 1 - row : row);
        const int b = seq[j];
        g = (b == 2) | (b == 4);
        const int ord = order[k];
        if (ord == 1 || ord == 2) {
          const int q = qual[j];
          const int c = kCol[b & 15];
          atomicAdd(&hq[(ord - 1) * R * NQ + lr * NQ + q], 1);
          atomicAdd(&ha[(ord - 1) * R * NC + lr * NC + c], 1);
          if (c < 4) atomicAdd(&ha[2 * R * NC + lr * NC + (rv ? 3 - c : c)], 1);
          qs = q;
          mymax = max(mymax, q);
        }
      }
    }
#pragma unroll
    for (int o = R / 2; o; o >>= 1) {
      g += __shfl_xor_sync(0xFFFFFFFFu, g, o, R);
      qs += __shfl_xor_sync(0xFFFFFFFFu, qs, o, R);
    }
    if (lr == 0 && k < k1) {
      if (g) atomicAdd(&gc[k], (unsigned long long)g);
      if (qs) atomicAdd(&qsum[k], (unsigned long long)qs);
    }
  }
  if (mymax) atomicMax(&bmax, mymax);
  __syncthreads();

  for (int x = threadIdx.x; x < 2 * R * NQ; x += TPB) {
    const int v = hq[x];
    const int w = x / (R * NQ), cell = x - w * R * NQ;
    if (v && r0 + cell / NQ < qrows)
      atomicAdd(&(w ? q2 : q1)[(int64_t)r0 * NQ + cell],
                (unsigned long long)v);
  }
  for (int x = threadIdx.x; x < 3 * R * NC; x += TPB) {
    const int v = ha[x];
    const int w = x / (R * NC), cell = x - w * R * NC;
    if (v && r0 + cell / NC < nbases)
      atomicAdd(&(w == 0 ? a1 : w == 1 ? a2 : ar)[(int64_t)r0 * NC + cell],
                (unsigned long long)v);
  }
  if (threadIdx.x == 0 && bmax)
    atomicMax(maxq, (unsigned long long)bmax);
}

}  // namespace

// seq, qual u8[nb]; seq_off int64; oidx int64[no]; order, rev u8[no];
// outputs int64, zeroed by the caller and added into: q1, q2 [qrows, 257],
// a1, a2, ar [nbases, 6], gc, qsum [no], maxq [1].  Every selected read
// is at most max_len <= nbases bases long.  Returns cudaGetLastError().
extern "C" int samtpu_stats_hists(const void* seq, const void* qual,
                                  const void* seq_off, const void* oidx,
                                  const void* order, const void* rev,
                                  int64_t no, int nbases, int qrows,
                                  int max_len, void* q1, void* q2, void* a1,
                                  void* a2, void* ar, void* gc, void* qsum,
                                  void* maxq, void* stream) {
  if (no <= 0 || max_len <= 0) return 0;
  const int64_t tiles = (max_len + R - 1) / R;
  int64_t groups = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int64_t most = (no + HALVES - 1) / HALVES;  // >= 16 reads a block
  if (groups > most) groups = most;
  if (groups < 1) groups = 1;
  const int64_t per_block = (no + groups - 1) / groups;
  groups = (no + per_block - 1) / per_block;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  stats_hists_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const uint8_t*)qual, (const int64_t*)seq_off,
      (const int64_t*)oidx, (const uint8_t*)order, (const uint8_t*)rev, no,
      per_block, nbases, qrows, (unsigned long long*)q1,
      (unsigned long long*)q2, (unsigned long long*)a1,
      (unsigned long long*)a2, (unsigned long long*)ar,
      (unsigned long long*)gc, (unsigned long long*)qsum,
      (unsigned long long*)maxq);
  return (int)cudaGetLastError();
}
