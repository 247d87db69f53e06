// K10 consensus_segsum: the gap5 column scorer's per-column sums of the
// 15-hypothesis contributions, on Hopper, exact.
//
// Replaces samtools_tpu/ops/consensus_vec.py::_get_dev_segsum (:346-361)
// and gap5_scores_device (:367-399): an XLA gather of T[b6, q, q2, :]
// from gap5_table9 cast to f32 ([6, 101, 101, 15]), a multiply by the keep
// mask and a sorted f32 segment_sum into S[ncols, 15], with the counts of
// kept bases per column and the column depth computed on the host.  Here
// all three come from one pass on the card:
//   S[c, j]      = sum over kept e in [col_off[c], col_off[c+1]), in entry
//                  order, of T[(b6_e * 101 + q_e) * 101 + q2_e, j]  (f64)
//   counts[c, b] = number of kept e with b6_e == b                 (int32)
//   depth[c]     = number of kept e                                (int32)
// An entry is 4 bytes, (b6, q, q2, keep) as uint8, where the JAX device
// function ships 20 (int32 and f32).
//
// Why f64 in entry order: an f32 sum in any other order than the host's
// f64 loop can move a column across a rounding step of the finalization
// (fast_exp's 0.1-wide table steps, the phred and log-odds truncations),
// and the JAX package's risky-column gate (finalize_risky: top-2 gaps and
// two +-eps perturbation patterns) does not catch every such column: on
// 2 Mbp of messy reads at 30x, an f32 column-sum design printed other
// bytes than the host branch.  Summing the f64 table rows one entry after
// another per column, as gap5_scores does, gives its S bit for bit, so the
// finalization needs no gate and no host recompute.
//
// Design: a half-warp per column (two columns per warp).  Lane j < 15 owns
// coordinate j and adds T[row, j] for every kept entry in order (a row is
// 16 doubles, 128 bytes, one coalesced load per entry from the L2-resident
// 7.8 MB table); lanes 0-5 count the kept bases, lane 15 (the row's pad)
// the depth.  The half-warp loads 16 entries at a time, one per lane, and
// broadcasts them with __shfl_sync.  Additions are plain f64 adds (no
// fused multiply-add is involved), in the host's order.
//
// What bounds it on the H100: bytes (4 B per entry, 8 B per column offset,
// 148 B of output per column); the row gathers (128 B per kept entry) come
// from L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HALVES = 16;  // columns per block: 8 warps x 2 half-warps
constexpr int ROW = 16;     // doubles per table row (15 used)

__global__ void __launch_bounds__(HALVES * 16)
consensus_segsum_kernel(const double* __restrict__ T,
                        const uint32_t* __restrict__ ent,
                        const int64_t* __restrict__ col_off, int ncols,
                        double* __restrict__ S, int32_t* __restrict__ counts,
                        int32_t* __restrict__ depth) {
  const int lane = threadIdx.x & 15;
  const int64_t c = (int64_t)blockIdx.x * HALVES + (threadIdx.x >> 4);
  if (c >= ncols) return;  // a whole half-warp leaves together
  const unsigned half = (threadIdx.x & 16) ? 0xFFFF0000u : 0x0000FFFFu;
  const int64_t lo = col_off[c], hi = col_off[c + 1];
  double s = 0.0;
  int cnt = 0;
  for (int64_t base = lo; base < hi; base += 16) {
    const uint32_t mine = base + lane < hi ? ent[base + lane] : 0u;
    const int m = hi - base < 16 ? (int)(hi - base) : 16;
    for (int k = 0; k < m; ++k) {
      const uint32_t v = __shfl_sync(half, mine, k, 16);
      if (v >> 24) {
        const int b6 = v & 0xFF;
        const int q = (v >> 8) & 0xFF, q2 = (v >> 16) & 0xFF;
        const int64_t row = ((int64_t)b6 * 101 + q) * 101 + q2;
        s += __ldg(T + row * ROW + lane);
        cnt += lane < 6 ? (b6 == lane) : (lane == 15);
      }
    }
  }
  if (lane < 15) S[c * 15 + lane] = s;
  if (lane < 6) counts[c * 6 + lane] = cnt;
  if (lane == 15) depth[c] = cnt;
}

}  // namespace

// T float64[6 * 101 * 101, 16], ent uint8[n, 4] (b6, q, q2, keep) in
// column order, col_off int64[ncols + 1]; S float64[ncols, 15], counts
// int32[ncols, 6], depth int32[ncols] (written).  Returns
// cudaGetLastError().
extern "C" int samtpu_consensus_segsum(const void* T, const void* ent,
                                       const void* col_off, void* S,
                                       void* counts, void* depth, int ncols,
                                       void* stream) {
  if (ncols <= 0) return 0;
  const int blocks = (ncols + HALVES - 1) / HALVES;
  consensus_segsum_kernel<<<blocks, HALVES * 16, 0, (cudaStream_t)stream>>>(
      (const double*)T, (const uint32_t*)ent, (const int64_t*)col_off, ncols,
      (double*)S, (int32_t*)counts, (int32_t*)depth);
  return (int)cudaGetLastError();
}
