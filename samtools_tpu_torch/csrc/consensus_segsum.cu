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
// What bounds it on the H100: bytes, 4 B an entry, 8 B a column offset and
// 148 B of output a column (0.08 ms for a 1 Mi window of 30x reads); but
// every kept entry also reads its 128-byte table row, 3.85 GB for that
// window.  Rows repeat (308 distinct ones in clean's window, 39 KB), so
// they come from the SM's L1 at ~128 B a clock: about one clock an entry
// an SM, ~0.14 ms for that window, is this design's floor.
//
// Design (redesigned for the H100).  The first form gave a half-warp one
// column and waited on every row (one L2 round trip an entry; a column
// thousands deep paid thousands in a row), and a block lived for 16
// columns, so each column also paid its offsets' and first entries'
// round trips.  Here:
// * A quarter-warp (8 lanes) walks a stream of C consecutive columns in
//   entry order; lane l owns coordinates 2l and 2l + 1 (lane 7: 14 and the
//   row's zero pad) and adds a 16-byte half-row per entry: four entries a
//   warp instruction.  A block holds S streams (8 S threads); the plan
//   (ops/consensus_vec.py segsum_plan) sizes S and C so that about three
//   blocks an SM fill the card: many shallow columns a stream, or one
//   deep column a stream with S down to 8, so that deep columns run side
//   by side.
// * A stream's entries are staged into its ring of RING chunks of CH
//   entries in shared memory by cp.async, RING chunks ahead of the one
//   being added; its column ends are in shared memory too.
// * Entries go 8 at a time, one a lane, each lane decoding its own (row
//   offset, kept-base bits) for the others to shuffle.  The 8 half-rows
//   are loaded into registers (ld.global.nc, through L1) before the first
//   add, so a deep column pays one L1 round trip every 8 entries, not
//   every entry.  A batch inside one column adds them with no branch (an
//   entry not kept adds +0.0 and no count: the sums start at +0.0 and
//   never become -0.0, so the bits are the host's), and counts its bases
//   for all lanes at once (nibble sums over the quarter-warp); a batch
//   that crosses a column end counts entry by entry and writes the column
//   at its last entry.
// * Timed on the H100, a 1 Mi window of 30x reads: 0.42 ms against the
//   first form's 0.77.  A shared-memory row cache (a hash of row ids to
//   slots, filled per window of 8,192 entries) was built and timed first:
//   1.13 ms, its hashing and per-entry decoding costing more than the L2
//   round trips it removed, and the rows fit the L1 anyway.  What is left
//   is the walk itself (decode, shuffles, adds, column writes): with no
//   entry kept it takes as long as the first form.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int LANES = 8;    // a quarter-warp a stream
constexpr int SMIN = 4, SMAX = 32;  // streams a block
constexpr int CMAX = 32;    // columns a stream
constexpr int CH = 64;      // entries a staged chunk (256 bytes)
constexpr int RING = 4;     // chunks a stream has in flight

// an entry (b6, q, q2, keep) as the lanes use it: the row's index in
// half-rows (row * 8) in bits 0-18 and, for a kept entry, bit 19 + b6
// (a base count) and bit 25 (the depth); 0 for an entry not kept.  nib:
// the same counts as nibbles (nibble b6, nibble 6 the depth), for adding
// 8 entries' counts at once
__device__ __forceinline__ uint32_t decode(uint32_t v, uint32_t& nib) {
  nib = 0u;
  if (!(v >> 24)) return 0u;
  const uint32_t b6 = v & 0xFF;
  const uint32_t row =
      (b6 * 101 + ((v >> 8) & 0xFF)) * 101 + ((v >> 16) & 0xFF);
  nib = (1u << (4 * b6)) | (1u << 24);
  return (row * LANES) | (1u << (19 + b6)) | (1u << 25);
}

// lane l's 16 bytes of an entry's table row: row * 128 bytes from the
// lane's own base (T + 16 l), an offset of 32 bits
__device__ __forceinline__ double2 half_row(const char* lane_base,
                                            uint32_t d) {
  return __ldg(reinterpret_cast<const double2*>(
      lane_base + (size_t)((d & 0x7FFFF) << 4)));
}

// lane l < 6 counts the kept bases of b6 == l, lane 6 the depth; bit 26,
// lane 7's, is never set
__device__ __forceinline__ int count_bit(uint32_t d, int l) {
  return (d >> (19 + l)) & 1;
}

// a quarter-warp's stream: its columns [c, cz) (ca its first), their ends
// relative to the stream's first entry (in shared memory, ends[i] the end
// of column ca + i), the sums of the current column
struct Stream {
  int c, cz, ca;
  const int* ends;
  int cend;  // INT_MAX past the last column
  double s0, s1;
  int cnt;
};

// writes the stream's current column (lane l its part), moves to the next
__device__ __forceinline__ void emit(Stream& st, int l,
                                     double* __restrict__ S,
                                     int32_t* __restrict__ counts,
                                     int32_t* __restrict__ depth) {
  const int64_t c = st.c;
  if (l < 7) {
    S[c * 15 + 2 * l] = st.s0;
    S[c * 15 + 2 * l + 1] = st.s1;
  } else {
    S[c * 15 + 14] = st.s0;
  }
  if (l < 6) counts[c * 6 + l] = st.cnt;
  if (l == 6) depth[c] = st.cnt;
  ++st.c;
  st.cend = st.c < st.cz ? st.ends[st.c - st.ca] : INT_MAX;
  st.s0 = st.s1 = 0.0;
  st.cnt = 0;
}

__device__ __forceinline__ void cp16(void* sm, const void* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(sm);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this lane's copies of all but the RING - 1 newest chunks are done
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

// copies chunk j of a stream into its ring slot, lane l its 16-byte parts
// below stop; one commit group a chunk, empty past the last one
__device__ __forceinline__ void issue(uint32_t* ring, const uint8_t* base,
                                      const uint8_t* stop, int j, int chunks,
                                      int l) {
  if (j < chunks) {
#pragma unroll
    for (int h = 0; h < CH * 4 / 16 / LANES; ++h) {
      const uint8_t* src = base + (int64_t)j * CH * 4 + 16 * (h * LANES + l);
      if (src < stop) cp16(ring + (j % RING) * CH + 4 * (h * LANES + l), src);
    }
  }
  commit();
}

// Every lane of a warp runs the same loop trips (the longest stream's of
// its four), so that the shuffles and __syncwarp see the whole warp: a
// shuffle under a partial mask in code the compiler cannot prove
// converged becomes a slow collective loop.
__global__ void __launch_bounds__(SMAX * LANES, 3)
consensus_segsum_kernel(const double* __restrict__ T,
                        const uint32_t* __restrict__ ent,
                        const int64_t* __restrict__ col_off, int ncols, int C,
                        double* __restrict__ S, int32_t* __restrict__ counts,
                        int32_t* __restrict__ depth) {
  // RING chunks of entries a stream, then C column ends a stream
  extern __shared__ __align__(16) uint32_t smem[];
  const int nst = blockDim.x / LANES, qw = threadIdx.x / LANES;
  const int l = threadIdx.x & (LANES - 1);
  const char* lane_base = reinterpret_cast<const char*>(T) + 16 * l;
  // lane l < 6 counts nibble l (bases b6 == l), lane 6 nibble 6 (depth)
  const int nib_shift = 4 * min(l, 6);
  const uint32_t nib_mask = l < 7 ? 15u : 0u;
  uint32_t* ring = smem + qw * RING * CH;
  int* ends = reinterpret_cast<int*>(smem + nst * RING * CH) + qw * C;
  const int64_t stream = (int64_t)blockIdx.x * nst + qw;
  Stream st;
  st.ca = (int)min((int64_t)ncols, stream * C);
  st.cz = min(ncols, st.ca + C);
  st.ends = ends;
  const int64_t sa = __ldg(col_off + st.ca);
  for (int i = l; i < st.cz - st.ca; i += LANES)
    ends[i] = (int)(__ldg(col_off + st.ca + 1 + i) - sa);
  const int len = (int)(__ldg(col_off + st.cz) - sa);
  // the stream's entries as 16-byte aligned chunks of CH entries from
  // base, skew entries before its first one
  const uint8_t* first = reinterpret_cast<const uint8_t*>(ent + sa);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(
      (uintptr_t)first & ~(uintptr_t)15);
  const int skew = (int)(first - base) / 4;
  const uint8_t* stop = reinterpret_cast<const uint8_t*>(
      ((uintptr_t)(ent + sa + len) + 15) & ~(uintptr_t)15);
  const int chunks = len ? (skew + len + CH - 1) / CH : 0;
  const int trips = __reduce_max_sync(0xFFFFFFFFu, chunks);
#pragma unroll
  for (int j = 0; j < RING; ++j) issue(ring, base, stop, j, chunks, l);
  __syncwarp();
  st.c = st.ca;
  st.cend = st.c < st.cz ? ends[0] : INT_MAX;
  st.s0 = st.s1 = 0.0;
  st.cnt = 0;
  for (int j = 0; j < trips; ++j) {
    wait_oldest();
    __syncwarp();
    const uint32_t* slot = ring + (j % RING) * CH;
#pragma unroll 1
    for (int b = 0; b < CH; b += LANES) {
      // entries g .. g + 7 of the stream (g < 0: before its first one)
      const int g = j * CH + b - skew;
      const int at = g + l;
      uint32_t nib = 0u;
      const uint32_t mine =
          at >= 0 && at < len ? decode(slot[b + l], nib) : 0u;
      // the 8 entries' counts, nibble by nibble (at most 8 each)
      nib += __shfl_xor_sync(0xFFFFFFFFu, nib, 1, LANES);
      nib += __shfl_xor_sync(0xFFFFFFFFu, nib, 2, LANES);
      nib += __shfl_xor_sync(0xFFFFFFFFu, nib, 4, LANES);
      uint32_t d[LANES];
      double2 val[LANES];
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        d[k] = __shfl_sync(0xFFFFFFFFu, mine, k, LANES);
        val[k] = d[k] ? half_row(lane_base, d[k]) : make_double2(0.0, 0.0);
      }
      if (g + LANES <= st.cend) {
        // all 8 in the current column, or outside the stream (adding 0)
#pragma unroll
        for (int k = 0; k < LANES; ++k) {
          st.s0 += val[k].x;
          st.s1 += val[k].y;
        }
        st.cnt += (nib >> nib_shift) & nib_mask;
      } else {
#pragma unroll
        for (int k = 0; k < LANES; ++k) {
          while (g + k == st.cend) emit(st, l, S, counts, depth);
          st.s0 += val[k].x;
          st.s1 += val[k].y;
          st.cnt += count_bit(d[k], l);
        }
      }
    }
    // the slot is read: the chunk RING ahead goes into it
    __syncwarp();
    issue(ring, base, stop, j + RING, chunks, l);
  }
  cp_async_wait_all();
  // the stream's last column with entries, then any empty ones after it
  while (st.c < st.cz) emit(st, l, S, counts, depth);
}

}  // namespace

// T float64[6 * 101 * 101, 16], ent uint8[n, 4] (b6, q, q2, keep) in
// column order, col_off int64[ncols + 1]; S float64[ncols, 15], counts
// int32[ncols, 6], depth int32[ncols] (written).  The plan
// (ops/consensus_vec.py segsum_plan): blocks of S streams of C columns.
// ent is 4-byte aligned; the staging copies the 16-byte granules that hold
// a stream's entries, so it reads up to 12 bytes before and after them.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernel cannot take.
extern "C" int samtpu_consensus_segsum(const void* T, const void* ent,
                                       const void* col_off, void* S,
                                       void* counts, void* depth, int ncols,
                                       int streams, int C, int blocks,
                                       void* stream) {
  if (ncols <= 0) return 0;
  if (streams < SMIN || streams > SMAX || (streams & (streams - 1)) ||
      C < 1 || C > CMAX || (int64_t)blocks * streams * C < ncols)
    return (int)cudaErrorInvalidValue;
  // the rings and column ends: up to 36 KB a block; a carveout of 45% of
  // the SM's 228 KB holds three blocks and leaves the L1 the rest for the
  // table rows
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(consensus_segsum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMAX * (RING * CH + CMAX) * 4);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(consensus_segsum_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               45);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  consensus_segsum_kernel<<<blocks, streams * LANES,
                            (size_t)streams * (RING * CH + C) * 4,
                            (cudaStream_t)stream>>>(
      (const double*)T, (const uint32_t*)ent, (const int64_t*)col_off, ncols,
      C, (double*)S, (int32_t*)counts, (int32_t*)depth);
  return (int)cudaGetLastError();
}
