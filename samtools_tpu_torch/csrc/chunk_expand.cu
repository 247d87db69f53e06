// K6's front, chunk_expand: one chunk's packed host->device buffer parsed
// and its cigars expanded into the inputs of K4, K5 and K1's census form,
// in one launch.
//
// Replaces the front of samtools_tpu/ops/mpileup_device.py::_chunk_jit
// (:152-203 and :215 of chunk_step: the buffer parse, the nt16 -> 0-4
// codes, the device cigar expansion, the reference-window gather, the
// transposed expected diagonals and the bases' reference positions), which
// the port ran as about 25 torch ops (ops/mpileup_device.py::
// chunk_expand_plain).  Input: buf uint8[C, 48 + 2 LQ], a row a read
//   LE i32 pos | LE u16 lead | LE u16 lref | f32 bM | f32 bI |
//   LE u32 cig8[8] | LQ nt16 bases | LQ quals.
// Outputs, as the plain version's: ref_win u8[C, LQ + 8] (the contig's
// codes at clamp(pos - lead + j, 0, ref_len - 1)), sq u8[C, LQ] (through
// the nt16 -> 0-4 table; a byte of 16 or more is 4, as in the JAX
// package), qq u8[C, LQ], cdT i32[LQ, C] (each M base's expected
// diagonal rstart - qstart + lead of its op, 1 << 20 off M), lref
// i32[C], bMv and bIv f32[C] (bit for bit), seg i32[C, LQ] (the M op's
// ordinal, -1 off M), refpos i32[C, LQ] (pos - lead + q + the diagonal,
// 0 off M).  Every sum is int32 and wraps as the plain's do.
//
// What bounds it on the H100: bytes, C x (48 + 2 LQ) read and C x (LQ + 8
// + 2 LQ + 12 LQ + 12) written (116 MB, 0.035 ms, at 65,536 reads of 100
// bases; the contig's bytes under the windows are not counted).  The
// plain version builds [C, 8, LQ] masks and products (210 MB each at that
// chunk) to find, for each base, the one op that holds it.
//
// Design: a block takes 32 reads.  Their 48-byte headers are copied into
// shared memory with byte loads (neighbouring threads on neighbouring
// bytes: a row is 48 + 2 LQ bytes, so for an odd LQ not even 4-byte
// aligned; each thread's six loads are issued before any store), and one
// thread a read walks its 8 cigar words once, as 32-bit words from shared
// memory: each M op's query interval [qstart, qstart + qlen) and diagonal
// go to shared memory, an op that is not M gets an empty interval.  Then
// the block steps through the reads' positions 32 at a time: warp w takes
// reads w, w + 8, w + 16 and w + 24 (the four reads' bases and quals
// loaded first), lane l position q0 + l, so every load of a base or a
// qual and every store of sq, qq, seg and refpos is 32 neighbouring
// elements of one row.  Each base tests the 8 intervals of its read (a
// broadcast from shared memory: the warp's lanes share the read) and
// sums, as the plain does, the diagonals and ordinals of those that hold
// it; nothing of [C, 8, LQ] is built.  cdT is the transpose: the 32 x 32
// tile of diagonals goes through shared memory (rows padded to 33 words,
// no bank conflicts) and leaves as 32 consecutive reads of each position,
// 128 B a store.  Last, the block's reference windows, one span of the
// output, are gathered a byte a thread, four loads in flight before their
// stores.  The kernel is bound by the latency of its loads more than by
// their bytes: each phase issues all its loads before it waits on one,
// which takes registers (58 a thread, four blocks an SM) rather than
// more blocks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HDR = 48;
constexpr int MAXOPS = 8;
constexpr int LREF_PAD = 8;
constexpr int R = 32;    // reads a block
constexpr int QB = 32;   // positions a step: the cdT tile is QB x R
constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int32_t BIGC = 1 << 20;

__global__ void __launch_bounds__(TPB) chunk_expand_kernel(
    const uint8_t* __restrict__ buf, int C, int LQ,
    const uint8_t* __restrict__ ref, int64_t ref_len,
    const uint8_t* __restrict__ table, uint8_t* __restrict__ ref_win,
    uint8_t* __restrict__ sq, uint8_t* __restrict__ qq,
    int32_t* __restrict__ cdT, int32_t* __restrict__ lref,
    uint32_t* __restrict__ bMv, uint32_t* __restrict__ bIv,
    int32_t* __restrict__ seg, int32_t* __restrict__ refpos) {
  static_assert(R * HDR % TPB == 0 && R % WARPS == 0, "block shape");
  constexpr int HDR_PER = R * HDR / TPB;  // header bytes a thread
  constexpr int RPW = R / WARPS;          // reads a warp
  constexpr int U = 4;                    // window bytes in flight
  __shared__ __align__(16) uint8_t hdr[R * HDR];
  __shared__ int32_t q_beg[R][MAXOPS], q_end[R][MAXOPS], diag[R][MAXOPS];
  __shared__ int32_t xbs[R];
  __shared__ int32_t tile[QB][R + 1];
  __shared__ uint8_t tab[16];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, C - r0);
  const int64_t RS = HDR + 2 * (int64_t)LQ;
  const uint8_t* rows = buf + (int64_t)r0 * RS;

  // the headers: every thread's bytes loaded before any is stored
  if (t < 16) tab[t] = table[t];
  {
    uint8_t v[HDR_PER];
#pragma unroll
    for (int u = 0; u < HDR_PER; ++u) {
      const int k = t + u * TPB, r = k / HDR;
      if (r < nr) v[u] = rows[r * RS + (k - r * HDR)];
    }
#pragma unroll
    for (int u = 0; u < HDR_PER; ++u)
      if ((t + u * TPB) / HDR < nr) hdr[t + u * TPB] = v[u];
  }
  __syncthreads();

  // one thread a read: the header fields (little-endian words) and the 8
  // cigar ops
  if (t < nr) {
    const uint32_t* h = reinterpret_cast<const uint32_t*>(hdr + t * HDR);
    const uint32_t lead = h[1] & 0xFFFFu;
    lref[r0 + t] = (int32_t)(h[1] >> 16);
    bMv[r0 + t] = h[2];
    bIv[r0 + t] = h[3];
    xbs[t] = (int32_t)(h[0] - lead);
    uint32_t qstart = 0, rstart = 0;
#pragma unroll
    for (int k = 0; k < MAXOPS; ++k) {
      const uint32_t cig = h[4 + k];
      const uint32_t op = cig & 0xF, ln = cig >> 4;
      const bool m = op == 0 || op == 7 || op == 8;
      const uint32_t qlen = (m || op == 1 || op == 4) ? ln : 0u;
      const uint32_t rlen = (m || op == 2) ? ln : 0u;
      // an op that is not M holds no base: an empty interval
      q_beg[t][k] = m ? (int32_t)qstart : 0;
      q_end[t][k] = m ? (int32_t)(qstart + qlen) : 0;
      diag[t][k] = (int32_t)(rstart - qstart + lead);
      qstart += qlen;
      rstart += rlen;
    }
  }
  __syncthreads();

  // the bases, QB positions a step; a warp's reads' bytes loaded first
  for (int q0 = 0; q0 < LQ; q0 += QB) {
    const int q = q0 + lane;
    uint8_t bv[RPW], qv[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * WARPS;
      if (r < nr && q < LQ) {
        const uint8_t* row = rows + r * RS + HDR;
        bv[i] = row[q];
        qv[i] = row[LQ + q];
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * WARPS;
      if (r >= nr) break;
      int32_t cd_out = BIGC;
      if (q < LQ) {
        uint32_t cdelta = 0;
        int32_t segid = 0;
        bool m = false;
#pragma unroll
        for (int k = 0; k < MAXOPS; ++k) {
          const bool in = q >= q_beg[r][k] && q < q_end[r][k];
          m |= in;
          cdelta += in ? (uint32_t)diag[r][k] : 0u;
          segid += in ? k : 0;
        }
        const int64_t o = (int64_t)(r0 + r) * LQ + q;
        sq[o] = bv[i] < 16 ? tab[bv[i]] : 4;
        qq[o] = qv[i];
        seg[o] = m ? segid : -1;
        refpos[o] = (int32_t)((uint32_t)xbs[r] + (uint32_t)q + cdelta);
        if (m) cd_out = (int32_t)cdelta;
      }
      tile[lane][r] = cd_out;
    }
    __syncthreads();
    for (int j = warp; j < QB && q0 + j < LQ; j += WARPS)
      if (lane < nr) cdT[(int64_t)(q0 + j) * C + r0 + lane] = tile[j][lane];
    __syncthreads();
  }

  // the reference windows: the block's rows of ref_win are one span,
  // U bytes a thread in flight
  const int LRM = LQ + LREF_PAD;
  const int n_win = nr * LRM;
  uint8_t* ow = ref_win + (int64_t)r0 * LRM;
  for (int e0 = t; e0 < n_win; e0 += U * TPB) {
    uint8_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * TPB;
      if (e < n_win) {
        const int r = e / LRM;
        int64_t i = (int32_t)((uint32_t)xbs[r] + (uint32_t)(e - r * LRM));
        i = i < 0 ? 0 : (i > ref_len - 1 ? ref_len - 1 : i);
        v[u] = ref[i];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * TPB < n_win) ow[e0 + u * TPB] = v[u];
  }
}

}  // namespace

// buf uint8[C, 48 + 2 LQ]; ref uint8[ref_len] (0-4 codes); table
// uint8[16] (nt16 -> 0-4); outputs ref_win uint8[C, LQ + 8], sq and qq
// uint8[C, LQ], cdT int32[LQ, C], lref int32[C], bMv and bIv float32[C],
// seg and refpos int32[C, LQ] (4-byte aligned where int32 or float32).
// Returns the launch's CUDA error, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int samtpu_chunk_expand(const void* buf, int C, int LQ,
                                   const void* ref, int64_t ref_len,
                                   const void* table, void* ref_win, void* sq,
                                   void* qq, void* cdT, void* lref, void* bMv,
                                   void* bIv, void* seg, void* refpos,
                                   void* stream) {
  if (C <= 0) return 0;
  if (LQ < 1 || ref_len < 1) return (int)cudaErrorInvalidValue;
  chunk_expand_kernel<<<(C + R - 1) / R, TPB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, C, LQ, (const uint8_t*)ref, ref_len,
      (const uint8_t*)table, (uint8_t*)ref_win, (uint8_t*)sq, (uint8_t*)qq,
      (int32_t*)cdT, (int32_t*)lref, (uint32_t*)bMv, (uint32_t*)bIv,
      (int32_t*)seg, (int32_t*)refpos);
  return (int)cudaGetLastError();
}
