// K4 baq_hmm: the banded glocal pair-HMM of BAQ with its posterior decode,
// batched over reads, on Hopper.
//
// Replaces samtools_tpu/ops/baq_device.py::_probaln_batch (:111-299) with
// _decode_row (:60-99), the XLA device function of the fused chunk step
// (htslib's probaln_glocal under sam_prob_realn).  Band W = 2*BW+1 = 15
// slots; slot j of query row i (1-based) is ref position k = i + j - BW.
//
// What bounds it on the H100: the backward pass needs every forward row,
// and each read is a serial chain of rows.  Kept in device memory, the
// forward trace (fM and fI, 2 x W floats per row, and the row sum) is
// 0.8 GB per 65,536-read chunk of 100 bases, written once and read once.
// Without it, what is left is instruction issue: one thread per read
// gives 65,536 threads, two waves of the card at 8 warps per SM, and each
// thread runs ~2,000 instructions per query row (forward, recompute,
// backward + decode; f32 without fused multiply-adds), so the time is
// about two waves of one warp's instruction stream.
//
// Design: one thread per read, the 15-slot band of M/I/D in registers.
//   * The forward pass keeps only a checkpoint every S rows: the
//     normalized M, I and D of that row (3 x W floats), laid out
//     [NCK][3W][C] with the read index fastest so a warp's stores
//     coalesce, NCK = (LQ-1)/S (row LQ's state stays in registers for the
//     end row): 283 MB a chunk at S = 4, in place of the 0.8 GB trace.
//   * The backward pass walks the S-row segments from the last to the
//     first: it reloads the segment's checkpoint, reruns the segment's
//     forward rows with the same code (a deterministic f32 step gives the
//     same floats from the same state, so the recomputed rows equal a
//     stored trace bit for bit), keeps each row's fM, fI and row sum in
//     shared memory laid out [S][2W+1][threads] (consecutive threads on
//     consecutive banks), then runs the segment's backward rows with the
//     posterior decode fused in.  The recompute adds ~50% arithmetic.
//   * A block's reads are one contiguous span of each [C, L] input (ref
//     window, query, quality); the block copies them into shared memory
//     with 16-byte loads, so the rows need no transposed copies and no
//     device-memory loads but the checkpoints and cdT ([LQ][C], coalesced).
//     Outputs (one byte per base: bq | good << 7) overwrite the query span
//     behind the backward pass and leave as the block's spans of bq and
//     good, coalesced.
//   * Quality -> error probability is a 256-entry table in shared memory,
//     filled once per block with the same powf expression.
//   * Rows whose band lies inside the read's window (all but ~15 a read)
//     take a copy of the row step without the edge masks.
//   * S = 4 and 32 threads a block fit 8 blocks (8 warps) per SM in shared
//     memory, which covers the 2,048 warps of a chunk in two waves; S = 5
//     and 6 fit fewer and need three, S = 3 takes 389 MB of checkpoints.
// The within-row D chain D[j] = x[j] + m8 * D[j-1] is a 15-step serial
// recurrence in the thread, in place of the TPU version's Toeplitz
// matmuls (:160-161, :219, :264).  Arithmetic is f32 throughout (built
// with --fmad=false); reads whose posterior lies within the rounding
// margin of a phred boundary, or whose best state nearly ties, are
// flagged risky and recomputed by the f64 host HMM.
//
// Quirks of the reference that are reproduced, as in the TPU version:
//   * ref codes beyond the read's window length lref are ambiguous (:140-142);
//   * outside the window the ref reads as code 15 (the refp padding, :166);
//   * row 1 has its own initialisation (:188-196);
//   * the forward I transition reads one zero slot past the band (:207-208);
//   * the forward D chain's slot 0 reads its own row's fM (:218);
//   * the end row sums slots j in [1, 2*BW] only (:239-241);
//   * the backward emission is zero at k >= lref (:260);
//   * the backward I transition clamps slot j-1 to 0 at j = 0 (:263).
// Decode: argmax over the M/I-interleaved 2W slots takes the first maximum
// (M_j before I_j, j ascending, strict >); mx2 is the largest value after
// zeroing only the argmax slot; the leak is summed directly, never as
// tot - max; val truncates toward zero; risky only counts on M bases
// (crow < 1<<19).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int BW = 7;
constexpr int W = 2 * BW + 1;
constexpr int S = 4;     // checkpoint stride, rows
constexpr int TPB = 32;  // threads (reads) per block
constexpr int ROW = 2 * W + 1;  // floats of one recomputed row: fM, fI, s
constexpr int NQ = 256;         // error-probability table: every u8 quality

struct Params {
  float m0, m1, m2, m3, m4, m6, m8, sM, EIm1, EIm4;
};

// normalized forward state of one row
struct Band {
  float M[W], I[W], D[W];
};

// what one read's thread reads: its rows of the inputs, staged in shared
// memory
struct Read {
  const uint8_t* ref;    // ref window codes, [LRM]
  const uint8_t* query;  // query codes, [LQ]
  const uint8_t* qual;   // qualities, [LQ]
  const float* qtab;     // quality -> error probability
  int lr, lim;
};

__host__ __device__ constexpr int64_t n_checkpoints(int LQ) {
  return LQ >= 1 ? (LQ - 1) / S : 0;
}

// a block's span of one [C, L] u8 input in shared memory: its TPB rows
// and up to 15 bytes of alignment offset, in 16-byte units
__host__ __device__ constexpr int64_t span_bytes(int L) {
  return ((int64_t)TPB * L + 16 + 15) & ~(int64_t)15;
}

__host__ __device__ constexpr int64_t smem_bytes(int LQ, int LRM) {
  return (int64_t)(NQ + S * ROW * TPB) * 4 + span_bytes(LRM) +
         2 * span_bytes(LQ);
}

__device__ __forceinline__ int ref_code(const Read& r, int idx) {
  return (idx >= 0 && idx < r.lim) ? (int)r.ref[idx] : 15;
}

__device__ __forceinline__ float emis(int r, int q, float ql) {
  const float EM = (float)(1.0 / 3.0);
  if (r > 3 || q > 3) return 1.0f;
  return r == q ? 1.0f - ql : ql * EM;
}

// forward row 1 (its own initialisation); sets R to row 1's ref window
// and p to the normalized row, returns the row sum
__device__ __forceinline__ float fwd_row1(const Read& r, float bM, float bI,
                                          Band& p, int* R) {
  const float EI = 0.25f;
#pragma unroll
  for (int j = 0; j < W; ++j) R[j] = ref_code(r, 1 + j - BW - 1);
  const int q = r.query[0];
  const float ql = r.qtab[r.qual[0]];
  const float fI1 = EI * bI;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = 1 + j - BW;
    const bool m = k >= 1 && k <= r.lr;
    p.M[j] = m ? emis(R[j], q, ql) * bM : 0.0f;
    p.I[j] = m ? fI1 : 0.0f;
    p.D[j] = 0.0f;
    s += p.M[j] + p.I[j];
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    p.M[j] = p.M[j] / s;
    p.I[j] = p.I[j] / s;
  }
  return s;
}

// forward row i >= 2 from row i-1 (p, with R holding row i-1's ref
// window); advances both to row i, returns the row sum.  EDGE: the band
// reaches past the read's window (slots k < 1 or k > lr are zeroed);
// interior rows skip those selects.
template <bool EDGE>
__device__ __forceinline__ float fwd_row(const Read& r, const Params& P,
                                         int i, Band& p, int* R) {
  const float EI = 0.25f;
#pragma unroll
  for (int j = 0; j < W - 1; ++j) R[j] = R[j + 1];
  R[W - 1] = ref_code(r, i + W - 1 - BW - 1);
  const int q = r.query[i - 1];
  const float ql = r.qtab[r.qual[i - 1]];
  float nM[W], nI[W], nD[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = i + j - BW;
    const bool m = !EDGE || (k >= 1 && k <= r.lr);
    const float e = emis(R[j], q, ql);
    const float mm = e * (P.m0 * p.M[j] + P.m3 * p.I[j] + P.m6 * p.D[j]);
    const float pMs = j + 1 < W ? p.M[j + 1] : 0.0f;
    const float pIs = j + 1 < W ? p.I[j + 1] : 0.0f;
    const float ii = EI * (P.m1 * pMs + P.m4 * pIs);
    nM[j] = m ? mm : 0.0f;
    nI[j] = m ? ii : 0.0f;
  }
  float D = 0.0f, s = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = i + j - BW;
    const bool m = !EDGE || (k >= 1 && k <= r.lr);
    const float x = P.m2 * (j == 0 ? nM[0] : nM[j - 1]);
    D = j == 0 ? x : x + P.m8 * D;
    nD[j] = m ? D : 0.0f;
    s += nM[j] + nI[j] + nD[j];
  }
  const float inv = 1.0f / s;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    p.M[j] = nM[j] * inv;
    p.I[j] = nI[j] * inv;
    p.D[j] = nD[j] * inv;
  }
  return s;
}

__device__ __forceinline__ float fwd_step(const Read& r, const Params& P,
                                          int i, Band& p, int* R) {
  return (i <= BW || i + BW > r.lr) ? fwd_row<true>(r, P, i, p, R)
                                    : fwd_row<false>(r, P, i, p, R);
}

// posterior decode of query row i; z over the interleaved 2W slots.
// Returns bq | good << 7 (bq <= 100).
__device__ __forceinline__ uint8_t decode_row(const float* fM, const float* bM,
                                              const float* fI, const float* bI,
                                              int i, int crow, int q,
                                              bool* risky_out) {
  float mx = 0.0f;
  int best = 0;
#pragma unroll
  for (int s = 0; s < 2 * W; ++s) {
    const float z = (s & 1) ? fI[s >> 1] * bI[s >> 1] : fM[s >> 1] * bM[s >> 1];
    if (s == 0 || z > mx) {
      mx = z;
      best = s;
    }
  }
  const float zbest = mx;
  float leak = 0.0f, mx2 = 0.0f;
#pragma unroll
  for (int s = 0; s < 2 * W; ++s) {
    // the best slot counts as 0: adding 0 to the leak (all z >= 0) and
    // taking the max with 0 (mx2 starts at 0) change nothing, so skip it
    const float z = (s & 1) ? fI[s >> 1] * bI[s >> 1]
                            : fM[s >> 1] * bM[s >> 1];
    if (s != best) {
      leak += z;
      mx2 = z > mx2 ? z : mx2;
    }
  }
  const float tot = zbest + leak;
  const float val = -4.343f * (logf(fmaxf(leak, 1e-38f)) -
                               logf(fmaxf(tot, 1e-38f))) + 0.499f;
  int kq = leak > 0.0f ? (int)val : 100;
  const int bq = kq > 100 ? 99 : kq;
  const float fl = floorf(val);
  const float frac = val - fl;
  const bool matters = fl <= (float)q + 1.0f;
  bool risky = (fminf(frac, 1.0f - frac) < 3e-3f && matters) ||
               (mx2 > 0.9997f * zbest);
  *risky_out = risky && crow < (1 << 19);
  const int kbest = best / 2 + i - 1 - BW;
  const int good =
      ((best & 1) == 0 && kbest == crow + (i - 1) && zbest > 0.0f) ? 1 : 0;
  return (uint8_t)(bq | good << 7);
}

// backward row i from row i+1 (nM, nI; R holds the ref codes at 0-based
// index i + j - BW, q1/ql1 the query base and error probability at 0-based
// index i); leaves row i's normalized backward values in nM, nI.  `row`:
// row i's forward sum in shared memory.  EDGE: the band reaches past the
// read's window (no emission at k >= lr; slots k < 1 or k > lr zeroed).
template <bool EDGE>
__device__ __forceinline__ void bwd_row(const Read& r, const Params& P,
                                        int i, const int* R, int q1,
                                        float ql1, const float* row,
                                        float* nM, float* nI) {
  float ee[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = i + j - BW;
    const float e1 = EDGE && k >= r.lr ? 0.0f : emis(R[j], q1, ql1);
    ee[j] = e1 * nM[j];
  }
  float bMr[W], bIr[W];
  float Dn = 0.0f;  // D[j+1] of the backward chain, unmasked
  // loops count up: ptxas left a count-down loop here rolled, its arrays
  // in local memory
#pragma unroll
  for (int jj = 0; jj < W; ++jj) {
    const int j = W - 1 - jj;
    const float nIs = j == 0 ? nI[0] : nI[j - 1];
    bMr[j] = ee[j] * P.m0 + P.EIm1 * nIs + P.m2 * Dn;
    bIr[j] = ee[j] * P.m3 + P.EIm4 * nIs;
    Dn = ee[j] * P.m6 + P.m8 * Dn;
  }
  const float inv = 1.0f / row[2 * W * TPB];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = i + j - BW;
    const bool m = !EDGE || (k >= 1 && k <= r.lr);
    nM[j] = m ? bMr[j] * inv : 0.0f;
    nI[j] = m ? bIr[j] * inv : 0.0f;
  }
}

__device__ __forceinline__ void put_checkpoint(float* ck, int64_t C, int c,
                                               int g, const Band& p) {
  float* at = ck + (int64_t)g * 3 * W * C + c;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    at[j * C] = p.M[j];
    at[(W + j) * C] = p.I[j];
    at[(2 * W + j) * C] = p.D[j];
  }
}

// one read (read c of C): forward with checkpoints, end row, then segment
// by segment the forward recompute into `rows` and the backward + decode.
// Writes row i's bq | good << 7 to out[i-1], which is the read's query row
// (r.query): the backward reads query index i-1 before it writes out[i-1]
// and never reads it again.  Returns whether the read is risky.
__device__ __forceinline__ bool hmm_read(const Read& r, const Params& P,
                                         const int32_t* __restrict__ cdT,
                                         int64_t C, int c, float bM, float bI,
                                         int LQ, float* __restrict__ ck,
                                         float* __restrict__ rows, int t,
                                         uint8_t* out) {
  // ---------------- forward: checkpoints only ----------------
  Band p;
  int R[W];
  float s = fwd_row1(r, bM, bI, p, R);
  if (S == 1 && LQ > 1) put_checkpoint(ck, C, c, 0, p);
  for (int i = 2; i <= LQ; ++i) {
    s = fwd_step(r, P, i, p, R);
    if (i % S == 0 && i < LQ) put_checkpoint(ck, C, c, i / S - 1, p);
  }

  // ---------------- end row ----------------
  // p holds row LQ (normalized); s is its row sum
  float s_end = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = LQ + j - BW;
    const bool m = k >= 1 && k <= r.lr && j >= 1 && j <= 2 * BW;
    const float v = p.M[j] * P.sM + p.I[j] * P.sM;
    s_end += m ? v : 0.0f;
  }
  float nM[W], nI[W];
  const float binit = P.sM / s / s_end;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int k = LQ + j - BW;
    const bool m = k >= 1 && k <= r.lr && j >= 1 && j <= 2 * BW;
    nM[j] = m ? binit : 0.0f;
    nI[j] = nM[j];
  }
  bool rk_any;
  // query index LQ-1 is read again below: out[LQ-1] is written last
  const uint8_t last = decode_row(p.M, nM, p.I, nI, LQ,
                                  cdT[(int64_t)(LQ - 1) * C + c],
                                  r.qual[LQ - 1], &rk_any);

  // ---------------- segments, last to first ----------------
  // q1/qual1: query base and quality at 0-based index i of backward row
  // i, carried in registers from row to row (the query row is overwritten
  // by the outputs behind the backward pass); the first backward row is
  // LQ-1
  int q1 = r.query[LQ - 1], qual1 = r.qual[LQ - 1];
  for (int g = (LQ - 1) / S; g >= 0; --g) {
    const int i0 = g * S + 1;
    const int i1 = min(g * S + S, LQ - 1);  // last row with a backward step
    if (i1 < i0) continue;  // a last segment of row LQ alone
    // forward recompute of rows i0..i1 from the checkpoint of row i0-1
    if (g == 0) {
      s = fwd_row1(r, bM, bI, p, R);
    } else {
      const float* at = ck + (int64_t)(g - 1) * 3 * W * C + c;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        p.M[j] = at[j * C];
        p.I[j] = at[(W + j) * C];
        p.D[j] = at[(2 * W + j) * C];
        R[j] = ref_code(r, (i0 - 1) + j - BW - 1);
      }
    }
    for (int i = i0; i <= i1; ++i) {
      if (i > 1) s = fwd_step(r, P, i, p, R);
      float* row = rows + (i - i0) * ROW * TPB + t;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        row[j * TPB] = p.M[j];
        row[(W + j) * TPB] = p.I[j];
      }
      row[2 * W * TPB] = s;
    }
    // backward + decode of rows i1..i0.  R[j]: ref code at 0-based index
    // i + j - BW for backward row i
#pragma unroll
    for (int j = 0; j < W; ++j) R[j] = ref_code(r, i1 + j - BW);
    for (int i = i1; i >= i0; --i) {
      // index i-1: this row's decode inputs, the next row's emission
      const int q0 = r.query[i - 1], qual0 = r.qual[i - 1];
      const int crow = cdT[(int64_t)(i - 1) * C + c];
      const int ref0 = ref_code(r, i - 1 - BW);
      const float* row = rows + (i - i0) * ROW * TPB + t;
      const float ql1 = r.qtab[qual1];
      if (i <= BW || i + BW >= r.lr)
        bwd_row<true>(r, P, i, R, q1, ql1, row, nM, nI);
      else
        bwd_row<false>(r, P, i, R, q1, ql1, row, nM, nI);
      float fM[W], fI[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        fM[j] = row[j * TPB];
        fI[j] = row[(W + j) * TPB];
      }
      bool rk;
      out[i - 1] = decode_row(fM, nM, fI, nI, i, crow, qual0, &rk);
      rk_any |= rk;
#pragma unroll
      for (int jj = 1; jj < W; ++jj) R[W - jj] = R[W - jj - 1];
      R[0] = ref0;
      q1 = q0;
      qual1 = qual0;
    }
  }
  out[LQ - 1] = last;
  return rk_any;
}

__global__ void __launch_bounds__(TPB) baq_hmm_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const uint8_t* __restrict__ qual, const int32_t* __restrict__ cdT,
    const int32_t* __restrict__ lref, const float* __restrict__ bMv,
    const float* __restrict__ bIv, int C, int LQ, int LRM, Params P,
    float* __restrict__ ck, uint8_t* __restrict__ bq,
    uint8_t* __restrict__ good, uint8_t* __restrict__ risky) {
  extern __shared__ uint4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  float* qtab = sh;                                          // [NQ]
  float* rows = sh + NQ;                                     // [S][ROW][TPB]
  uint8_t* sref = reinterpret_cast<uint8_t*>(rows + S * ROW * TPB);
  uint8_t* squery = sref + span_bytes(LRM);  // then the outputs
  uint8_t* squal = squery + span_bytes(LQ);
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * TPB;
  const int nr = min(TPB, C - c0);
  // the block's reads are one contiguous span of each [C, L] input
  const int mr = load_span(sref, ref + (int64_t)c0 * LRM, nr * LRM, TPB);
  const int mq = load_span(squery, query + (int64_t)c0 * LQ, nr * LQ, TPB);
  const int mu = load_span(squal, qual + (int64_t)c0 * LQ, nr * LQ, TPB);
  for (int k = t; k < NQ; k += TPB) qtab[k] = powf(10.0f, -(float)k / 10.0f);
  __syncthreads();
  if (t < nr) {
    const int c = c0 + t;
    const int lr = lref[c];
    const Read r{sref + mr + t * LRM, squery + mq + t * LQ,
                 squal + mu + t * LQ, qtab, lr, lr < LRM ? lr : LRM};
    risky[c] = hmm_read(r, P, cdT, C, c, bMv[c], bIv[c], LQ, ck, rows, t,
                        squery + mq + t * LQ) ? 1 : 0;
  }
  __syncthreads();
  // the outputs, bq | good << 7 in the query span, out as the block's
  // spans of bq[C, LQ] and good[C, LQ]
  const int n = nr * LQ;
  const int64_t off = (int64_t)c0 * LQ;
  const uint8_t* stage = squery + mq;
  const bool words = (((uintptr_t)stage | (uintptr_t)(bq + off) |
                       (uintptr_t)(good + off)) & 3) == 0;
  const int n4 = words ? n / 4 : 0;
  const uint32_t* st4 = reinterpret_cast<const uint32_t*>(stage);
  uint32_t* bq4 = reinterpret_cast<uint32_t*>(bq + off);
  uint32_t* good4 = reinterpret_cast<uint32_t*>(good + off);
  for (int k = t; k < n4; k += TPB) {
    const uint32_t v = st4[k];
    bq4[k] = v & 0x7F7F7F7Fu;
    good4[k] = (v >> 7) & 0x01010101u;
  }
  for (int k = 4 * n4 + t; k < n; k += TPB) {
    bq[off + k] = stage[k] & 0x7F;
    good[off + k] = stage[k] >> 7;
  }
}

}  // namespace

// Launch geometry for queries of LQ bases (ref windows of LRM) over C
// reads, into out[4]: the checkpoint stride S, threads per block, dynamic
// shared memory bytes per block, and the checkpoint scratch the caller
// allocates (bytes).
extern "C" void samtpu_baq_hmm_layout(int LQ, int LRM, int C, int64_t* out) {
  out[0] = S;
  out[1] = TPB;
  out[2] = smem_bytes(LQ, LRM);
  out[3] = n_checkpoints(LQ) * 3 * W * (int64_t)C * 4;
}

// ref uint8[C, LRM]; query/qual uint8[C, LQ]; cdT int32[LQ, C];
// lref int32[C]; bM/bI float[C]; scratch ck of samtpu_baq_hmm_layout's
// size (float [NCK, 3W, C]); outputs bq/good uint8[C, LQ] (good 0/1),
// risky uint8[C].  m[] holds the transition constants
// m0,m1,m2,m3,m4,m6,m8,sM,EI*m1,EI*m4, each computed in double and
// rounded to float by the caller.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a band other than 2*7+1.
extern "C" int samtpu_baq_hmm(const void* ref, const void* query,
                              const void* qual, const void* cdT,
                              const void* lref, const void* bM,
                              const void* bI, int C, int LQ, int LRM, int bw,
                              const float* m, void* ck, void* bq, void* good,
                              void* risky, void* stream) {
  if (bw != BW) return (int)cudaErrorInvalidValue;
  if (C <= 0 || LQ <= 0) return 0;
  Params P{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9]};
  const int64_t smem = smem_bytes(LQ, LRM);
  static std::atomic<bool> ready[kMaxDevices];
  const cudaError_t e = allow_smem(baq_hmm_kernel, ready);
  if (e != cudaSuccess) return (int)e;
  baq_hmm_kernel<<<(C + TPB - 1) / TPB, TPB, (size_t)smem,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)ref, (const uint8_t*)query, (const uint8_t*)qual,
      (const int32_t*)cdT, (const int32_t*)lref, (const float*)bM,
      (const float*)bI, C, LQ, LRM, P, (float*)ck, (uint8_t*)bq,
      (uint8_t*)good, (uint8_t*)risky);
  return (int)cudaGetLastError();
}
