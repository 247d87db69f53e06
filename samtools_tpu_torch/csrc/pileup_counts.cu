// K14 pileup_counts: the dense [window, 32] pileup scatter, on Hopper.
//
// Replaces samtools_tpu/ops/pileup_device.py's XLA functions
// pileup_counts (:29), pileup_qual_sums (:44) and pileup_counts_tiled
// (:55), which make_sharded_pileup (:131) runs on every mesh shard.  Each
// item is one aligned base: a window-relative position and a lane
// (nt16 code | reverse << 4).  Two entries:
//
// * pileup_scatter: out[refpos_i, lane_i] += w_i (w = 1, or the base's
//   quality) for every valid item whose position lies in [0, window).  A
//   lane is taken as JAX takes the index of a scatter: a negative lane
//   has 32 added once, and a lane still outside [0, 32) adds nothing.
// * pileup_tiled: items bucketed by tile ([n_tiles, B] blocks, posrel
//   within the tile); out[t * tile + posrel, lane] += 1 for every valid
//   item with posrel in [0, tile) and lane in [0, 32) (the one-hot x
//   one-hot product of the JAX form, which drops a negative lane).
//
// Integer sums are exact in any order, so both equal the JAX f32 sums
// (exact below 2^24 a cell) and the plain PyTorch versions bit for bit.
//
// What bounds it on the H100: bytes (13 or 9 bytes an item read, the
// window's int32 cells written once).  What held the first form (one
// global atomic an item above ~1,800 rows; a tile's items tested a byte
// at a time, a warp's adds serialised on the 1-4 cells of one row) is
// designed away:
//
// * scatter: blocks walk chunks of `chunk` consecutive items (a
//   persistent grid, chunk k on block k mod grid).  Each chunk is staged
//   in shared memory by 16-byte cp.async copies into a ring of RING
//   stages (double-buffered: the next chunk's copies are in flight while
//   this one adds); a block with one chunk loads it straight into
//   registers.  Each thread holds its items of the chunk in registers
//   (IPT: chunk / NT, rounded up to 1, 2, 4 or 8; the kernel is
//   instantiated for each), and the block reduces the lowest and highest row of
//   the chunk's items that add; when those rows fit `budget` rows, the items add with shared atomics
//   into a private [span, 32] accumulator (a cell's lane XOR-ed with its
//   row, so one lane of 32 rows spans the 32 banks), and the block then
//   flushes the nonzero cells with red.global.add; otherwise each item
//   adds with red.global.add.  Items come in read order on every path
//   (a coordinate-sorted BAM), so a chunk spans about chunk / depth + a
//   read length rows and most chunks take the private path.  Thread t
//   takes items t, t + 256, ... of a chunk and merges equal consecutive
//   cells of its own items in registers (two slots), so a pile on one
//   cell costs one add a thread a chunk.  `out` is zeroed by the caller:
//   the flushes add into it.
// * tiled: one block a tile and a shared [tile, 32] accumulator (64 KB
//   at the JAX default tile of 512).  Each thread walks a contiguous run
//   of its tile's items 16 at a time: valid as one 16-byte load (16
//   padded slots skipped at once), posrel and lane as four 16-byte loads
//   each.  Items are sorted by position (bucket_bases), so equal cells
//   come in runs: the two register slots add each run once with its
//   count, and at the end __match_any_sync folds the cells that several
//   lanes of a warp hold.  The block then writes its tile's rows with
//   16-byte stores (no atomics: it owns them), so `out` needs no zero
//   fill.  A tile too large for shared memory zeroes its rows and adds
//   with red.global.add.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "staging.cuh"

namespace {

constexpr int NT = 256;   // threads a block: the scatter
constexpr int TNT = 512;  // the tiled entry
// the scatter's stages: RING - 1 chunks' copies in flight while one adds
constexpr int RING = 2;
// a thread's items of a chunk, at most: chunk <= MAX_IPT * NT
constexpr int MAX_IPT = 8;
constexpr int LANES = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int jax_lane(int lane) {
  if (lane < 0) lane += LANES;
  return lane < LANES ? lane : -1;  // still negative: -1 as well
}

// the word of cell (row, lane) in a shared [rows, 32] accumulator
__device__ __forceinline__ int swz(int row, int lane) {
  return row * LANES + (lane ^ (row & 31));
}

// atomicAdd without a result
__device__ __forceinline__ void red_add(int32_t* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest RING - 2 groups of this thread's copies complete
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
}

// A thread's run merge: two (cell, sum) slots in registers.  An item on
// a slot's cell adds to it; an item on another cell evicts the older
// slot (its sum, if not 0, goes to the sink) and becomes the newer.
struct Runs {
  long long c0 = -1, c1 = -1;
  int n0 = 0, n1 = 0;

  template <typename Sink>
  __device__ __forceinline__ void add(long long c, int w, const Sink& sink) {
    if (c == c0) {
      n0 += w;
    } else if (c == c1) {
      n1 += w;
    } else {
      if (n1) sink(c1, n1);
      c1 = c0;
      n1 = n0;
      c0 = c;
      n0 = w;
    }
  }

  template <typename Sink>
  __device__ __forceinline__ void flush(const Sink& sink) const {
    if (n0) sink(c0, n0);
    if (n1) sink(c1, n1);
  }

  // the two slots with every lane of the warp taking part: the lowest
  // lane holding a cell adds the sum of the warp's slots on it
  template <typename Sink>
  __device__ __forceinline__ void fold(const Sink& sink) const {
    fold_one(c0, n0, sink);
    fold_one(c1, n1, sink);
  }

  template <typename Sink>
  __device__ __forceinline__ static void fold_one(long long c, int n,
                                                  const Sink& sink) {
    const unsigned m = __match_any_sync(FULL, c);
    if (c < 0) return;  // empty slots: a group of their own
    int sum = n;
    if (m & (m - 1)) {  // several lanes on one cell
      sum = 0;
      for (unsigned r = m; r; r &= r - 1)
        sum += __shfl_sync(m, n, __ffs(r) - 1);
    }
    if (sum && (int)(threadIdx.x & 31) == __ffs(m) - 1) sink(c, sum);
  }
};

struct ScatterArgs {
  const int32_t* refpos;
  const int32_t* lane;
  const int32_t* weight;  // null: each item weighs 1
  const uint8_t* valid;
  int64_t n;
  int window, chunk, budget;
  int32_t* out;
};

// A thread's items of a chunk, t + j * NT for j < IPT, from the staged
// chunk or straight from global memory: row, lane (-1: adds nothing) and
// weight in registers; lo/hi take the rows of those that add.
template <int IPT, bool GLOBAL>
__device__ __forceinline__ void load_items(
    const int32_t* rp, const int32_t* ln, const uint8_t* ok,
    const int32_t* wt, int cn, int window, int (&r)[IPT], int (&l)[IPT],
    int (&w)[IPT], int& lo, int& hi) {
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = threadIdx.x + j * NT;
    l[j] = -1;
    if (i >= cn) continue;
    const bool v = GLOBAL ? __ldg(ok + i) : ok[i];
    r[j] = GLOBAL ? __ldg(rp + i) : rp[i];
    const int lj = jax_lane(GLOBAL ? __ldg(ln + i) : ln[i]);
    w[j] = wt ? (GLOBAL ? __ldg(wt + i) : wt[i]) : 1;
    if (v && r[j] >= 0 && r[j] < window && lj >= 0) {
      l[j] = lj;
      lo = min(lo, r[j]);
      hi = max(hi, r[j]);
    }
  }
}

template <int IPT>
__global__ void __launch_bounds__(NT) scatter_chunks(ScatterArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_lo[NT / 32], s_hi[NT / 32];
  const int C = a.chunk, t = threadIdx.x;
  // a stage: refpos, lane, valid[, weight], each with 16 bytes of room
  // for the misalignment copy_span_async keeps
  const int ib = 4 * C + 16, vb = C + 16;
  const int sb = 2 * ib + vb + (a.weight ? ib : 0);
  int32_t* acc = reinterpret_cast<int32_t*>(smem + RING * sb);
  const int64_t nchunks = (a.n + C - 1) / C, G = gridDim.x;
  // several chunks a block: staged through the ring; one: loaded
  // straight into registers (no later chunk to overlap)
  const bool staged = nchunks > G;
  const int mr = (int)((uintptr_t)a.refpos & 15);
  const int ml = (int)((uintptr_t)a.lane & 15);
  const int mv = (int)((uintptr_t)a.valid & 15);
  const int mw = (int)((uintptr_t)a.weight & 15);
  int clean = 0;  // rows [0, clean) of acc hold zeros

  auto stage = [&](int64_t k, int s) {
    uint8_t* b = smem + s * sb;
    const int64_t i0 = k * C;
    const int cn = (int)(a.n - i0 < C ? a.n - i0 : C);
    copy_span_async(b, (const uint8_t*)(a.refpos + i0), 4 * cn, NT);
    copy_span_async(b + ib, (const uint8_t*)(a.lane + i0), 4 * cn, NT);
    copy_span_async(b + 2 * ib, a.valid + i0, cn, NT);
    if (a.weight)
      copy_span_async(b + 2 * ib + vb, (const uint8_t*)(a.weight + i0),
                      4 * cn, NT);
  };

  // chunk blockIdx.x + j * G goes to stage j mod RING, one commit group
  // a chunk; RING - 1 of them in flight ahead of the one that adds
  if (staged)
    for (int j = 0; j < RING - 1; ++j) {
      if (blockIdx.x + j * G < nchunks) stage(blockIdx.x + j * G, j);
      cp_async_commit();
    }
  int s = 0;
  for (int64_t k = blockIdx.x; k < nchunks; k += G, s = (s + 1) % RING) {
    const int64_t i0 = k * C;
    const int cn = (int)(a.n - i0 < C ? a.n - i0 : C);
    int r[IPT], l[IPT], w[IPT];
    int lo = INT_MAX, hi = INT_MIN;
    if (staged) {
      cp_async_wait_ring();
      // every thread is past the chunk before: its stage takes the next
      __syncthreads();
      if (k + (RING - 1) * G < nchunks)
        stage(k + (RING - 1) * G, (s + RING - 1) % RING);
      cp_async_commit();
      const uint8_t* b = smem + s * sb;
      load_items<IPT, false>(
          reinterpret_cast<const int32_t*>(b + mr),
          reinterpret_cast<const int32_t*>(b + ib + ml), b + 2 * ib + mv,
          a.weight ? reinterpret_cast<const int32_t*>(b + 2 * ib + vb + mw)
                   : nullptr,
          cn, a.window, r, l, w, lo, hi);
    } else {
      load_items<IPT, true>(a.refpos + i0, a.lane + i0, a.valid + i0,
                       a.weight ? a.weight + i0 : nullptr, cn, a.window, r,
                       l, w, lo, hi);
    }
    // the chunk's lowest and highest row that adds
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if ((t & 31) == 0) {
      s_lo[t >> 5] = lo;
      s_hi[t >> 5] = hi;
    }
    __syncthreads();
    lo = s_lo[0];
    hi = s_hi[0];
#pragma unroll
    for (int q = 1; q < NT / 32; ++q) {
      lo = min(lo, s_lo[q]);
      hi = max(hi, s_hi[q]);
    }
    if (hi < lo) continue;  // nothing adds

    if (hi - lo < a.budget) {
      const int span = hi - lo + 1;
      if (span > clean) {
        int4* z = reinterpret_cast<int4*>(acc);
        for (int q = clean * (LANES / 4) + t; q < span * (LANES / 4);
             q += NT)
          z[q] = make_int4(0, 0, 0, 0);
        clean = span;
        __syncthreads();
      }
      const auto to_acc = [&](long long c, int v) {
        atomicAdd(acc + c, v);
      };
      Runs runs;
#pragma unroll
      for (int j = 0; j < IPT; ++j)
        if (l[j] >= 0) runs.add(swz(r[j] - lo, l[j]), w[j], to_acc);
      runs.flush(to_acc);
      __syncthreads();
      // the nonzero cells into out, read 4 words at a time (word p of
      // a row holds lane p ^ row & 31), a warp 4 rows; acc back to zeros
      int4* aq = reinterpret_cast<int4*>(acc);
      for (int q = t; q < span * (LANES / 4); q += NT) {
        const int4 v = aq[q];
        if (v.x | v.y | v.z | v.w) {
          const int row = q >> 3, p = ((q & 7) * 4) ^ (row & 31);
          int32_t* o = a.out + (int64_t)(lo + row) * LANES;
          if (v.x) red_add(o + p, v.x);
          if (v.y) red_add(o + (p ^ 1), v.y);
          if (v.z) red_add(o + (p ^ 2), v.z);
          if (v.w) red_add(o + (p ^ 3), v.w);
          aq[q] = make_int4(0, 0, 0, 0);
        }
      }
    } else {
      const auto to_out = [&](long long c, int v) { red_add(a.out + c, v); };
      Runs runs;
#pragma unroll
      for (int j = 0; j < IPT; ++j)
        if (l[j] >= 0) runs.add((long long)r[j] * LANES + l[j], w[j], to_out);
      runs.flush(to_out);
    }
  }
}

// a tile's item (p, l) if it adds
__device__ __forceinline__ bool tiled_ok(int p, int l, int tile) {
  return p >= 0 && p < tile && l >= 0 && l < LANES;
}

template <typename Sink>
__device__ __forceinline__ void tiled_scalar(
    int64_t i, const int32_t* __restrict__ posrel,
    const int32_t* __restrict__ lane, const uint8_t* __restrict__ valid,
    int tile, Runs& runs, const Sink& sink, bool shared) {
  if (!__ldg(valid + i)) return;
  const int p = __ldg(posrel + i), l = __ldg(lane + i);
  if (tiled_ok(p, l, tile))
    runs.add(shared ? swz(p, l) : (long long)p * LANES + l, 1, sink);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int comp(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// SHARED: the tile's [tile, 32] cells in shared memory, written out at
// the end; else zeroed in out and added there
template <bool SHARED>
__global__ void __launch_bounds__(TNT) tiled_tiles(
    const int32_t* __restrict__ posrel, const int32_t* __restrict__ lane,
    const uint8_t* __restrict__ valid, int B, int tile, bool vec,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* acc = reinterpret_cast<int32_t*>(smem);
  const int t = threadIdx.x;
  int32_t* o = out + (int64_t)blockIdx.x * tile * LANES;
  const int64_t quads = (int64_t)tile * (LANES / 4);
  int4* z = SHARED ? reinterpret_cast<int4*>(acc) : reinterpret_cast<int4*>(o);
  for (int64_t q = t; q < quads; q += TNT) z[q] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const auto sink = [&](long long c, int v) {
    if (SHARED)
      atomicAdd(acc + c, v);
    else
      red_add(o + c, v);
  };
  // the tile's items [s, e): whole 16-item groups [ga, gb) (vec: every
  // pointer 16-byte aligned), the items before and after them one by one
  const int64_t s = (int64_t)blockIdx.x * B, e = s + B;
  int64_t a0 = e, b0 = e;
  if (vec) {
    a0 = min64(e, (s + 15) / 16 * 16);
    b0 = e / 16 * 16 > a0 ? e / 16 * 16 : a0;
  }
  Runs runs;
  for (int64_t i = s + t; i < a0; i += TNT)
    tiled_scalar(i, posrel, lane, valid, tile, runs, sink, SHARED);
  const int64_t ga = a0 / 16, G = b0 / 16 - ga;
  const int64_t per = (G + TNT - 1) / TNT;
  const int64_t g_end = min64(ga + G, ga + (t + 1) * per);
  for (int64_t g = ga + t * per; g < g_end; ++g) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(valid) + g);
    if (!(v.x | v.y | v.z | v.w)) continue;  // 16 padded slots
    int4 p[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p[q] = __ldg(reinterpret_cast<const int4*>(posrel) + 4 * g + q);
      l[q] = __ldg(reinterpret_cast<const int4*>(lane) + 4 * g + q);
    }
    const unsigned vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (!((vw[j >> 2] >> (8 * (j & 3))) & 0xFFu)) continue;
      const int pj = comp(p[j >> 2], j & 3), lj = comp(l[j >> 2], j & 3);
      if (tiled_ok(pj, lj, tile))
        runs.add(SHARED ? swz(pj, lj) : (long long)pj * LANES + lj, 1,
                 sink);
    }
  }
  for (int64_t i = b0 + t; i < e; i += TNT)
    tiled_scalar(i, posrel, lane, valid, tile, runs, sink, SHARED);
  runs.fold(sink);
  if (!SHARED) return;
  __syncthreads();
  // the tile's rows with 16-byte stores: the lanes 4q..4q+3 of a row are
  // one aligned quad of acc, permuted by the row's two low bits
  const int4* aq = reinterpret_cast<const int4*>(acc);
  int4* oq = reinterpret_cast<int4*>(o);
  for (int q = t; q < (int)quads; q += TNT) {
    const int row = q >> 3, x = row & 31;
    int4 v = aq[(row * LANES + (((q & 7) * 4) ^ (x & 28))) >> 2];
    if (x & 1) {
      const int a = v.x, b = v.z;
      v.x = v.y; v.y = a; v.z = v.w; v.w = b;
    }
    if (x & 2) {
      const int a = v.x, b = v.y;
      v.x = v.z; v.y = v.w; v.z = a; v.w = b;
    }
    oq[q] = v;
  }
}

// the opt-in shared memory a block and the SM count of each card,
// smem << 32 | sms (0: not read yet)
std::atomic<long long> limits_of[kMaxDevices];

// the current card (kernels.launch makes the tensors' card the current
// one) and its limits, read once a card
cudaError_t device_limits(int* dev, int* smem, int* sms) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  long long got =
      *dev < kMaxDevices ? limits_of[*dev].load(std::memory_order_acquire)
                         : 0;
  if (!got) {
    e = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
    got = (long long)*smem << 32 | (unsigned)*sms;
    if (*dev < kMaxDevices)
      limits_of[*dev].store(got, std::memory_order_release);
  }
  *smem = (int)(got >> 32);
  *sms = (int)(got & 0xFFFFFFFF);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the scatter's kernels by items a thread (1 << index), and for each and
// each card the resident blocks an SM at the shared memory of its last
// launch there: bytes << 32 | blocks (0: none yet; its shared-memory
// attribute is set before the first is stored)
void (*const scatter_kernels[4])(ScatterArgs) = {
    scatter_chunks<1>, scatter_chunks<2>, scatter_chunks<4>,
    scatter_chunks<8>};
std::atomic<long long> scatter_occupancy[4][kMaxDevices];

// blocks of scatter_kernels[which] resident on an SM of card `dev` with
// `bytes` of dynamic shared memory each
cudaError_t scatter_blocks_per_sm(int which, int dev, int bytes,
                                  int* per_sm) {
  std::atomic<long long>* slot =
      dev < kMaxDevices ? &scatter_occupancy[which][dev] : nullptr;
  const long long got = slot ? slot->load(std::memory_order_acquire) : 0;
  if (got && (int)(got >> 32) == bytes) {
    *per_sm = (int)(got & 0xFFFFFFFF);
    return cudaSuccess;
  }
  static std::atomic<bool> ready[4][kMaxDevices];
  cudaError_t e = allow_smem(scatter_kernels[which], ready[which]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, scatter_kernels[which], NT, (size_t)bytes);
  if (e == cudaSuccess && slot)
    slot->store((long long)bytes << 32 | (unsigned)*per_sm,
                std::memory_order_release);
  return e;
}

}  // namespace

// refpos/lane int32[n], weight int32[n] or null (each item weighs 1),
// valid uint8[n] (bool); out int32[window, 32], zeroed by the caller and
// added into.  chunk: items a chunk (a multiple of 16); budget: rows of
// a block's private accumulator (a chunk whose rows span more adds
// through global atomics).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a chunk or budget it does not take.
extern "C" int samtpu_pileup_scatter(const void* refpos, const void* lane,
                                     const void* weight, const void* valid,
                                     int64_t n, int window, int chunk,
                                     int budget, void* out, void* stream) {
  if (chunk <= 0 || chunk % 16 || chunk > MAX_IPT * NT || budget < 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || window <= 0) return 0;
  int dev = 0, smem = 0, sms = 0;
  cudaError_t e = device_limits(&dev, &smem, &sms);
  if (e != cudaSuccess) return (int)e;
  const int64_t ib = 4LL * chunk + 16, vb = chunk + 16;
  const int64_t bytes = RING * (2 * ib + vb + (weight ? ib : 0)) +
                        (int64_t)budget * LANES * 4;
  if (bytes > smem) return (int)cudaErrorInvalidValue;
  int which = 0;  // items a thread: 1 << which
  while ((NT << which) < chunk) ++which;
  int per_sm = 0;
  e = scatter_blocks_per_sm(which, dev, (int)bytes, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const int64_t chunks = (n + chunk - 1) / chunk;
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > chunks) grid = chunks;
  ScatterArgs a{(const int32_t*)refpos, (const int32_t*)lane,
                (const int32_t*)weight, (const uint8_t*)valid, n, window,
                chunk, budget, (int32_t*)out};
  scatter_kernels[which]<<<(unsigned)grid, NT, (size_t)bytes,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// posrel/lane int32[n_tiles, B], valid uint8[n_tiles, B] (bool); out
// int32[n_tiles * tile, 32], every cell written (no zero fill needed).
// Returns cudaGetLastError().
extern "C" int samtpu_pileup_tiled(const void* posrel, const void* lane,
                                   const void* valid, int n_tiles, int B,
                                   int tile, void* out, void* stream) {
  if (n_tiles <= 0 || B <= 0 || tile <= 0) return 0;
  int dev = 0, smem = 0, sms = 0;
  cudaError_t e = device_limits(&dev, &smem, &sms);
  if (e != cudaSuccess) return (int)e;
  const bool vec = aligned16(posrel) && aligned16(lane) && aligned16(valid);
  const int64_t bytes = (int64_t)tile * LANES * 4;
  if (bytes <= smem) {
    static std::atomic<bool> ready[kMaxDevices];
    e = allow_smem(tiled_tiles<true>, ready);
    if (e != cudaSuccess) return (int)e;
    tiled_tiles<true><<<n_tiles, TNT, (size_t)bytes,
                        (cudaStream_t)stream>>>(
        (const int32_t*)posrel, (const int32_t*)lane, (const uint8_t*)valid,
        B, tile, vec, (int32_t*)out);
  } else {
    tiled_tiles<false><<<n_tiles, TNT, 0, (cudaStream_t)stream>>>(
        (const int32_t*)posrel, (const int32_t*)lane, (const uint8_t*)valid,
        B, tile, vec, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
