"""K11 (flagstat) and K7n (census_narrow) alone on one CUDA card, at
their main-path shapes, beside the forms they had before their redesign,
without the rest of chip_smoke.py.

    python3 scripts/torch_flagstat_narrow_kernels.py [--variants]
        [--out PATH.json]

K11 runs on 2,516,582 records (clean's reads, 8 Mbp x 30x) and on one
``flagstat`` stream batch of 360,000; K7n on a census of 1 Mi rows (the
mpileup tool's window) and of 8 Mi rows (the census core's), as a clean
30x run fills them.  Each is held against its plain version, and timed:
``ms`` (single calls, the wrapper's host time included), ``b2b_ms``
(back to back) and ``device_ms`` (a CUDA graph of bare C-entry calls on
preallocated outputs; for K7n without the host's read of the maxima).

``OLD_CU`` below is a copy of the earlier forms: the ballot K11 (a warp
adds 32 records' masks with 32 ballots; 64-bit global atomics at the
end) and the two-pass K7n (a max pass and a cast pass, the host reading
the maxima between them).  It is built with nvcc into
``_build/others/`` and timed on the same inputs in the same process
(chip_smoke.py does the same through ``old_lib``, ``k11_old`` and
``k7n_old``).  ``--variants``: the current and the old sources patched
as ``VARIANTS`` lists (a part of the work left out), timed by
``device_ms`` only (a variant's output is not checked).  The JSON goes to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import kernel_timing as kt  # noqa: E402

# K11 and K7n as they were before their redesign, their entry points
# renamed
OLD_CU = r"""#include <cuda_runtime.h>

#include <cstdint>

namespace k11_ballot {

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

}  // namespace k11_ballot

// flag uint16[n], mapq uint8[n], tid/mtid int32[n]; out int64[16, 2]
// (counter-major: out[2c] QC-pass, out[2c + 1] QC-fail), added into.
// Returns cudaGetLastError().
extern "C" int samtpu_flagstat_ballot(const void* flag, const void* mapq,
                                      const void* tid, const void* mtid,
                                      int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + k11_ballot::TPB - 1) / k11_ballot::TPB;
  if (blocks > k11_ballot::MAX_BLOCKS) blocks = k11_ballot::MAX_BLOCKS;
  k11_ballot::flagstat_kernel<<<(int)blocks, k11_ballot::TPB, 0,
                                (cudaStream_t)stream>>>(
      (const uint16_t*)flag, (const uint8_t*)mapq, (const int32_t*)tid,
      (const int32_t*)mtid, n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

namespace k7n_two_pass {

constexpr int TPB = 256;
constexpr int MAX_BLOCKS = 1056;  // 8 per SM on the H100's 132 SMs

__global__ void __launch_bounds__(TPB)
census_max_kernel(const int32_t* __restrict__ c, int64_t n,
                  int32_t* __restrict__ out) {
  int cm = 0, qm = 0;
  const int64_t stride = (int64_t)gridDim.x * TPB;
  for (int64_t x = (int64_t)blockIdx.x * TPB + threadIdx.x; x < n * 6;
       x += stride) {
    const int v = c[x];
    if (x % 6 == 5)
      qm = max(qm, v);
    else
      cm = max(cm, v);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    cm = max(cm, __shfl_xor_sync(0xFFFFFFFFu, cm, o));
    qm = max(qm, __shfl_xor_sync(0xFFFFFFFFu, qm, o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (cm) atomicMax(&out[0], cm);
    if (qm) atomicMax(&out[1], qm);
  }
}

template <typename CT, typename QT>
__global__ void __launch_bounds__(TPB)
census_cast_kernel(const int32_t* __restrict__ c, int64_t n,
                   uint8_t* __restrict__ out, int64_t q_off) {
  CT* counts = reinterpret_cast<CT*>(out);
  QT* qsum = reinterpret_cast<QT*>(out + q_off);
  // the 0-3 bytes between the counts and the qual sums read as zero
  const int64_t pad0 = n * 5 * (int64_t)sizeof(CT);
  if (blockIdx.x == 0 && pad0 + threadIdx.x < q_off)
    out[pad0 + threadIdx.x] = 0;
  const int64_t stride = (int64_t)gridDim.x * TPB;
  for (int64_t r = (int64_t)blockIdx.x * TPB + threadIdx.x; r < n;
       r += stride) {
    const int32_t* row = c + r * 6;
#pragma unroll
    for (int k = 0; k < 5; ++k) counts[r * 5 + k] = (CT)row[k];
    qsum[r] = (QT)row[5];
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + TPB - 1) / TPB;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return b < 1 ? 1 : (int)b;
}

template <typename CT>
void cast_q(const int32_t* c, int64_t n, uint8_t* out, int64_t q_off,
            int qsize, cudaStream_t s) {
  if (qsize == 2)
    census_cast_kernel<CT, uint16_t>
        <<<blocks_for(n), TPB, 0, s>>>(c, n, out, q_off);
  else
    census_cast_kernel<CT, int32_t>
        <<<blocks_for(n), TPB, 0, s>>>(c, n, out, q_off);
}

}  // namespace k7n_two_pass

// census int32[>= n, 6]; out int32[2], zeroed by the caller: the largest
// count (lanes 0-4) and the largest qual sum (lane 5) of rows [0, n).
// Returns cudaGetLastError().
extern "C" int samtpu_census_max_two_pass(const void* census, int64_t n,
                                          void* out, void* stream) {
  if (n <= 0) return 0;
  k7n_two_pass::census_max_kernel<<<k7n_two_pass::blocks_for(n * 6),
                                    k7n_two_pass::TPB, 0,
                                    (cudaStream_t)stream>>>(
      (const int32_t*)census, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Rows [0, n) of census int32[>= n, 6] into out: counts [n, 5] of csize
// bytes each (1: u8, 2: u16, 4: int32) at byte 0, qual sums [n] of qsize
// bytes (2: u16, 4: int32) at byte q_off.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a size it does not take.
extern "C" int samtpu_census_cast_two_pass(const void* census, int64_t n,
                                           int csize, int qsize, void* out,
                                           int64_t q_off, void* stream) {
  if ((csize != 1 && csize != 2 && csize != 4) || (qsize != 2 && qsize != 4)
      || q_off % 4)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int32_t* c = (const int32_t*)census;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (csize == 1)
    k7n_two_pass::cast_q<uint8_t>(c, n, o, q_off, qsize, s);
  else if (csize == 2)
    k7n_two_pass::cast_q<uint16_t>(c, n, o, q_off, qsize, s);
  else
    k7n_two_pass::cast_q<int32_t>(c, n, o, q_off, qsize, s);
  return (int)cudaGetLastError();
}
"""

# name -> (source: a csrc/ file or "old", [(text, replacement), ...]);
# each text must occur in the source
VARIANTS = {
    "k11_no_final_sum": ("flagstat.cu", [
        ("last = atomicAdd(ticket, 1u) == gridDim.x - 1;", "last = false;")]),
    "k11_loads_only": ("flagstat.cu", [
        ("    m[k] = mask_of(lut, fk, qk, tv[k], uv[k]);",
         "    m[k] = fk ^ qk ^ (uint32_t)tv[k] ^ (uint32_t)uv[k];"),
        ("      add8(p, m);",
         "      p[0] ^= m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4] ^ m[5] ^ m[6] "
         "^ m[7];")]),
    "k11_ballot_no_atomics": ("old", [
        ("    atomicAdd(&out[threadIdx.x], (unsigned long long)acc[threadIdx.x]);",
         "    out[threadIdx.x] = acc[threadIdx.x];")]),
    "k11_ballot_loads_only": ("old", [
        ("i < n ? record_mask(flag[i], mapq[i], tid[i], mtid[i]) : 0u;",
         "i < n ? flag[i] ^ mapq[i] ^ tid[i] ^ mtid[i] : 0u;"),
        ("    for (int b = 0; b < 32; ++b) {\n"
         "      const unsigned int c = __popc(__ballot_sync(0xFFFFFFFFu, (m >> b) & 1u));\n"
         "      if (lane == b) mine += c;",
         "    for (int b = 0; b < 1; ++b) {\n      mine += m;")]),
    "k7n_phase2_forward": ("census_narrow.cu", [
        ("  walk_ring(ring, g, n, staged, true,",
         "  walk_ring(ring, g, n, staged, false,")]),
    "k7n_ring_4x1024": ("census_narrow.cu", [
        ("constexpr int TILE = 2048;", "constexpr int TILE = 1024;"),
        ("constexpr int RING = 3;", "constexpr int RING = 4;")]),
    "k7n_ring_2x4096": ("census_narrow.cu", [
        ("constexpr int TILE = 2048;", "constexpr int TILE = 4096;"),
        ("constexpr int RING = 3;", "constexpr int RING = 2;")]),
    "k7n_phase1_only": ("census_narrow.cu", [
        ("  cg::this_grid().sync();\n",
         "  cg::this_grid().sync();\n  if (staged_rows >= 0) return;\n")]),
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
OLD_SIGNATURES = {
    "samtpu_flagstat_ballot": [_P, _P, _P, _P, _L, _P, _P],
    "samtpu_census_max_two_pass": [_P, _L, _P, _P],
    "samtpu_census_cast_two_pass": [_P, _L, _I, _I, _P, _L, _P],
}


def _nvcc_lib(name: str, text: str):
    """``text`` built with the port's nvcc flags into
    ``_build/others/lib<name>-<hash>.so``, loaded."""
    from samtools_tpu_torch import build
    out = os.path.join(build.BUILD_DIR, "others")
    os.makedirs(out, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    lib = os.path.join(out, f"lib{name}-{tag}.so")
    if not os.path.exists(lib):
        cu = os.path.join(out, f"{name}-{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        subprocess.run([build._nvcc(), *[f for f in build.NVCC_FLAGS
                                         if f not in ("-Xptxas", "-v")],
                        "-shared", "-I", os.path.join(build.ROOT, "csrc"),
                        "-o", lib, cu], check=True)
    return ctypes.CDLL(lib)


def old_lib():
    """``OLD_CU`` built and loaded, its entry points typed."""
    L = _nvcc_lib("old_k11_k7n", OLD_CU)
    for name, args in OLD_SIGNATURES.items():
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return L


def variant_fn(name: str):
    """VARIANTS[name] built and loaded: its entry point, typed as the
    source's."""
    from samtools_tpu_torch import build, kernels
    src, patches = VARIANTS[name]
    if src == "old":
        text = OLD_CU
    else:
        with open(os.path.join(build.ROOT, "csrc", src)) as f:
            text = f.read()
    for old, new in patches:
        assert old in text, (name, old)
        text = text.replace(old, new)
    L = _nvcc_lib(name, text)
    if src == "old":
        entry, args = "samtpu_flagstat_ballot", OLD_SIGNATURES[
            "samtpu_flagstat_ballot"]
    else:
        entry = {"flagstat.cu": "samtpu_flagstat",
                 "census_narrow.cu": "samtpu_census_narrow"}[src]
        args = kernels._SIGNATURES[entry]
    fn = getattr(L, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = args
    if src == "census_narrow.cu":
        # the variant's own SM count, shared memory and ring for its plan
        out = (ctypes.c_int64 * 3)()
        L.samtpu_census_narrow_limits.argtypes = [
            ctypes.POINTER(ctypes.c_int64)]
        kt.require(L.samtpu_census_narrow_limits(out) == 0,
                   f"{name}: limits query failed")
        fn.limits = tuple(out)
    return fn


def k11_bare(args, fn=None, per_sm=None):
    """A call of K11's C entry point (``fn``: a variant's) on ``args``
    with preallocated output and scratch (``per_sm``: blocks an SM, the
    plan's by default): no wrapper, no count."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import flagstat as fs
    dev = args[0].device
    n = args[0].numel()
    sms = kernels.sm_count(dev)
    out = torch.empty(fs.N_COUNTERS, 2, dtype=torch.int64, device=dev)
    per_sm = per_sm or fs.BLOCKS_PER_SM
    sc = torch.zeros(32 + 32 * sms * per_sm, dtype=torch.int32, device=dev)
    fn = fn or getattr(kernels._load(), "samtpu_flagstat")
    ptrs = [a.data_ptr() for a in args]
    plan = fs.flagstat_plan(n, sms * per_sm // fs.BLOCKS_PER_SM)

    def bare():
        return fn(*ptrs, n, plan, sc.data_ptr(), out.data_ptr(),
                  kernels.stream_of(out))
    bare.keep = (out, sc)
    return bare


def k7n_bare(census, wlen: int, fn=None, staged=None):
    """A call of K7n's C entry point (``fn``: a variant's; ``staged``:
    rows a block stages, the plan's by default) on preallocated output and
    scratch: the cooperative kernel alone, no read of the maxima."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import mpileup_device as md
    dev = census.device
    sms, smem, ring = getattr(fn, "limits", None) or md._narrow_limits(dev)
    blocks, rows, st = md.narrow_plan(wlen, sms, smem, ring)
    buf = torch.empty(wlen * md.ROW_BYTES + 16, dtype=torch.uint8,
                      device=dev)
    sc = torch.zeros(3, dtype=torch.int32, device=dev)
    host_max = torch.zeros(2, dtype=torch.int32, pin_memory=True)
    fn = fn or getattr(kernels._load(), "samtpu_census_narrow")

    def bare():
        return fn(census.data_ptr(), wlen, blocks, rows,
                  st if staged is None else staged, buf.data_ptr(),
                  sc.data_ptr(), host_max.data_ptr(),
                  kernels.stream_of(buf))
    bare.keep = (buf, sc, host_max)
    return bare


def k11_old(L, args, want) -> dict:
    """The ballot K11 on ``args``: equal to ``want``, its times (``ms`` and
    ``b2b_ms`` through a copy of its wrapper: the argument checks, a
    zeroed out, the launch; ``device_ms`` the kernel alone)."""
    import torch
    from samtools_tpu_torch import kernels
    n = args[0].numel()
    out = torch.zeros(16, 2, dtype=torch.int64, device=args[0].device)
    ptrs = [a.data_ptr() for a in args]

    def kernel():
        return L.samtpu_flagstat_ballot(*ptrs, n, out.data_ptr(),
                                        kernels.stream_of(out))

    def call():
        flag, mapq, tid, mtid = args
        kernels.check(flag, "flag", torch.uint16, (n,))
        kernels.check(mapq, "mapq", torch.uint8, (n,))
        kernels.check(tid, "tid", torch.int32, (n,))
        kernels.check(mtid, "mtid", torch.int32, (n,))
        kernels.on_card(flag, mapq, tid, mtid)
        got = torch.zeros(16, 2, dtype=torch.int64, device=flag.device)
        if L.samtpu_flagstat_ballot(flag.data_ptr(), mapq.data_ptr(),
                                    tid.data_ptr(), mtid.data_ptr(), n,
                                    got.data_ptr(), kernels.stream_of(flag)):
            raise RuntimeError("the ballot K11 failed")
        return got
    kt.require(torch.equal(call(), want), "the ballot K11 differs")
    kt.require(kernel() == 0, "the ballot K11 failed")
    return {"ms": kt.cuda_ms(call), "b2b_ms": kt.cuda_ms(call, per=10),
            "device_ms": kt.graph_ms(kernel)}


def k7n_old(L, census, wlen: int, want) -> dict:
    """The two-pass K7n on rows [0, wlen) of ``census``: its max pass, the
    host's read of the maxima, its cast pass; equal to ``want`` (buffer,
    types), its times (``device_ms``: the two passes alone, the types
    fixed)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import mpileup_device as md
    dev = census.device
    mx = torch.zeros(2, dtype=torch.int32, device=dev)

    def call():
        stream = kernels.stream_of(census)
        mx.zero_()
        L.samtpu_census_max_two_pass(census.data_ptr(), wlen, mx.data_ptr(),
                                stream)
        cdt, qdt = md.narrow_types(*mx.tolist())
        q_off, end = md._narrow_offsets(wlen, cdt, qdt)
        buf = torch.empty(end, dtype=torch.uint8, device=dev)
        L.samtpu_census_cast_two_pass(census.data_ptr(), wlen, cdt.itemsize,
                                 qdt.itemsize, buf.data_ptr(), q_off,
                                 stream)
        return buf, cdt, qdt
    got = call()
    torch.cuda.synchronize()
    kt.require(got[1:] == want[1:] and torch.equal(got[0], want[0]),
               "the two-pass K7n differs")
    cdt, qdt = got[1], got[2]
    q_off, end = md._narrow_offsets(wlen, cdt, qdt)
    buf = torch.empty(end, dtype=torch.uint8, device=dev)

    def passes():
        stream = kernels.stream_of(census)
        L.samtpu_census_max_two_pass(census.data_ptr(), wlen, mx.data_ptr(),
                                stream)
        L.samtpu_census_cast_two_pass(census.data_ptr(), wlen, cdt.itemsize,
                                 qdt.itemsize, buf.data_ptr(), q_off,
                                 stream)
    return {"ms": kt.cuda_ms(call), "b2b_ms": kt.cuda_ms(call, per=10),
            "device_ms": kt.graph_ms(passes)}


def host_us(fn, calls: int = 200) -> float:
    """Wall microseconds of one call of ``fn`` followed by a sync of the
    card, the median of 5 runs of ``calls`` calls: what a caller waits."""
    import statistics
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        got.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(got)


def k7n_host(census, wlen: int) -> dict:
    """Where a K7n call's wall goes: the wrapper, against the bare launch
    and a sync; and what allocating a pinned int32[2] for each call's
    maxima would cost (host wall and CUDA-event time)."""
    from samtools_tpu_torch.ops import mpileup_device as md
    import torch

    def pinned():
        return torch.empty(2, dtype=torch.int32, pin_memory=True)
    return {"wrapper_us": host_us(lambda: md.census_narrow(census, wlen)),
            "bare_sync_us": host_us(k7n_bare(census, wlen)),
            "pinned_int32x2_us": host_us(pinned),
            "pinned_int32x2_ms": kt.cuda_ms(pinned)}


def clean_flags(n: int, seed: int):
    """K11's inputs for ``n`` single-end reads as clean's BAM holds them
    (forward or reverse, mapped, mapq 60, one contig), on the card."""
    import torch
    rng = np.random.default_rng(seed)
    cols = (np.where(rng.random(n) < 0.5, 16, 0).astype(np.uint16),
            np.full(n, 60, np.uint8), np.zeros(n, np.int32),
            np.full(n, -1, np.int32))
    return [torch.from_numpy(c).to("cuda") for c in cols]


def clean_census(rows: int, seed: int):
    """An int32 [rows, 6] census as 30x of 100-base reads fill it: ~30
    bases a row on the reference's base, a few others, qual sums of
    ~33 a base; on the card."""
    import torch
    rng = np.random.default_rng(seed)
    c = np.zeros((rows, 6), np.int32)
    ref = rng.integers(0, 4, rows)
    c[np.arange(rows), ref] = rng.poisson(30, rows)
    c[:, 4] = rng.poisson(0.3, rows)
    c[:, 5] = c[:, :5].sum(1) * 33
    return torch.from_numpy(c).to("cuda")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from samtools_tpu_torch import build, kernels
    from samtools_tpu_torch.ops import flagstat as fs
    from samtools_tpu_torch.ops import mpileup_device as md
    build.build(("cuda",))
    with open(build.lib_path("cuda")[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "flagstat" in ln
                 or "census_narrow" in ln or "registers" in ln
                 or "spill" in ln]
    L = old_lib()
    fns = {v: variant_fn(v) for v in VARIANTS} if a.variants else {}
    res = {"ptxas": ptxas, "card": torch.cuda.get_device_name(0),
           "k11": {}, "k7n": {}}
    for name, n in (("clean", 2_516_582), ("stream_batch", 360_000)):
        args = clean_flags(n, 3)
        got = fs.flagstat_census(*args)
        kt.require(torch.equal(got, fs.flagstat_plain(*args)),
                   f"K11 differs from its plain version ({name})")
        r = {"ms": kt.cuda_ms(lambda: fs.flagstat_census(*args)),
             "b2b_ms": kt.cuda_ms(lambda: fs.flagstat_census(*args),
                                  per=10),
             "device_ms": kt.graph_ms(k11_bare(args)),
             "device_ms_1_an_sm": kt.graph_ms(k11_bare(args, per_sm=1)),
             "device_ms_4_an_sm": kt.graph_ms(k11_bare(args, per_sm=4)),
             "bound_ms": kt.bound(n * 11 + 16 * 2 * 8, 0)[0],
             "blocks": fs.flagstat_plan(n, kernels.sm_count(args[0].device)),
             "ballot_form": k11_old(L, args, got), "variants": {}}
        for v, fn in fns.items():
            if v.startswith("k11_ballot"):
                out = torch.zeros(16, 2, dtype=torch.int64, device="cuda")
                ptrs = [t.data_ptr() for t in args]
                r["variants"][v] = kt.graph_ms(
                    lambda fn=fn, out=out, ptrs=ptrs: fn(
                        *ptrs, n, out.data_ptr(), kernels.stream_of(out)))
            elif v.startswith("k11"):
                r["variants"][v] = kt.graph_ms(k11_bare(args, fn))
        res["k11"][name] = r
        print(json.dumps({"k11": name, **r}), flush=True)
        del args
    for name, rows in (("tool_window", 1 << 20), ("core", 8 << 20)):
        census = clean_census(rows, 5)
        want = md.census_narrow_plain(census, rows)
        got = md.census_narrow(census, rows)
        kt.require(got[1:] == want[1:] and torch.equal(got[0], want[0]),
                   f"K7n differs from its plain version ({name})")
        blocks, per, staged = md.narrow_plan(
            rows, *md._narrow_limits(census.device))
        r = {"ms": kt.cuda_ms(lambda: md.census_narrow(census, rows)),
             "b2b_ms": kt.cuda_ms(lambda: md.census_narrow(census, rows),
                                  per=10),
             "device_ms": kt.graph_ms(k7n_bare(census, rows)),
             "unstaged_device_ms": kt.graph_ms(k7n_bare(census, rows,
                                                        staged=0)),
             "bound_ms": kt.bound(rows * 24 + got[0].numel() + 8, 0)[0],
             "plan": {"blocks": blocks, "rows": per, "staged": staged,
                      "staged_share": min(rows, blocks * staged) / rows},
             "types": [str(got[1]), str(got[2])],
             "host": k7n_host(census, rows),
             "two_pass_form": k7n_old(L, census, rows, got),
             "variants": {v: kt.graph_ms(k7n_bare(census, rows, fn))
                          for v, fn in fns.items() if v.startswith("k7n")}}
        res["k7n"][name] = r
        print(json.dumps({"k7n": name, **r}), flush=True)
        del census, want, got
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
