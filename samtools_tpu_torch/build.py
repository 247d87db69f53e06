"""Builds the port's two native libraries from the checkout, at first use.

* the host library ``native/samtpu_host.cc`` — ``g++``, plain C ABI;
* the CUDA kernels ``csrc/*.cu`` — one ``nvcc -c`` per source for
  ``sm_90a``, all started together, linked into one shared library with
  a plain C interface (both are loaded with ``ctypes``).

Outputs go to ``_build/`` beside this file (git-ignored), named by a hash
of the sources and flags, under an exclusive file lock so concurrent
processes never interleave builds.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept in
``_build/libsamtpu_kernels-<hash>.log``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(ROOT, "_build")
HOST_SOURCE = os.path.join(ROOT, "native", "samtpu_host.cc")
CU_SOURCES = [os.path.join(ROOT, "csrc", f) for f in
              ("segment_contract.cu", "baq_hmm.cu", "baq_finalize.cu",
               "consensus_segsum.cu", "flagstat.cu", "stats_hists.cu",
               "census_narrow.cu", "pileup_counts.cu", "census_checksum.cu",
               "chunk_expand.cu", "qual_deltas.cu", "apply_expand.cu",
               "depth_scan.cu", "cov_reduce.cu")]
# headers the sources include: part of the build's hash
CU_HEADERS = [os.path.join(ROOT, "csrc", "staging.cuh")]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
# fmad=false: no fused multiply-adds, so the HMM rounds like its plain
# PyTorch version, op by op (its risky margin absorbs the rest)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]


def _digest(paths: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return cand


def lib_path(which: str) -> str:
    if which == "host":
        return os.path.join(
            BUILD_DIR, f"libsamtpu_host-{_digest([HOST_SOURCE], CXX_FLAGS)}.so")
    return os.path.join(
        BUILD_DIR,
        f"libsamtpu_kernels-{_digest(CU_SOURCES + CU_HEADERS, NVCC_FLAGS)}.so")


def build(which: tuple[str, ...] = ("host", "cuda")) -> dict[str, str]:
    """Build the named libraries ("host", "cuda") if they are missing;
    return their paths.  Every compile of one call runs in parallel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {w: lib_path(w) for w in which}
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [w for w in which if not os.path.exists(paths[w])]
        if not todo:
            return paths
        tag = f"{os.getpid()}"
        procs, objs = [], []
        if "host" in todo:
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                   f"{paths['host']}.{tag}", HOST_SOURCE, "-lpthread"]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        if "cuda" in todo:
            nvcc = _nvcc()
            for src in CU_SOURCES:
                obj = os.path.join(BUILD_DIR, os.path.basename(src)
                                   + f".{tag}.o")
                objs.append(obj)
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        failed = []
        log = []
        for cmd, p in procs:
            _, err = p.communicate()
            text = err.decode(errors="replace")
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if p.returncode != 0:
                failed.append(log[-1])
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(failed))
        if "cuda" in todo:
            cmd = [_nvcc(), "-shared", "-gencode",
                   "arch=compute_90a,code=sm_90a", "-o",
                   f"{paths['cuda']}.{tag}", *objs]
            p = subprocess.run(cmd, capture_output=True)
            if p.returncode != 0:
                raise RuntimeError("kernel link failed:\n"
                                   + p.stderr.decode(errors="replace"))
            for obj in objs:
                os.remove(obj)
            with open(paths["cuda"][:-3] + ".log", "w") as f:
                f.write("\n".join(log[-len(CU_SOURCES):]))
        for w in todo:
            os.replace(f"{paths[w]}.{tag}", paths[w])
    return paths
