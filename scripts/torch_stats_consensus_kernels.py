"""K12 (stats_hists) and K10 (consensus_segsum) alone on one CUDA card, at
their main-path shapes and their hard shapes, without the rest of
chip_smoke.py.

    python3 scripts/torch_stats_consensus_kernels.py [--parent DIR]
        [--variants] [--out PATH.json]

K12 runs on a chunk of 65,536 simulated 100-base reads (nbases 300), as
``stats`` gives it, and on chip_smoke.py's hard shapes (binned quals,
gaps in oidx, a single read, reads with no bases, 20,000-base reads);
K10 on the first 1 Mi window of ``consensus`` over 1 Mbp of simulated
30x reads (the entries the command builds, caught on their way to K10)
and on chip_smoke.py's hard shapes (amplicon columns 5,000 deep, q and
q2 uniform on 1-100, binned quals, nothing kept).  Each case goes through
chip_smoke.py's own checks and timings (``_k12_case``, ``_k10_case``):
equal to the host oracle and the plain version, ``ms``, ``b2b_ms``,
``device_ms``, bound.

``--parent DIR``: a checkout of an earlier commit (``git archive``);
its ``csrc/stats_hists.cu`` and ``csrc/consensus_segsum.cu`` are built
with nvcc into ``_build/others/`` and timed on the same inputs
through their own C interfaces (the forms before launch plans: outputs
zeroed by the caller for K12; one call each), in the same process, so
the two forms are compared on one card.  ``--variants``: the current
sources, patched as ``VARIANTS`` lists (a part of the work left out),
built beside them and timed on the clean shapes' inputs
(``device_ms`` only: a variant's output is not checked), to see what
each part of a kernel costs.  The JSON goes to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


# name -> (source, [(text, replacement), ...]); each text must occur in
# the source
VARIANTS = {
    "k12_no_flush": ("stats_hists.cu", [
        ("x < rt * QCELLS; x += TPB", "x < 0; x += TPB"),
        ("x < rt * NC; x += TPB", "x < 0; x += TPB")]),
    "k12_no_shared_atomics": ("stats_hists.cu", [
        ("atomicAdd(&hist[cell + qcell + q], 1);",
         "if (q > 255) hist[0] = 1;"),
        ("atomicAdd(&hist[cell + acell + col_of(b)], 1);",
         "if (b > 15) hist[1] = 1;")]),
    "k10_no_row_loads": ("consensus_segsum.cu", [
        ("val[k] = d[k] ? half_row(lane_base, d[k])",
         "val[k] = d[k] ? make_double2(1.0, (double)l)")]),
    "k10_no_stores": ("consensus_segsum.cu", [
        ("  if (l < 7) {\n    S[c * 15", "  if (c < 0) {\n    S[c * 15"),
        ("if (l < 6) counts[c * 6 + l] = st.cnt;",
         "if (c < 0) counts[c * 6 + l] = st.cnt;"),
        ("if (l == 6) depth[c] = st.cnt;", "if (c < 0) depth[c] = st.cnt;"),
        ("  } else {\n    S[c * 15 + 14]",
         "  } else if (c < -1) {\n    S[c * 15 + 14]")]),
    "k10_no_counts": ("consensus_segsum.cu", [
        ("st.cnt += count_bit(d[k], l);", "st.cnt += 0;"),
        ("st.cnt += (nib >> nib_shift) & nib_mask;", "st.cnt += 0;")]),
}


def variant_lib(name: str):
    """VARIANTS[name] built from the current sources into
    ``_build/variants/``, loaded, with the current C interface."""
    from samtools_tpu_torch import build, kernels
    src_name, patches = VARIANTS[name]
    src = os.path.join(build.ROOT, "csrc")
    out = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(src, src_name)) as f:
        text = f.read()
    for old, new in patches:
        assert old in text, (name, old)
        text = text.replace(old, new)
    cu = os.path.join(out, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out, f"lib{name}.so")
    subprocess.run([build._nvcc(), *[f for f in build.NVCC_FLAGS
                                     if f not in ("-Xptxas", "-v")],
                    "-shared", "-I", src, "-o", lib, cu], check=True)
    L = ctypes.CDLL(lib)
    entry = ("samtpu_stats_hists" if src_name == "stats_hists.cu"
             else "samtpu_consensus_segsum")
    fn = getattr(L, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = kernels._SIGNATURES[entry]
    return fn


def variant_k12(fn, case, dev) -> float:
    """device_ms of a K12 variant on one case (output not checked)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import stats_kernels as sk
    seq, qual, off, oidx, order, rev, nbases, qrows = case
    args = sk.chunk_inputs(seq, qual, off, oidx, order, rev, dev)
    max_len = int((off[oidx + 1] - off[oidx]).max())
    plan = sk.hists_plan(oidx.size, max_len, kernels.sm_count(dev))
    out = torch.empty(sk.hist_words(oidx.size, nbases, qrows),
                      dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in args]

    def bare():
        return fn(*ptrs, oidx.size, nbases, qrows, max_len, *plan,
                  out.data_ptr(), kernels.stream_of(out))
    cs.require(bare() == 0, "a K12 variant failed")
    return cs.graph_ms(bare)


def variant_k10(fn, col_off, b6, q, q2, keep, cp, dev) -> float:
    """device_ms of a K10 variant on one case (output not checked)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import consensus_vec as cv
    T = cv.segsum_table(cp, dev)
    ent = torch.from_numpy(np.stack([b6, q, q2, keep], 1).astype(
        np.uint8)).to(dev)
    off = torch.from_numpy(np.ascontiguousarray(col_off, np.int64)).to(dev)
    ncols = col_off.size - 1
    outs = [torch.empty(ncols, 15, dtype=torch.float64, device=dev),
            torch.empty(ncols, 6, dtype=torch.int32, device=dev),
            torch.empty(ncols, dtype=torch.int32, device=dev)]
    ptrs = [t.data_ptr() for t in (T, ent, off, *outs)]
    plan = cv.segsum_plan(ncols, kernels.sm_count(dev))

    def bare():
        return fn(*ptrs, ncols, *plan, kernels.stream_of(T))
    cs.require(bare() == 0, "a K10 variant failed")
    return cs.graph_ms(bare, calls=10)


def parent_lib(parent: str):
    """The parent's K12 and K10 built into one library, loaded."""
    from samtools_tpu_torch import build
    src = os.path.join(parent, "samtools_tpu_torch", "csrc")
    out = os.path.join(build.BUILD_DIR, "others")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libparent.so")
    subprocess.run([build._nvcc(), *[f for f in build.NVCC_FLAGS
                                     if f not in ("-Xptxas", "-v")],
                    "-shared", "-I", src, "-o", lib,
                    os.path.join(src, "stats_hists.cu"),
                    os.path.join(src, "consensus_segsum.cu")], check=True)
    L = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    L.samtpu_stats_hists.restype = I
    L.samtpu_stats_hists.argtypes = [P] * 6 + [ctypes.c_int64, I, I, I] \
        + [P] * 9
    L.samtpu_consensus_segsum.restype = I
    L.samtpu_consensus_segsum.argtypes = [P] * 6 + [I, P]
    return L


def parent_k12(L, case, dev) -> dict:
    """The earlier K12 on one case: equal to the current K12, its time."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import stats_kernels as sk
    seq, qual, off, oidx, order, rev, nbases, qrows = case
    args = sk.chunk_inputs(seq, qual, off, oidx, order, rev, dev)
    max_len = int((off[oidx + 1] - off[oidx]).max())
    no = oidx.size
    want = sk.stats_hists(*args, nbases, qrows, max_len)
    flat = torch.zeros_like(want)
    h = sk.split_hists(flat, no, nbases, qrows)
    ptrs = [t.data_ptr() for t in args]
    parts = [h[k].data_ptr() for k in ("q1", "q2", "a1", "a2", "ar", "gc",
                                      "qsum", "maxq")]

    def call():
        flat.zero_()
        return L.samtpu_stats_hists(*ptrs, no, nbases, qrows, max_len,
                                    *parts, kernels.stream_of(flat))
    cs.require(call() == 0, "the parent's K12 failed")
    torch.cuda.synchronize()
    cs.require(torch.equal(flat, want), "the parent's K12 differs")
    return {"ms": cs.cuda_ms(call), "b2b_ms": cs.cuda_ms(call, per=10),
            "device_ms": cs.graph_ms(call)}


def parent_k10(L, col_off, b6, q, q2, keep, cp, dev) -> dict:
    """The earlier K10 on one case: equal to the current K10, its time."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import consensus_vec as cv
    T = cv.segsum_table(cp, dev)
    ent = torch.from_numpy(np.stack([b6, q, q2, keep], 1).astype(
        np.uint8)).to(dev)
    off = torch.from_numpy(np.ascontiguousarray(col_off, np.int64)).to(dev)
    want = cv.consensus_segsum(T, ent, off)
    outs = [torch.empty_like(t) for t in want]
    ncols = col_off.size - 1
    ptrs = [t.data_ptr() for t in (T, ent, off, *outs)]

    def call():
        return L.samtpu_consensus_segsum(*ptrs, ncols, kernels.stream_of(T))
    cs.require(call() == 0, "the parent's K10 failed")
    torch.cuda.synchronize()
    cs.require(all(torch.equal(a, b) for a, b in zip(outs, want)),
               "the parent's K10 differs")
    return {"ms": cs.cuda_ms(call), "b2b_ms": cs.cuda_ms(call, per=10),
            "device_ms": cs.graph_ms(call, calls=10)}


def k10_window(workdir: str):
    """The entries of the first window K10 scores in ``consensus`` over 1
    Mbp of simulated 30x reads: (col_off, b6, q, q2, keep, cp)."""
    from samtools_tpu_torch import cli
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.ops import consensus_vec as cv
    from samtools_tpu_torch.sim import (make_header, simulate_batch,
                                        simulate_reference)
    L = 1 << 20
    ref = simulate_reference(L, seed=7)
    b = simulate_batch(ref_len=L, coverage=cs.COVERAGE,
                       read_len=cs.READ_LEN, seed=42, paired=False,
                       err_rate=0.01, ref=ref)
    path = os.path.join(workdir, "w.bam")
    write_bam(path, make_header(L), b, threads=cs.THREADS)
    first = []
    scorer = cv.gap5_scores_device

    def keep_first(*args):
        if not first:
            first.append(args)
        return scorer(*args)
    cv.gap5_scores_device = keep_first
    try:
        cli.main(["consensus", "-o", os.path.join(workdir, "w.fa"), path])
    finally:
        cv.gap5_scores_device = scorer
    return first[0][:6]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--out")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from samtools_tpu_torch import build
    from samtools_tpu_torch.sim import simulate_batch, simulate_reference
    dev = torch.device("cuda")
    build.build(("host", "cuda"))
    with open(build.lib_path("cuda")[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "stats_hists" in ln
                 or "consensus_segsum" in ln or "registers" in ln]
    L = parent_lib(a.parent) if a.parent else None
    res = {"ptxas": ptxas, "card": torch.cuda.get_device_name(0),
           "k12": {}, "k10": {}}
    fns = {v: variant_lib(v) for v in VARIANTS} if a.variants else {}

    ref = simulate_reference(1 << 20, seed=7)
    b = simulate_batch(ref_len=240_000, coverage=cs.COVERAGE,
                       read_len=cs.READ_LEN, seed=42, paired=False,
                       err_rate=0.01, ref=ref[:240_000])
    n = min(b.n, cs.CHUNK)
    rng = np.random.default_rng(5)
    order = np.ones(n, np.uint8)
    rev = rng.integers(0, 2, n).astype(np.uint8)
    cases = {"clean": (b.seq, b.qual, b.seq_off, np.arange(n, dtype=np.int64),
                       order, rev, 300, 300),
             **cs.k12_stress_inputs(b.seq, b.qual, b.seq_off, order, rev)}
    for name, case in cases.items():
        r = cs._k12_case(*case, dev)
        if L is not None:
            r["parent"] = parent_k12(L, case, dev)
        res["k12"][name] = r
        if name in ("clean", "binned"):
            r["variants"] = {v: variant_k12(fn, case, dev)
                             for v, fn in fns.items() if v.startswith("k12")}
        print(json.dumps({"k12": name, **{k: r[k] for k in (
            "ms", "b2b_ms", "device_ms", "bound_ms")},
            "parent": r.get("parent"), "variants": r.get("variants")}),
            flush=True)

    with tempfile.TemporaryDirectory() as wd:
        col_off, b6, q, q2, keep, cp = k10_window(wd)
    cases = {"clean": (col_off, b6, q, q2, keep),
             **cs.k10_stress_inputs(col_off, b6, q, q2, keep)}
    for name, case in cases.items():
        r = cs._k10_case(*case, cp, dev)
        if L is not None:
            r["parent"] = parent_k10(L, *case, cp, dev)
        res["k10"][name] = r
        if name in ("clean", "amplicon", "none_kept"):
            r["variants"] = {v: variant_k10(fn, *case, cp, dev)
                             for v, fn in fns.items() if v.startswith("k10")}
        print(json.dumps({"k10": name, **{k: r[k] for k in (
            "ms", "b2b_ms", "device_ms", "bound_ms")},
            "parent": r.get("parent"), "variants": r.get("variants"),
            "detail": r["detail"]}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
