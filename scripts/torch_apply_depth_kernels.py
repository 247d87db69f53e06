"""K8's front (``apply_expand``) and K9 (``depth_scan``, ``cov_reduce``)
alone on one CUDA card, at the main path's shapes, without the rest of
chip_smoke.py, which takes its rows and checks from here.

Shapes: ``apply`` (65,536 all-M reads of 100 bases simulated on
chip_smoke.py's clean reference, 8 Mbp, seed 7); ``depth`` (the
difference column of a clean-like window: 2,516,582 reads of 100 bases
on 8 Mbp, +1 at a read's start and -1 at its end, in rows of 8,388,608 +
a tile, as ``pick_tile`` plans them; no direct column, and again with a
0/1 direct column); ``coverage`` (a
1 Mi-row census of 30x-like lanes).  Each kernel is held against its
plain version, exactly, and timed: ``ms`` (single calls, the wrapper's
host time included), ``b2b_ms`` (back to back), ``device_ms`` (a CUDA
graph of bare C-entry calls on preallocated outputs), ``plain_ms`` and
``library_ms`` where one PyTorch call computes the same function, beside
the bound (``scripts/kernel_timing.py``).  K8 whole: ``device_ms`` is a
CUDA graph of its three bare entries (``apply_expand``, K4, K5).

The depth scan's bound has two parts: the columns read once from HBM,
and the L values across the host link at the width their max picks, at
the link's peak (``bound_link_ms``; at the pinned device-to-host rate of
one copy measured here: ``bound_link_measured_ms``).  The narrowing
edges (maxima 255, 256, 32,767, 32,768, a max only past row L, sums
that wrap, negative depths under each width, each column absent) are
checked against the plain version.

Run alone, the script also measures what chip_smoke.py does not: K8's
``b2b_ms`` with its per-read constants kept and made anew
(``k8_constants``), the transports of the depth values (``TRANSPORTS``,
each in a fresh process: the first full-size call and the calls after
it), and with ``--parent DIR`` (a checkout of the parent commit)
``depth`` on clean from the parent and from this checkout, parent,
change, change, parent, each a fresh process.

    python3 scripts/torch_apply_depth_kernels.py [--out R.json]
        [--parent DIR] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kernel_timing as kt  # noqa: E402

READS = 1 << 16
READ_LEN = 100
REF_LEN = 8 << 20
CLEAN_READS = 2_516_582
COV_ROWS = 1 << 20
SUB = 1 << 16


def _ptr(t):
    return None if t is None else t.data_ptr()


def host_ms(fn, reps: int = 5) -> float:
    """Host-clock median of ``reps`` calls of ``fn`` (which ends in a
    sync or on the host), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ------------------------------------------------------------------ K8
def apply_inputs(dev):
    """(ref_dev, buf_dev): the clean reference's 0-4 codes and 65,536
    all-M reads of 100 bases (nt16 bases) packed as K8 takes them."""
    import torch
    from samtools_tpu_torch.sim import simulate_batch, simulate_reference
    ref = simulate_reference(REF_LEN, seed=7)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = simulate_batch(ref_len=REF_LEN, coverage=READS * READ_LEN / REF_LEN
                       * 1.02, read_len=READ_LEN, seed=42, paired=False,
                       err_rate=0.01, ref=ref)
    k = np.arange(READS)
    idx = b.seq_off[k][:, None] + np.arange(READ_LEN)[None, :]
    buf = np.empty((READS, 4 + 2 * READ_LEN), np.uint8)
    buf[:, :4] = b.pos[k].astype("<i4").view(np.uint8).reshape(-1, 4)
    buf[:, 4:4 + READ_LEN] = b.seq[idx]
    buf[:, 4 + READ_LEN:] = b.qual[idx]
    return (torch.from_numpy(lut[ref]).to(dev),
            torch.from_numpy(buf).to(dev))


def apply_rows(ref_dev, buf_dev) -> dict:
    """``apply_expand``'s row on (ref_dev, buf_dev), and K8's
    ``device_ms``: a CUDA graph of the three bare entries (the front, K4,
    K5) on preallocated outputs."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import baq_device as bd
    lib = kernels._load()
    B, row = buf_dev.shape
    L = (row - 4) // 2
    l_ref = L + bd.APPLY_PAD
    want = bd.apply_expand_plain(ref_dev, buf_dev)
    before = kernels.launches["apply_expand"]
    got = bd.apply_expand(ref_dev, buf_dev)
    torch.cuda.synchronize()
    kt.require(kernels.launches["apply_expand"] == before + 1,
               "apply_expand did not launch once")
    kt.require(all(torch.equal(g, w) for g, w in zip(got, want)),
               "apply_expand differs from its plain version")
    win, sq, qq = (torch.empty_like(t) for t in got)
    reads = bd.apply_plan(L)

    def expand_bare():
        kt.require(lib.samtpu_apply_expand(
            buf_dev.data_ptr(), B, L, reads, ref_dev.data_ptr(),
            ref_dev.numel(), win.data_ptr(), sq.data_ptr(), qq.data_ptr(),
            kernels.stream_of(buf_dev)) == 0, "apply_expand's C entry failed")
    expand_bare()
    torch.cuda.synchronize()
    kt.require(all(torch.equal(a, b) for a, b in zip((win, sq, qq), got)),
               "apply_expand's C entry differs from its wrapper")
    row_ = dict(
        max_abs_err=0, ms=kt.cuda_ms(lambda: bd.apply_expand(ref_dev,
                                                            buf_dev)),
        b2b_ms=kt.cuda_ms(lambda: bd.apply_expand(ref_dev, buf_dev),
                          per=10),
        device_ms=kt.graph_ms(expand_bare),
        plain_ms=kt.cuda_ms(lambda: bd.apply_expand_plain(ref_dev, buf_dev)),
        library_ms=None,
        library_note="no PyTorch call unpacks the rows and gathers the "
                     "windows",
        detail={"reads": B, "l_query": L, "reads_a_block": reads},
        **dict(zip(("bound_ms", "bound_by"),
                   kt.bound(B * row + B * (l_ref + 2 * L), 0))))

    # K8 whole: the front, K4 and K5 as _apply runs them on the card
    cdT, lref, bMv, bIv, seg = bd._kept_constants(B, L, buf_dev.device)
    t = bd._transitions(L)
    m = (ctypes.c_float * 10)(*(t[k] for k in (
        "m0", "m1", "m2", "m3", "m4", "m6", "m8", "sM")),
        bd.EI * t["m1"], bd.EI * t["m4"])
    ck = torch.empty(bd.hmm_layout(L, l_ref, B)["scratch_bytes"],
                     dtype=torch.uint8, device=buf_dev.device)
    bq = torch.empty(B, L, dtype=torch.uint8, device=buf_dev.device)
    good = torch.empty_like(bq)
    risky = torch.empty(B, dtype=torch.uint8, device=buf_dev.device)
    appq = torch.empty_like(bq)

    def k8_bare():
        expand_bare()
        s = kernels.stream_of(buf_dev)
        kt.require(lib.samtpu_baq_hmm(
            win.data_ptr(), sq.data_ptr(), qq.data_ptr(), cdT.data_ptr(),
            lref.data_ptr(), bMv.data_ptr(), bIv.data_ptr(), B, L, l_ref, 7,
            m, ck.data_ptr(), bq.data_ptr(), good.data_ptr(),
            risky.data_ptr(), s) == 0, "K4's C entry failed")
        kt.require(lib.samtpu_baq_finalize(
            bq.data_ptr(), good.data_ptr(), qq.data_ptr(), seg.data_ptr(), B,
            L, appq.data_ptr(), s) == 0, "K5's C entry failed")
    k8_bare()
    torch.cuda.synchronize()
    kq, kr = bd.baq_apply(ref_dev, buf_dev)
    torch.cuda.synchronize()
    kt.require(torch.equal(appq, kq) and torch.equal(risky.bool(), kr),
               "K8's bare entries differ from baq_apply")
    return {"apply_expand": row_,
            "baq_apply_device_ms": kt.graph_ms(k8_bare, calls=10)}


# ------------------------------------------------------------- K9 depth
def clean_depth_column(dev):
    """(diff int32 [rows, 1] on ``dev``, L): a clean-like window's
    difference events, rows as the depth path plans them."""
    import torch
    from samtools_tpu_torch.ops import pileup_engine as pe
    rng = np.random.default_rng(42)
    pos = np.sort(rng.integers(0, REF_LEN - READ_LEN, CLEAN_READS))
    L = REF_LEN
    tile = pe.pick_tile(L)
    rows = -(-L // tile) * tile
    diff = np.bincount(pos, minlength=rows) - np.bincount(
        pos + READ_LEN, minlength=rows)
    return torch.from_numpy(diff.astype(np.int32)[:, None]).to(dev), L


def depth_bare(diff, direct, L: int, out):
    """A call of the depth scan's C entry on a preallocated ``out``
    (int32 rows [0, L), in card or pinned host memory)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_engine as pe
    lib = kernels._load()
    col = diff if diff is not None else direct
    rows = col.shape[0]
    tiles = pe.depth_plan(rows)
    scratch = torch.empty(tiles + 2, dtype=torch.int32, device=col.device)

    def bare():
        kt.require(lib.samtpu_depth_scan(
            _ptr(diff), _ptr(direct), rows, L, tiles, scratch.data_ptr(),
            out.data_ptr(), kernels.stream_of(col)) == 0,
            "depth_scan's C entry failed")
    return bare


def link_width(mx: int) -> int:
    """Bytes a value of the first L takes across the link at the width
    the max over all rows picks (the plain version's narrowing)."""
    return 1 if mx < 256 else 2 if mx < 1 << 15 else 4


def depth_row(diff, direct, L: int) -> dict:
    """``depth_scan``'s row on (diff, direct, L): equal to its plain
    version, its times, and the bound in two parts: the columns read
    once from HBM, and the L values across the host link at the width
    their max picks, at the link's peak (PCIe Gen5 x16, 64 GB/s each
    way); ``bound_link_measured_ms`` is the same bytes at the pinned
    device-to-host rate of one copy measured here (``link_GBps``)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_engine as pe
    want = pe.depth_scan_plain(diff, direct, L)
    before = kernels.launches["depth_scan"]
    got = pe.depth_scan(diff, direct, L)
    kt.require(kernels.launches["depth_scan"] == before + 1,
               "depth_scan did not launch once")
    kt.require(got.dtype == np.int32 and np.array_equal(got, want),
               "depth_scan differs from its plain version")
    cols = [c for c in (diff, direct) if c is not None]
    col = cols[0]
    rows = col.shape[0]
    out_pin = torch.empty(L, dtype=torch.int32, pin_memory=True)
    out_dev = torch.empty(L, dtype=torch.int32, device=col.device)
    into_host = depth_bare(diff, direct, L, out_pin)
    into_host()
    torch.cuda.current_stream(col.device).synchronize()
    kt.require(np.array_equal(out_pin.numpy(), want),
               "depth_scan's C entry differs from plain")
    copy_ms = kt.cuda_ms(lambda: out_pin.copy_(out_dev, non_blocking=True))
    full = torch.cumsum(diff[:, 0], 0) if diff is not None else 0
    if direct is not None:
        full = full + direct[:, 0]
    mx = int(full.to(torch.int32).max())
    link_bytes = L * link_width(mx)
    hbm_ms = kt.bound(len(cols) * rows * 4, 0)[0]
    link_ms = link_bytes / kt.LINK_BYTES_PER_S * 1e3
    link_GBps = 4 * L / copy_ms / 1e6
    return dict(
        max_abs_err=0, ms=kt.cuda_ms(lambda: pe.depth_scan(diff, direct, L)),
        b2b_ms=kt.cuda_ms(lambda: pe.depth_scan(diff, direct, L), per=10),
        device_ms=kt.graph_ms(into_host),
        device_ms_into_card=kt.graph_ms(depth_bare(diff, direct, L,
                                                   out_dev)),
        plain_ms=kt.cuda_ms(lambda: pe.depth_scan_plain(diff, direct, L)),
        library_ms=kt.cuda_ms(lambda: torch.cumsum(col[:, 0], 0)),
        library_note="torch.cumsum of the column: the scan only",
        bound_ms=max(hbm_ms, link_ms), bound_by="bytes",
        bound_hbm_ms=hbm_ms, bound_link_ms=link_ms,
        bound_link_measured_ms=link_bytes / (link_GBps * 1e9) * 1e3,
        link_bytes=link_bytes, link_GBps=link_GBps,
        detail={"rows": rows, "L": L, "columns": len(cols),
                "tiles": pe.depth_plan(rows), "max": mx,
                "link_bytes_sent": 4 * L})


# The transports of the first L values, each in a process of its own (the
# first full-size call pays the allocations a ``depth`` run pays: one
# window a contig; each transport makes its buffers in it): int32_pinned (the wrapper's: int32 straight into
# pinned memory from the caching host allocator, kept by it after the
# first call), int32_registered (int32 straight into a fresh numpy array
# registered with the driver for the call), int32_pageable (int32 into
# card memory, one copy to a pageable array), narrow_reused (the values
# narrowed on the card, one copy of L x width bytes into a pinned stage
# of 4L bytes, the widest case, widened by the host into a pinned int32
# array; stage and array reused from call to call) and narrow_fresh (the
# same, widened into a fresh numpy array), and the plain version.  The
# narrow ones take the width from the max, found beforehand and outside
# every time, as a kernel could find it in its scan.
TRANSPORTS = ("int32_pinned", "int32_registered", "int32_pageable",
              "narrow_reused", "narrow_fresh", "plain")


def transport_fn(name: str, diff, direct, L: int, mx: int):
    """One call of transport ``name`` on (diff, direct, L), returning
    int32[L] on the host; for the narrow ones also (fetch_ms, widen_ms)
    of the last call on the host clock.  Every buffer is made in the
    first call; the reused ones are kept for the calls after it."""
    import torch
    from samtools_tpu_torch.ops import pileup_engine as pe
    col = diff if diff is not None else direct
    stream = torch.cuda.current_stream(col.device)
    if name == "int32_pinned":
        return lambda: pe.depth_scan(diff, direct, L)
    if name == "plain":
        return lambda: pe.depth_scan_plain(diff, direct, L)
    if name == "int32_registered":
        cudart = torch.cuda.cudart()

        def registered():
            host = np.empty(L, np.int32)
            kt.require(cudart.cudaHostRegister(
                host.ctypes.data, host.nbytes, 0) == 0,
                "cudaHostRegister failed")
            try:
                depth_bare(diff, direct, L, torch.from_numpy(host))()
                stream.synchronize()
            finally:
                cudart.cudaHostUnregister(host.ctypes.data)
            return host
        return registered

    def scan_into_card():
        out_dev = torch.empty(L, dtype=torch.int32, device=col.device)
        depth_bare(diff, direct, L, out_dev)()
        return out_dev
    if name == "int32_pageable":
        return lambda: scan_into_card().cpu().numpy()
    dt = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[link_width(mx)]
    held, split = {}, {}

    def narrow():
        out_dev = scan_into_card()
        t0 = time.perf_counter()
        if not held:
            # the stage holds the widest case: its width is known only
            # after the scan
            held["stage"] = torch.empty(4 * L, dtype=torch.uint8,
                                        pin_memory=True)
            if name == "narrow_reused":
                held["wide"] = torch.empty(L, dtype=torch.int32,
                                           pin_memory=True)
        stage = held["stage"][:L * dt.itemsize].view(dt)
        stage.copy_(out_dev.to(dt), non_blocking=True)
        stream.synchronize()
        t1 = time.perf_counter()
        dst = held.get("wide")
        if dst is None:
            dst = torch.from_numpy(np.empty(L, np.int32))
        dst.copy_(stage)
        split["fetch_ms"] = (t1 - t0) * 1e3
        split["widen_ms"] = (time.perf_counter() - t1) * 1e3
        return dst.numpy()
    narrow.split = split
    return narrow


TRANSPORT_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.path.join(sys.argv[1], "scripts"))
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch_apply_depth_kernels as ad
from samtools_tpu_torch import kernels
from samtools_tpu_torch.ops import pileup_engine as pe
name = sys.argv[2]
dev = torch.device("cuda")
kernels._load()
diff, L = ad.clean_depth_column(dev)
small = diff[:3 * pe.DEPTH_TILE].clone()
# the values and their max on the host: no card allocation before the
# first call
full = np.cumsum(diff[:, 0].cpu().numpy(), dtype=np.int64)
want, mx = full[:L].astype(np.int32), int(full.max())
torch.cuda.synchronize()
# a small call of the same transport first: the library, the kernels and
# the CUDA context are warm, the full-size allocations are not
ad.transport_fn(name, small, None, small.shape[0], mx)()
fn = ad.transport_fn(name, diff, None, L, mx)
torch.cuda.synchronize()
t0 = time.perf_counter()
got = fn()
first = (time.perf_counter() - t0) * 1e3
ad.kt.require(np.array_equal(got, want), f"{name} differs from plain")
res = {"transport": name, "first_ms": first,
       **{"first_" + k: v for k, v in getattr(fn, "split", {}).items()}}
times, splits = [], []
for _ in range(7):
    t0 = time.perf_counter()
    fn()
    times.append((time.perf_counter() - t0) * 1e3)
    splits.append(dict(getattr(fn, "split", {})))
res["ms"] = sorted(times)[3]
for k in splits[0]:
    res[k] = sorted(s[k] for s in splits)[3]
print(json.dumps(res))
"""


def depth_transports() -> dict:
    """TRANSPORTS on clean's depth window, each in a fresh process:
    ``first_ms`` (the first full-size call, host clock, its sync and
    allocations included) and ``ms`` (the median of 7 calls after it);
    the narrow ones also split into the fetch and the widening."""
    import subprocess
    res = {}
    for name in TRANSPORTS:
        p = subprocess.run([sys.executable, "-c", TRANSPORT_CHILD, ROOT,
                            name], capture_output=True, text=True,
                           timeout=600)
        kt.require(p.returncode == 0, f"transport {name}: rc "
                   f"{p.returncode}: {p.stderr[-800:]}")
        res[name] = json.loads(p.stdout.strip().splitlines()[-1])
    return res


# `depth` on clean.bam through cli.main, in a fresh process from the
# checkout given (the CUDA context and the kernel library made first, the
# wall taken around cli.main alone, the depth step's calls timed inside)
DEPTH_CHILD = r"""
import contextlib, json, os, sys, time
root, bam, out = sys.argv[1:4]
sys.path.insert(0, root)
import torch
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.ops import pileup_engine as pe
torch.zeros(1, device="cuda")
kernels._load()
calls = []
real = pe.depth_scan


def timed(*a, **k):
    t0 = time.perf_counter()
    r = real(*a, **k)
    calls.append((time.perf_counter() - t0) * 1e3)
    return r


pe.depth_scan = timed
with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
    t0 = time.perf_counter()
    rc = cli.main(["depth", bam])
    wall = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump({"rc": rc, "wall_s": wall, "depth_scan_ms": calls}, f)
"""


def depth_walls(parent: str, workdir: str) -> dict:
    """``depth`` on clean.bam (8 Mbp, 30x, seed 42, as chip_smoke.py
    simulates it) from ``parent`` (a checkout of the parent commit) and
    from this checkout, in the order parent, change, change, parent, each
    a fresh process: its wall and the depth step's time in it."""
    import subprocess
    import tempfile
    os.makedirs(workdir, exist_ok=True)
    bam = os.path.join(workdir, "clean.bam")
    sim = ("import sys\n"
           "from samtools_tpu_torch.io.bam import write_bam\n"
           "from samtools_tpu_torch.sim import (make_header, simulate_batch,"
           " simulate_reference)\n"
           f"b = simulate_batch(ref_len={REF_LEN}, coverage=30.0, "
           f"read_len={READ_LEN}, seed=42, paired=False, err_rate=0.01, "
           f"ref=simulate_reference({REF_LEN}, seed=7))\n"
           f"write_bam(sys.argv[1], make_header({REF_LEN}), b, threads=4)\n")
    build = "from samtools_tpu_torch import build; build.build(('cuda',))"
    procs = [subprocess.Popen([sys.executable, "-c", sim, bam], cwd=ROOT),
             subprocess.Popen([sys.executable, "-c", build], cwd=parent)]
    for p in procs:
        kt.require(p.wait(timeout=900) == 0, "simulating or building failed")
    res = {"order": [], "bam_bytes": os.path.getsize(bam)}
    for who in ("parent", "change", "change", "parent"):
        root = parent if who == "parent" else ROOT
        fd, out = tempfile.mkstemp(suffix=".json", dir=workdir)
        os.close(fd)
        p = subprocess.run([sys.executable, "-c", DEPTH_CHILD, root, bam,
                            out], cwd=root, capture_output=True, text=True,
                           timeout=600)
        kt.require(p.returncode == 0, f"depth ({who}): rc {p.returncode}: "
                   f"{p.stderr[-800:]}")
        with open(out) as f:
            got = json.load(f)
        kt.require(got["rc"] == 0, f"depth ({who}) exited {got['rc']}")
        res["order"].append({"tree": who, **got})
    return res


def edge_columns(rows: int, L: int, top: int, where: str, cols: str, rng):
    """(diff, direct) int32 [rows] (None where ``cols``, "diff", "direct"
    or "both", leaves one out) whose depth is small (0-9) but for one row
    of ``top``: at row 5 (``where`` "in") or at row L + 10 ("pad", past
    the rows returned); "wrap" adds 100 past a depth of ``top``, so the
    int32 sums wrap; "neg" puts depths of -(23 top + 7) and -1 near it,
    which the narrowing to the width of ``top`` wraps."""
    dep = rng.integers(0, 10, rows).astype(np.int64)
    at = 5 if where != "pad" else L + 10
    dep[at] = top
    if where == "wrap":
        dep[at + 1] = top + 100
    if where == "neg":
        dep[at + 3], dep[at + 7] = -(23 * top + 7), -1
    direct = {"both": np.minimum(rng.integers(0, 4, rows), dep),
              "diff": np.zeros(rows, np.int64), "direct": dep}[cols]
    diff = np.diff(dep - direct, prepend=0)
    return (diff.astype(np.uint32).view(np.int32) if cols != "direct"
            else None,
            direct.astype(np.uint32).view(np.int32) if cols != "diff"
            else None)


EDGES = [(255, "in", "both"), (256, "in", "both"), (32767, "in", "diff"),
         (32768, "in", "direct"), (255, "in", "diff"),
         (40000, "pad", "both"), ((1 << 31) - 5, "wrap", "both"),
         (200, "neg", "both"), (3000, "neg", "diff"),
         (40000, "neg", "direct")]


def depth_edges(dev) -> list:
    """The narrowing edges on the card, each equal to the plain version:
    maxima 255, 256, 32,767 and 32,768 inside rows [0, L), a max of
    40,000 only past L, sums that wrap past 2^31, negative depths under
    each width, each column absent."""
    import torch
    from samtools_tpu_torch.ops import pileup_engine as pe
    rows = 3 * pe.DEPTH_TILE + 4100
    L = rows - 2000
    seen = []
    rng = np.random.default_rng(3)
    for top, where, cols in EDGES:
        args = [None if c is None else torch.from_numpy(c[:, None]).to(dev)
                for c in edge_columns(rows, L, top, where, cols, rng)]
        got = pe.depth_scan(*args, L)
        want = pe.depth_scan_plain(*args, L)
        kt.require(np.array_equal(got, want),
                   f"depth_scan differs from plain at max {top} ({where}, "
                   f"{cols})")
        seen.append({"top": top, "where": where, "columns": cols})
    return seen


def k8_constants(ref_dev, buf_dev, rounds: int = 3) -> dict:
    """K8's ``b2b_ms`` with its per-read constants kept on the card (the
    wrapper's ``_kept_constants``) and made anew each call
    (``_fresh_constants``, two zero fills of [B, L] int32 and three of
    [B]), the two interleaved kept, fresh, fresh, kept ``rounds`` times;
    the medians."""
    from samtools_tpu_torch.ops import baq_device as bd

    def fresh():
        return bd._apply(ref_dev, buf_dev, bd.apply_expand,
                         bd._fresh_constants, bd.baq_hmm, bd.baq_finalize)

    def kept():
        return bd.baq_apply(ref_dev, buf_dev)
    got = {"kept": [], "fresh": []}
    for _ in range(rounds):
        for name, fn in (("kept", kept), ("fresh", fresh), ("fresh", fresh),
                         ("kept", kept)):
            got[name].append(kt.cuda_ms(fn, per=10))
    return {f"b2b_{k}_ms": statistics.median(v) for k, v in got.items()} | {
        f"b2b_{k}_runs_ms": v for k, v in got.items()}


# ---------------------------------------------------------- K9 coverage
def coverage_census(dev):
    """A 1 Mi-row coverage census of 30x-like lanes on ``dev``."""
    import torch
    rng = np.random.default_rng(5)
    c0 = rng.poisson(30, COV_ROWS)
    c2 = c0 + rng.poisson(2, COV_ROWS)
    q = rng.integers(20, 41, COV_ROWS) * c0
    census = np.stack([c0, q & 127, c2, q >> 7], 1).astype(np.int32)
    return torch.from_numpy(census).to(dev)


def cov_row(census, sub: int = SUB, min_depth: int = 1) -> dict:
    """``cov_reduce``'s row on the census: equal to its plain version,
    its times and the bound from bytes."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_engine as pe
    lib = kernels._load()
    want = pe.cov_reduce_plain(census, sub, min_depth)
    before = kernels.launches["cov_reduce"]
    got = pe.cov_reduce(census, sub, min_depth)
    kt.require(kernels.launches["cov_reduce"] == before + 1,
               "cov_reduce did not launch once")
    kt.require(torch.equal(got, want), "cov_reduce differs from plain")
    rows = census.shape[0]
    nsub = -(-rows // sub)
    dev = census.device
    G, chunk = pe.cov_plan(rows, sub, kernels.sm_count(dev))
    out = torch.empty_like(got)
    partial = torch.empty(max(1, nsub * G * 3), dtype=torch.int64,
                          device=dev)
    tickets = torch.zeros(nsub, dtype=torch.int32, device=dev)

    def bare():
        kt.require(lib.samtpu_cov_reduce(
            census.data_ptr(), rows, sub, chunk, G, min_depth,
            partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            kernels.stream_of(census)) == 0, "cov_reduce's C entry failed")
    bare()
    torch.cuda.synchronize()
    kt.require(torch.equal(out, want), "cov_reduce's C entry differs")
    return dict(
        max_abs_err=0, ms=kt.cuda_ms(lambda: pe.cov_reduce(census, sub,
                                                           min_depth)),
        b2b_ms=kt.cuda_ms(lambda: pe.cov_reduce(census, sub, min_depth),
                          per=10),
        device_ms=kt.graph_ms(bare),
        plain_ms=kt.cuda_ms(lambda: pe.cov_reduce_plain(census, sub,
                                                        min_depth)),
        library_ms=None,
        library_note="no PyTorch call gates the rows and sums them a "
                     "subwindow",
        detail={"rows": rows, "sub": sub, "subwindows": nsub,
                "blocks_a_subwindow": G, "rows_a_block": chunk},
        **dict(zip(("bound_ms", "bound_by"),
                   kt.bound(rows * 16 + nsub * 24, 0))))


# (rows, sub, min_depth): rows not a multiple of sub, the min_depth gate,
# one row, sub past the rows, one subwindow 1,000 deep at Q40
COV_EDGES = [(SUB * 3 + 17, SUB, 1), (SUB * 2 + 5, SUB, 25), (1, SUB, 1),
             (5000, 1 << 20, 0), (SUB, SUB, 1)]


def cov_edge_census(rows: int, rng) -> np.ndarray:
    """A coverage census int32 [rows, 4] of random lanes; at SUB rows,
    1,000x at Q40 everywhere, whose quality sum passes 2^31."""
    if rows == SUB:
        return np.tile(np.array([1000, 40_000, 1000, 0], np.int32),
                       (rows, 1))
    return np.stack([rng.integers(0, 40, rows),
                     rng.integers(0, 128, rows) * 40,
                     rng.integers(0, 45, rows),
                     rng.integers(0, 3, rows)], 1).astype(np.int32)


def cov_edges(dev) -> list:
    """cov_reduce on the card at COV_EDGES, each equal to the plain
    version."""
    import torch
    from samtools_tpu_torch.ops import pileup_engine as pe
    rng = np.random.default_rng(9)
    for rows, sub, md in COV_EDGES:
        t = torch.from_numpy(cov_edge_census(rows, rng)).to(dev)
        kt.require(torch.equal(pe.cov_reduce(t, sub, md),
                               pe.cov_reduce_plain(t, sub, md)),
                   f"cov_reduce differs from plain ({rows}, {sub}, {md})")
    return [dict(zip(("rows", "sub", "min_depth"), c)) for c in COV_EDGES]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "time `depth` on clean from it and from this one")
    ap.add_argument("--workdir", help="where clean.bam is written (a "
                    "temporary directory, removed after, by default)")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from samtools_tpu_torch import build
    build.build(("cuda",))
    with open(build.lib_path("cuda")[:-3] + ".log") as f:
        log = f.read().split("$ ")
    ptxas = [ln.strip() for part in log if any(
        f"csrc/{k}.cu" in part.split("\n", 1)[0]
        for k in ("apply_expand", "depth_scan", "cov_reduce"))
        for ln in part.splitlines()[1:]
        if "registers" in ln or "spill" in ln or "entry function" in ln]
    dev = torch.device("cuda")
    res = {"card": torch.cuda.get_device_name(0), "ptxas": ptxas}

    def show(*keys):
        print(json.dumps({k: res[k] for k in keys}), flush=True)
    ref_dev, buf_dev = apply_inputs(dev)
    res.update(apply_rows(ref_dev, buf_dev))
    res["k8_constants"] = k8_constants(ref_dev, buf_dev)
    show("apply_expand", "baq_apply_device_ms", "k8_constants")
    del ref_dev, buf_dev
    diff, L = clean_depth_column(dev)
    res["depth_scan"] = depth_row(diff, None, L)
    # with a direct column as well: 0/1 weights, as depth -q gives
    direct = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2, (diff.shape[0], 1)).astype(np.int32)).to(dev)
    res["depth_scan_direct"] = depth_row(diff, direct, L)
    res["depth_edges"] = depth_edges(dev)
    show("depth_scan", "depth_scan_direct")
    del diff, direct
    res["cov_reduce"] = cov_row(coverage_census(dev))
    res["cov_edges"] = cov_edges(dev)
    show("cov_reduce")
    torch.cuda.empty_cache()
    res["depth_transports"] = depth_transports()
    show("depth_transports")
    if a.parent:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            res["depth_walls"] = depth_walls(a.parent, a.workdir or tmp)
        show("depth_walls")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
