"""Where the time of the port's census core, or of its mpileup, depth,
coverage, bedcov, consensus, flagstat, stats, targetcut, phase or tview
command, goes on one CUDA card.

    python3 scripts/torch_core_profile.py [--ref-len N] [--coverage X]
        [--messy | --pairs | --islands] [--tool [--mpileup-args "OPTS"] |
        --pileup "CMD [OPTS]" ... [--host]] [--out PATH.json]

Simulates the bench workload (8 Mbp x 30x x 100 bp by default), writes it
as a BAM with the port's writer, then streams it through BamStream ->
DeviceCensusPipeline -> finish() twice:

1. timed: host seconds of each pipeline stage, exclusive of the stages
   it calls (a stack of perf_counter timers wrapped around the methods);
2. profiled: torch.profiler over the same run, for the device time of
   every kernel by name, and of the torch kernels each pipeline stage
   launches (``stage_device_s``: a record_function range around the
   stage, inclusive of the stages it calls; the profiler ties a kernel to
   the torch op that launched it, so the port's own kernels, launched
   through ctypes, count in no stage).  The device's idle share is
   1 - busy / wall_s, against the timed pass's wall (the one Mbases_per_s
   reads), not the profiled pass's, which carries the profiler's own
   cost; the port runs on one stream, so kernel times do not overlap.

A stage the package does not have is skipped, so the script also
profiles a tree whose pipeline has other stages (``_weights``, the
weight build the census form of K1 took over).

With ``--tool`` the runs are the mpileup command instead, in-process
(``cli.main(["mpileup", "-f", ref.fa, in.bam, "-o", out])``, the text
written to a file beside the BAM): one warm-up (its wall is
``first_run_wall_s``), one timed (host seconds per tool stage, exclusive,
in ``TOOL_STAGES``), one profiled (device busy time and idle share); then
the command in a fresh process, plain (``fresh_process_wall_s``) and under
cProfile (the top functions by self seconds, and the port's own by
cumulative seconds).  ``tool_text_bytes`` is the output's size.
``--mpileup-args "-s -O"`` passes those options to every run (before the
BAM), which sends the command down its general path: BAQ through
``apply_baq_batch`` (K8), the pileup table and its order (K13), the entry
pieces and the row renderer, each a stage of ``TOOL_STAGES``.
``--pairs`` simulates overlapping messy pairs instead
(``sim.simulate_overlapping_pairs``), so the overlap tweak has work.

With ``--pileup "depth -a"`` (or ``coverage ...``, ``bedcov ...``,
``consensus ...``, ``flagstat``, ``stats ...``) the runs are that command
in-process on the BAM (``-o`` to a file; flagstat and stats write to
standard output, captured;
bedcov
reads a seeded BED of 1,000 intervals of 1-10 kbp and the BAM on
standard input, its in-memory branch, and writes to standard output,
captured): a warm-up, a timed run (host seconds per
stage in ``PILEUP_STAGES``, exclusive) and a profiled run (device busy
time and idle share).  ``--pileup`` may be given several times: each
command runs on the same BAM, its result under ``runs``.  ``--host``
runs each on the numpy host branch (``SAMTPU_DEVICE=0``) as well.

``--islands`` profiles ``chip_smoke.py``'s pileup_tools cell instead of
the bench workload (a 200 kbp contig, reads at 30x over three 40 kbp
islands of a diploid sample; ``--ref-len``, ``--coverage`` and ``--seed``
do not apply), with its FASTA beside the BAM: ``--pileup "targetcut -f
{fa}"``, ``--pileup phase`` and ``--pileup "tview -d T -w 120 -p
sim1:100001"`` (tview gets the BAM and the FASTA after its options; the
others write to standard output, captured).  Their stages: the error
model (``ErrMod.cal``), ``gencns``, ``process_cns``, ``phase_block``
(with ``count_all`` and ``fragphase`` inside it), ``assign_levels``,
``bcf_call_glfgen``, ``build_pileup`` with K13 (``entry_order``) and
``apply_baq_batch`` with K8 (``_apply_baq_device``) and the host HMM
(``baq_batch``).

Prints one JSON object, and writes it to --out when that is given.
"""

from __future__ import annotations

import argparse
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from samtools_tpu_torch import cli, kernels  # noqa: E402
from samtools_tpu_torch.core.batch import ReadBatch  # noqa: E402
from samtools_tpu_torch.io import stream  # noqa: E402
from samtools_tpu_torch.io.bam import write_bam  # noqa: E402
from samtools_tpu_torch.io.stream import BamStream  # noqa: E402
from samtools_tpu_torch.ops import depth as dops  # noqa: E402
from samtools_tpu_torch.ops import baq as baqmod  # noqa: E402
from samtools_tpu_torch.ops import mpileup_device as md  # noqa: E402
from samtools_tpu_torch.ops import pileup as plmod  # noqa: E402
from samtools_tpu_torch.ops import pileup_engine as pe  # noqa: E402
from samtools_tpu_torch.sim import (make_header, simulate_batch,  # noqa: E402
                                    simulate_messy,
                                    simulate_overlapping_pairs,
                                    simulate_reference)
from samtools_tpu_torch.ops import errmod  # noqa: E402
from samtools_tpu_torch.tools import (bedcov_cmd,  # noqa: E402
                                      consensus_cmd, coverage_cmd,
                                      depth_cmd, flagstat_cmd, mpileup_cmd,
                                      phase_cmd, stats_batch, stats_cmd,
                                      targetcut_cmd, tview_cmd)

STAGES = ("_gather_rows", "_make_buf", "_plan", "_h2d", "_expand",
          "_weights", "_chunk_step", "_drain", "_host_reads", "finish")
# (owner, attribute) of each tool stage; the owner is looked up by name in
# the tool's module namespace
TOOL_STAGES = (("mpileup_cmd._WindowCursor", "_pull"),
               ("mpileup_cmd._WindowCursor", "window"),
               ("mpileup_cmd", "_read_filter"),
               ("mpileup_cmd", "_prepare_sub"),
               ("mpileup_cmd._DeviceBaqEngine", "run_window"),
               ("md.DeviceCensusPipeline", "begin_window"),
               ("md.DeviceCensusPipeline", "finish_window"),
               ("md.DeviceCensusPipeline", "_host_apply"),
               ("md.DeviceCensusPipeline", "_gather_rows"),
               ("md.DeviceCensusPipeline", "_make_buf"),
               ("md.DeviceCensusPipeline", "_chunk_step"),
               ("md", "classify_reads"),
               ("mpileup_cmd", "tweak_overlaps"),
               ("mpileup_cmd.native", "mpileup_text"),
               ("ReadBatch", "take"),
               ("ReadBatch", "concat"),
               # the general path
               ("mpileup_cmd", "build_pileup"),
               ("plmod", "entry_order"),
               ("mpileup_cmd", "build_entry_pieces"),
               ("mpileup_cmd", "_render_rows"),
               ("baqmod", "_apply_baq_device"),
               ("baqmod.native", "baq_batch"))
# the same for the pileup family: whole-file reads, the stream cursor,
# the host item build, K1 with its uploads, K9, the numpy branch, rows
PILEUP_STAGES = (("depth_cmd", "read_alignments"),
                 ("coverage_cmd", "read_alignments"),
                 ("bedcov_cmd", "read_alignments"),
                 ("stream._Cursor", "_pull"),
                 ("stream._Cursor", "take"),
                 ("coverage_cmd._Stats", "select"),
                 ("pe", "depth_items"),
                 ("pe", "coverage_items"),
                 ("pe", "segment_matmul"),
                 ("pe", "depth_scan"),
                 ("pe", "cov_reduce"),
                 ("dops", "depth_window"),
                 ("dops", "coverage_envelope"),
                 ("dops", "overlap_clips"),
                 ("coverage_cmd", "window_host"),
                 ("bedcov_cmd", "_mspan_depth"),
                 ("bedcov_cmd", "_build_states_streaming"),
                 ("depth_cmd", "_emit"),
                 ("coverage_cmd", "build_pileup"),
                 ("plmod", "entry_order"),
                 # consensus: the reads, the table, per-read preparation,
                 # the scorer (K10 with its copies, or the f64 host loop),
                 # the insertion sites, the writer
                 ("consensus_cmd", "read_alignments"),
                 ("consensus_cmd", "build_pileup"),
                 ("consensus_cmd", "expand_ops"),
                 ("consensus_cmd.auxmod", "batch_tag_values"),
                 ("consensus_cmd.natmod", "nm_init_batch"),
                 ("consensus_cmd.CV", "entry_quals"),
                 ("consensus_cmd.CV", "gap5_scores_device"),
                 ("consensus_cmd.CV", "gap5_scores"),
                 ("consensus_cmd.CV", "gap5_finalize"),
                 ("consensus_cmd.CV", "consensus_base_vec"),
                 ("consensus_cmd", "_ins_sites_vec"),
                 ("consensus_cmd", "_fasta_emit"),
                 ("consensus_cmd", "dump_fastq"),
                 # flagstat: the batches, K11 with its copies, numpy
                 ("flagstat_cmd.fsops", "flagstat_counts"),
                 ("flagstat_cmd.fsops", "flagstat_numpy"),
                 # stats: the batch engine's passes, K12 with its copies
                 # (orig_hists) or the host library's pass, the CRC pass,
                 # the sorted-block residue, mismatches per cycle, output
                 ("stats_batch", "collect_batch"),
                 ("stats_batch", "_orig_read_stats"),
                 ("stats_batch.K", "orig_hists"),
                 ("stats_batch.native", "stats_orig_hists"),
                 ("stats_batch.native", "stats_crc32_batch"),
                 ("stats_batch", "_count_indels_batch"),
                 ("stats_batch", "_isize_batch"),
                 ("stats_batch", "_sorted_block"),
                 ("stats_batch.native", "stats_cov_gcd"),
                 ("stats_batch", "_mismatches_batch"),
                 ("stats_cmd.Stats", "output"),
                 # targetcut, phase, tview: the reads, BAQ (K8 and the
                 # host HMM), the table with K13, the per-column loops
                 ("targetcut_cmd", "read_alignments"),
                 ("phase_cmd", "read_alignments"),
                 ("tview_cmd", "read_alignments"),
                 ("targetcut_cmd", "apply_baq_batch"),
                 ("baqmod", "_apply_baq_device"),
                 ("baqmod.native", "baq_batch"),
                 ("targetcut_cmd", "build_pileup"),
                 ("phase_cmd", "build_pileup"),
                 ("tview_cmd", "build_pileup"),
                 ("errmod.ErrMod", "cal"),
                 ("targetcut_cmd", "gencns"),
                 ("targetcut_cmd", "process_cns"),
                 ("phase_cmd", "phase_block"),
                 ("phase_cmd", "count_all"),
                 ("phase_cmd", "fragphase"),
                 ("phase_cmd", "write_alignments"),
                 ("tview_cmd", "assign_levels"),
                 ("tview_cmd", "bcf_call_glfgen"),
                 ("ReadBatch", "take"),
                 ("ReadBatch", "concat"))


def annotated(name, fn):
    """fn inside a torch.profiler range of its own name."""
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


class StageTimer:
    """Exclusive host seconds per wrapped function."""

    def __init__(self):
        self.acc = defaultdict(float)
        self._stack = []

    def wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*a, **k)
            finally:
                child = self._stack.pop()
                dt = time.perf_counter() - t0
                self.acc[name] += dt - child
                if self._stack:
                    self._stack[-1] += dt
        return timed


def run(path, ref_int, ref_len, threads, timer=None):
    pipe = md.DeviceCensusPipeline(ref_int, ref_len)
    t0 = time.perf_counter()
    with BamStream(path, threads=threads, window_bytes=64 << 20) as st:
        it = st.batches()
        while True:
            t1 = time.perf_counter()
            batch = next(it, None)
            if timer is not None:
                timer.acc["stream_decode"] += time.perf_counter() - t1
            if batch is None:
                break
            pipe.add_batch(batch)
    pipe.finish()
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def _owner(path: str):
    names = {"mpileup_cmd": mpileup_cmd, "md": md, "ReadBatch": ReadBatch,
             "depth_cmd": depth_cmd, "coverage_cmd": coverage_cmd,
             "bedcov_cmd": bedcov_cmd, "stream": stream, "pe": pe,
             "dops": dops, "plmod": plmod, "baqmod": baqmod,
             "consensus_cmd": consensus_cmd, "flagstat_cmd": flagstat_cmd,
             "stats_batch": stats_batch, "stats_cmd": stats_cmd,
             "targetcut_cmd": targetcut_cmd, "phase_cmd": phase_cmd,
             "tview_cmd": tview_cmd, "errmod": errmod}
    head, *rest = path.split(".")
    obj = names[head]
    for r in rest:
        obj = getattr(obj, r)
    return obj


def run_tool(fa, path, out, extra=()):
    t0 = time.perf_counter()
    rc = cli.main(["mpileup", "-f", fa, *extra, path, "-o", out])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"mpileup exited {rc}")
    return time.perf_counter() - t0


def profile_tool(path, ref, d, n_reads, extra=()):
    """The mpileup command's warm-up, timed and profiled runs, with the
    options ``extra``."""
    fa = os.path.join(d, "ref.fa")
    with open(fa, "wb") as f:
        f.write(b">sim1\n" + b"".join(ref[i:i + 60].tobytes() + b"\n"
                                      for i in range(0, ref.size, 60)))
    with open(fa + ".fai", "w") as f:
        f.write(f"sim1\t{ref.size}\t6\t60\t61\n")
    out = os.path.join(d, "tool.pileup")
    warm = run_tool(fa, path, out, extra)   # warm-up: the first run
    timer = StageTimer()
    saved = [(_owner(o), a, getattr(_owner(o), a)) for o, a in TOOL_STAGES]
    for obj, a, fn in saved:
        wrapped = timer.wrap(a, fn)
        setattr(obj, a, staticmethod(wrapped) if a == "concat" else wrapped)
    try:
        wall = run_tool(fa, path, out, extra)
    finally:
        for obj, a, fn in saved:
            setattr(obj, a, staticmethod(fn) if a == "concat" else fn)
    kernels.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = run_tool(fa, path, out, extra)
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0) + t / 1e6
    busy = sum(dev.values())
    host_total = sum(timer.acc.values())
    # the command as a user starts it: a fresh process, once plain and
    # once under cProfile (its top functions by cumulative time)
    cmd = ["-m", "samtools_tpu_torch", "mpileup", "-f", fa, *extra, path,
           "-o", out]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, *cmd], check=True, cwd=ROOT,
                   stderr=subprocess.DEVNULL)
    fresh = time.perf_counter() - t0
    stats = os.path.join(d, "fresh.prof")
    subprocess.run([sys.executable, "-m", "cProfile", "-o", stats, *cmd],
                   check=True, cwd=ROOT, stderr=subprocess.DEVNULL)
    st = pstats.Stats(stats).stats

    def name(k):
        return f"{os.path.basename(k[0])}:{k[1]}({k[2]})"
    # self seconds of the costliest functions; cumulative seconds of the
    # port's own
    self_top = sorted(((v[2], name(k)) for k, v in st.items()),
                      reverse=True)[:20]
    port_cum = sorted(((v[3], name(k)) for k, v in st.items()
                       if "samtools_tpu_torch" in k[0]), reverse=True)[:15]
    return {
        "wall_s": wall,
        "Mbases_per_s": n_reads * 100 / wall / 1e6,
        "first_run_wall_s": warm,
        "fresh_process_wall_s": fresh,
        "fresh_process_cprofile_self_s": {n: round(t, 3)
                                          for t, n in self_top},
        "fresh_process_cprofile_port_cumulative_s": {
            n: round(t, 3) for t, n in port_cum},
        "tool_text_bytes": os.path.getsize(out),
        "host_stage_s": dict(sorted(timer.acc.items(),
                                    key=lambda kv: -kv[1])),
        "host_stage_sum_s": host_total,
        "outside_stages_s": wall - host_total,
        "profiled_wall_s": wall_prof,
        "device_busy_s": busy if dev else "not measured",
        "device_idle_share": 1 - busy / wall if dev else "not measured",
        "device_top_s": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:12]),
        "launches": dict(kernels.launches),
    }


def run_pileup(argv, stdin=None):
    """One in-process run of a pileup command (``stdin``: a file given as
    standard input); its wall."""
    import contextlib
    import io
    t0 = time.perf_counter()
    old = sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.TextIOWrapper(open(stdin, "rb"))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
    finally:
        if sys.stdin is not old:
            sys.stdin.close()
            sys.stdin = old
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return time.perf_counter() - t0


def profile_pileup(spec, path, d, n_reads, host, ref_len, fa=None):
    """The pileup command's warm-up, timed and profiled runs (``fa``: the
    FASTA that ``{fa}`` in ``spec`` names, and tview's reference)."""
    import shlex
    words = [w.format(fa=fa) for w in shlex.split(spec)]
    out = os.path.join(d, "pileup.out")
    if words[0] == "tview":
        argv, stdin = [*words, path, fa], None
    elif words[0] in ("targetcut", "phase"):
        argv, stdin = [*words, path], None
    elif words[0] == "bedcov":
        bed = os.path.join(d, "regions.bed")
        rng = np.random.default_rng(21)
        with open(bed, "w") as f:
            for s0 in np.sort(rng.integers(0, max(1, ref_len - 10000),
                                           1000)):
                f.write(f"sim1\t{s0}\t{s0 + rng.integers(1000, 10001)}\n")
        argv, stdin = [*words, bed, "-"], path
    elif words[0] in ("flagstat", "stats"):
        argv, stdin = [*words, path], None
    else:
        argv, stdin = [*words, path, "-o", out], None
    if host:
        os.environ["SAMTPU_DEVICE"] = "0"
    else:
        os.environ.pop("SAMTPU_DEVICE", None)
    warm = run_pileup(argv, stdin)
    timer = StageTimer()
    saved = [(_owner(o), a, getattr(_owner(o), a)) for o, a in PILEUP_STAGES]
    for obj, a, fn in saved:
        wrapped = timer.wrap(a, fn)
        setattr(obj, a, staticmethod(wrapped) if a == "concat" else wrapped)
    try:
        wall = run_pileup(argv, stdin)
    finally:
        for obj, a, fn in saved:
            setattr(obj, a, staticmethod(fn) if a == "concat" else fn)
    kernels.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = run_pileup(argv, stdin)
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0) + t / 1e6
    busy = sum(dev.values())
    host_total = sum(timer.acc.values())
    return {
        "command": argv[:len(words)], "host_branch": host,
        "wall_s": wall,
        "Mbases_per_s": n_reads * 100 / wall / 1e6,
        "first_run_wall_s": warm,
        "host_stage_s": dict(sorted(timer.acc.items(),
                                    key=lambda kv: -kv[1])),
        "host_stage_sum_s": host_total,
        "outside_stages_s": wall - host_total,
        "profiled_wall_s": wall_prof,
        "device_busy_s": busy if dev else "not measured",
        "device_idle_share": 1 - busy / wall if dev else "not measured",
        "device_top_s": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:12]),
        "launches": dict(kernels.launches),
    }


def write_result(res: dict, out: str | None) -> None:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


def profile_islands(args) -> int:
    """The --pileup commands on chip_smoke.py's pileup_tools cell."""
    import chip_smoke
    with tempfile.TemporaryDirectory() as d:
        cell = chip_smoke.write_tools_inputs(d)
        res = {"device": torch.cuda.get_device_name(0), "mode": "pileup",
               "workload": {"cell": "pileup_tools",
                            "contig_len": chip_smoke.TOOLS_LEN,
                            "islands": chip_smoke.TOOLS_ISLANDS,
                            "coverage": chip_smoke.COVERAGE,
                            "reads": cell["reads"],
                            "het_snps": cell["het_snps"]},
               "runs": [profile_pileup(spec, cell["bam"], d, cell["reads"],
                                       h, chip_smoke.TOOLS_LEN, cell["fa"])
                        for spec in args.pileup
                        for h in ((False, True) if args.host
                                  else (False,))]}
    write_result(res, args.out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref-len", type=int, default=8 << 20)
    ap.add_argument("--coverage", type=float, default=30.0)
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--messy", action="store_true")
    kind.add_argument("--pairs", action="store_true",
                      help="overlapping messy pairs")
    kind.add_argument("--islands", action="store_true",
                      help="chip_smoke.py's pileup_tools cell (for "
                      "targetcut, phase and tview)")
    ap.add_argument("--seed", type=int, default=42)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tool", action="store_true",
                      help="profile the mpileup command, not the core")
    mode.add_argument("--pileup", metavar="CMD", action="append",
                      help='profile a depth, coverage, bedcov, consensus, '
                      'flagstat, stats, targetcut, phase or tview '
                      'command, e.g. "depth -a" (repeatable)')
    ap.add_argument("--mpileup-args", default="",
                    help='with --tool: options for every mpileup run, '
                    'e.g. "-s -O"')
    ap.add_argument("--host", action="store_true",
                    help="with --pileup: the numpy host branch too")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if args.islands and not args.pileup:
        ap.error("--islands profiles --pileup commands")
    if not torch.cuda.is_available():
        print("torch_core_profile: CUDA is not available", file=sys.stderr)
        return 1
    if args.islands:
        return profile_islands(args)
    threads = max(1, min(8, os.cpu_count() or 1))
    ref = simulate_reference(args.ref_len, seed=7)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    ref_int = lut[ref]
    if args.pairs:
        b = simulate_overlapping_pairs(args.ref_len, coverage=args.coverage,
                                       seed=args.seed, ref=ref)
    else:
        b = simulate_batch(ref_len=args.ref_len, coverage=args.coverage,
                           read_len=100, seed=args.seed, paired=False,
                           err_rate=0.01, ref=ref)
    if args.messy:
        simulate_messy(b, args.seed)
    n_reads = b.n
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "core.bam")
        write_bam(path, make_header(args.ref_len), b, threads=threads)
        del b
        if args.tool or args.pileup:
            res = {"device": torch.cuda.get_device_name(0),
                   "mode": "pileup" if args.pileup else "tool",
                   "workload": {"ref_len": args.ref_len,
                                "coverage": args.coverage,
                                "messy": args.messy, "pairs": args.pairs,
                                "reads": int(n_reads),
                                "mpileup_args": args.mpileup_args},
                   **({"runs": [profile_pileup(spec, path, d, n_reads, h,
                                               args.ref_len)
                                for spec in args.pileup
                                for h in ((False, True) if args.host
                                          else (False,))]}
                      if args.pileup else
                      profile_tool(path, ref, d, n_reads,
                                   args.mpileup_args.split()))}
            write_result(res, args.out)
            return 0
        run(path, ref_int, args.ref_len, threads)       # warm-up
        timer = StageTimer()
        saved = {s: getattr(md.DeviceCensusPipeline, s) for s in STAGES
                 if hasattr(md.DeviceCensusPipeline, s)}
        saved_classify = md.classify_reads
        for s, fn in saved.items():
            setattr(md.DeviceCensusPipeline, s, timer.wrap(s, fn))
        md.classify_reads = timer.wrap("classify_reads", saved_classify)
        try:
            pipe, wall = run(path, ref_int, args.ref_len, threads, timer)
        finally:
            for s, fn in saved.items():
                setattr(md.DeviceCensusPipeline, s, fn)
            md.classify_reads = saved_classify
        kernels.reset_launches()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for s, fn in saved.items():
            setattr(md.DeviceCensusPipeline, s, annotated(s, fn))
        try:
            with torch.profiler.profile(activities=acts) as prof:
                _, wall_prof = run(path, ref_int, args.ref_len, threads)
        finally:
            for s, fn in saved.items():
                setattr(md.DeviceCensusPipeline, s, fn)
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        # the stage ranges' own device-side spans are not kernels
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA \
                and e.key not in saved:
            dev[e.key] = dev.get(e.key, 0) + t / 1e6
    stage_dev = defaultdict(float)
    for e in prof.events():
        if e.name in saved and \
                e.device_type == torch.autograd.DeviceType.CPU:
            stage_dev[e.name] += e.device_time_total / 1e6
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    host_total = sum(timer.acc.values())
    res = {
        "device": torch.cuda.get_device_name(0),
        "workload": {"ref_len": args.ref_len, "coverage": args.coverage,
                     "messy": args.messy, "reads": int(n_reads)},
        "wall_s": wall,
        "Mbases_per_s": n_reads * 100 / wall / 1e6,
        "host_stage_s": dict(sorted(timer.acc.items(),
                                    key=lambda kv: -kv[1])),
        "host_stage_sum_s": host_total,
        "host_reads": int(pipe.n_host_reads),
        "risky_reads": int(pipe.n_risky),
        "profiled_wall_s": wall_prof,
        "device_busy_s": busy if dev else "not measured",
        "device_idle_share": 1 - busy / wall if dev else "not measured",
        "device_top_s": dict(top),
        "stage_device_s": dict(stage_dev) if dev else "not measured",
        "launches": dict(kernels.launches),
    }
    write_result(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
