"""Shared command-line plumbing of the port's subcommands.

Counterpart of samtools_tpu/tools/common.py (:17-150); samtools' analogs
are sam_opts.c (the global long options every tool accepts),
sam_utils.c (print_error / print_error_errno) and the region iterator
the tools open (``try_region_read``).  Also the port's own rules for
where a command's device work runs (``pick_device``), the devices a
command's mesh spans (``mesh_devices``, ``device_shards``) and how a
command runs its span workers (``worker_env``, ``worker_device``,
``run_span_workers``).
"""

from __future__ import annotations

import getopt
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field

import torch

from ..core import metrics
from ..core.regions import parse_region
from ..device import resolve
from ..io.files import AlignmentFile
from ..io.stream import BamStream


def print_error(subcommand: str, fmt: str, *args):
    """One stderr message in samtools' format."""
    sys.stdout.flush()
    msg = (fmt % args) if args else fmt
    if subcommand:
        sys.stderr.write(f"samtools {subcommand}: {msg}\n")
    else:
        sys.stderr.write(f"samtools: {msg}\n")
    sys.stderr.flush()


def print_error_errno(subcommand: str, fmt: str, *args,
                      exc: OSError | None = None):
    extra = os.strerror(exc.errno) if exc is not None and exc.errno else None
    msg = (fmt % args) if args else fmt
    if extra:
        print_error(subcommand, "%s: %s", msg, extra)
    else:
        print_error(subcommand, "%s", msg)


@dataclass
class GlobalArgs:
    """Parsed global options (samtools' sam_global_args)."""
    in_fmt: str | None = None
    in_opts: dict = field(default_factory=dict)
    out_fmt: str | None = None
    out_opts: dict = field(default_factory=dict)
    reference: str | None = None
    nthreads: int = 0
    write_index: bool = False
    verbosity: int = 3


# long options every tool accepts (samtools' SAM_OPT_GLOBAL_OPTIONS)
GLOBAL_LONG_OPTS = [
    "input-fmt=", "input-fmt-option=", "output-fmt=", "output-fmt-option=",
    "reference=", "threads=", "write-index", "verbosity=",
]


def _parse_fmt(val: str) -> tuple[str, dict]:
    """FORMAT[,opt[=val]]... as htslib's hts_parse_format reads it."""
    parts = val.split(",")
    opts = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            opts[k] = v
        elif p:
            opts[p] = "1"
    return parts[0].lower(), opts


def handle_global_opt(ga: GlobalArgs, opt: str, val: str,
                      short_threads: str | None = "-@",
                      short_outfmt: str | None = None,
                      short_reference: str | None = None) -> bool:
    """Apply one parsed option if it is a global one; True if it was."""
    if opt == "--input-fmt":
        ga.in_fmt, extra = _parse_fmt(val)
        ga.in_opts.update(extra)
    elif opt == "--input-fmt-option":
        k, _, v = val.partition("=")
        ga.in_opts[k] = v
    elif opt == "--output-fmt" or (short_outfmt and opt == short_outfmt):
        ga.out_fmt, extra = _parse_fmt(val)
        ga.out_opts.update(extra)
    elif opt == "--output-fmt-option":
        k, _, v = val.partition("=")
        ga.out_opts[k] = v
    elif opt == "--reference" or (short_reference and opt == short_reference):
        ga.reference = val
    elif opt == "--threads" or (short_threads and opt == short_threads):
        ga.nthreads = int(val)
    elif opt == "--write-index":
        ga.write_index = True
    elif opt == "--verbosity":
        ga.verbosity = int(val)
        metrics.set_verbosity(ga.verbosity)
    else:
        return False
    return True


class UsageError(Exception):
    pass


def gnu_getopt(argv: list[str], shortopts: str, longopts: list[str]):
    """getopt.gnu_getopt with samtools' error behaviour: a bad option
    raises UsageError (the caller prints usage to stderr and exits 1)."""
    try:
        return getopt.gnu_getopt(argv, shortopts, longopts + GLOBAL_LONG_OPTS)
    except getopt.GetoptError as e:
        raise UsageError(str(e)) from None


def out_level(ga: GlobalArgs) -> int:
    """The compression level of ``--output-fmt-option level=N``: 6 by
    default or when N is not a number."""
    try:
        return int(ga.out_opts.get("level", 6))
    except ValueError:
        return 6


def open_stream(path: str, threads: int) -> BamStream | None:
    """A BamStream on ``path``, or None when the file is not a
    BGZF-compressed BAM (the caller reads it whole).  OSError
    propagates."""
    try:
        return BamStream(path, threads=threads or 2)
    except RuntimeError:        # BgzfError, BamError
        return None


def open_streams(paths: list[str], threads: int) -> list[BamStream]:
    """A BamStream on each path, or [] when any path is ``-`` or not a
    BGZF BAM (the caller reads every file whole, as the JAX tools do).
    OSError propagates; no stream is left open but those returned."""
    streams = []
    try:
        for path in paths:
            st = None if path == "-" else open_stream(path, threads)
            if st is None:
                break
            streams.append(st)
        else:
            return streams
    except OSError:
        for st in streams:
            st.close()
        raise
    for st in streams:
        st.close()
    return []


def try_region_read(path: str, threads: int, reg: str):
    """(AlignmentFile, Region) holding only the reads of ``reg`` that the
    BAI/CSI chunks give (the sam_itr_querys path of samtools'
    bam_plcmd.c:541-550), or None when the file is not an indexed BAM or
    the region names no contig (the caller reads the whole file).
    Raises RegionError for a region that does not parse."""
    if path == "-":
        return None
    st = open_stream(path, threads)
    if st is None:
        return None
    with st:
        if st.index() is None:
            return None
        region = parse_region(reg, st.header.tid)
        if region.tid < 0:
            return None
        batch = st.query(region.tid, region.beg, region.end)
        return (AlignmentFile(header=st.header, batch=batch, format="bam"),
                region)


def n_shards() -> int:
    """SAMTPU_SHARDS as the JAX mpileup and consensus read it: the span
    count of their span workers (1 by default or when malformed; no
    cap)."""
    try:
        return max(int(os.environ.get("SAMTPU_SHARDS", "1")), 1)
    except ValueError:
        return 1


def spans(header, shards: int) -> list[tuple[int, int, int]]:
    """The genome spans (tid, beg, end) of the JAX span workers (mpileup's
    ``_run_sharded``, consensus's ``_run_sharded_consensus``) for
    ``shards``: each contig cut into spans of max(ceil(len / shards),
    1 Mi) positions, in contig order.  With fewer than two the port runs
    serially."""
    out = []
    for tid, ln in enumerate(header.ref_lens):
        ln = int(ln)
        if ln > 0:
            step = max((ln + shards - 1) // shards, 1 << 20)
            out += [(tid, beg, min(beg + step, ln))
                    for beg in range(0, ln, step)]
    return out


def strip_args(argv: list, opts: tuple) -> list:
    """``argv`` without the options ``opts`` and their values (each takes
    one): the arguments a parent forwards to its span workers."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in opts:
            skip = True
        else:
            out.append(a)
    return out


def mesh_devices(dev, n: int) -> list:
    """The devices a tool's mesh spans when ``n`` shards are asked for:
    the first min(n, count) CUDA cards for a CUDA ``dev``, the one
    ``dev`` otherwise (the CPU)."""
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(min(n, torch.cuda.device_count()))]
    return [dev]


def device_shards(dev) -> int:
    """SAMTPU_SHARDS as the JAX depth and flagstat read it (``_n_shards``,
    samtools_tpu/tools/depth_cmd.py:103-118): ``all`` is every device, a
    malformed value 1, and the count is capped at the device count
    (``mesh_devices``: the CUDA cards for a CUDA ``dev``, 1 on the CPU),
    so one device runs unsharded."""
    v = os.environ.get("SAMTPU_SHARDS", "1")
    if v == "all":
        n = sys.maxsize
    else:
        try:
            n = int(v)
        except ValueError:
            return 1
    return max(len(mesh_devices(dev, n)), 1) if n > 1 else 1


# the parent's resolved device, handed to its span workers
WORKER_DEVICE = "SAMTPU_TORCH_WORKER_DEVICE"


def worker_env(dev, **extra) -> dict:
    """The environment of a span worker (``python -m
    samtools_tpu_torch``): the parent's with ``extra``, this checkout
    first on PYTHONPATH, and the parent's device under WORKER_DEVICE
    (absent on the host branch, ``dev`` None, where SAMTPU_DEVICE passes
    through)."""
    env = dict(os.environ, **extra)
    env.pop(WORKER_DEVICE, None)
    if dev is not None:
        env[WORKER_DEVICE] = str(dev)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def worker_device(device):
    """A span worker's device: the caller's, else the one its parent
    handed it (WORKER_DEVICE), else None (the CUDA card).  Only the
    worker branches read it: a worker never picks the CPU by itself."""
    return device if device is not None else os.environ.get(WORKER_DEVICE)


def run_span_workers(argvs: list, envs: list, shards: int,
                     dev) -> list[tuple[int, bytes]]:
    """Run ``python -m samtools_tpu_torch <argv>`` for each argv with its
    environment, at most ``shards`` at a time (the JAX tools' cap), each
    worker's standard error into a temporary file (a worker writes its
    output to a file, nothing to our standard output); wait for every
    one.
    On the card the kernels are built first, so the workers only load
    them.  Returns (exit code, standard error) of each, in order."""
    if dev is not None and dev.type == "cuda":
        from .. import build
        build.build()
    procs, errs = [], []
    try:
        for argv, env in zip(argvs, envs):
            errs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "samtools_tpu_torch", *argv],
                env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=errs[-1]))
            while sum(p.poll() is None for p in procs) >= shards:
                procs[-shards].wait()
        got = []
        for p, err in zip(procs, errs):
            rc = p.wait()
            err.seek(0)
            got.append((rc, err.read()))
        return got
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()


def report_failed(workers: list[tuple[int, bytes]]) -> None:
    """Copy each failed worker's standard error to ours."""
    sys.stdout.flush()
    for rc, err in workers:
        if rc != 0:
            sys.stderr.write(err.decode(errors="replace"))
    sys.stderr.flush()


def pick_device(device=None):
    """Where a command's device work runs: None for the host branch
    (``SAMTPU_DEVICE=0|host``, numpy), else the torch device ``device``
    names (None: the CUDA card).  No size threshold sends work to the
    host.  Raises RuntimeError when the card is named and CUDA is
    missing."""
    if os.environ.get("SAMTPU_DEVICE") in ("0", "host"):
        return None
    return resolve(device)


def no_card(cmd: str, err: RuntimeError) -> int:
    """Report ``pick_device``'s error; the command's exit code."""
    sys.stderr.write(f"[{cmd}] {err} (SAMTPU_DEVICE=0 runs the host "
                     "branch)\n")
    return 1
