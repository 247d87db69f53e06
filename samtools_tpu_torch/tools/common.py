"""Shared command-line plumbing of the port's subcommands.

Counterpart of samtools_tpu/tools/common.py (:17-150); samtools' analogs
are sam_opts.c (the global long options every tool accepts),
sam_utils.c (print_error / print_error_errno) and the region iterator
the tools open (``try_region_read``).  Also the port's own rules
for where a command's device work runs (``pick_device``) and for what it
does not do yet (``not_ported``).
"""

from __future__ import annotations

import getopt
import os
import sys
from dataclasses import dataclass, field

import torch

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


def not_ported(cmd: str, what: str) -> int:
    """One stderr line for an input or option the port does not take
    yet; the command's exit code."""
    sys.stderr.write(f"[{cmd}] {what} is not ported yet\n")
    return 1


def n_shards() -> int:
    """SAMTPU_SHARDS as the JAX mpileup and consensus read it: the span
    count of their span workers (1 by default or when malformed; no
    cap)."""
    try:
        return max(int(os.environ.get("SAMTPU_SHARDS", "1")), 1)
    except ValueError:
        return 1


def n_spans(header, shards: int) -> int:
    """How many genome spans the JAX span workers (mpileup's
    ``_run_sharded``, consensus's ``_run_sharded_consensus``) cut the
    contigs into for ``shards``: spans of max(ceil(len / shards), 1 Mi)
    per contig.  With fewer than two they run serially."""
    total = 0
    for ln in header.ref_lens:
        ln = int(ln)
        if ln > 0:
            step = max((ln + shards - 1) // shards, 1 << 20)
            total += (ln + step - 1) // step
    return total


def device_shards(dev) -> int:
    """SAMTPU_SHARDS as the JAX depth and flagstat read it (``_n_shards``,
    samtools_tpu/tools/depth_cmd.py:103-118): ``all`` is every device, a
    malformed value 1, and the count is capped at the device count (the
    CUDA cards for a CUDA ``dev``, 1 on the CPU), so one device runs
    unsharded."""
    ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
    v = os.environ.get("SAMTPU_SHARDS", "1")
    if v == "all":
        return ndev
    try:
        n = int(v)
    except ValueError:
        return 1
    return max(min(n, ndev), 1)


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
