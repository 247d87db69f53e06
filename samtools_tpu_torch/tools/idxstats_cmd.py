"""samtools idxstats: mapped and unmapped reads per contig.

Counterpart of samtools_tpu/tools/idxstats_cmd.py (samtools'
bam_index.c:231-310): the index's pseudo-bin counts for a BAM with a
.bai/.csi, a whole-file count without one (and for SAM and CRAM); rows
``name\\tlen\\tmapped\\tunmapped`` and a ``*`` row.  A host command: it
does no device work.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.flags import FUNMAP
from ..io import index as idxmod
from ..io.files import detect_format, read_alignments
from ..io.stream import BamStream
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)


def usage(fp):
    fp.write("Usage: samtools idxstats [options] <in.bam>\n"
             "  -X           Include customized index file\n")


def slow_counts(path: str, threads: int):
    """(header, counts[n_ref + 1, 2]) from a whole-file read (samtools'
    slow_idxstats, bam_index.c:173-221): row 0 the unplaced reads, column
    0 mapped, 1 unmapped; (None, None) when the file is not position
    sorted."""
    f = read_alignments(path, threads=threads)
    b = f.batch
    tid = b.tid.astype(np.int64)
    if b.n:
        # each contig must come in one run
        seen = tid[np.concatenate([[0], np.nonzero(np.diff(tid))[0] + 1])]
        if np.unique(seen).size != seen.size:
            print_error("idxstats", "file is not position sorted")
            return None, None
    unmapped = (b.flag & FUNMAP) != 0
    n = f.header.n_refs + 1
    m = np.bincount(tid[~unmapped] + 1, minlength=n)
    u = np.bincount(tid[unmapped] + 1, minlength=n)
    return f.header, np.stack([m, u], axis=1)


def main_idxstats(argv: list[str]) -> int:
    ga = GlobalArgs()
    has_index_file = False
    try:
        opts, args = gnu_getopt(argv, "@:X", [])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-X":
            has_index_file = True
        elif not handle_global_opt(ga, o, v):
            usage(sys.stderr)
            return 1
    if len(args) != (2 if has_index_file else 1):
        usage(sys.stdout if not args else sys.stderr)
        return 0 if not args else 1
    path = args[0]
    try:
        fmt = detect_format(path)
    except OSError as e:
        print_error_errno("idxstats", 'failed to open "%s"', path, exc=e)
        return 1

    idx = None
    if fmt == "bam":
        idx = idxmod.load_index(args[1] if has_index_file
                                else idxmod.find_index_file(path))
        if idx is None:
            print_error("idxstats", 'fail to load index for "%s", '
                        "reverting to slow method", path)
    if idx is not None:
        with BamStream(path, threads=ga.nthreads or 2) as st:
            h = st.header
        for i in range(h.n_refs):
            m, u = idx.stat(i)
            print(f"{h.ref_names[i]}\t{h.ref_lens[i]}\t{m}\t{u}")
        print(f"*\t0\t0\t{idx.n_no_coor}")
        return 0

    header, counts = slow_counts(path, ga.nthreads)
    if header is None:
        print_error("idxstats", 'failed to process "%s"', path)
        return 1
    for i in range(header.n_refs):
        print(f"{header.ref_names[i]}\t{header.ref_lens[i]}"
              f"\t{counts[i + 1, 0]}\t{counts[i + 1, 1]}")
    print(f"*\t0\t{counts[0, 0]}\t{counts[0, 1]}")
    return 0
