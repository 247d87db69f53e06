"""samtools head: print the header and, with ``-n``, the first records.

Counterpart of samtools_tpu/tools/head_cmd.py (samtools' main_head,
sam_view.c:1760-1878).  A host command: no device work.
"""

from __future__ import annotations

import sys

from ..io.files import read_alignments
from ..io.sam_text import format_record
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)


def usage(fp) -> None:
    fp.write(
        "Usage: samtools head [OPTION]... [FILE]\n"
        "Options:\n"
        "  -h, --headers INT   Display INT header lines [all]\n"
        "  -n, --records INT   Display INT alignment record lines [none]\n")


def main_head(argv: list[str]) -> int:
    ga = GlobalArgs()
    all_headers = True
    nheaders = 0
    nrecords = 0
    try:
        opts, args = gnu_getopt(argv, "h:n:T:@:", ["headers=", "records="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-h", "--headers"):
            all_headers = False
            nheaders = int(v, 0)
        elif o in ("-n", "--records"):
            nrecords = int(v, 0)
        elif not handle_global_opt(ga, o, v, short_reference="-T"):
            usage(sys.stderr)
            return 1
    if len(args) > 1:
        usage(sys.stderr)
        return 1
    if not args and sys.stdin.isatty():
        usage(sys.stdout)
        return 0
    fname = args[0] if args else "-"
    try:
        f = read_alignments(fname, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("head", 'failed to open "%s" for reading', fname,
                          exc=e)
        return 1
    except Exception:
        print_error("head", 'failed to read the header from "%s"', fname)
        return 1
    text = f.header.text
    if all_headers:
        sys.stdout.write(text)
    elif nheaders > 0:
        lines = text.split("\n")
        sys.stdout.write("\n".join(lines[:nheaders]))
        if len(lines) > nheaders:
            sys.stdout.write("\n")
    if nrecords > 0:
        for i in range(min(nrecords, f.batch.n)):
            print(format_record(f.header, f.batch, i))
    return 0
