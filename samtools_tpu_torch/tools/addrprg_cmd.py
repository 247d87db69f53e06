"""samtools addreplacerg: add or replace read-group tags.

Counterpart of samtools_tpu/tools/addrprg_cmd.py (samtools'
bam_addrprg.c): ``-r``'s line assembled with ``\\t`` unescaped and
``@RG`` put in front, ``-R``'s ID checked against the header, ``-m
overwrite_all`` (every record's RG deleted and appended; with ``-r`` the
header's other @RG lines dropped) or ``orphan_only``, ``-w`` overwriting
the header's line.  A host command: no device work.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..io.files import infer_output_format, read_alignments, write_alignments
from ..io.header import SamHeader
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)


def usage(fp):
    fp.write(
        "Usage: samtools addreplacerg [options] [-r <@RG line> | -R "
        "<existing id>] [-m orphan_only|overwrite_all] [-o <output.bam>] "
        "<input.bam>\n")


def basic_unescape(s: str):
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            i += 1
            if i >= len(s):
                sys.stderr.write(
                    "[basic_unescape] Unterminated escape sequence.\n")
                return None
            e = s[i]
            if e == "\\":
                out.append("\\")
            elif e == "t":
                out.append("\t")
            elif e == "n":
                sys.stderr.write("[basic_unescape] \\n in escape sequence"
                                 " is not supported.\n")
                return None
            else:
                sys.stderr.write("[basic_unescape] Unsupported escape "
                                 "sequence.\n")
                return None
        else:
            out.append(c)
        i += 1
    return "".join(out)


def get_rg_id(line: str):
    m = re.search(r"\tID:([^\t]*)", line)
    return m.group(1) if m else None


def main_addreplacerg(argv: list[str]) -> int:
    ga = GlobalArgs()
    rg_parts = []
    rg_id = None
    mode = "overwrite_all"
    output_name = None
    no_pg = False
    uncompressed = False
    overwrite_hdr_rg = False
    if not argv:
        usage(sys.stdout)
        return 0
    try:
        opts, args = gnu_getopt(argv, "r:R:m:o:O:h@:uw", ["no-PG"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-r":
            if not rg_parts:
                if len(v) < 3 or (v[0] != "@" and v[1] != "R"
                                  and v[2] != "G"):
                    rg_parts.append("@RG")
            rg_parts.append(v)
        elif o == "-R":
            rg_id = v
        elif o == "-m":
            if v not in ("overwrite_all", "orphan_only"):
                usage(sys.stderr)
                return 1
            mode = v
        elif o == "-o":
            output_name = v
        elif o == "-h":
            usage(sys.stdout)
            return 0
        elif o == "--no-PG":
            no_pg = True
        elif o == "-u":
            uncompressed = True
        elif o == "-w":
            overwrite_hdr_rg = True
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1
    rg_line = "\t".join(rg_parts) if rg_parts else None
    if not args:
        sys.stderr.write("You must specify an input file.\n")
        usage(sys.stderr)
        return 1
    if rg_id and rg_line:
        sys.stderr.write("The options -r and -R are mutually exclusive.\n")
        return 1
    if rg_line:
        rg_line = basic_unescape(rg_line)
        if rg_line is None:
            return 1
        rg_id = get_rg_id(rg_line)
        if rg_id is None:
            sys.stderr.write(
                "[parse_args] The supplied RG line lacks an ID tag.\n")
            return 1

    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e:
        print_error_errno("addreplacerg", 'could not open "%s"', args[0],
                          exc=e)
        return 1
    header = f.header
    b = f.batch

    hdr_lines = [l for l in header.text.split("\n") if l]
    existing_ids = [get_rg_id(l) or "" for l in hdr_lines
                    if l.startswith("@RG")]

    if rg_line:
        if rg_id in existing_ids:
            if overwrite_hdr_rg:
                hdr_lines = [l for l in hdr_lines
                             if not (l.startswith("@RG")
                                     and get_rg_id(l) == rg_id)]
            else:
                sys.stderr.write(
                    "[init] RG line with ID:%s already present in the "
                    "header. Use -w to overwrite.\n" % rg_id)
                return 1
        # htslib appends the new @RG after the last existing RG line (or
        # at the end of the header)
        last_rg = max((i for i, l in enumerate(hdr_lines)
                       if l.startswith("@RG")), default=None)
        at = last_rg + 1 if last_rg is not None else len(hdr_lines)
        hdr_lines.insert(at, rg_line)
        if mode == "overwrite_all":
            hdr_lines = [l for l in hdr_lines
                         if not (l.startswith("@RG")
                                 and get_rg_id(l) != rg_id)]
    else:
        if rg_id is not None:
            if rg_id not in existing_ids:
                sys.stderr.write("RG ID supplied does not exist in header."
                                 " Supply full @RG line with -r instead?\n")
                return 1
        else:
            if not existing_ids:
                sys.stderr.write("No RG specified on command line or in "
                                 "existing header.\n")
                return 1
            rg_id = existing_ids[0]

    out_header = SamHeader.from_text(
        "\n".join(hdr_lines) + "\n", header.ref_names, header.ref_lens)
    if not no_pg:
        out_header = out_header.add_pg_line(
            "samtools", "samtools",
            "samtools addreplacerg " + " ".join(argv),
            SAMTOOLS_PARITY_VERSION)

    rg_bytes = np.frombuffer(b"RGZ" + rg_id.encode("latin-1") + b"\0",
                             np.uint8)
    aux_out = []
    for i in range(b.n):
        a = b.aux_of(i)
        has_rg = auxmod.get_value(a, "RG") is not None
        if mode == "overwrite_all":
            if has_rg:
                a = auxmod.delete_tags(a, {"RG"})
            a = np.concatenate([a, rg_bytes])
        elif not has_rg:
            a = np.concatenate([a, rg_bytes])
        aux_out.append(a)
    off = np.zeros(b.n + 1, np.int64)
    for i, a in enumerate(aux_out):
        off[i + 1] = off[i] + len(a)
    b.aux = (np.concatenate(aux_out).astype(np.uint8)
             if aux_out else np.empty(0, np.uint8))
    b.aux_off = off

    fmt = infer_output_format(output_name, ga.out_fmt, default="sam")
    try:
        write_alignments(output_name, out_header, b, fmt=fmt,
                         threads=ga.nthreads,
                         level=0 if uncompressed else 6,
                         include_header=True)
    except OSError as e:
        print_error_errno("addreplacerg", 'could not create "%s"',
                          output_name, exc=e)
        return 1
    return 0
