"""samtools split: one file a read group or tag value.

Counterpart of samtools_tpu/tools/split_cmd.py (samtools' bam_split.c):
the file-name format (``%%``, ``%*``, ``%#``, ``%!``, ``%.``), each read
group's header keeping only its @RG line, ``-d TAG`` outputs made as
values come, at most ``-M``, integer values zero-padded by ``-p`` (a
negative one a digit wider), reads of no known group to ``-u`` (its
header from ``-h``).  A host command: no device work.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..io.files import infer_output_format, read_alignments, \
    write_alignments
from ..io.header import SamHeader
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

DEFAULT_MAX_SPLIT = 100


def usage(fp):
    fp.write(
        "Usage: samtools split [-u <unaccounted.bam>] [-h "
        "<unaccounted_header.sam>]\n"
        "                      [-f <format_string>] [-v] <merged.bam>\n")


def expand_format_string(fmt: str, basename: str, tag_val: str,
                         file_idx: int, zero_pad: int, ext: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        i += 1
        if i >= len(fmt):
            print_error("split", "Trailing %% in filename format string")
            return None
        s = fmt[i]
        if s == "%":
            out.append("%")
        elif s == "*":
            out.append(basename)
        elif s == "#":
            out.append(str(file_idx) if zero_pad == 0
                       else "%0*d" % (zero_pad, file_idx))
        elif s == "!":
            out.append(tag_val)
        elif s == ".":
            out.append(ext)
        else:
            print_error("split",
                        "Unknown specifier %%%s in filename format string",
                        s)
            return None
        i += 1
    return "".join(out)


def _remove_except_rg(header: SamHeader, keep_id: str) -> SamHeader:
    lines = []
    for line in header.text.split("\n"):
        if line.startswith("@RG"):
            m = re.search(r"\tID:([^\t]*)", line)
            if not m or m.group(1) != keep_id:
                continue
        lines.append(line)
    return SamHeader.from_text("\n".join(l for l in lines if l) + "\n",
                               header.ref_names, header.ref_lens)


def _replace_rg(header: SamHeader, new_id: str) -> SamHeader:
    """Remove all @RG lines, insert @RG ID:new_id where the RG block
    was (after @HD if no RGs existed)."""
    lines = [l for l in header.text.split("\n") if l]
    first_rg = None
    kept = []
    for l in lines:
        if l.startswith("@RG"):
            if first_rg is None:
                first_rg = len(kept)
            continue
        kept.append(l)
    at = first_rg if first_rg is not None else (
        1 if kept and kept[0].startswith("@HD") else 0)
    kept.insert(at, "@RG\tID:%s" % new_id)
    return SamHeader.from_text("\n".join(kept) + "\n",
                               header.ref_names, header.ref_lens)


def _add_pg(header: SamHeader, argv: list[str]) -> SamHeader:
    return header.add_pg_line("samtools", "samtools",
                              "samtools split " + " ".join(argv),
                              SAMTOOLS_PARITY_VERSION)


def main_split(argv: list[str]) -> int:
    ga = GlobalArgs()
    fmt_string = "%*_%#.%."
    unaccounted = None
    unaccounted_hdr = None
    tag = None
    max_split = DEFAULT_MAX_SPLIT
    verbose = False
    no_pg = False
    zero_pad = 0
    try:
        opts, args = gnu_getopt(argv, "vf:h:u:d:M:p:@:",
                                ["max-split=", "no-PG"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-v":
            verbose = True
        elif o == "-f":
            fmt_string = v
        elif o == "-h":
            unaccounted_hdr = v
        elif o == "-u":
            unaccounted = v
        elif o == "-d":
            if len(v) != 2:
                print_error("split",
                            '"%s" is not a valid tag name', v)
                return 1
            tag = v
        elif o in ("-M", "--max-split"):
            max_split = int(v)
            if max_split <= 0:
                print_error("split", "Max split must be greater than 0")
                return 1
        elif o == "-p":
            zero_pad = int(v)
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    if len(args) != 1:
        print_error("split", "Invalid number of arguments: %d", len(args))
        usage(sys.stderr)
        return 1
    input_name = args[0]
    is_rg = tag is None or tag == "RG"
    lookup_tag = "RG" if is_rg else tag

    try:
        f = read_alignments(input_name, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("split", 'Could not open "%s"', input_name, exc=e)
        return 1
    header = f.header
    b = f.batch

    out_fmt = infer_output_format(None, ga.out_fmt, default="bam")
    ext = {"bam": "bam", "sam": "sam", "cram": "cram",
           "sam.gz": "sam.gz"}.get(out_fmt, "bam")
    basename = os.path.basename(input_name)
    dot = basename.rfind(".")
    if dot >= 0:
        basename = basename[:dot]

    # unaccounted header
    unacc_header = None
    if unaccounted:
        if unaccounted_hdr:
            try:
                hf = read_alignments(unaccounted_hdr, threads=ga.nthreads)
            except OSError as e:
                print_error_errno(
                    "split",
                    'Could not open unaccounted header file "%s"',
                    unaccounted_hdr, exc=e)
                return 1
            unacc_header = hf.header
            if unacc_header.n_refs != header.n_refs:
                print_error("split", "Unaccounted header contains wrong "
                            "number of references")
                return 1
            for t in range(header.n_refs):
                if header.ref_lens[t] != unacc_header.ref_lens[t]:
                    print_error(
                        "split", 'Unaccounted header reference %d "%s" is'
                        " not the same length as in the input file",
                        t + 1, unacc_header.ref_name(t))
                    return 1
        else:
            unacc_header = header
            if not no_pg:
                unacc_header = _add_pg(unacc_header, argv)

    # output slots: name -> (filename, header, [indices])
    outputs: list[dict] = []
    val_to_idx: dict[str, int] = {}

    def new_output(val: str, file_idx: int, hdr: SamHeader):
        name = expand_format_string(fmt_string, basename, val, file_idx,
                                    zero_pad, ext)
        if name is None:
            return None
        outputs.append({"name": name, "header": hdr, "idx": []})
        val_to_idx[val] = len(outputs) - 1
        return len(outputs) - 1

    if is_rg:
        rg_ids = []
        for line in header.text.split("\n"):
            if line.startswith("@RG"):
                m = re.search(r"\tID:([^\t]*)", line)
                rg_ids.append(m.group(1) if m else "")
        if verbose:
            sys.stderr.write("@RG's found %d\n" % len(rg_ids))
        if max_split < len(rg_ids):
            max_split = len(rg_ids)
        for i, rid in enumerate(rg_ids):
            hdr = _remove_except_rg(header, rid)
            if not no_pg:
                hdr = _add_pg(hdr, argv)
            if new_output(rid, i, hdr) is None:
                return 1

    unacc_idx: list[int] = []
    for i in range(b.n):
        got = auxmod.get_value(b.aux_of(i), lookup_tag)
        val = None
        if got is not None:
            t, v = got
            if t in "ZH":
                val = str(v)
            elif t in "cCsSiI":
                if zero_pad == 0:
                    val = "%d" % int(v)
                else:
                    iv = int(v)
                    val = "%0*d" % (zero_pad + 1 if iv < 0 else zero_pad,
                                    iv)
        oi = val_to_idx.get(val) if val is not None else None
        if oi is None and val is not None and tag is not None \
                and len(outputs) < max_split:
            # lazily create an output for a new tag value (-d only)
            if is_rg:
                hdr = _replace_rg(header, val)
            else:
                hdr = header
            if not no_pg:
                hdr = _add_pg(hdr, argv)
            oi = new_output(val, len(val_to_idx), hdr)
            if oi is None:
                return 1
        if oi is not None:
            outputs[oi]["idx"].append(i)
        else:
            if unaccounted is None:
                if val is not None:
                    sys.stderr.write(
                        'Read "%s" with unaccounted for tag "%s".\n'
                        % (b.qname_str(i), val))
                else:
                    sys.stderr.write('Read "%s" has no %s tag.\n'
                                     % (b.qname_str(i), lookup_tag))
                return 1
            unacc_idx.append(i)

    for out in outputs:
        sub = b.take(np.array(out["idx"], np.int64))
        try:
            write_alignments(out["name"], out["header"], sub, fmt=out_fmt,
                             threads=ga.nthreads, include_header=True)
        except OSError as e:
            print_error_errno("split", 'Could not write to "%s"',
                              out["name"], exc=e)
            return 1
    if unaccounted:
        sub = b.take(np.array(unacc_idx, np.int64))
        try:
            write_alignments(unaccounted, unacc_header, sub, fmt=out_fmt,
                             threads=ga.nthreads, include_header=True)
        except OSError as e:
            print_error_errno("split",
                              "Could not write to unaccounted output file",
                              exc=e)
            return 1
    return 0
