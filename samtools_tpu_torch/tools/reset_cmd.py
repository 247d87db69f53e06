"""samtools reset: aligned records back to unaligned reads.

Counterpart of samtools_tpu/tools/reset_cmd.py (samtools' reset.c): the
flags reset (unmapped; proper pair, mate reverse and, without
``--dupflag``, duplicate cleared), reverse reads turned back to their
read orientation, aux tags kept or removed with the default removal
list, and the header rebuilt from its @RG lines (not with ``--no-RG``),
its @PG lines up to ``--reject-PG``, and a samtools @PG a chain end.
A host command: no device work.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..io.files import infer_output_format, read_alignments, \
    write_alignments
from ..io.header import SamHeader
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)

DEFAULT_REMOVE = ["AS", "CC", "CG", "CP", "H1", "H2", "HI", "H0", "IH",
                  "MC", "MD", "MQ", "NM", "SA", "TS"]

_NT16_COMP = np.array([int(f"{c:04b}"[::-1], 2) for c in range(16)],
                      np.uint8)


def usage(fp):
    fp.write("Usage: samtools reset [options]\n")


def main_reset(argv: list[str]) -> int:
    ga = GlobalArgs()
    keep: set | None = None
    remove: set | None = None
    keep_rgs = True
    no_pg_entry = False
    keep_dupflag = False
    pgid = None
    outname = None
    try:
        opts, args = gnu_getopt(argv, "o:@:x:O:T:",
                                ["keep-tag=", "remove-tag=", "no-RG",
                                 "reject-PG=", "no-PG", "dupflag",
                                 "output-fmt=", "reference="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "--no-RG":
            keep_rgs = False
        elif o == "--no-PG":
            no_pg_entry = True
        elif o == "--dupflag":
            keep_dupflag = True
        elif o == "--reject-PG":
            pgid = v
        elif o == "-o":
            outname = v
        elif o in ("-x", "--remove-tag"):
            if v.startswith("^"):
                keep = (keep or set()) | set(
                    t for t in v[1:].split(",") if t)
            else:
                remove = (remove or set()) | set(
                    t for t in v.split(",") if t)
        elif o == "--keep-tag":
            keep = (keep or set()) | set(t for t in v.split(",") if t)
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1
    if not args and not argv and sys.stdin.isatty():
        usage(sys.stdout)
        return 0
    if len(args) > 1:
        usage(sys.stderr)
        return 1
    inname = args[0] if args else "-"
    outname = outname or "-"

    # update_aux_conf (reset.c:80)
    if keep is None and remove is None:
        remove = set()
    if keep is not None and not keep_rgs:
        keep.discard("RG")
    if remove is not None:
        if not keep_rgs:
            remove.add("RG")
        remove.update(DEFAULT_REMOVE)

    try:
        f = read_alignments(inname, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("reset", 'failed to open "%s"', inname, exc=e)
        return 1
    header = f.header
    b = f.batch

    # output header: @HD + RG lines + PG lines (up to --reject-PG) + PG
    lines = ["@HD\tVN:1.6"]
    if keep_rgs:
        lines.extend(l for l in header.text.split("\n")
                     if l.startswith("@RG"))
    pg_lines = [l for l in header.text.split("\n") if l.startswith("@PG")]
    if pgid:
        kept_pg = []
        for l in pg_lines:
            m = re.search(r"\tID:([^\t]*)", l)
            if m and m.group(1) == pgid:
                break
            kept_pg.append(l)
        pg_lines = kept_pg
    lines.extend(pg_lines)
    out_header = SamHeader.from_text("\n".join(lines) + "\n")
    if not no_pg_entry:
        # CL-only @PG entry via htslib sam_hdr_add_pg semantics
        # (reset.c:267): ONE new @PG line per PG-chain end.  A chain end
        # is a kept PG whose ID no other kept PG references through PP;
        # merged headers carrying N parallel chains therefore gain N
        # entries — samtools, samtools.1, ... — each PP-linked to its
        # own chain end (reject.2.expected's 80 = 41 kept + 39 ends).
        existing = out_header.find_tag_values("PG", "ID")
        referenced = set(out_header.find_tag_values("PG", "PP"))
        ends = [i for i in existing if i not in referenced]
        cl = "samtools reset " + " ".join(argv)
        taken = set(existing)

        def uniq(base):
            uid, k = base, 1
            while uid in taken:
                uid = "%s-%d" % (base, k)
                k += 1
            taken.add(uid)
            return uid

        new_lines = []
        if not ends:
            new_lines.append("@PG\tID:%s\tPN:samtools\tCL:%s"
                             % (uniq("samtools"), cl))
        else:
            for i, end_id in enumerate(ends):
                base = "samtools" if i == 0 else "samtools.%d" % i
                new_lines.append("@PG\tID:%s\tPN:samtools\tPP:%s\tCL:%s"
                                 % (uniq(base), end_id, cl))
        out_header = SamHeader.from_text(
            out_header.text + "\n".join(new_lines) + "\n")

    sel = np.nonzero((b.flag & (F.FSECONDARY | F.FSUPPLEMENTARY))
                     == 0)[0]
    sub = b.take(sel)
    n = sub.n
    flags = sub.flag.astype(np.int64)
    flags &= ~F.FPROPER_PAIR
    flags |= F.FUNMAP
    flags |= np.where(flags & F.FPAIRED, F.FMUNMAP, 0)
    flags &= ~F.FMREVERSE
    if not keep_dupflag:
        flags &= ~F.FDUP
    rev = (flags & F.FREVERSE) != 0

    # reverse-complement seq/qual for reverse reads, clear the flag
    for i in np.nonzero(rev)[0]:
        i = int(i)
        s0, s1 = int(sub.seq_off[i]), int(sub.seq_off[i + 1])
        sub.seq[s0:s1] = _NT16_COMP[sub.seq[s0:s1]][::-1]
        sub.qual[s0:s1] = sub.qual[s0:s1][::-1]
    flags &= ~F.FREVERSE
    sub.flag = flags.astype(np.uint16)
    sub.tid = np.full(n, -1, np.int32)
    sub.pos = np.full(n, -1, np.int64)
    sub.mapq = np.zeros(n, np.uint8)
    sub.mtid = np.full(n, -1, np.int32)
    sub.mpos = np.full(n, -1, np.int64)
    sub.tlen = np.zeros(n, np.int64)
    sub.cigar = np.empty(0, np.uint32)
    sub.cigar_off = np.zeros(n + 1, np.int64)

    aux_out = []
    for i in range(n):
        a = sub.aux_of(i)
        if keep is not None:
            a = auxmod.keep_tags(a, keep)
        elif remove:
            a = auxmod.delete_tags(a, remove)
        aux_out.append(a)
    off = np.zeros(n + 1, np.int64)
    for i, a in enumerate(aux_out):
        off[i + 1] = off[i] + len(a)
    sub.aux = (np.concatenate(aux_out).astype(np.uint8)
               if aux_out else np.empty(0, np.uint8))
    sub.aux_off = off

    fmt = infer_output_format(outname, ga.out_fmt, default="sam")
    try:
        write_alignments(outname, out_header, sub, fmt=fmt,
                         threads=ga.nthreads, include_header=True)
    except OSError as e:
        print_error_errno("reset", 'failed to write "%s"', outname, exc=e)
        return 1
    return 0
