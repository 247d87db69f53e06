"""samtools faidx / fqidx: index a FASTA or FASTQ and print regions of it.

Counterpart of samtools_tpu/tools/faidx_cmd.py (samtools' faidx.c): the
lines wrapped at ``-n`` or at the file's own line length, strand marks
(``--mark-strand``, ``/rc`` by default), ``-i`` reverse complements,
``-c`` goes on past a missing region, ``-r`` reads regions from a file,
and a missing ``.fai`` is built and written.  A host command: no device
work.
"""

from __future__ import annotations

import os
import sys

from ..io import fasta as fastamod
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)

COMP = {}
for _a, _b in zip(b"ACGTUMRWSYKVHDBNacgtumrwsykvhdbn",
                  b"TGCAAKYWSRMBDHVNtgcaakywsrmbdhvn"):
    COMP[_a] = _b


def revcomp(seq: bytes) -> bytes:
    return bytes(COMP.get(c, c) for c in reversed(seq))


def usage(fp, fastq: bool):
    tool = "fqidx" if fastq else "faidx"
    ft = "FASTQ" if fastq else "FASTA"
    fp.write(
        f"Usage: samtools {tool} <file.f{'q' if fastq else 'a'}|file.f"
        f"{'q' if fastq else 'a'}.gz> [<reg> [...]]\n"
        f"Option: -o, --output FILE        Write {ft} to file.\n"
        "        -n, --length INT         Length of FASTA sequence line."
        " [60]\n"
        "        -c, --continue           Continue after trying to retrieve"
        " missing region.\n"
        "        -r, --region-file FILE   File of regions.  Format is"
        " chr:from-to. One per line.\n"
        "        -i, --reverse-complement Reverse complement sequences.\n"
        "        -h, --help               This message.\n")


def _parse_fai_region(idx, reg: str):
    """fai region: name, name:beg-end, name:pos (single base)."""
    if idx.has(reg):
        return reg, 0, idx.length(reg)
    if reg.startswith("{"):
        close = reg.find("}")
        name = reg[1:close]
        rest = reg[close + 1:].lstrip(":")
    else:
        colon = reg.rfind(":")
        if colon < 0:
            return None
        name = reg[:colon]
        rest = reg[colon + 1:]
    if not idx.has(name):
        return None
    L = idx.length(name)
    if not rest:
        return name, 0, L
    rest = rest.replace(",", "")
    try:
        if "-" in rest:
            bs, _, es = rest.partition("-")
            beg = int(bs) - 1 if bs else 0
            end = int(es) if es else L
        else:
            beg = int(rest) - 1
            end = beg + 1  # ONE_COORD semantics
    except ValueError:
        return None
    if beg < 0:
        beg = 0
    if end > L:
        end = L
    return name, beg, end


def _fetch_and_write(idx, out, reg: str, length, rev, pos_mark, neg_mark,
                     fastq: bool, ignore: bool) -> int:
    got = _parse_fai_region(idx, reg)
    if got is None:
        sys.stderr.write(f"[faidx] Failed to fetch sequence in {reg}\n")
        return 0 if ignore else -1
    name, beg, end = got
    seq = idx.fetch(name, beg, end)
    if len(seq) == 0:
        sys.stderr.write(f"[faidx] Zero length sequence: {reg}\n")
    elif end < (1 << 62) and len(seq) != end - beg:
        sys.stderr.write(f"[faidx] Truncated sequence: {reg}\n")
    wrap = length
    if wrap is None or wrap < 0:
        wrap = idx.records[name].linebases
    if wrap <= 0:
        wrap = 1 << 62
    if rev:
        seq = revcomp(seq)
    out.write(("@" if fastq else ">").encode())
    out.write(reg.encode("latin-1"))
    out.write((neg_mark if rev else pos_mark).encode("latin-1"))
    out.write(b"\n")
    for i in range(0, len(seq), wrap):
        out.write(seq[i:i + wrap])
        out.write(b"\n")
    if fastq:
        qual = idx.fetch_qual(name, beg, end)
        if rev:
            qual = qual[::-1]
        out.write(b"+\n")
        for i in range(0, len(qual), wrap):
            out.write(qual[i:i + wrap])
            out.write(b"\n")
    return 0


def _faidx_main(argv: list[str], fastq: bool) -> int:
    ga = GlobalArgs()
    output = None
    length = None
    ignore = False
    region_file = None
    rev = False
    pos_mark, neg_mark = "", "/rc"
    try:
        opts, args = gnu_getopt(argv, "o:n:cr:ifh",
                                ["output=", "length=", "continue",
                                 "region-file=", "reverse-complement",
                                 "fastq", "help", "mark-strand=",
                                 "fai-idx=", "gzi-idx="])
    except UsageError:
        usage(sys.stderr, fastq)
        return 1
    fai_name = None
    for o, v in opts:
        if o in ("-o", "--output"):
            output = v
        elif o in ("-n", "--length"):
            length = int(v)
        elif o in ("-c", "--continue"):
            ignore = True
        elif o in ("-r", "--region-file"):
            region_file = v
        elif o in ("-i", "--reverse-complement"):
            rev = True
        elif o in ("-f", "--fastq"):
            fastq = True
        elif o == "--mark-strand":
            if v == "rc":
                pos_mark, neg_mark = "", "/rc"
            elif v == "no":
                pos_mark = neg_mark = ""
            elif v == "sign":
                pos_mark, neg_mark = "(+)", "(-)"
            elif v.startswith("custom,"):
                parts = v.split(",")
                pos_mark = parts[1] if len(parts) > 1 else ""
                neg_mark = parts[2] if len(parts) > 2 else ""
            else:
                usage(sys.stderr, fastq)
                return 1
        elif o == "--fai-idx":
            fai_name = v
        elif o == "--gzi-idx":
            pass
        elif o in ("-h", "--help"):
            usage(sys.stdout, fastq)
            return 0
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr, fastq)
            return 1
    if not args:
        usage(sys.stdout if not argv else sys.stderr, fastq)
        return 1
    path = args[0]
    regions = args[1:]

    try:
        fai_path = fai_name or (path + ".fai")
        if os.path.exists(fai_path):
            with open(fai_path) as f:
                idx = fastamod.parse_fai(f.read(), path)
        else:
            idx = fastamod.build_fai(path)
            try:
                with open(fai_path, "w") as f:
                    f.write(fastamod.fai_text(idx, fastq=fastq))
            except OSError as e:
                print_error_errno("faidx",
                                  "Could not build fai index %s.fai", path,
                                  exc=e)
                return 1
    except OSError as e:
        print_error_errno("faidx", "Could not load fai index of %s", path,
                          exc=e)
        return 1

    if not regions and not region_file:
        return 0  # index-only invocation

    out = open(output, "wb") if output else sys.stdout.buffer
    rc = 0
    try:
        if region_file:
            with open(region_file) as f:
                for line in f:
                    reg = line.rstrip("\n\r")
                    if not reg:
                        continue
                    if _fetch_and_write(idx, out, reg, length, rev,
                                        pos_mark, neg_mark, fastq,
                                        ignore) < 0:
                        rc = 1
                        break
        for reg in regions:
            if _fetch_and_write(idx, out, reg, length, rev, pos_mark,
                                neg_mark, fastq, ignore) < 0:
                rc = 1
                break
    finally:
        out.flush()
        if output:
            out.close()
    return rc


def main_faidx(argv: list[str]) -> int:
    return _faidx_main(argv, fastq=False)


def main_fqidx(argv: list[str]) -> int:
    return _faidx_main(argv, fastq=True)
