"""samtools reference: rebuild a reference FASTA from aligned reads.

Counterpart of samtools_tpu/tools/reference_cmd.py (samtools'
reference.c): each read's SEQ, CIGAR and MD:Z tag patch the bases it
covers (MD2ref/build_ref), reads without MD:Z are skipped, bases no read
covers stay ``N``, and each contig is written as 60-column FASTA with a
coverage note on standard error unless ``-q``.  ``-r`` keeps the reads
of a region (all ``N`` when none falls there).  ``-e``, the CRAM
embedded-reference mode, is refused after the file is read, as the JAX
tool refuses it.  The reads are walked one at a time on the host.  A
host command: no device work.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..core.regions import parse_region, RegionError, HTS_POS_MAX
from ..io.files import read_alignments
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

_NT16_CHARS = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)

# cigar ops skipped by the MD walk (reference.c:363): everything except
# M (0), D (2), = (7), X (8)
_CIG_SKIP = [0, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1]


class _CigarCursor:
    """next_cigar_op (reference.c:317-342)."""

    def __init__(self, cigar):
        self.cigar = cigar
        self.ind = 0
        self.op = 0
        self.len = 0
        self.spos = 0  # extra seq skip from query-consuming skipped ops

    def next(self) -> int:
        while True:
            while self.len == 0:
                if self.ind < len(self.cigar):
                    c = int(self.cigar[self.ind])
                    self.op = c & 0xF
                    self.len = c >> 4
                    self.ind += 1
                else:
                    return -1
            if _CIG_SKIP[self.op]:
                self.spos += F.CIGAR_CONSUMES_QUERY[self.op] * self.len
                self.len = 0
                continue
            self.len -= 1
            return self.op


def build_ref(seq_codes, cigar, pos, md: str, ref: np.ndarray) -> int:
    """Patch ref[] from one record's SEQ+CIGAR+MD (reference.c:350-429).

    Returns 1 on success, -1 on inconsistency."""
    ref_len = len(ref)
    cur = _CigarCursor(cigar)
    l_qseq = len(seq_codes)
    iref = pos
    i = 0
    n = len(md)
    # iseq tracked through the cursor's spos (skipped query ops) plus
    # explicit advances
    iseq = 0
    while iseq < l_qseq and i < n:
        ch = md[i]
        if ch.isdigit():
            j = i
            while j < n and md[j].isdigit():
                j += 1
            ln = int(md[i:j])
            i = j
            while iseq < l_qseq and ln:
                spos0 = cur.spos
                op = cur.next()
                iseq += cur.spos - spos0
                if op < 0:
                    return -1
                if op not in (F.CMATCH, F.CEQUAL):
                    print_error("MD2ref",
                                "MD:Z and CIGAR are incompatible")
                    return -1
                if iref < ref_len:
                    ref[iref] = _NT16_CHARS[seq_codes[iseq]]
                iseq += 1
                iref += 1
                ln -= 1
        elif ch == "^":
            i += 1
            while i < n and md[i].isalpha():
                spos0 = cur.spos
                op = cur.next()
                iseq += cur.spos - spos0
                if op < 0:
                    return -1
                if op != F.CDEL:
                    print_error("MD2ref",
                                "MD:Z and CIGAR are incompatible")
                    return -1
                if iref < ref_len:
                    ref[iref] = ord(md[i])
                i += 1
                iref += 1
        else:
            spos0 = cur.spos
            op = cur.next()
            iseq += cur.spos - spos0
            if op < 0:
                return -1
            if op not in (F.CMATCH, F.CDIFF):
                print_error("MD2ref", "MD:Z and CIGAR are incompatible")
                return -1
            if iref < ref_len:
                ref[iref] = ord(ch)
            i += 1
            iref += 1
            iseq += 1
    return 1


def dump_ref(out, header, region, ref_id: int, ref: np.ndarray,
             verbose: bool):
    """60-column FASTA + coverage note (reference.c:66-128)."""
    ref_len = len(ref)
    if region is not None and region.tid == ref_id:
        end = region.end if region.end < HTS_POS_MAX else ref_len
        if region.beg > 0 or end < ref_len:
            out.write(b">%s:%d-%d\n"
                      % (header.ref_name(ref_id).encode(),
                         region.beg + 1, end))
            ref = ref[region.beg:min(ref_len, end)]
        else:
            out.write(b">%s\n" % header.ref_name(ref_id).encode())
    else:
        out.write(b">%s\n" % header.ref_name(ref_id).encode())
    n_count = int(np.count_nonzero(ref == ord("N"))) if verbose else 0
    data = ref.tobytes()
    for i in range(0, len(data), 60):
        out.write(data[i:i + 60])
        out.write(b"\n")
    if verbose:
        sys.stderr.write("Dump ref %d len %d, coverage %.2f%%\n"
                         % (ref_id, len(ref),
                            100 - n_count * 100.0 / max(len(ref), 1)))


def main_reference(argv: list[str]) -> int:
    ga = GlobalArgs()
    out_path = None
    verbose = True
    use_embedded = False
    reg = None
    try:
        opts, args = gnu_getopt(argv, "@:qo:er:",
                                ["output=", "quiet", "embedded",
                                 "region="])
    except UsageError:
        print("Usage: samtools reference [-@ N] [-r region] [-e] [-q]"
              " [-o out.fa] [in.cram]")
        return 0
    for o, v in opts:
        if o in ("-o", "--output"):
            out_path = v
        elif o in ("-q", "--quiet"):
            verbose = False
        elif o in ("-e", "--embedded"):
            use_embedded = True
        elif o in ("-r", "--region"):
            reg = v
        elif handle_global_opt(ga, o, v):
            pass
        else:
            print("Usage: samtools reference [-@ N] [-r region] [-e] [-q]"
                  " [-o out.fa] [in.cram]")
            return 0
    if not args and sys.stdin.isatty():
        print("Usage: samtools reference [-@ N] [-r region] [-e] [-q]"
              " [-o out.fa] [in.cram]")
        return 0

    fn = args[0] if args else "-"
    try:
        f = read_alignments(fn, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("reference", "failed to open file '%s'", fn,
                          exc=e)
        return 1
    except Exception as e:
        print_error("reference", "%s", str(e))
        return 1

    if use_embedded:
        print_error("reference",
                    "embedded-reference mode requires CRAM input"
                    " (not yet supported)")
        return 1

    header = f.header
    b = f.batch

    region = None
    if reg:
        try:
            region = parse_region(reg, header.tid)
        except RegionError:
            print_error("reference", "failed to parse region '%s'", reg)
            return 1

    out = open(out_path, "wb") if out_path else sys.stdout.buffer

    spans = b.ref_span()
    ends = b.pos + np.where(spans > 0, spans, 1)

    sel = np.arange(b.n)
    if region is not None:
        sel = sel[(b.tid == region.tid) & (b.pos < region.end)
                  & (ends > region.beg)]

    last_tid = -99
    ref = None
    wrote_any = False
    for i in sel:
        tid = int(b.tid[i])
        if tid != last_tid:
            if last_tid >= 0:
                dump_ref(out, header, region, last_tid, ref, verbose)
                wrote_any = True
            last_tid = tid
            rl = header.ref_lens[tid] if tid >= 0 else 0
            ref = np.full(rl, ord("N"), np.uint8)
        if tid < 0:
            continue
        md = auxmod.get_value(b.aux_of(i), "MD")
        if md is None or md[0] != "Z":
            continue
        if build_ref(b.seq_of(i), b.cigar_of(i), int(b.pos[i]),
                     str(md[1]), ref) < 0:
            if out_path:
                out.close()
            return 1

    if last_tid >= 0:
        dump_ref(out, header, region, last_tid, ref, verbose)
        wrote_any = True
    elif region is not None and not wrote_any:
        # no data, but region requested: emit Ns (reference.c:477-487)
        rl = min(region.end, header.ref_lens[region.tid])
        ref = np.full(rl, ord("N"), np.uint8)
        dump_ref(out, header, region, region.tid, ref, verbose)

    if out_path:
        out.close()
    else:
        out.flush()
    return 0
