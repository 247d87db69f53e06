"""samtools depad: convert a padded BAM into an unpadded one.

Counterpart of samtools_tpu/tools/depad_cmd.py (samtools' padding.c):
each read's sequence is expanded along the padded reference
(``unpad_seq``), its CIGAR rebuilt against the unpadded reference (M, I,
D or P a column, redundant P between M/D removed), its position and its
mate's mapped through the padded-to-unpadded position map, and the
header's @SQ lengths set to the unpadded ones from ``-T``'s padded
FASTA.  The reference comes from ``-T`` or from embedded reference reads
(a read named after its contig at position 0).  The reads are walked on
the host, in two passes.  A host command: no device work.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import flags as F
from ..core.batch import ReadBatch
from ..io.fasta import load_fasta
from ..io.files import read_alignments, write_alignments, \
    infer_output_format
from ..io.header import SamHeader
from ..io.sam_text import CIGAR_CHARS
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)

# base -> nt16 code; '-' and '*' are gaps (0), tested before this table
_NT16 = {c: i for i, c in enumerate(F.SEQ_NT16_STR)}


def unpad_seq(cigar: np.ndarray, seq: np.ndarray, qname: str):
    """A padded record as one nt16 code per reference column, 0 for a
    gap (padding.c:87-126); None after an error message."""
    out = []
    j = 0
    warned = False
    for c in cigar:
        op = int(c) & 0xF
        ol = int(c) >> 4
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            out.append(seq[j:j + ol])
            j += ol
        elif op == F.CSOFT_CLIP:
            j += ol
        elif op == F.CHARD_CLIP:
            pass
        elif op == F.CDEL:
            out.append(np.zeros(ol, np.uint8))
        elif op == F.CREF_SKIP:
            out.append(np.zeros(ol, np.uint8))
            if not warned:
                sys.stderr.write("[depad] WARNING: CIGAR op N treated as"
                                 " op D in read %s\n" % qname)
                warned = True
        else:
            sys.stderr.write("[depad] ERROR: Didn't expect CIGAR op %s in"
                             " read %s\n" % (CIGAR_CHARS[op], qname))
            return None
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def load_unpadded_ref(fai, name: str, ref_len: int):
    """A padded FASTA sequence as nt16 codes, '-' and '*' as 0
    (padding.c:128); None after an error message."""
    try:
        raw = fai.fetch(name)
    except Exception:
        return None
    if len(raw) != ref_len:
        sys.stderr.write("[depad] ERROR: FASTA sequence %s length %d, "
                         "expected %d\n" % (name, len(raw), ref_len))
        return None
    out = np.zeros(len(raw), np.uint8)
    for k, ch in enumerate(raw.decode("latin-1")):
        if ch in "-*":
            out[k] = 0
        else:
            i = _NT16.get(ch.upper(), 16 if ch not in "=" else 0)
            if i in (0, 16):
                sys.stderr.write("[depad] ERROR: Invalid character %c "
                                 "(ASCII %d) in FASTA sequence %s\n"
                                 % (ch, ord(ch), name))
                return None
            out[k] = i
    return out


def get_unpadded_len(fai, name: str, padded_len: int) -> int:
    try:
        raw = fai.fetch(name)
    except Exception:
        return -1
    if len(raw) != padded_len:
        sys.stderr.write("[depad] ERROR: FASTA sequence '%s' length %d, "
                         "expected %d\n" % (name, len(raw), padded_len))
        return -1
    bases = 0
    for ch in raw.decode("latin-1"):
        if ch in "-*":
            continue
        i = _NT16.get(ch.upper(), 16)
        if i in (0, 16):
            sys.stderr.write("[depad] ERROR: Invalid character %c (ASCII"
                             " %d) in FASTA sequence '%s'\n"
                             % (ch, ord(ch), name))
            return -1
        bases += 1
    return bases


def update_posmap(ref: np.ndarray) -> np.ndarray:
    """Padded position -> unpadded position (padding.c:195-204)."""
    nz = (ref != 0).astype(np.int64)
    pm = np.zeros(len(ref), np.int64)
    np.cumsum(nz[:-1], out=pm[1:])
    return pm


def usage(fp):
    fp.write("\nUsage:   samtools depad <in.bam>\n\n"
             "Options:\n"
             "  -s           Output is SAM (default is BAM)\n"
             "  -S           Input is SAM (default is BAM)\n"
             "  -u           Uncompressed BAM output (can't use with -s)\n"
             "  -1           Fast compression BAM output (can't use with -s)\n"
             "  -T, --reference FILE\n"
             "               Padded reference sequence file [null]\n"
             "  -o FILE      Output file name [stdout]\n"
             "  --no-PG      do not add a PG line\n"
             "  -?           Longer help\n")


def main_depad(argv: list[str]) -> int:
    ga = GlobalArgs()
    fn_out = None
    out_fmt = None
    level = 6
    no_pg = False
    try:
        opts, args = gnu_getopt(argv, "SCso:u1T:?", ["no-PG"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-S":
            pass
        elif o == "-C":
            ga.out_fmt = "cram"
        elif o == "-s":
            ga.out_fmt = "sam"
        elif o == "-o":
            fn_out = v
        elif o == "-u":
            level = 0
            if ga.out_fmt is None:
                ga.out_fmt = "bam"
        elif o == "-1":
            level = 1
            if ga.out_fmt is None:
                ga.out_fmt = "bam"
        elif o == "--no-PG":
            no_pg = True
        elif o == "-T":
            ga.reference = v
        elif o == "-?":
            usage(sys.stderr)
            return 1
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    if not args:
        usage(sys.stderr)
        return 1

    fai = None
    if ga.reference:
        try:
            fai = load_fasta(ga.reference)
        except Exception:
            sys.stderr.write("[depad] failed to load reference file "
                             '"%s".\n' % ga.reference)
            return 1

    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e:
        print_error_errno("depad", 'failed to open "%s" for reading',
                          args[0], exc=e)
        return 1
    header = f.header
    batch = f.batch

    # fix header LN values to unpadded lengths (padding.c:403-440)
    if fai is not None:
        new_lens = []
        lines = header.text.split("\n")
        for i, name in enumerate(header.ref_names):
            ul = get_unpadded_len(fai, name, header.ref_lens[i])
            if ul < 0:
                sys.stderr.write("[depad] ERROR getting unpadded length"
                                 " of '%s', padded length %d\n"
                                 % (name, header.ref_lens[i]))
                new_lens.append(header.ref_lens[i])
                continue
            new_lens.append(ul)
        out_lines = []
        for line in lines:
            if line.startswith("@SQ"):
                fields = line.split("\t")
                sn = next((x[3:] for x in fields if x.startswith("SN:")),
                          None)
                if sn in header.ref_names:
                    tid = header.tid(sn)
                    fields = [("LN:%d" % new_lens[tid])
                              if x.startswith("LN:") else x
                              for x in fields]
                    line = "\t".join(fields)
            out_lines.append(line)
        h_fix = SamHeader.from_text("\n".join(out_lines),
                                    header.ref_names, new_lens)
    else:
        sys.stderr.write("[depad] Warning - reference lengths will not be"
                         " corrected without FASTA reference\n")
        h_fix = header

    if not no_pg:
        h_fix = h_fix.add_pg_line("samtools", "samtools",
                                  "samtools depad " + " ".join(argv),
                                  SAMTOOLS_PARITY_VERSION)

    r_tid = -1
    r_seq = None       # current unpadded ref (nt16 codes, 0 = gap)
    posmap = None

    b = batch
    new_pos = b.pos.copy()
    new_mtid = b.mtid.copy()
    new_mpos = b.mpos.copy()
    new_cigars: dict[int, list[int]] = {}

    for i in range(b.n):
        flag = int(b.flag[i])
        if flag & F.FUNMAP:
            continue
        qname = b.qname_str(i)
        cigar = b.cigar_of(i)
        tid = int(b.tid[i])
        pos = int(b.pos[i])
        if pos == 0 and tid >= 0 and qname == header.ref_name(tid):
            # embedded reference read (padding.c:229-262)
            r_tid = tid
            r_seq = unpad_seq(cigar, b.seq_of(i), qname)
            if r_seq is None:
                sys.stderr.write("[depad] ERROR: Problem parsing SEQ "
                                 "and/or CIGAR in reference %s\n" % qname)
                return 1
            if header.ref_lens[r_tid] != len(r_seq):
                sys.stderr.write(
                    "[depad] ERROR: (Padded) length of '%s' is %d in BAM"
                    " header, but %d in embedded reference\n"
                    % (qname, header.ref_lens[r_tid], len(r_seq)))
                return 1
            if fai is not None:
                q_seq = load_unpadded_ref(fai, header.ref_name(tid),
                                          header.ref_lens[tid])
                if q_seq is None:
                    sys.stderr.write("[depad] ERROR: Failed to load "
                                     "embedded reference '%s' from "
                                     "FASTA\n" % header.ref_name(tid))
                    return 1
                if not np.array_equal(r_seq, q_seq):
                    sys.stderr.write(
                        "[depad] ERROR: Embedded sequence and reference"
                        " FASTA don't match for %s\n"
                        % header.ref_name(tid))
                    return 1
            l_qseq = int(b.seq_off[i + 1] - b.seq_off[i])
            new_cigars[i] = [(l_qseq << 4) | F.CMATCH]
            posmap = update_posmap(r_seq)
        elif len(cigar) > 0:
            if tid < 0:
                sys.stderr.write("[depad] ERROR: Read '%s' has CIGAR but"
                                 " no RNAME\n" % qname)
                return 1
            elif tid == r_tid:
                pass
            elif fai is not None:
                r_seq = load_unpadded_ref(fai, header.ref_name(tid),
                                          header.ref_lens[tid])
                if r_seq is None:
                    sys.stderr.write("[depad] ERROR: Failed to load '%s'"
                                     " from reference FASTA\n"
                                     % header.ref_name(tid))
                    return 1
                posmap = update_posmap(r_seq)
                r_tid = tid
            else:
                sys.stderr.write("[depad] ERROR: Missing %s embedded "
                                 "reference sequence (and no FASTA "
                                 "file)\n" % header.ref_name(tid))
                return 1
            q = unpad_seq(cigar, b.seq_of(i), qname)
            if q is None:
                sys.stderr.write("[depad] ERROR: Problem parsing SEQ "
                                 "and/or CIGAR in read %s\n" % qname)
                return 1
            cigar2: list[int] = []
            first_op = int(cigar[0]) & 0xF
            if first_op == F.CSOFT_CLIP:
                cigar2.append(int(cigar[0]))
            elif first_op == F.CHARD_CLIP:
                cigar2.append(int(cigar[0]))
                if len(cigar) > 2 and (int(cigar[1]) & 0xF) == \
                        F.CSOFT_CLIP:
                    cigar2.append(int(cigar[1]))
            # classify each aligned base (padding.c:296-297)
            ops = np.where(
                q != 0,
                np.where(r_seq[pos:pos + len(q)] != 0, F.CMATCH, F.CINS),
                np.where(r_seq[pos:pos + len(q)] != 0, F.CDEL, F.CPAD))
            k = 0
            if ops[0] == F.CINS:
                while k + 1 < pos and not r_seq[pos - k - 1]:
                    k += 1
                if k:
                    cigar2.append((k << 4) | F.CPAD)
                k = 0
            elif ops[0] == F.CPAD:
                while k + 1 < pos and not r_seq[pos - k - 1]:
                    k += 1
            # run-length encode ops (padding.c:310-316)
            op = int(ops[0])
            k += 1
            for x in ops[1:]:
                if op != int(x):
                    cigar2.append((k << 4) | op)
                    op = int(x)
                    k = 1
                else:
                    k += 1
            cigar2.append((k << 4) | op)
            last_op = int(cigar[-1]) & 0xF
            if last_op == F.CSOFT_CLIP:
                cigar2.append(int(cigar[-1]))
            elif last_op == F.CHARD_CLIP:
                if len(cigar) > 2 and (int(cigar[-2]) & 0xF) == \
                        F.CSOFT_CLIP:
                    cigar2.append(int(cigar[-2]))
                cigar2.append(int(cigar[-1]))
            # remove redundant P between M/D ops (padding.c:325-346)
            n2 = len(cigar2)
            for ci in range(2, n2):
                if (cigar2[ci - 1] & 0xF) == F.CPAD and cigar2[ci - 1]:
                    pre_op = cigar2[ci - 2] & 0xF
                    post_op = cigar2[ci] & 0xF
                    if pre_op in (F.CMATCH, F.CDEL) and \
                            post_op in (F.CMATCH, F.CDEL):
                        cigar2[ci - 1] = 0
                        if pre_op == post_op:
                            cigar2[ci] = ((((cigar2[ci - 2] >> 4)
                                            + (cigar2[ci] >> 4)) << 4)
                                          | post_op)
                            cigar2[ci - 2] = 0
            new_cigars[i] = [c for c in cigar2 if c]

    # positions and mate positions through each contig's position map,
    # in a second pass that follows samtools' sequential walk
    r_tid = -1
    r_seq = None
    posmap = None
    posmaps: dict[int, np.ndarray] = {}

    def get_posmap(tid: int):
        if tid in posmaps:
            return posmaps[tid]
        if fai is None:
            return None
        rs = load_unpadded_ref(fai, header.ref_name(tid),
                               header.ref_lens[tid])
        if rs is None:
            return None
        pm = update_posmap(rs)
        posmaps[tid] = pm
        return pm

    for i in range(b.n):
        flag = int(b.flag[i])
        if flag & F.FUNMAP:
            continue
        tid = int(b.tid[i])
        qname = b.qname_str(i)
        pos = int(b.pos[i])
        if pos == 0 and tid >= 0 and qname == header.ref_name(tid):
            rs = unpad_seq(b.cigar_of(i), b.seq_of(i), qname)
            posmaps[tid] = update_posmap(rs)
            r_tid = tid
        pm = posmaps.get(tid) if tid >= 0 else None
        if pm is None and tid >= 0:
            pm = get_posmap(tid)
        if pos != -1 and pm is not None:
            new_pos[i] = pm[pos]
        mtid = int(b.mtid[i])
        mpos = int(b.mpos[i])
        if mtid < 0 or mpos < 0:
            new_mtid[i] = -1
            new_mpos[i] = -1
        elif mtid == tid:
            if pm is not None:
                new_mpos[i] = pm[mpos]
        else:
            mpm = get_posmap(mtid)
            if mpm is None:
                sys.stderr.write("[depad] ERROR: Needed reference %s "
                                 "sequence for mate (and no FASTA "
                                 "file)\n" % header.ref_name(mtid))
                return 1
            new_mpos[i] = mpm[mpos]

    # rebuild batch with new cigars/positions
    out_b = _apply_updates(b, new_pos, new_mtid, new_mpos, new_cigars)

    out_fmt = infer_output_format(fn_out, ga.out_fmt, default="bam")
    write_alignments(fn_out or "-", h_fix, out_b, fmt=out_fmt,
                     threads=ga.nthreads, level=level)
    return 0


def _apply_updates(b, new_pos, new_mtid, new_mpos, new_cigars):
    """A copy of ``b`` with the new positions and CIGARs."""
    out = ReadBatch(n=b.n)
    out.tid = b.tid.copy()
    out.pos = new_pos
    out.mapq = b.mapq.copy()
    out.flag = b.flag.copy()
    out.mtid = new_mtid
    out.mpos = new_mpos
    out.tlen = b.tlen.copy()
    out.qname = b.qname.copy()
    out.qname_off = b.qname_off.copy()
    out.seq = b.seq.copy()
    out.seq_off = b.seq_off.copy()
    out.qual = b.qual.copy()
    out.aux = b.aux.copy()
    out.aux_off = b.aux_off.copy()
    parts = []
    offs = np.zeros(b.n + 1, np.int64)
    for i in range(b.n):
        if i in new_cigars:
            c = np.array(new_cigars[i], np.uint32)
        else:
            c = b.cigar_of(i)
        parts.append(c)
        offs[i + 1] = offs[i] + len(c)
    out.cigar = (np.concatenate(parts) if parts
                 else np.empty(0, np.uint32))
    out.cigar_off = offs
    return out
