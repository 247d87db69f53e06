"""samtools fastq / fasta: a BAM's reads as FASTQ or FASTA.

Counterpart of samtools_tpu/tools/fastq_cmd.py (samtools' bam_fastq.c
and htslib's FASTQ writer): the options, a template's READ1/READ2 paired
over a name-grouped stream, soft clips removed (``--no-sc``), index
reads (``--i1``/``--i2``), /1 and /2 suffixes, CASAVA 1.8 names (``-i``),
aux tags tab-separated in record order, FREVERSE reads reverse
complemented on nt16, '-' turned to '+' in barcodes.  A host command: no
device work.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..io import bgzf as bgzfmod
from ..io.files import read_alignments
from ..io.sam_text import CIGAR_CHARS, NT16_LUT
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

DEFAULT_BARCODE_TAG = "BC"
DEFAULT_QUALITY_TAG = "QT"

# nt16 complement = 4-bit reversal (A1<->T8, C2<->G4, ambiguity codes map)
_NT16_COMP = np.array([int(f"{c:04b}"[::-1], 2) for c in range(16)],
                      np.uint8)
_NT16_CHARS = np.frombuffer(F.SEQ_NT16_STR.encode(), np.uint8)


class Opts:
    def __init__(self):
        self.fnse = None
        self.fnr = [None, None, None]
        self.fn_input = "-"
        self.has12 = True
        self.has12always = False
        self.use_oq = False
        self.copy_tags = False
        self.illumina_tag = False
        self.no_sc = False
        self.sc2aux = True
        self.flag_on = 0
        self.flag_off = F.FSECONDARY | F.FSUPPLEMENTARY
        self.flag_alloff = 0
        self.flag_anyon = 0
        self.fasta = False
        self.def_qual = 1
        self.barcode_tag = DEFAULT_BARCODE_TAG
        self.quality_tag = DEFAULT_QUALITY_TAG
        self.index_file = [None, None]
        self.index_format = None
        self.extra_tags = None
        self.compression_level = 1
        self.filter_tag = None
        self.filter_tag_vals: set[str] | None = None
        self.scauxtag = "s0"
        self.umi = False
        self.umi_tag = "OX,RX"


class OutFile:
    """Plain or bgzf (by .gz/.bgz/.bgzf suffix) text sink."""

    def __init__(self, path: str, level: int):
        self.path = path
        if path == "-":
            self.fh = sys.stdout.buffer
            self.bg = None
        else:
            raw = open(path, "wb")
            if path.endswith((".gz", ".bgz", ".bgzf")):
                self.bg = bgzfmod.BgzfWriter(raw, level=level)
                self.fh = self.bg
            else:
                self.bg = None
                self.fh = raw

    def write(self, data: bytes):
        self.fh.write(data)

    def close(self):
        if self.fh is not sys.stdout.buffer:
            if self.bg is not None:
                self.bg.close()
            else:
                self.fh.close()


def which_readpart(flag: int) -> int:
    if (flag & F.FREAD1) and not (flag & F.FREAD2):
        return 1
    if (flag & F.FREAD2) and not (flag & F.FREAD1):
        return 2
    return 0


def usage(fp, fasta: bool):
    t = "FASTA" if fasta else "FASTQ"
    fp.write("Usage: samtools %s [options...] <in.bam>\n"
             "Converts a SAM, BAM or CRAM to %s format.\n"
             % ("fasta" if fasta else "fastq", t))


class Rec:
    __slots__ = ("flag", "qname", "seq", "qual", "aux", "mapq")

    def __init__(self, b, i):
        self.flag = int(b.flag[i])
        self.qname = b.qname_str(i)
        self.seq = b.seq_of(i).copy()
        self.qual = b.qual_of(i).copy()
        self.aux = b.aux_of(i)
        self.mapq = int(b.mapq[i])


def remove_softclips(rec: Rec, cigar: np.ndarray, backup: bool,
                     tag: str) -> bool:
    """--no-sc (removesoftclips, bam_fastq.c:1046).  Returns False if the
    read becomes empty (caller discards).  Mutates rec seq/qual/aux."""
    if cigar.size == 0:
        return True
    ops = cigar & 0xF
    if not (ops == F.CSOFT_CLIP).any():
        return True
    lens = (cigar >> 4).astype(np.int64)
    consumes_q = np.isin(ops, (F.CMATCH, F.CINS, F.CSOFT_CLIP,
                               F.CEQUAL, F.CDIFF))
    qoff = np.concatenate([[0], np.cumsum(np.where(consumes_q, lens, 0))])
    keep_mask = np.zeros(rec.seq.size, bool)
    clip_spans = []
    for j in range(cigar.size):
        if not consumes_q[j]:
            continue
        a, b = int(qoff[j]), int(qoff[j + 1])
        if ops[j] == F.CSOFT_CLIP:
            clip_spans.append((a, b))
        else:
            keep_mask[a:b] = True
    if backup:
        rev = bool(rec.flag & F.FREVERSE)
        cig_order = range(cigar.size - 1, -1, -1) if rev \
            else range(cigar.size)
        cig_str = "".join("%d%s" % (int(lens[j]),
                                    CIGAR_CHARS[int(ops[j])])
                          for j in cig_order)
        cb = np.concatenate([rec.seq[a:b] for a, b in clip_spans]) \
            if clip_spans else np.empty(0, np.uint8)
        cq = np.concatenate([rec.qual[a:b] for a, b in clip_spans]) \
            if clip_spans else np.empty(0, np.uint8)
        if rev:
            cb = _NT16_COMP[cb][::-1]
            cq = cq[::-1]
        bases = bytes(_NT16_CHARS[cb]).decode("latin-1")
        quals = bytes((cq + 33).astype(np.uint8)).decode("latin-1")
        val = "%s:%s:%s" % (cig_str, bases, quals)
        rec.aux = auxmod.delete_tags(rec.aux, {tag})
        rec.aux = np.concatenate([rec.aux, np.frombuffer(
            tag.encode() + b"Z" + val.encode("latin-1") + b"\0",
            np.uint8)])
    rec.seq = rec.seq[keep_mask]
    rec.qual = rec.qual[keep_mask]
    return rec.seq.size > 0


def aux_value_str(aux, tag: str):
    got = auxmod.get_value(aux, tag)
    if got is None:
        return None
    t, v = got
    if t in "iIsScC":
        return "%d" % int(v)
    if t == "f":
        return "%f" % float(np.float32(v))
    if t == "A":
        return str(v)
    if t in "ZH":
        return str(v)
    return None


def format_rec(rec: Rec, opts: Opts, tag_filter) -> bytes:
    """One record -> FASTQ/FASTA text (htslib fastq_format1 parity)."""
    name = rec.qname
    if opts.umi:
        for ut in opts.umi_tag.split(","):
            got = auxmod.get_value(rec.aux, ut.strip())
            if got is not None and got[0] == "Z":
                name += ":" + str(got[1]).replace("-", "+")
                break
    if opts.illumina_tag:
        rp = which_readpart(rec.flag)
        bcv = auxmod.get_value(rec.aux, opts.barcode_tag)
        bc = (str(bcv[1]).replace("-", "+")
              if bcv is not None and bcv[0] == "Z" else "0")
        name += " %d:%c:0:%s" % (2 if rp == 2 else 1,
                                 "Y" if rec.flag & F.FQCFAIL else "N",
                                 bc if bc else "0")
    elif opts.has12:
        rp = which_readpart(rec.flag)
        if rp:
            name += "/%d" % rp
    parts = [name]
    if tag_filter is not None:
        if tag_filter == "*":
            parts.extend(auxmod.aux_to_sam_fields(rec.aux))
        else:
            parts.extend(fld for fld in auxmod.aux_to_sam_fields(rec.aux)
                         if fld[:2] in tag_filter)
    hdr = "\t".join(parts)
    seq = rec.seq
    qual = rec.qual
    if rec.flag & F.FREVERSE:
        seq = _NT16_COMP[seq][::-1]
        qual = qual[::-1]
    seq_s = bytes(_NT16_CHARS[seq]).decode("latin-1")
    if opts.fasta:
        return (">%s\n%s\n" % (hdr, seq_s)).encode("latin-1")
    q = qual.astype(np.int64)
    q = np.where(q == 0xFF, opts.def_qual, q)
    qual_s = bytes((q + 33).astype(np.uint8)).decode("latin-1")
    return ("@%s\n%s\n+\n%s\n" % (hdr, seq_s, qual_s)).encode("latin-1")


def make_index_rec(src: Rec, opts: Opts, seq_str: str,
                   qual_str: str | None) -> Rec:
    """write_index_rec (bam_fastq.c:873): unmapped fwd record carrying
    the barcode slice as seq, QT slice (or def_qual) as qual."""
    r = Rec.__new__(Rec)
    r.flag = (src.flag | F.FUNMAP) & ~F.FREVERSE
    r.qname = src.qname
    r.seq = NT16_LUT[np.frombuffer(seq_str.encode("latin-1"), np.uint8)]
    if qual_str is not None:
        r.qual = (np.frombuffer(qual_str.encode("latin-1"), np.uint8)
                  - 33).astype(np.uint8)
    else:
        r.qual = np.full(r.seq.size, opts.def_qual, np.uint8)
    r.aux = src.aux
    r.mapq = 0
    return r


def output_index(b1: Rec | None, b2: Rec | None, opts: Opts, fpi,
                 tag_filter) -> None:
    """output_index (bam_fastq.c:918): split the barcode tag per
    --index-format into index reads."""
    if not fpi[0] and not fpi[1]:
        return
    b = b1 if b1 is not None else b2
    ifmt = opts.index_format or "i*i*"
    bc = qt = None
    for r in (b1, b2):
        if r is not None and bc is None:
            got = auxmod.get_value(r.aux, opts.barcode_tag)
            if got is not None and got[0] == "Z":
                bc = str(got[1])
    if bc is None:
        return
    for r in (b1, b2):
        if r is not None and qt is None:
            got = auxmod.get_value(r.aux, opts.quality_tag)
            if got is not None and got[0] == "Z":
                qt = str(got[1])
    if qt is not None and len(bc) != len(qt):
        qt = None

    inum = 0
    pi = 0      # position in ifmt
    bpos = qpos = 0
    while inum < 2 and pi < len(ifmt):
        fc = ifmt[pi]
        pi += 1
        if pi < len(ifmt) and ifmt[pi].isdigit():
            j = pi
            while j < len(ifmt) and ifmt[j].isdigit():
                j += 1
            length = int(ifmt[pi:j])
            pi = j
        else:
            pi += 1     # skip '*'
            length = 0
        end = bpos
        if length:
            while end < len(bc) and end - bpos < length:
                end += 1
        else:
            while end < len(bc) and bc[end].isalpha():
                end += 1
        if fc == "n":
            bpos = end + (1 if length == 0 else 0)
            if qt is not None:
                qpos = bpos
        elif fc == "i":
            if fpi[inum] is not None and end > bpos:
                qs = qt[bpos:bpos + (end - bpos)] if qt is not None \
                    else None
                rec = make_index_rec(b, opts, bc[bpos:end], qs)
                fpi[inum].write(format_rec(rec, opts, tag_filter))
            bpos = end + (1 if length == 0 else 0)
            if qt is not None:
                qpos = bpos
            inum += 1
        else:
            sys.stderr.write("Unknown index-format code\n")
            return


def filter_it_out(rec: Rec, opts: Opts) -> bool:
    if opts.filter_tag:
        val = aux_value_str(rec.aux, opts.filter_tag)
        got = auxmod.get_value(rec.aux, opts.filter_tag)
        if got is None:
            return True
        if opts.filter_tag_vals is not None:
            if val is None or val not in opts.filter_tag_vals:
                return True
    fl = rec.flag
    return ((fl & opts.flag_on) != opts.flag_on
            or (fl & opts.flag_off) != 0
            or ((fl & opts.flag_anyon) == 0 and opts.flag_anyon != 0)
            or (bool(fl & opts.flag_alloff)
                and (fl & opts.flag_alloff) == opts.flag_alloff))


def main_fastq(argv: list[str]) -> int:
    return _main(argv, fasta=False)


def main_fasta(argv: list[str]) -> int:
    return _main(argv, fasta=True)


LONG_OPTS = ["require-flags=", "excl-flags=", "exclude-flags=", "rf=",
             "incl-flags=", "include-flags=", "i1=", "I1=", "i2=", "I2=",
             "if=", "IF=", "index-format=", "barcode-tag=", "quality-tag=",
             "tag=", "tag-file=", "no-sc", "no-sc-bkp", "sc-aux=", "UMI",
             "UMI-tag="]


def _main(argv: list[str], fasta: bool) -> int:
    prg = "fasta" if fasta else "fastq"
    ga = GlobalArgs()
    opts = Opts()
    opts.fasta = fasta
    try:
        gopts, args = gnu_getopt(argv, "0:1:2:o:f:F:G:niNOs:c:tT:v:@:d:D:U",
                                 LONG_OPTS)
    except UsageError:
        usage(sys.stderr, fasta)
        return 1
    for o, v in gopts:
        if o == "-0":
            opts.fnr[0] = v
        elif o == "-1":
            opts.fnr[1] = v
        elif o == "-2":
            opts.fnr[2] = v
        elif o == "-o":
            opts.fnr[1] = v
            opts.fnr[2] = v
        elif o in ("-f", "--require-flags"):
            opts.flag_on |= int(v, 0)
        elif o in ("-F", "--excl-flags", "--exclude-flags"):
            opts.flag_off = int(v, 0)
        elif o == "-G":
            opts.flag_alloff |= int(v, 0)
        elif o in ("--rf", "--incl-flags", "--include-flags"):
            opts.flag_anyon |= int(v, 0)
        elif o == "-n":
            opts.has12 = False
        elif o == "-N":
            opts.has12always = True
        elif o == "-O":
            opts.use_oq = True
        elif o == "-s":
            opts.fnse = v
        elif o == "-t":
            opts.copy_tags = True
        elif o == "-i":
            opts.illumina_tag = True
        elif o in ("-U", "--UMI"):
            opts.umi = True
        elif o == "--UMI-tag":
            opts.umi_tag = v
        elif o == "-c":
            opts.compression_level = max(0, min(9, int(v)))
        elif o == "-T":
            opts.extra_tags = v
        elif o == "-v":
            opts.def_qual = int(v)
        elif o in ("-d", "--tag"):
            if len(v) < 2 or (len(v) > 2 and v[2] != ":"):
                print_error(prg, 'Invalid "tag:value" option: "%s"', v)
                return 1
            if opts.filter_tag and opts.filter_tag != v[:2]:
                print_error(prg, "Different tag type specified to before")
                return 1
            if len(v) >= 3:
                if opts.filter_tag_vals is None:
                    opts.filter_tag_vals = set()
                opts.filter_tag_vals.add(v[3:])
            opts.filter_tag = v[:2]
        elif o in ("-D", "--tag-file"):
            if len(v) < 4 or v[2] not in ":;":
                print_error("view", 'Invalid "tag:file" option: "%s"', v)
                return 1
            if opts.filter_tag and opts.filter_tag != v[:2]:
                print_error(prg, "Different tag type specified to before")
                return 1
            try:
                with open(v[3:], "rt") as fp:
                    if opts.filter_tag_vals is None:
                        opts.filter_tag_vals = set()
                    for line in fp:
                        opts.filter_tag_vals.add(line.rstrip("\n"))
            except OSError as e:
                print_error_errno(prg, 'failed to open "%s" for reading',
                                  v[3:], exc=e)
                return 1
            opts.filter_tag = v[:2]
        elif o == "--barcode-tag":
            opts.barcode_tag = v
        elif o == "--quality-tag":
            opts.quality_tag = v
        elif o == "--i1" or o == "--I1":
            opts.index_file[0] = v
        elif o == "--i2" or o == "--I2":
            opts.index_file[1] = v
        elif o in ("--if", "--IF", "--index-format"):
            opts.index_format = v
        elif o == "--no-sc":
            opts.no_sc = True
        elif o == "--no-sc-bkp":
            opts.sc2aux = False
        elif o == "--sc-aux":
            if len(v) != 2:
                print_error(prg, "Invalid backup tag")
                return 1
            opts.scauxtag = v
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr, fasta)
            return 1

    if opts.fnr[1] or opts.fnr[2]:
        opts.has12 = False
    if opts.has12always:
        opts.has12 = True

    n_index = (opts.index_format or "").count("i")
    if n_index > 2:
        sys.stderr.write("Invalid index format: more than 2 indexes\n")
        return 1
    if opts.index_file[1] and not opts.index_file[0]:
        sys.stderr.write("Index one specified, but index two not given\n")
        return 1
    if opts.illumina_tag and not n_index:
        sys.stderr.write("You must specify an index format "
                         "(--index-format) with the Illumina Casava (-i) "
                         "option\n")
        return 1
    if n_index == 0 and opts.index_file[0]:
        sys.stderr.write("index_format not specified, but index file "
                         "given\n")
        return 1
    if not (0 <= opts.def_qual <= 93):
        sys.stderr.write("Invalid -v default quality %d, allowed range 0 "
                         "to 93\n" % opts.def_qual)
        return 1
    if len(args) > 1:
        sys.stderr.write("Too many arguments.\n")
        return 1
    opts.fn_input = args[0] if args else "-"

    # tag filter for the writer: None = no tags, "*" = all, set = listed
    if opts.extra_tags is not None and opts.extra_tags in ("", "*"):
        tag_filter = "*"
    else:
        tags = []
        if opts.copy_tags:
            tags.extend(["RG", "BC", "QT"])
        if opts.extra_tags:
            tags.extend(t for t in opts.extra_tags.split(",") if t)
        tag_filter = set(tags) if tags else None

    try:
        f = read_alignments(opts.fn_input, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("bam2fq", 'Cannot read file "%s"',
                          opts.fn_input, exc=e)
        return 1
    so = f.header.find_tag_values("HD", "SO")
    if so and so[0] == "coordinate":
        print_error(prg, "Coordinate sorted file.  "
                    "Read pairs may be out of order")

    lvl = opts.compression_level
    out_files: dict[str, OutFile] = {}

    def open_out(path):
        if path in out_files:
            return out_files[path]
        of = OutFile(path, lvl)
        out_files[path] = of
        return of

    fpse = open_out(opts.fnse) if opts.fnse else None
    fpr = [open_out(p) if p else open_out("-") for p in opts.fnr]
    fpi = [open_out(p) if p else None for p in opts.index_file]

    b = f.batch
    n_reads = 0
    n_singletons = 0
    best: dict[int, Rec] = {}
    score = {0: 0, 1: 0, 2: 0}
    current = None

    def flush():
        nonlocal n_singletons
        if score[1] > 0 and score[2] > 0:
            if opts.illumina_tag:
                # copy barcode/quality tags from R1 to R2 for CASAVA
                for tg in (opts.barcode_tag, opts.quality_tag):
                    got = auxmod.get_value(best[1].aux, tg)
                    if got is not None and got[0] == "Z":
                        best[2].aux = auxmod.delete_tags(best[2].aux, {tg})
                        best[2].aux = np.concatenate(
                            [best[2].aux, np.frombuffer(
                                tg.encode() + b"Z"
                                + str(got[1]).encode("latin-1") + b"\0",
                                np.uint8)])
            fpr[1].write(format_rec(best[1], opts, tag_filter))
            fpr[2].write(format_rec(best[2], opts, tag_filter))
            output_index(best[1], best[2], opts, fpi, tag_filter)
        elif score[1] > 0 or score[2] > 0:
            rp = 1 if score[1] > 0 else 2
            if fpse is not None:
                fpse.write(format_rec(best[rp], opts, tag_filter))
                n_singletons += 1
            else:
                fpr[rp].write(format_rec(best[rp], opts, tag_filter))
            output_index(best.get(1) if score[1] > 0 else None,
                         best.get(2) if score[2] > 0 else None,
                         opts, fpi, tag_filter)
        if score[0]:
            fpr[0].write(format_rec(best[0], opts, tag_filter))
            output_index(best[0], None, opts, fpi, tag_filter)

    for i in range(b.n):
        rec = Rec(b, i)
        if filter_it_out(rec, opts):
            continue
        if opts.use_oq:
            got = auxmod.get_value(rec.aux, "OQ")
            if got is not None and got[0] == "Z":
                oq = (np.frombuffer(str(got[1]).encode("latin-1"),
                                    np.uint8) - 33)
                n = min(oq.size, rec.qual.size)
                rec.qual[:n] = oq[:n]
        if opts.no_sc:
            if not remove_softclips(rec, b.cigar_of(i), opts.sc2aux,
                                    opts.scauxtag):
                continue
        n_reads += 1
        if current is None or rec.qname != current:
            if current is not None:
                flush()
            current = rec.qname
            score = {0: 0, 1: 0, 2: 0}
            best = {}
        b_score = 2 if (rec.qual.size and rec.qual[0] != 0xFF) else 1
        if rec.qual.size == 0:
            b_score = 1
        rp = which_readpart(rec.flag)
        if score[rp] < b_score:
            score[rp] = b_score
            best[rp] = rec
    if current is not None:
        flush()

    for of in out_files.values():
        of.close()
    sys.stderr.write("[M::bam2fq_mainloop] discarded %d singletons\n"
                     % n_singletons)
    sys.stderr.write("[M::bam2fq_mainloop] processed %d reads\n" % n_reads)
    return 0
