"""samtools import: FASTQ (or FASTA) to unaligned SAM, BAM or CRAM.

Counterpart of samtools_tpu/tools/import_cmd.py (samtools' bam_import.c
and htslib's FASTQ reader): a /1 or /2 name suffix sets PAIRED, MUNMAP
and READ1/READ2; a CASAVA comment (``-i``) sets the read's order, QCFAIL
and barcode tag; ``-T`` copies SAM-style aux fields from the comment;
``-U`` moves a UMI off the name ('+' to '-'); index files become BC
('-'-joined) and QT (' '-joined) tags.  A host command: no device work.
"""

from __future__ import annotations

import gzip
import re
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ReadBatch
from ..io.header import SamHeader
from ..io.files import infer_output_format, write_alignments
from ..io.sam_text import NT16_LUT
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

# file slots, in read order (index before main reads; bam_import.c:139)
FQ_I1, FQ_I2, FQ_R0, FQ_R1, FQ_R2, FQ_SINGLE, FQ_END = range(7)

_CASAVA_RE = re.compile(r"^([12]):([YN]):(\d+):?([!-~]*)$")
_AUX_RE = re.compile(r"^[A-Za-z][A-Za-z0-9]:[AifZHBdjJ]:")
_UMI_CHARS = set("ACGTNacgtn+")


def usage(fp):
    fp.write("Usage: samtools import [options] [file.fastq ...]\n")


class FastqReader:
    """Streaming FASTQ/FASTA parser (htslib fastq_parse1 analog)."""

    def __init__(self, path: str):
        if path == "-":
            data = sys.stdin.buffer.read()
        else:
            with open(path, "rb") as f:
                data = f.read()
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        self.lines = data.decode("latin-1").split("\n")
        self.pos = 0

    def read(self):
        """Returns (name, comment, seq, qual|None) or None at EOF."""
        n = len(self.lines)
        while self.pos < n and not self.lines[self.pos].strip():
            self.pos += 1
        if self.pos >= n:
            return None
        line = self.lines[self.pos]
        if line[0] not in "@>":
            raise ValueError("bad fastq record start: %r" % line[:20])
        fasta = line[0] == ">"
        self.pos += 1
        m = re.match(r"(\S+)[ \t]*(.*)", line[1:])
        name = m.group(1)
        comment = m.group(2)
        seq_parts = []
        while self.pos < n:
            l2 = self.lines[self.pos]
            if not l2:
                self.pos += 1
                continue
            if l2[0] == "+" and not fasta:
                break
            if l2[0] in "@>" and fasta:
                break
            seq_parts.append(l2.strip())
            self.pos += 1
        seq = "".join(seq_parts)
        if fasta:
            return name, comment, seq, None
        self.pos += 1  # '+' line
        qual_parts = []
        got = 0
        while self.pos < n and got < len(seq):
            l2 = self.lines[self.pos].rstrip("\r")
            qual_parts.append(l2)
            got += len(l2)
            self.pos += 1
        qual = "".join(qual_parts)
        if len(qual) != len(seq):
            raise ValueError("seq/qual length mismatch for %s" % name)
        return name, comment, seq, qual


class ParsedRead:
    __slots__ = ("name", "flag", "seq", "qual", "aux_fields")


def parse_read(raw, opts) -> ParsedRead:
    name, comment, seq, qual = raw
    r = ParsedRead()
    flag = F.FUNMAP
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        flag |= F.FPAIRED | F.FMUNMAP | (
            F.FREAD1 if name[-1] == "1" else F.FREAD2)
        name = name[:-2]
    if opts.umi and ":" in name:
        base, last = name.rsplit(":", 1)
        if last and all(c in _UMI_CHARS for c in last):
            name = base
            r_umi = last.replace("+", "-")
        else:
            r_umi = None
    else:
        r_umi = None
    aux_fields = []
    if r_umi is not None:
        aux_fields.append("%s:Z:%s" % (opts.umi_tag, r_umi))
    if comment:
        fields = comment.split("\t") if "\t" in comment \
            else comment.split(" ")
        for fld in fields:
            if not fld:
                continue
            if opts.casava:
                m = _CASAVA_RE.match(fld)
                if m:
                    rp, qcfail, _, bc = m.groups()
                    flag |= F.FPAIRED | F.FMUNMAP | (
                        F.FREAD1 if rp == "1" else F.FREAD2)
                    if qcfail == "Y":
                        flag |= F.FQCFAIL
                    if bc:
                        aux_fields.append("%s:Z:%s"
                                          % (opts.barcode_seq, bc))
                    continue
            if opts.aux is not None and _AUX_RE.match(fld):
                if opts.aux_all or fld[:2] in opts.aux_set:
                    aux_fields.append(fld)
    if opts.name2 and comment:
        name = comment.split()[0]
    r.name = name
    r.flag = flag
    r.seq = seq
    r.qual = qual
    r.aux_fields = aux_fields
    return r


class Opts:
    pass


LONG_OPTS = ["no-PG", "i1=", "i2=", "r1=", "r2=", "rg=", "rg-line=",
             "order=", "barcode-tag=", "quality-tag=", "UMI-tag=",
             "name2", "umi", "UMI", "output-fmt=", "output-fmt-option="]


def main_import(argv: list[str]) -> int:
    ga = GlobalArgs()
    opts = Opts()
    opts.no_pg = False
    opts.fn = [None] * FQ_END
    opts.fn_out = "-"
    opts.idx_both = False
    opts.casava = False
    opts.barcode_seq = "BC"
    opts.barcode_qual = "QT"
    opts.umi = False
    opts.umi_tag = "RX"
    opts.aux = None
    opts.rg = None
    opts.rg_line = None
    opts.order = None
    opts.order_str = 0
    opts.name2 = False
    level = 6
    rg_parts = []
    try:
        gopts, args = gnu_getopt(argv, "1:2:s:0:bhiT:r:R:o:O:u@:NU",
                                 LONG_OPTS)
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in gopts:
        if o == "-b":
            opts.idx_both = True
        elif o == "-0":
            opts.fn[FQ_R0] = v
        elif o in ("-1", "--r1"):
            opts.fn[FQ_R1] = v
        elif o in ("-2", "--r2"):
            opts.fn[FQ_R2] = v
        elif o == "--i1":
            opts.fn[FQ_I1] = v
        elif o == "--i2":
            opts.fn[FQ_I2] = v
        elif o == "-s":
            opts.fn[FQ_SINGLE] = v
        elif o == "-o":
            opts.fn_out = v
        elif o == "-i":
            opts.casava = True
        elif o in ("-U", "--umi", "--UMI"):
            opts.umi = True
        elif o == "--barcode-tag":
            opts.barcode_seq = v
        elif o == "--quality-tag":
            opts.barcode_qual = v
        elif o == "--UMI-tag":
            opts.umi_tag = v
        elif o == "-T":
            opts.aux = v
        elif o == "-u":
            level = 0
        elif o == "-R" or o == "--rg":
            opts.rg = v
        elif o == "-r" or o == "--rg-line":
            if not v.startswith("@") and not rg_parts:
                rg_parts.append("@RG")
            rg_parts.append(v)
            opts.rg_line = "\t".join(rg_parts) if rg_parts[0] == "@RG" \
                else rg_parts[0] + "\t" + "\t".join(rg_parts[1:]) \
                if len(rg_parts) > 1 else rg_parts[0]
        elif o == "-N" or o == "--name2":
            opts.name2 = True
        elif o == "--no-PG":
            opts.no_pg = True
        elif o == "--order":
            opts.order = v[:2]
            if len(v) > 3 and v[2] == ":":
                opts.order_str = int(v[3:])
        elif o == "-h":
            usage(sys.stdout)
            return 0
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1

    opts.aux_all = opts.aux is not None and opts.aux in ("", "*")
    opts.aux_set = (set(t for t in (opts.aux or "").split(",") if t)
                    if opts.aux is not None else set())

    if len(args) == 1:
        opts.fn[FQ_SINGLE] = args[0]
    else:
        for i in range(min(2, len(args))):
            opts.fn[FQ_R1 + i] = args[i]

    readers = []
    ids = []
    read_str = []
    index_str = []
    for i in range(FQ_END):
        if not opts.fn[i]:
            continue
        try:
            readers.append(FastqReader(opts.fn[i]))
        except OSError as e:
            sys.stderr.write("%s: %s\n" % (opts.fn[i], e.strerror))
            return 1
        ids.append(i)
        if i == FQ_I1:
            read_str.append(" --i1 I1.fastq")
            index_str.append("i*")
        elif i == FQ_I2:
            read_str.append(" --i2 I2.fastq")
            index_str.append("i*")
        elif i == FQ_R0:
            read_str.append(" -0 unpaired.fastq")
        elif i == FQ_R1:
            read_str.append(" -1 R1.fastq")
        elif i == FQ_R2:
            read_str.append(" -2 R2.fastq")
        elif i == FQ_SINGLE:
            read_str.append(" -n -o paired.fastq")
    if not readers:
        usage(sys.stdout)
        return 0
    if opts.casava:
        read_str.append(" -i")
        if not index_str:
            read_str.append(" --index-format 'i*i*'")
    if opts.umi:
        read_str.append(" -U --UMI-tag %s" % opts.umi_tag)

    # header (CO reverse hint + HD + RG + PG; bam_import.c:256)
    hdr_lines = ["@HD\tVN:1.6\tSO:unsorted\tGO:query"]
    if read_str:
        co = "@CO\tReverse with: samtools fastq%s" % "".join(read_str)
        if index_str:
            co += ' --index-format="%s"' % "".join(index_str)
        hdr_lines.append(co)
    rg_id = opts.rg
    if opts.rg_line:
        line = opts.rg_line if opts.rg_line.startswith("@") \
            else "@RG\t" + opts.rg_line
        hdr_lines.append(line)
        m = re.search(r"\tID:([^\t]*)", line)
        if not m:
            sys.stderr.write('"-r RG-LINE" option contained no ID field\n')
            return 1
        rg_id = m.group(1)
    elif opts.rg:
        hdr_lines.append("@RG\tID:%s" % opts.rg)
    if not opts.no_pg:
        hdr_lines.append(
            "@PG\tID:samtools\tPN:samtools\tVN:%s\tCL:%s"
            % (SAMTOOLS_PARITY_VERSION,
               "samtools import " + " ".join(argv)))
    header = SamHeader.from_text("\n".join(hdr_lines) + "\n")

    # interleave: one record per open file per cycle, index files first
    out_reads: list[ParsedRead] = []
    read_num = 0
    while True:
        idx_seq: list[str] = []
        idx_qual: list[str] = []
        eof = 0
        for k, i in enumerate(ids):
            try:
                raw = readers[k].read()
            except ValueError as e:
                print_error("import", "%s", str(e))
                return 1
            if raw is None:
                eof += 1
                continue
            if i in (FQ_I1, FQ_I2):
                idx_seq.append(raw[2])
                idx_qual.append(raw[3] if raw[3] is not None else "")
                continue
            r = parse_read(raw, opts)
            if idx_seq:
                if opts.idx_both or i in (FQ_SINGLE, FQ_R0, FQ_R1):
                    r.aux_fields.append("%s:Z:%s" % (opts.barcode_seq,
                                                     "-".join(idx_seq)))
                    r.aux_fields.append("%s:Z:%s" % (opts.barcode_qual,
                                                     " ".join(idx_qual)))
            if i == FQ_R1:
                if not (r.flag & (F.FREAD1 | F.FREAD2)):
                    r.flag |= F.FREAD1
                r.flag |= F.FPAIRED
                if FQ_R2 in ids:
                    r.flag |= F.FMUNMAP
            elif i == FQ_R2:
                r.flag |= F.FPAIRED | F.FREAD2
                if FQ_R1 in ids:
                    r.flag |= F.FMUNMAP
            if rg_id:
                r.aux_fields.append("RG:Z:%s" % rg_id)
            if opts.order:
                if opts.order_str:
                    r.aux_fields.append("%s:Z:%0*d" % (opts.order,
                                                       opts.order_str,
                                                       read_num))
                else:
                    r.aux_fields.append("%s:i:%d" % (opts.order, read_num))
                read_num += 1
            out_reads.append(r)
        if eof == len(ids):
            break
        if eof:
            print_error("import",
                        "input files with differing number of records")
            return 1

    # build ReadBatch
    n = len(out_reads)
    b = ReadBatch(n=n)
    b.flag = np.array([r.flag for r in out_reads], np.uint16) \
        if n else np.empty(0, np.uint16)
    b.tid = np.full(n, -1, np.int32)
    b.pos = np.full(n, -1, np.int64)
    b.mapq = np.zeros(n, np.uint8)
    b.mtid = np.full(n, -1, np.int32)
    b.mpos = np.full(n, -1, np.int64)
    b.tlen = np.zeros(n, np.int64)
    qnames = [r.name.encode("latin-1") for r in out_reads]
    b.qname = (np.frombuffer(b"".join(qnames), np.uint8)
               if qnames else np.empty(0, np.uint8))
    b.qname_off = np.concatenate(
        [[0], np.cumsum([len(q) for q in qnames], dtype=np.int64)])
    b.cigar = np.empty(0, np.uint32)
    b.cigar_off = np.zeros(n + 1, np.int64)
    seqs = [NT16_LUT[np.frombuffer(r.seq.encode("latin-1"), np.uint8)]
            for r in out_reads]
    b.seq = (np.concatenate(seqs).astype(np.uint8)
             if seqs else np.empty(0, np.uint8))
    b.seq_off = np.concatenate(
        [[0], np.cumsum([len(s) for s in seqs], dtype=np.int64)])
    quals = []
    for r in out_reads:
        if r.qual is None:
            quals.append(np.full(len(r.seq), 0xFF, np.uint8))
        else:
            quals.append((np.frombuffer(r.qual.encode("latin-1"),
                                        np.uint8) - 33).astype(np.uint8))
    b.qual = (np.concatenate(quals).astype(np.uint8)
              if quals else np.empty(0, np.uint8))
    auxs = []
    for r in out_reads:
        if r.aux_fields:
            auxs.append(np.frombuffer(
                b"".join(auxmod.sam_field_to_aux(x)
                         for x in r.aux_fields), np.uint8))
        else:
            auxs.append(np.empty(0, np.uint8))
    b.aux = (np.concatenate(auxs).astype(np.uint8)
             if auxs else np.empty(0, np.uint8))
    b.aux_off = np.concatenate(
        [[0], np.cumsum([len(a) for a in auxs], dtype=np.int64)])

    fmt = infer_output_format(opts.fn_out, ga.out_fmt, default="sam")
    try:
        write_alignments(opts.fn_out, header, b, fmt=fmt,
                         threads=ga.nthreads, level=level,
                         include_header=True)
    except OSError as e:
        print_error_errno("import", "failed to write \"%s\"",
                          opts.fn_out, exc=e)
        return 1
    return 0
