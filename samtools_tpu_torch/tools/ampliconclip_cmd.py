"""samtools ampliconclip: clip primer sequence from the ends of reads.

Counterpart of samtools_tpu/tools/ampliconclip_cmd.py (samtools'
bam_ampliconclip.c): the primers of a BED file, per contig, sorted by
their right ends; each mapped read's 5' end (or with ``--both-ends`` both
ends) is matched against them within ``--tolerance`` bases by a
bisection and a scan (``matching_clip_site``, which also counts the reads
each primer clips), and the overlap is soft- or hard-clipped off the
CIGAR (``trim_left``, ``trim_right``).  Then the length filters, the OA
tag and the NM/MD deletion, the output and rejects files, the stats and
the primer counts.  The file is read whole and walked a record at a
time.  A host command: no device work.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ReadBatch
from ..io.files import infer_output_format, read_alignments, write_alignments
from ..io.header import SamHeader
from ..io.sam_text import CIGAR_CHARS
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     out_level, print_error_errno)

_CONSUMES_Q = F.CIGAR_CONSUMES_QUERY
_CONSUMES_R = F.CIGAR_CONSUMES_REF


class BedEntry:
    """One BED row: a primer, and the reads it clipped."""
    __slots__ = ("left", "right", "name", "score", "rev", "num_reads")

    def __init__(self, left, right, name, score, rev):
        self.left = left
        self.right = right
        self.name = name
        self.score = score
        self.rev = rev
        self.num_reads = 0


def load_bed_multi_ref(path: str, get_strand: bool,
                       sort_by_pos: bool = True):
    """({contig: [BedEntry]}, {contig: longest primer}, contigs in file
    order) of a BED file (bam_ampliconclip.c:76-256), each contig's rows
    sorted by right end when ``sort_by_pos`` (ampliconclip) and in file
    order otherwise (ampliconstats); None after an error message, or when
    the file holds no row."""
    lists: dict[str, list[BedEntry]] = {}
    longest: dict[str, int] = {}
    ref_order: list[str] = []
    try:
        fh = open(path)
    except OSError as e:
        print_error_errno("amplicon", "unable to open file %s.", path,
                          exc=e)
        return None
    with fh:
        for ln, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line or line[0] == "#" \
                    or line.startswith(("track ", "browser ")):
                continue
            cols = line.split()
            if len(cols) < (6 if get_strand else 3):
                sys.stderr.write(
                    "[amplicon] error: invalid bed file format in line %d"
                    " of %s.\n" % (ln, path))
                return None
            ref = cols[0]
            left, right = int(cols[1]), int(cols[2])
            name = cols[3] if len(cols) >= 4 else None
            score = cols[4] if len(cols) >= 5 else None
            rev = 0
            if get_strand:
                if cols[5] not in ("+", "-"):
                    sys.stderr.write(
                        "[amplicon] error: bad strand value in line %d, "
                        "expecting '+' or '-', found '%s'.\n"
                        % (ln, cols[5]))
                    return None
                rev = int(cols[5] == "-")
            if ref not in lists:
                lists[ref] = []
                longest[ref] = 0
                ref_order.append(ref)
            lists[ref].append(BedEntry(left, right, name, score, rev))
            longest[ref] = max(longest[ref], right - left)
    if not lists:
        return None
    if sort_by_pos:
        for sites in lists.values():
            sites.sort(key=lambda e: e.right)
    return lists, longest, ref_order


def matching_clip_site(sites: list[BedEntry], pos: int, is_rev: bool,
                       use_strand: bool, longest: int, tol: int) -> int:
    """The largest overlap of a read end at ``pos`` with a primer
    (bam_ampliconclip.c:279-338), 0 for none; the primer that gives it
    counts one more read."""
    l, r = 0, len(sites)
    mid = len(sites) // 2
    pos_tol = (pos - tol if pos > tol else 0) if is_rev else pos
    while r - l > 1:
        if sites[mid].right <= pos_tol:
            l = mid
        else:
            r = mid
        mid = (l + r) // 2
    size = 0
    used = None
    for i in range(l, len(sites)):
        e = sites[i]
        if use_strand and is_rev != e.rev:
            continue
        if is_rev:
            mod_left, mod_right = e.left, e.right + tol
        else:
            mod_left = e.left - tol if e.left > tol else 0
            mod_right = e.right
        if pos + longest + tol < mod_right:
            break
        if mod_left <= pos <= mod_right:
            over = pos - e.left if is_rev else e.right - pos
            if size < over:
                size = over
                used = e
    if used is not None:
        used.num_reads += 1
    return size


def trim_left(cigar, pos: int, l_qseq: int, bases: int, hard: bool):
    """bam_trim_left (bam_ampliconclip.c:341-487): ``bases`` reference
    bases clipped off the read's start.  (new CIGAR list, new pos, query
    bases to drop from the front (0 for a soft clip), emptied): emptied
    when a hard clip consumes the whole read."""
    ref_remove = bases
    qry_removed = 0
    hardclip = 0
    new_pos = pos
    n = len(cigar)
    i = 0
    while i < n:
        op, ln = int(cigar[i]) & 0xF, int(cigar[i]) >> 4
        if op == F.CHARD_CLIP:
            hardclip += ln
        else:
            if _CONSUMES_R[op]:
                if ln > ref_remove:
                    break
                ref_remove -= ln
                new_pos += ln
            if _CONSUMES_Q[op]:
                qry_removed += ln
        i += 1

    if i < n:
        op = int(cigar[i]) & 0xF
        if _CONSUMES_R[op]:
            new_pos += ref_remove
        if _CONSUMES_Q[op]:
            qry_removed += ref_remove
    else:
        if hard:
            return [], pos, l_qseq, True
        qry_removed = l_qseq

    new_cigar = []
    if hard:
        if hardclip + qry_removed > 0:
            new_cigar.append(((hardclip + qry_removed) << 4) | F.CHARD_CLIP)
    else:
        if hardclip > 0:
            new_cigar.append((hardclip << 4) | F.CHARD_CLIP)
        if qry_removed > 0:
            new_cigar.append((qry_removed << 4) | F.CSOFT_CLIP)
    if i < n and (int(cigar[i]) >> 4) > ref_remove:
        new_cigar.append((((int(cigar[i]) >> 4) - ref_remove) << 4)
                         | (int(cigar[i]) & 0xF))
        new_cigar.extend(int(c) for c in cigar[i + 1:])
    return new_cigar, new_pos, qry_removed if hard else 0, False


def trim_right(cigar, l_qseq: int, bases: int, hard: bool):
    """bam_trim_right (bam_ampliconclip.c:490-619): ``bases`` reference
    bases clipped off the read's end.  (new CIGAR list, query bases to
    drop from the end (0 for a soft clip), emptied)."""
    ref_remove = bases
    qry_removed = 0
    hardclip = 0
    i = len(cigar) - 1
    while i >= 0:
        op, ln = int(cigar[i]) & 0xF, int(cigar[i]) >> 4
        if op == F.CHARD_CLIP:
            hardclip += ln
        else:
            if _CONSUMES_R[op]:
                if ln > ref_remove:
                    break
                ref_remove -= ln
            if _CONSUMES_Q[op]:
                qry_removed += ln
        i -= 1

    if i >= 0:
        if _CONSUMES_Q[int(cigar[i]) & 0xF]:
            qry_removed += ref_remove
        new_cigar = [int(c) for c in cigar[:i]]
        new_cigar.append((((int(cigar[i]) >> 4) - ref_remove) << 4)
                         | (int(cigar[i]) & 0xF))
    else:
        if hard:
            return [], l_qseq, True
        qry_removed = l_qseq
        new_cigar = []

    if hard:
        if hardclip + qry_removed > 0:
            new_cigar.append(((hardclip + qry_removed) << 4) | F.CHARD_CLIP)
    else:
        if qry_removed > 0:
            new_cigar.append((qry_removed << 4) | F.CSOFT_CLIP)
        if hardclip > 0:
            new_cigar.append((hardclip << 4) | F.CHARD_CLIP)
    return new_cigar, qry_removed if hard else 0, False


def active_query_len(cigar) -> int:
    """Query bases outside the clips (bam_ampliconclip.c:622-638)."""
    return sum(int(c) >> 4 for c in cigar
               if _CONSUMES_Q[int(c) & 0xF] and int(c) & 0xF != F.CSOFT_CLIP)


def cigar_str(cigar) -> str:
    return "".join("%d%s" % (int(c) >> 4, CIGAR_CHARS[int(c) & 0xF])
                   for c in cigar)


def oa_value(qname: str, pos: int, flag: int, cigar, mapq: int,
             aux_buf) -> str:
    """The OA:Z value of the record before clipping
    (bam_ampliconclip.c:649-686): samtools writes the read name where
    RNAME belongs, and no comma before MAPQ when NM is absent; kept."""
    old = auxmod.get_value(aux_buf, "OA")
    s = "%s%s,%d,%c,%s" % (old[1] if old is not None else "", qname,
                           pos + 1, "-" if flag & F.FREVERSE else "+",
                           cigar_str(cigar))
    nm = auxmod.get_value(aux_buf, "NM")
    if nm is not None:
        return s + ",%d,%d;" % (mapq, int(nm[1]))
    return s + "%d,;" % mapq


def end_pos(pos: int, cigar) -> int:
    """The reference end of a read at ``pos`` with ``cigar``."""
    return pos + sum(int(c) >> 4 for c in cigar if _CONSUMES_R[int(c) & 0xF])


class Rec:
    """One record while it is clipped: its fields, rewritten in place."""
    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar", "mtid",
                 "mpos", "tlen", "seq", "qual", "aux")

    @classmethod
    def of(cls, b: ReadBatch, i: int) -> "Rec":
        r = cls()
        r.qname = b.qname_str(i)
        r.flag = int(b.flag[i])
        r.tid = int(b.tid[i])
        r.pos = int(b.pos[i])
        r.mapq = int(b.mapq[i])
        r.cigar = b.cigar_of(i).copy()
        r.mtid = int(b.mtid[i])
        r.mpos = int(b.mpos[i])
        r.tlen = int(b.tlen[i])
        r.seq = b.seq_of(i).copy()
        r.qual = b.qual_of(i).copy()
        r.aux = b.aux_of(i).copy()
        return r


def usage(fp):
    fp.write("Usage: samtools ampliconclip -b BED file <input.bam> -o <output.bam>\n\n"
             "Option: \n"
             " -b  FILE             BED file of regions (eg amplicon primers) to be removed.\n"
             " -o  FILE             output file name (default: stdout).\n"
             " -f  FILE             write stats to file name (default: stderr)\n"
             " -u                   Output uncompressed data\n"
             " --soft-clip          soft clip amplicon primers from reads (default)\n"
             " --hard-clip          hard clip amplicon primers from reads.\n"
             " --both-ends          clip on both 5' and 3' ends.\n"
             " --strand             use strand data from BED file to match read direction.\n"
             " --clipped            only output clipped reads.\n"
             " --fail               mark unclipped, mapped reads as QCFAIL.\n"
             " --filter-len INT     do not output reads INT size or shorter.\n"
             " --fail-len   INT     mark as QCFAIL reads INT size or shorter.\n"
             " --unmap-len  INT     unmap reads INT size or shorter, default 0.\n"
             " --no-excluded        do not write excluded reads (unmapped or QCFAIL).\n"
             " --rejects-file FILE  file to write filtered reads.\n"
             " --primer-counts FILE file to write read counts per bed entry (bedgraph format).\n"
             " --original           for clipped entries add an OA tag with original data.\n"
             " --keep-tag           for clipped entries keep the old NM and MD tags.\n"
             " --tolerance          match region within this number of bases, default 5.\n"
             " --no-PG              do not add an @PG line.\n")


LONGOPTS = ["no-PG", "soft-clip", "hard-clip", "strand", "clipped", "fail",
            "both-ends", "filter-len=", "fail-len=", "no-excluded",
            "rejects-file=", "primer-counts=", "original", "keep-tag",
            "tolerance=", "unmap-len="]


class Opts:
    """ampliconclip's options, at their defaults."""

    def __init__(self):
        self.bedfile = None
        self.fnout = "-"
        self.hard = False
        self.add_pg = True
        self.use_strand = False
        self.write_clipped = False
        self.mark_fail = False
        self.both = False
        self.fail_len = -1
        self.filter_len = -1
        self.no_excluded = False
        self.oa_tag = False
        self.del_tag = True
        self.tol = 5
        self.unmap_len = 0
        self.stats_file = None
        self.primer_counts_file = None
        self.rejects_file = None
        self.uncompressed = False


# options without a value: attribute and value
_FLAG_OPTS = {"-u": ("uncompressed", True), "--no-PG": ("add_pg", False),
              "--soft-clip": ("hard", False), "--hard-clip": ("hard", True),
              "--strand": ("use_strand", True),
              "--clipped": ("write_clipped", True),
              "--fail": ("mark_fail", True), "--both-ends": ("both", True),
              "--no-excluded": ("no_excluded", True),
              "--original": ("oa_tag", True), "--keep-tag": ("del_tag", False)}
# options with a value: attribute and its type
_VALUE_OPTS = {"-b": ("bedfile", str), "-o": ("fnout", str),
               "-f": ("stats_file", str), "--filter-len": ("filter_len", int),
               "--fail-len": ("fail_len", int),
               "--rejects-file": ("rejects_file", str),
               "--primer-counts": ("primer_counts_file", str),
               "--tolerance": ("tol", int), "--unmap-len": ("unmap_len", int)}


class Counts:
    """The stats ampliconclip reports."""

    def __init__(self):
        self.total = self.forward = self.reverse = self.both = 0
        self.not_clipped = self.excluded = 0
        self.filtered = self.failed = self.written = 0


def _apply_left(rec: Rec, p_size: int, hard: bool):
    new_cigar, new_pos, qry_removed, emptied = trim_left(
        rec.cigar, rec.pos, len(rec.seq), p_size, hard)
    if emptied:
        # the read keeps its position, with no bases and no CIGAR
        rec.seq = np.empty(0, np.uint8)
        rec.qual = np.empty(0, np.uint8)
        rec.cigar = np.empty(0, np.uint32)
        return
    rec.cigar = np.array(new_cigar, np.uint32)
    rec.pos = new_pos
    if qry_removed:
        rec.seq = rec.seq[qry_removed:]
        rec.qual = rec.qual[qry_removed:]


def _apply_right(rec: Rec, p_size: int, hard: bool):
    new_cigar, qry_removed, emptied = trim_right(rec.cigar, len(rec.seq),
                                                 p_size, hard)
    if emptied:
        rec.seq = np.empty(0, np.uint8)
        rec.qual = np.empty(0, np.uint8)
        rec.cigar = np.empty(0, np.uint32)
        return
    rec.cigar = np.array(new_cigar, np.uint32)
    if qry_removed:
        rec.seq = rec.seq[:len(rec.seq) - qry_removed]
        rec.qual = rec.qual[:len(rec.qual) - qry_removed]


def clip_record(rec: Rec, sites, longest: int, o: Opts, c: Counts) -> bool:
    """Clip one mapped read on a contig with primers, apply the tags and
    the length options, and count it; True when it is filtered out."""
    oat = (oa_value(rec.qname, rec.pos, rec.flag, rec.cigar, rec.mapq,
                    rec.aux) if o.oa_tag else None)
    left = right = False
    if not o.both:
        if rec.flag & F.FREVERSE:
            p_size = matching_clip_site(sites, end_pos(rec.pos, rec.cigar),
                                        True, o.use_strand, longest, o.tol)
            if p_size:
                _apply_right(rec, p_size, o.hard)
                c.reverse += 1
                right = True
        else:
            p_size = matching_clip_site(sites, rec.pos, False, o.use_strand,
                                        longest, o.tol)
            if p_size:
                _apply_left(rec, p_size, o.hard)
                c.forward += 1
                left = True
    else:
        p_size = matching_clip_site(sites, rec.pos, False, o.use_strand,
                                    longest, o.tol)
        if p_size:
            _apply_left(rec, p_size, o.hard)
            c.forward += 1
            left = True
        # the end after the left clip
        p_size = matching_clip_site(sites, end_pos(rec.pos, rec.cigar), True,
                                    o.use_strand, longest, o.tol)
        if p_size:
            _apply_right(rec, p_size, o.hard)
            c.reverse += 1
            right = True
        if left and right:
            c.both += 1
    clipped = left or right
    if not clipped:
        if o.mark_fail:
            rec.flag |= F.FQCFAIL
        c.not_clipped += 1
    else:
        if o.oa_tag:
            rec.aux = auxmod.update_str_tag(rec.aux, "OA", oat)
        if o.del_tag:
            rec.aux = auxmod.delete_tags(rec.aux, {"NM", "MD"})

    filtered = False
    if o.fail_len >= 0 or o.filter_len >= 0 or o.unmap_len >= 0:
        aql = active_query_len(rec.cigar)
        if o.fail_len >= 0 and aql <= o.fail_len:
            rec.flag |= F.FQCFAIL
        if o.filter_len >= 0 and aql <= o.filter_len:
            filtered = True
        if o.unmap_len >= 0 and aql <= o.unmap_len:
            # unmapped (bam_ampliconclip.c:906-934)
            rec.flag |= F.FUNMAP
            rec.mapq = 0
            rec.cigar = np.empty(0, np.uint32)
    if rec.flag & F.FQCFAIL:
        c.failed += 1
    return filtered or (o.write_clipped and not clipped)


def clip_batch(header: SamHeader, batch: ReadBatch, bed_lists: dict,
               longest: dict, o: Opts, c: Counts):
    """(records kept, records filtered out) of the whole batch, a record
    at a time in file order."""
    kept: list[Rec] = []
    rejected: list[Rec] = []
    last_tid = -2
    sites = None
    exclude = F.FUNMAP | F.FQCFAIL
    for i in range(batch.n):
        c.total += 1
        rec = Rec.of(batch, i)
        if rec.tid != last_tid:
            last_tid = rec.tid
            rn = (header.ref_name(rec.tid) if 0 <= rec.tid < header.n_refs
                  else None)
            sites = bed_lists.get(rn)
        if not (rec.flag & exclude) and sites is not None:
            filtered = clip_record(rec, sites, longest[rn], o, c)
        else:
            c.excluded += 1
            filtered = o.no_excluded
        if not filtered:
            kept.append(rec)
            c.written += 1
        else:
            if o.rejects_file:
                rejected.append(rec)
            c.filtered += 1
    return kept, rejected


def main_ampliconclip(argv: list[str]) -> int:
    ga = GlobalArgs()
    o = Opts()
    try:
        opts, args = gnu_getopt(argv, "b:@:o:O:f:u", LONGOPTS)
    except UsageError:
        usage(sys.stderr)
        return 1
    for opt, v in opts:
        if opt in _FLAG_OPTS:
            setattr(o, *_FLAG_OPTS[opt])
        elif opt in _VALUE_OPTS:
            name, kind = _VALUE_OPTS[opt]
            setattr(o, name, kind(v))
        elif not handle_global_opt(ga, opt, v, short_outfmt="-O"):
            usage(sys.stderr)
            return 1

    if not o.bedfile or not args:
        usage(sys.stderr)
        return 1
    if o.tol < 0:
        sys.stderr.write("[ampliconclip] warning: invalid tolerance of %d,"
                         " resetting tolerance to default of 5.\n" % o.tol)
        o.tol = 5

    loaded = load_bed_multi_ref(o.bedfile, o.use_strand)
    if loaded is None:
        sys.stderr.write("[ampliconclip] error: unable to load bed file.\n")
        return 1
    bed_lists, longest, ref_order = loaded

    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e:
        print_error_errno("ampliconclip", "cannot open input file", exc=e)
        return 1
    header = f.header
    # coordinate order becomes unknown (bam_ampliconclip.c:719-726)
    if re.search(r"^@HD\t.*\bSO:coordinate\b", header.text, re.M):
        header = header.with_text(re.sub(
            r"(^@HD\t.*\bSO:)coordinate\b", r"\1unknown", header.text,
            count=1, flags=re.M))
    arg_list = "samtools ampliconclip " + " ".join(argv)
    if o.add_pg:
        header = header.add_pg_line("samtools", "samtools", arg_list,
                                    SAMTOOLS_PARITY_VERSION)

    c = Counts()
    kept, rejected = clip_batch(header, f.batch, bed_lists, longest, o, c)

    level = 0 if o.uncompressed else out_level(ga)
    write_alignments(o.fnout, header, records_to_batch(kept),
                     fmt=infer_output_format(o.fnout, ga.out_fmt,
                                             default="bam"),
                     threads=ga.nthreads, level=level)
    if o.rejects_file:
        write_alignments(o.rejects_file, header, records_to_batch(rejected),
                         fmt=infer_output_format(o.rejects_file, ga.out_fmt,
                                                 default="bam"),
                         threads=ga.nthreads, level=level)

    report = ("COMMAND: %s\nTOTAL READS: %ld\nTOTAL CLIPPED: %ld\n"
              "FORWARD CLIPPED: %ld\nREVERSE CLIPPED: %ld\nBOTH CLIPPED: %ld\n"
              "NOT CLIPPED: %ld\nEXCLUDED: %ld\nFILTERED: %ld\nFAILED: %ld\n"
              "WRITTEN: %ld\n" % (arg_list, c.total, c.forward + c.reverse,
                                  c.forward, c.reverse, c.both,
                                  c.not_clipped, c.excluded, c.filtered,
                                  c.failed, c.written))
    # the stats go to stderr when no file is named or it cannot be opened
    if not (o.stats_file and _write_file(o.stats_file, report, "stats")):
        sys.stderr.write(report)

    if o.primer_counts_file:
        rows = ["#CHR\tLEFT\tRIGHT\tNAME\tSCORE\tSTRAND\tNUM_CLIPPED\n"]
        for rn in ref_order:
            for e in bed_lists[rn]:
                rows.append("%s\t%d\t%d\t%s\t%s\t%s\t%d\n" % (
                    rn, e.left, e.right,
                    e.name if e.name is not None else "(null)",
                    e.score if e.score is not None else "(null)",
                    ("-" if e.rev else "+") if o.use_strand else ".",
                    e.num_reads))
        _write_file(o.primer_counts_file, "".join(rows), "count summary")
    return 0


def _write_file(path: str, text: str, what: str) -> bool:
    """``text`` into ``path``; False after a warning when it cannot be
    opened."""
    try:
        with open(path, "w") as fp:
            fp.write(text)
        return True
    except OSError:
        sys.stderr.write("[ampliconclip] warning: cannot write %s to %s.\n"
                         % (what, path))
        return False


def records_to_batch(records: list[Rec]) -> ReadBatch:
    """A ReadBatch of the records, in order (qualities follow
    ``seq_off``)."""
    n = len(records)
    out = ReadBatch(n=n)
    out.tid = np.array([r.tid for r in records], np.int32)
    out.pos = np.array([r.pos for r in records], np.int64)
    out.mapq = np.array([r.mapq for r in records], np.uint8)
    out.flag = np.array([r.flag for r in records], np.uint16)
    out.mtid = np.array([r.mtid for r in records], np.int32)
    out.mpos = np.array([r.mpos for r in records], np.int64)
    out.tlen = np.array([r.tlen for r in records], np.int64)
    for flat, off, dtype, parts in (
            ("qname", "qname_off", np.uint8,
             [np.frombuffer(r.qname.encode(), np.uint8) for r in records]),
            ("cigar", "cigar_off", np.uint32, [r.cigar for r in records]),
            ("seq", "seq_off", np.uint8, [r.seq for r in records]),
            ("aux", "aux_off", np.uint8, [r.aux for r in records])):
        offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in parts], out=offs[1:])
        setattr(out, flat, np.concatenate(parts).astype(dtype, copy=False)
                if parts else np.empty(0, dtype))
        setattr(out, off, offs)
    out.qual = (np.concatenate([r.qual for r in records]).astype(
        np.uint8, copy=False) if records else np.empty(0, np.uint8))
    return out
