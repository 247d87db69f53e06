"""samtools checksum: order-free checksums of alignment files.

Counterpart of samtools_tpu/tools/checksum_cmd.py (samtools'
bam_checksum.c): each record's CRC32s (flag+sequence, +name, +quality,
+aux, and with ``-P``/``-C``/``-M`` position, CIGAR and mate) are
multiplied in GF(2^31 - 1) (``ops/checksum.py``), per read group, so
the report depends neither on the order of the records nor on how a
file was split; ``-m`` merges earlier reports, ``-B`` writes
biobambam2's bamseqchksum format.  The records are hashed one at a time
on the host, as in the JAX package.  A host command: no device work.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..core.sanitize import parse_sanitize_options, sanitize_batch, \
    FIX_ALL, FIX_CIGARX
from ..io.files import read_alignments
from ..ops.checksum import gf31_mul, map_crc
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)
from .flags_cmd import flag2str, str2flag

PRIME = (1 << 31) - 1

# nt16 code -> ASCII base (forward) and complement base (reverse strand),
# mirroring the lookup strings at bam_checksum.c:95-129.
_FWD = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_REV = np.frombuffer(b"=TGKCYSBAWRDMHVN", np.uint8)

# rows of the sums table
R_ALL, R_PASS, R_FAIL = 0, 1, 2
FIELDS = ("seq", "name", "qual", "aux", "pos", "cigar", "mate")


class Sums:
    """Aggregated hashes for one group (bam_checksum.c:204-240)."""

    def __init__(self):
        # [field][row] products in GF(2^31-1); counts per row
        self.h = {f: [1, 1, 1] for f in FIELDS}
        self.count = [0, 0, 0]

    def update_row(self, row: int, crcs: dict, count_crc: int, n: int):
        for f in FIELDS:
            v = int(map_crc(np.uint64(count_crc ^ crcs[f])))
            self.h[f][row] = gf31_mul(self.h[f][row], v)
        self.count[row] += n


class Opts:
    def __init__(self):
        self.req_flags = 0
        self.excl_flags = F.FSECONDARY | F.FSUPPLEMENTARY
        self.flag_mask = F.FPAIRED | F.FREAD1 | F.FREAD2
        self.rev_comp = 1
        self.in_order = 0
        self.sanitize = 0
        self.check_pos = 0
        self.check_cigar = 0
        self.check_mate = 0
        self.tag_str = "BC,FI,QT,RT,TC"
        self.tags: list[str] = []
        self.nrec = 0
        self.verbose = 0
        self.show_pass = 0
        self.show_fail = 0
        self.show_combine = 1
        self.fp = sys.stdout
        self.tabs = 0
        self.merge = 0
        self.compat = 0


def parse_tags(o: Opts) -> int:
    tags = o.tag_str.split(",")
    for t in tags:
        if t == "*":
            continue
        if len(t) != 2:
            sys.stderr.write("Bad tag string.  Should be XX,YY,... syntax\n")
            return 1
        if not ("0" <= t[0] <= "z" and "0" <= t[1] <= "z"):
            sys.stderr.write("[checksum] Illegal tag ID '%s'\n" % t[:2])
            return 1
    o.tags = tags
    return 0


def canonical_tag(raw: bytes) -> bytes:
    """Minimal-width integer tag re-encoding (bam_checksum.c:353-402)."""
    t = raw[2:3]
    if t not in b"CcSsIi":
        return raw
    val = auxmod.decode_value(np.frombuffer(raw, np.uint8), 0)
    if val >= 0:
        code = b"C" if val <= 255 else (b"S" if val <= 65535 else b"I")
    else:
        code = b"c" if val >= -128 else (b"s" if val >= -32768 else b"i")
    if code == t:
        return raw
    if code in b"Cc":
        body = (val & 0xFF).to_bytes(1, "little")
    elif code in b"Ss":
        body = (val & 0xFFFF).to_bytes(2, "little")
    else:
        body = (val & 0xFFFFFFFF).to_bytes(4, "little")
    return raw[:2] + code + body


def hash_aux(aux_buf: np.ndarray, o: Opts, crc_seq: int):
    """The CRC32 of the selected aux fields in canonical binary form,
    chained on ``crc_seq``, and the RG:Z value or None
    (bam_checksum.c:423-519)."""
    rgz = None
    negate = o.tags and o.tags[0] == "*"
    excl = set(o.tags[1:]) if negate else None
    sel_index = {t: i for i, t in enumerate(o.tags)} if not negate else None
    found: list = []
    if not negate:
        found = [None] * len(o.tags)
    buf = bytes(aux_buf)
    i, n = 0, len(buf)
    arr = np.frombuffer(buf, np.uint8)
    order = 0
    collected = []
    while i + 3 <= n:
        end = auxmod.skip_one(arr, i)
        tag = buf[i:i + 2].decode("latin-1")
        if tag == "RG" and buf[i + 2:i + 3] == b"Z":
            rgz = buf[i + 3:end - 1].decode("latin-1")
        legal = ("0" <= tag[0] <= "z") and ("0" <= tag[1] <= "z")
        if legal:
            if negate:
                if tag not in excl:
                    collected.append((tag, order, buf[i:end]))
                    order += 1
            else:
                j = sel_index.get(tag)
                if j is not None:
                    found[j] = buf[i:end]  # last occurrence wins
        i = end
    if negate:
        collected.sort(key=lambda x: (x[0], x[1]))
        parts = [canonical_tag(raw) for _, _, raw in collected]
    else:
        parts = [canonical_tag(raw) for raw in found if raw is not None]
    return zlib.crc32(b"".join(parts), crc_seq) & 0xFFFFFFFF, rgz


def record_crcs(batch, i: int, o: Opts, seq_chars: np.ndarray,
                qual_chars: np.ndarray):
    """Record ``i``'s CRC32s by field, and its RG:Z value or None
    (bam_checksum.c:672-753)."""
    flags = bytes([int(batch.flag[i]) & o.flag_mask & 0xFF])
    s0, s1 = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
    seq_b = seq_chars[s0:s1].tobytes()
    qual_b = qual_chars[s0:s1].tobytes()
    if (batch.flag[i] & F.FREVERSE) and o.rev_comp:
        # seq_chars already complemented batch-wide for reverse records;
        # reversal is per record
        seq_b = seq_b[::-1]
        qual_b = qual_b[::-1]

    c = {}
    crc_flag = zlib.crc32(flags) & 0xFFFFFFFF
    c["seq"] = zlib.crc32(seq_b, crc_flag) & 0xFFFFFFFF

    qn = batch.qname[batch.qname_off[i]:batch.qname_off[i + 1]].tobytes()
    crc = zlib.crc32(qn + b"\0") & 0xFFFFFFFF
    crc = zlib.crc32(flags, crc) & 0xFFFFFFFF
    c["name"] = zlib.crc32(seq_b, crc) & 0xFFFFFFFF

    c["qual"] = zlib.crc32(qual_b, c["seq"]) & 0xFFFFFFFF

    aux_buf = batch.aux[batch.aux_off[i]:batch.aux_off[i + 1]]
    c["aux"], rgz = hash_aux(aux_buf, o, c["seq"])

    c["pos"] = c["cigar"] = c["mate"] = 0
    if o.check_pos:
        b = (int(batch.tid[i]) & 0xFFFFFFFF).to_bytes(4, "little") \
            + (int(batch.pos[i]) & (2**64 - 1)).to_bytes(8, "little")
        c["pos"] = zlib.crc32(b, c["seq"]) & 0xFFFFFFFF
    if o.check_mate:
        b = (int(batch.mtid[i]) & 0xFFFFFFFF).to_bytes(4, "little") \
            + (int(batch.mpos[i]) & (2**64 - 1)).to_bytes(8, "little") \
            + (int(batch.tlen[i]) & (2**64 - 1)).to_bytes(8, "little")
        c["mate"] = zlib.crc32(b, c["seq"]) & 0xFFFFFFFF
    if o.check_cigar:
        mq = (int(batch.mapq[i]) & 0xFFFFFFFF).to_bytes(4, "little")
        crc = zlib.crc32(mq, c["seq"]) & 0xFFFFFFFF
        cig = batch.cigar[batch.cigar_off[i]:batch.cigar_off[i + 1]]
        c["cigar"] = zlib.crc32(cig.astype("<u4").tobytes(), crc) & 0xFFFFFFFF
    return c, rgz


def sums_update(qcfail: bool, g: Sums, crcs: dict, o: Opts, count: int):
    """bam_checksum.c:257-271."""
    count_crc = 0
    if o.in_order:
        n = count if o.in_order == 1 else g.count[0]
        count_crc = zlib.crc32((n & (2**64 - 1)).to_bytes(8, "little")) \
            & 0xFFFFFFFF
    g.update_row(R_ALL, crcs, count_crc, 1)
    if o.show_pass and not qcfail:
        g.update_row(R_PASS, crcs, count_crc, 1)
    if o.show_fail and qcfail:
        g.update_row(R_FAIL, crcs, count_crc, 1)


def sums_report(o: Opts, g: Sums, set_name: str):
    """One group's rows (bam_checksum.c:274-333); the combined hash folds
    the sequence's product in twice and the quality's never, as samtools
    does."""
    names = ["all", "pass", "fail"]
    for r in range(3):
        if r == R_PASS and not o.show_pass:
            continue
        if r == R_FAIL and not o.show_fail:
            continue
        if not o.verbose and not g.count[r]:
            continue
        h = g.h
        if o.tabs:
            line = "%s\t%s\t%d\t%s%x\t%x\t%x\t%x" % (
                set_name, names[r], g.count[r], "\t" if o.compat else "",
                h["seq"][r], h["name"][r], h["qual"][r], h["aux"][r])
            if o.check_pos:
                line += "\t%x" % h["pos"][r]
            if o.check_cigar:
                line += "\t%x" % h["cigar"][r]
            if o.check_mate:
                line += "\t%x" % h["mate"][r]
        else:
            line = "%-10s %-4s %12d  %08x  %08x  %08x  %08x" % (
                set_name, names[r], g.count[r],
                h["seq"][r], h["name"][r], h["qual"][r], h["aux"][r])
            if o.check_pos:
                line += "  %08x" % h["pos"][r]
            if o.check_cigar:
                line += "  %08x" % h["cigar"][r]
            if o.check_mate:
                line += "  %08x" % h["mate"][r]

        hc = 1
        for v in (g.count[r] >> 32, g.count[r] & 0xFFFFFFFF, h["seq"][r],
                  h["name"][r], h["seq"][r], h["aux"][r]):
            hc = gf31_mul(hc, int(map_crc(np.uint64(v))))
        if o.check_pos:
            hc = gf31_mul(hc, int(map_crc(np.uint64(h["pos"][r]))))
        if o.check_cigar:
            hc = gf31_mul(hc, int(map_crc(np.uint64(h["cigar"][r]))))
        if o.check_mate:
            hc = gf31_mul(hc, int(map_crc(np.uint64(h["mate"][r]))))

        if o.show_combine:
            line += ("\t%x" % hc) if o.tabs else ("  %08x" % hc)
        o.fp.write(line + "\n")


def checksum_bamseqchksum(o: Opts, all_g: Sums, norg: Sums,
                          groups: dict) -> int:
    """biobambam2 bamseqchksum compatibility output
    (bam_checksum.c:531-560; the tag list in the header is a literal)."""
    o.fp.write("###\tset\tcount\t\tb_seq\tname_b_seq\tb_seq_qual"
               "\tb_seq_tags(BC,FI,QT,RT,TC)\n")
    o.tabs = 1
    o.show_pass = 1
    o.verbose = 1
    o.show_combine = 0
    sums_report(o, all_g, "all")
    sums_report(o, norg, "")
    for k in sorted(groups):
        sums_report(o, groups[k], k)
    return 0


def checksum_report(fn: str, o: Opts, all_g: Sums, norg: Sums,
                    groups: dict) -> int:
    if o.compat:
        return checksum_bamseqchksum(o, all_g, norg, groups)
    sep = "\t" if o.tabs else " "
    o.fp.write("# Checksum 1.0 for file:%s%s\n" % (sep, fn))
    o.fp.write("# Aux tags:%s%s\n" %
               ("\t" if o.tabs else "          ", o.tag_str))
    o.fp.write("# BAM flags:%s%s\n" %
               ("\t" if o.tabs else "         ", flag2str(o.flag_mask)))
    if o.tabs:
        hdr = "\n# Group\tQC\tcount\tflag+seq\t+name\t+qual\t+aux"
        if o.check_pos:
            hdr += "\t+chr/pos"
        if o.check_cigar:
            hdr += "\t+cigar"
        if o.check_mate:
            hdr += "\t+mate"
        hdr += "\tcombined\n"
    else:
        hdr = ("\n# Group    QC          count  flag+seq  +name"
               "     +qual     +aux    ")
        if o.check_pos:
            hdr += "  +chr/pos"
        if o.check_cigar:
            hdr += "  +cigar  "
        if o.check_mate:
            hdr += "  +mate   "
        hdr += "  combined\n"
    o.fp.write(hdr)

    sums_report(o, all_g, "all")
    if o.verbose or (norg.count[0] + norg.count[1]):
        sums_report(o, norg, "-")
    for k in sorted(groups):
        sums_report(o, groups[k], k)
    return 0


def checksum(ga: GlobalArgs, o: Opts, fn: str) -> int:
    try:
        f = read_alignments(fn, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("checksum",
                          'Cannot open input file "%s"' % fn, exc=e)
        return -1
    except Exception as e:
        print_error("checksum", "%s", str(e))
        return -1
    batch = f.batch
    if o.sanitize:
        batch = sanitize_batch(batch, f.header, o.sanitize)

    # batch-wide nt16->ASCII expansion; strand complement applied per
    # batch, reversal per record (bam_checksum.c fill_seq_qual)
    rev_mask = (batch.flag & F.FREVERSE).astype(bool) if o.rev_comp else \
        np.zeros(batch.n, bool)
    per_base_rev = np.repeat(rev_mask, batch.l_qseq) if batch.n else \
        np.zeros(0, bool)
    seq_chars = np.where(per_base_rev, _REV[batch.seq], _FWD[batch.seq])
    qual_chars = (batch.qual + np.uint8(33)).astype(np.uint8)

    all_g = Sums()
    norg = Sums()
    groups: dict[str, Sums] = {}

    nrec = o.nrec
    for i in range(batch.n):
        fl = int(batch.flag[i])
        if fl & o.excl_flags:
            continue
        if (fl & o.req_flags) != o.req_flags:
            continue
        crcs, rgz = record_crcs(batch, i, o, seq_chars, qual_chars)
        qcfail = bool(fl & F.FQCFAIL)
        if rgz is not None:
            g = groups.get(rgz)
            if g is None:
                g = groups[rgz] = Sums()
            count = g.count[0]
            sums_update(qcfail, g, crcs, o, count)
        else:
            count = norg.count[0]
            sums_update(qcfail, norg, crcs, o, count)
        sums_update(qcfail, all_g, crcs, o, count)
        if nrec:
            nrec -= 1
            if nrec == 0:
                break

    return checksum_report(fn, o, all_g, norg, groups)


# ----------------------------------------------------------------------
# -m merge mode: combine previously-written checksum reports
# (bam_checksum.c:837-1162)

H_GROUP, H_QC, H_COUNT, H_SEQ, H_NAME, H_QUAL, H_AUX, H_POS, H_CIGAR, \
    H_MATE, H_COMBINED = range(11)

_SAM_TOKENS = {
    "Group": H_GROUP, "QC": H_QC, "count": H_COUNT, "flag+seq": H_SEQ,
    "+name": H_NAME, "+qual": H_QUAL, "+aux": H_AUX, "+chr/pos": H_POS,
    "+cigar": H_CIGAR, "+mate": H_MATE, "combined": H_COMBINED,
}
_BB_TOKENS = {
    "###": H_GROUP, "set": H_QC, "count": H_COUNT, "b_seq": H_SEQ,
    "name_b_seq": H_NAME, "b_seq_qual": H_QUAL,
}


def sums_parse(o: Opts, fn: str, sums: Sums, norg: Sums,
               groups: dict) -> int:
    try:
        fh = open(fn)
    except OSError as e:
        sys.stderr.write("%s: %s\n" % (fn, e.strerror))
        return -1
    header: list[int] = []
    hdr_kind = None
    minfields = 8
    with fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("# Checksum"):
                parts = line.split()
                if len(parts) >= 3 and "." in parts[2]:
                    try:
                        major, minor = parts[2].split(".")[:2]
                        if int(major) != 1 or int(minor.split("+")[0]) != 0:
                            sys.stderr.write(
                                "Unsupported checksum output version\n")
                            return -1
                    except ValueError:
                        pass
                continue
            if line.startswith("# Group"):
                if hdr_kind is not None:
                    sys.stderr.write(
                        "Invalid header, repeat of header line\n")
                    return -1
                hdr_kind = "sam"
                header = []
                for tok in line[2:].split():
                    if tok not in _SAM_TOKENS:
                        sys.stderr.write(
                            "Unrecognised header token '%s'\n" % tok)
                        return -1
                    h = _SAM_TOKENS[tok]
                    if h == H_POS:
                        o.check_pos = 1
                    elif h == H_CIGAR:
                        o.check_cigar = 1
                    elif h == H_MATE:
                        o.check_mate = 1
                    header.append(h)
                continue
            if line.startswith("# Aux"):
                val = line.split(":", 1)[1].strip() if ":" in line else ""
                if val:
                    if o.tag_str is None:
                        o.tag_str = val
                    elif o.tag_str != val:
                        sys.stderr.write("Aux tag mismatch, %s - %s\n"
                                         % (o.tag_str, val))
                        return -1
                continue
            if line.startswith("# BAM"):
                val = line.split(":", 1)[1].strip() if ":" in line else ""
                if val:
                    o.flag_mask = str2flag(val)
                continue
            if line.startswith("###\t"):
                if hdr_kind is not None:
                    sys.stderr.write(
                        "Invalid header, repeat of header line\n")
                    return -1
                hdr_kind = "bambam"
                minfields = 7
                header = []
                for tok in line.split():
                    if tok.startswith("b_seq_tags("):
                        tags = tok[11:].rstrip(")")
                        if o.tag_str is None:
                            o.tag_str = tags
                        elif o.tag_str != tags:
                            sys.stderr.write("Aux tag mismatch, %s - %s\n"
                                             % (o.tag_str, tags))
                            return -1
                        header.append(H_AUX)
                        continue
                    if tok not in _BB_TOKENS:
                        sys.stderr.write(
                            "Unrecognised header token '%s'\n" % tok)
                        return -1
                    header.append(_BB_TOKENS[tok])
                continue
            if not line or line.startswith("#"):
                continue
            if line.startswith("all ") or line.startswith("all\t"):
                continue

            if hdr_kind == "bambam" and line.startswith("\t"):
                cols = [""] + line.lstrip("\t").split()
            else:
                cols = line.split()
            if len(cols) < minfields or len(cols) != len(header):
                sys.stderr.write(
                    "Incorrect number of columns in line: %s\n" % line)
                return -1

            qc = 0
            count = 0
            crcs = {f: 1 for f in FIELDS}
            for col, h in zip(cols, header):
                if h == H_QC:
                    if col == "all":
                        qc = 0
                    elif col == "pass":
                        qc = 1
                    elif col == "fail":
                        qc = 2
                    else:
                        return -1
                elif h == H_COUNT:
                    count = int(col)
                elif h == H_SEQ:
                    crcs["seq"] = int(col, 16)
                elif h == H_NAME:
                    crcs["name"] = int(col, 16)
                elif h == H_QUAL:
                    crcs["qual"] = int(col, 16)
                elif h == H_AUX:
                    crcs["aux"] = int(col, 16)
                elif h == H_POS:
                    crcs["pos"] = int(col, 16)
                elif h == H_CIGAR:
                    crcs["cigar"] = int(col, 16)
                elif h == H_MATE:
                    crcs["mate"] = int(col, 16)

            if cols[0] == "-" or cols[0] == "":
                norg.update_row(qc, crcs, 0, count)
            else:
                g = groups.get(cols[0])
                if g is None:
                    g = groups[cols[0]] = Sums()
                g.update_row(qc, crcs, 0, count)
            sums.update_row(qc, crcs, 0, count)
    return 0


def combine(o: Opts, files: list[str]) -> int:
    s = Sums()
    norg = Sums()
    groups: dict[str, Sums] = {}
    o.tag_str = None
    for fn in files:
        if sums_parse(o, fn, s, norg, groups) < 0:
            sys.stderr.write("Failed to parse checksum file '%s'\n" % fn)
            return -1
    checksum_report("merge", o, s, norg, groups)
    return 0


# ----------------------------------------------------------------------
# CLI (bam_checksum.c:1167-1406)

USAGE = """Usage: samtools checksum [options] [file.bam ...]
or     samtools checksum [options] -m [file.chk ...]

Options:
  -F, --exclude-flags FLAG    Filter if any FLAGs are present [0x900]
  -f, --require-flags FLAG    Filter unless all FLAGs are present [0]
  -b, --flag-mask FLAG        BAM FLAGs to use in checksums [0x0c1]
  -c, --no-rev-comp           Do not reverse-complement sequences [off]
  -t, --tags STR[,STR]        Select tags to checksum [BC,FI,QT,RT,TC]
  -O, --in-order              Use order-specific checksumming [off]
  -P, --check-pos             Also checksum CHR / POS [off]
  -C, --check-cigar           Also checksum MAPQ / CIGAR [off]
  -M, --check_mate            Also checksum PNEXT / RNEXT / TLEN [off]
  -z, --sanitize FLAGS        Perform sanity checks and fix records [off]
  -N, --count INT             Stop after INT number of records [0]
  -o, --output FILE           Write report to FILE [stdout]
  -q, --show-qc               Also show QC pass/fail lines
  -v, --verbose               Increase verbosity: show lines with 0 counts
  -a, --all                   Check all: -PCMOc -b 0xfff -f0 -F0 -z all,cigarx
  -T, --tabs                  Format output as tab delimited text
  -m, --merge FILE            Merge checksum output (-o opt) files
  -B, --bamseqchksum          Report in bamseqchksum format
"""

LONGOPTS = [
    "exclude-flags=", "require-flags=", "flag-mask=", "tags=",
    "no-rev-comp", "in-order", "check-pos", "check-cigar", "check-mate",
    "count=", "sanitize=", "output=", "show-qc", "verbose", "all",
    "tabs", "merge", "bamseqchksum",
]


def main_checksum(argv: list[str]) -> int:
    o = Opts()
    ga = GlobalArgs()
    try:
        opts, args = gnu_getopt(argv, "@:f:F:t:cPCMOb:z:aN:vqo:TmB",
                                LONGOPTS)
    except UsageError as e:
        print_error("checksum", "%s", str(e))
        sys.stderr.write(USAGE)
        return 1

    out_path = None
    for opt, val in opts:
        if opt in ("-O", "--in-order"):
            o.in_order += 1
        elif opt in ("-F", "--exclude-flags"):
            o.excl_flags = str2flag(val)
            if o.excl_flags < 0:
                print_error("checksum", "could not parse flag %s", val)
                return 1
        elif opt in ("-f", "--require-flags"):
            o.req_flags = str2flag(val)
            if o.req_flags < 0:
                print_error("checksum", "could not parse flag %s", val)
                return 1
        elif opt in ("-b", "--flag-mask"):
            o.flag_mask = str2flag(val)
            if o.flag_mask < 0:
                print_error("checksum", "could not parse flag %s", val)
                return 1
        elif opt in ("-P", "--check-pos"):
            o.check_pos = 1
        elif opt in ("-C", "--check-cigar"):
            o.check_cigar = 1
        elif opt in ("-M", "--check-mate"):
            o.check_mate = 1
        elif opt in ("-t", "--tags"):
            o.tag_str = val
        elif opt in ("-c", "--no-rev-comp"):
            o.rev_comp = 0
        elif opt in ("-N", "--count"):
            o.nrec = int(val, 0)
        elif opt in ("-B", "--bamseqchksum"):
            o.compat = 1
            o.show_pass = 1
        elif opt in ("-v", "--verbose"):
            o.verbose += 1
        elif opt in ("-q", "--show-qc"):
            o.show_pass = o.show_fail = 1
        elif opt in ("-T", "--tabs"):
            o.tabs = 1
        elif opt in ("-m", "--merge"):
            o.merge = 1
        elif opt in ("-z", "--sanitize"):
            o.sanitize = parse_sanitize_options(val)
            if o.sanitize < 0:
                return 1
        elif opt in ("-a", "--all"):
            o.req_flags = 0
            o.excl_flags = 0
            o.flag_mask = -1
            o.rev_comp = 0
            o.in_order = 1
            o.check_pos = 1
            o.check_cigar = 1
            o.check_mate = 1
            o.sanitize = FIX_ALL | FIX_CIGARX
            o.tag_str = "*,cF,MD,NM"
        elif opt in ("-o", "--output"):
            out_path = val
        elif handle_global_opt(ga, opt, val):
            pass
        else:
            sys.stderr.write(USAGE)
            return 1

    if not args and sys.stdin.isatty():
        sys.stdout.write(USAGE)
        return 0

    if parse_tags(o):
        return 1

    if out_path:
        try:
            o.fp = open(out_path, "w")
        except OSError as e:
            sys.stderr.write("%s: %s\n" % (out_path, e.strerror))
            return 1

    ret = 0
    if o.merge:
        ret = combine(o, args) < 0
    else:
        if args:
            for fn in args:
                ret |= checksum(ga, o, fn) < 0
        else:
            ret = checksum(ga, o, "-") < 0

    if o.fp is not sys.stdout:
        o.fp.close()
    else:
        o.fp.flush()

    if ret:
        sys.stderr.write("[checksum] Failed to process data\n")
    return 1 if ret else 0
