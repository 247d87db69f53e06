"""Aligner-output → SAM converters + fasta-sanitize.

Counterpart of samtools_tpu/tools/convert_cmds.py: samtools' misc/
helper scripts — bowtie2sam.pl, psl2sam.pl, soap2sam.pl, zoom2sam.pl,
maq2sam.c, novo2sam.pl, export2sam.pl, blast2sam.pl, fasta-sanitize.pl,
interpolate_sam.pl — with byte-identical output for identical input,
including their quirks (bowtie's X<nm> tag named after the mismatch
count, soap's control-char stripping that keeps tabs but eats spaces,
maq's flag-field encodings).  These are format shims, not compute
paths: host Python, no device work.
"""

from __future__ import annotations

import gzip
import re
import struct
import sys


def _split_tab(line: str) -> list[str]:
    """perl split("\\t", ...): trailing empty fields are dropped."""
    t = line.rstrip("\n").split("\t")
    while t and t[-1] == "":
        t.pop()
    return t


def _split_ws(line: str) -> list[str]:
    """perl split(/\\s+/, ...): trailing empties dropped, leading kept."""
    t = re.split(r"\s+", line.rstrip("\n"))
    while t and t[-1] == "":
        t.pop()
    return t


def _input_lines(args):
    if args:
        for path in args:
            with (sys.stdin if path == "-" else open(path, "rt")) as f:
                yield from f
    else:
        yield from sys.stdin


# ----------------------------------------------------------------- bowtie

def _bowtie_aux(line: str):
    """misc/bowtie2sam.pl bowtie2sam_aux."""
    t = _split_tab(line)
    s = [None] * 11
    name = t[0]
    s[0] = re.sub(r"/[12]$", "", t[0])
    s[1] = 0
    s[9], s[10] = t[4], t[5]
    s[5] = "%dM" % len(s[9])
    s[2] = t[2]
    s[3] = int(t[3]) + 1
    if t[1] == "-":
        s[1] |= 0x10
    s[4] = 25 if int(t[6]) == 0 else 0
    s[6], s[7], s[8] = "*", 0, 0
    nm = len(t) - 7
    s.append("NM:i:%d" % nm)
    s.append("X%d:i:%d" % (nm, int(t[6]) + 1))
    md = ""
    if len(t) > 7 and t[7]:
        a = 0
        for m in re.finditer(r"(\d+):[ACGTN]>([ACGTN])", t[7],
                             re.IGNORECASE):
            y, z = int(m.group(1)), m.group(2)
            md += "%d%s" % (y - a, z)
            a += y - a + 1
        md += str(len(s[9]) - a)
    else:
        md = str(len(s[9]))
    s.append("MD:Z:%s" % md)
    return name, nm, s


def main_bowtie2sam(argv: list[str]) -> int:
    if not argv and sys.stdin.isatty():
        sys.stderr.write("Usage: bowtie2sam.pl <aln.bowtie>\n")
        return 1
    last = ""
    staging: list[list] = []
    k = best_s = subbest_s = best_k = 0
    started = False

    def flush():
        rec = staging[best_k]
        if best_s == subbest_s:
            rec[4] = 0
        elif subbest_s - best_s == 1 and rec[4] > 15:
            rec[4] = 15
        sys.stdout.write("\t".join(str(x) for x in rec) + "\n")

    for line in _input_lines(argv):
        name, nm, s = _bowtie_aux(line)
        if name == last:
            if k < len(staging):
                staging[k] = s
            else:
                staging.append(s)
            if best_s > nm:
                subbest_s = best_s
                best_s = nm
                best_k = k
            elif subbest_s > nm:
                subbest_s = nm
            k += 1
        else:
            if last:
                flush()
            k, best_s, subbest_s, best_k = 1, nm, 1000, 0
            if staging:
                staging[0] = s
            else:
                staging.append(s)
            last = name
            started = True
    if started:
        flush()
    return 0


# -------------------------------------------------------------------- psl

def main_psl2sam(argv: list[str]) -> int:
    """misc/psl2sam.pl: BLAT PSL → SAM with BLAST-style AS score."""
    opts = {"a": 1, "b": 3, "q": 5, "r": 2}
    args = []
    it = iter(argv)
    for v in it:
        if v[:1] == "-" and len(v) == 2 and v[1] in opts:
            opts[v[1]] = int(next(it))
        else:
            args.append(v)
    if not args and sys.stdin.isatty():
        sys.stderr.write(
            "Usage: psl2sam.pl [-a %(a)d] [-b %(b)d] [-q %(q)d] "
            "[-r %(r)d] <in.psl>\n" % opts)
        return 1
    a, b, q, r = opts["a"], opts["b"], opts["q"], opts["r"]
    for line in _input_lines(args):
        if not re.match(r"^\d", line):
            continue
        t = line.split()
        s = [None] * 11
        cigar = ""
        t10, t11, t12 = int(t[10]), int(t[11]), int(t[12])
        if t[8] == "-":
            t11, t12 = t10 - t12, t10 - t11
        s[0] = t[9]
        s[1] = 0 if t[8] == "+" else 16
        s[2] = t[13]
        s[3] = int(t[15]) + 1
        s[4] = 0
        s[6], s[7], s[8], s[9], s[10] = "*", 0, 0, "*", "*"
        if t11:
            cigar += "%dH" % t11
        x = [int(v) for v in t[18].rstrip(",").split(",")] if t[18] else []
        y = [int(v) for v in t[19].rstrip(",").split(",")] if t[19] else []
        z = [int(v) for v in t[20].rstrip(",").split(",")] if t[20] else []
        y0, z0 = y[0], z[0]
        gap_open = gap_ext = 0
        for i in range(1, int(t[17])):
            ly = y[i] - y[i - 1] - x[i - 1]
            lz = z[i] - z[i - 1] - x[i - 1]
            if ly < lz:       # del: reference gap longer
                gap_open += 1
                gap_ext += lz - ly
                cigar += "%dM%dD" % (y[i] - y0, lz - ly)
                y0, z0 = y[i], z[i]
            elif lz < ly:     # ins: query gap longer
                gap_open += 1
                gap_ext += ly - lz
                cigar += "%dM%dI" % (z[i] - z0, ly - lz)
                y0, z0 = y[i], z[i]
        cigar += "%dM" % (t12 - y0)
        if t10 != t12:
            cigar += "%dH" % (t10 - t12)
        s[5] = cigar
        score = a * int(t[0]) - b * int(t[1]) - q * gap_open - r * gap_ext
        if score < 0:
            score = 0
        s.append("AS:i:%d" % score)
        sys.stdout.write("\t".join(str(v) for v in s) + "\n")
    return 0


# ----------------------------------------------------- soap / zoom mating

def _mating(s1: list, s2: list):
    """Shared mate fixing (soap2sam.pl / zoom2sam.pl `mating`)."""
    isize = 0
    if s1[2] != "*" and s1[2] == s2[2]:
        x1 = s1[3] + len(s1[9]) if s1[1] & 0x10 else s1[3]
        x2 = s2[3] + len(s2[9]) if s2[1] & 0x10 else s2[3]
        isize = x2 - x1
    if s2[2] != "*":
        s1[6] = "=" if s2[2] == s1[2] else s2[2]
        s1[7], s1[8] = s2[3], isize
        if s2[1] & 0x10:
            s1[1] |= 0x20
    else:
        s1[1] |= 0x8
    if s1[2] != "*":
        s2[6] = "=" if s1[2] == s2[2] else s1[2]
        s2[7], s2[8] = s1[3], -isize
        if s1[1] & 0x10:
            s2[1] |= 0x20
    else:
        s2[1] |= 0x8


def _soap_aux(line: str, is_paired: bool):
    t = _split_ws(line)
    if len(t) < 9 or re.match(r"^\s", line) or not t[0]:
        return None
    if not re.match(r"^\d+$", t[3]):     # SOAP-2.1.x field bug
        t = t[0:3] + t[4:]
    s = [None] * 11
    s[0] = re.sub(r"/[12]$", "", t[0])
    s[1] = 1 | (1 << (6 if t[4] == "a" else 7))
    if is_paired:
        s[1] |= 2
    s[9] = t[1]
    s[10] = t[2][: len(t[1])] if len(t[2]) > len(t[1]) else t[2]
    s[5] = "%dM" % len(s[9])
    s[2], s[3] = t[7], int(t[8])
    if t[6] == "-":
        s[1] |= 0x10
    s[4] = 30 if int(t[3]) == 1 else 0
    s[6], s[7], s[8] = "*", 0, 0
    s.append("NM:i:%s" % t[9])
    md = ""
    if int(t[9]):
        xs = []
        for fld in t[10:]:
            m = re.match(r"^([ACGT])->(\d+)", fld, re.IGNORECASE)
            if m:
                xs.append("%.3d,%s" % (int(m.group(2)), m.group(1)))
        xs.sort()
        a = 0
        for v in xs:
            ypart, z = v.split(",")
            y = int(ypart)
            md += "%d%s" % (y - a, z)
            a += y - a + 1
        md += str(len(t[1]) - a)
    else:
        md = str(len(t[1]))
    s.append("MD:Z:%s" % md)
    return s


def main_soap2sam(argv: list[str]) -> int:
    is_paired = "-p" in argv
    args = [v for v in argv if v != "-p"]
    if not args and sys.stdin.isatty():
        sys.stderr.write("Usage: soap2sam.pl [-p] <aln.soap>\n")
        return 1
    s_last: list = []

    def put(s):
        sys.stdout.write("\t".join(str(v) for v in s) + "\n")

    for line in _input_lines(args):
        # strip control/high bytes; keeps TAB (\011), eats spaces+NL
        line = re.sub(r"[\177-\377]|[\000-\010]|[\012-\040]", "", line)
        s_curr = _soap_aux(line, is_paired)
        if s_curr is None:
            continue
        if s_last and s_last[0] == s_curr[0]:
            _mating(s_last, s_curr)
            put(s_last)
            put(s_curr)
            s_last = []
        else:
            if s_last:
                put(s_last)
            s_last = s_curr
    if s_last:
        put(s_last)
    return 0


def _zoom_aux(line: str, is_paired: bool, rlen: int):
    t = _split_tab(line)
    s = [None] * 11
    s[0] = t[0]
    s[1] = 0
    if s[0].endswith("_F"):
        s[1] |= 1 | (1 << 6)
    if s[0].endswith("_R"):
        s[1] |= 1 | (1 << 7)
    if is_paired:
        s[1] |= 2
    s[9] = "*"
    s[10] = "*"
    s[5] = "%dM" % rlen
    s[2] = re.split(r"\s+", t[1])[0]
    m = re.search(r":(\d+)$", t[1])
    s[3] = int(m.group(1)) + 1
    if re.search(r"_[FR]$", s[0]):
        u = 1 if s[0].endswith("_F") else 0
        w = 1 if t[2] == "+" else 0
        if u ^ w:
            s[1] |= 0x10
        s[0] = re.sub(r"_[FR]$", "", s[0])
    else:
        if t[2] == "-":
            s[1] |= 0x10
    s[4] = 30
    s[6], s[7], s[8] = "*", 0, 0
    s.append("NM:i:%s" % t[3])
    return s


def main_zoom2sam(argv: list[str]) -> int:
    is_paired = "-p" in argv
    args = [v for v in argv if v != "-p"]
    if len(args) < 1:
        sys.stderr.write(
            "Usage: zoom2sam.pl [-p] <readLen> <aln.zoom>\n"
            "Warnings: This script only supports the default Illumina "
            "outputs.\n")
        return 1
    rlen = int(args[0])
    args = args[1:]
    s_last: list = []

    def put(s):
        sys.stdout.write("\t".join(str(v) for v in s) + "\n")

    for line in _input_lines(args):
        s_curr = _zoom_aux(line, is_paired, rlen)
        if s_last and s_last[0] == s_curr[0]:
            _mating(s_last, s_curr)
            put(s_last)
            put(s_curr)
            s_last = []
        else:
            if s_last:
                put(s_last)
            s_last = s_curr
    if s_last:
        put(s_last)
    return 0


# -------------------------------------------------------------------- maq

_MAQ_MAX_READLEN = 64
_MAQ_REC = struct.Struct("<%dB8B3i36s" % _MAQ_MAX_READLEN)
_PAIR_FF, _PAIR_FR, _PAIR_RF, _PAIR_RR = 0x01, 0x02, 0x04, 0x08
_PAIR_PAIRED, _PAIR_SW = 0x10, 0x80


def main_maq2sam(argv: list[str]) -> int:
    """misc/maq2sam.c: MAQ .map (gzip binary) → SAM text records."""
    if not argv:
        sys.stderr.write("Usage: maq2sam <in.map> [<readGroup>]\n")
        return 1
    rg = argv[1] if len(argv) > 1 else None
    fp = gzip.open(sys.stdin.buffer if argv[0] == "-" else argv[0], "rb")
    w = sys.stdout.write
    with fp:
        fmt = struct.unpack("<i", fp.read(4))[0]
        if fmt != -1:
            if fmt > 0:
                sys.stderr.write("** Obsolete map format is detected. "
                                 "Please use 'mapass2maq' command to "
                                 "convert the format.\n")
                return 3
            return 1
        n_ref = struct.unpack("<i", fp.read(4))[0]
        names = []
        for _ in range(n_ref):
            ln = struct.unpack("<i", fp.read(4))[0]
            names.append(fp.read(ln).split(b"\x00")[0].decode("latin-1"))
        fp.read(8)  # n_mapped_reads
        while True:
            raw = fp.read(_MAQ_REC.size)
            if len(raw) < _MAQ_REC.size:
                if raw:
                    sys.stderr.write("Truncated! Continue anyway.\n")
                break
            vals = _MAQ_REC.unpack(raw)
            seq = vals[:_MAQ_MAX_READLEN]
            size, map_qual, info1, info2, c0, c1, mflag, alt_qual = \
                vals[_MAQ_MAX_READLEN:_MAQ_MAX_READLEN + 8]
            seqid, pos, dist = vals[_MAQ_MAX_READLEN + 8:
                                    _MAQ_MAX_READLEN + 11]
            name = vals[-1].split(b"\x00")[0].decode("latin-1")
            se_mapq = seq[_MAQ_MAX_READLEN - 1]
            flag = 0
            if mflag:
                flag |= 1
            if (mflag & _PAIR_PAIRED) or ((mflag & _PAIR_SW)
                                          and mflag != 192):
                flag |= 2
            if mflag == 192:
                flag |= 4
            if mflag == 64:
                flag |= 8
            if pos & 1:
                flag |= 0x10
            if (flag & 1) and dist != 0:
                if dist > 0:
                    if mflag & (_PAIR_FF | _PAIR_RF):
                        c = 0
                    elif mflag & (_PAIR_FR | _PAIR_RR):
                        c = 1
                    else:
                        c = pos & 1
                else:
                    if mflag & (_PAIR_FF | _PAIR_FR):
                        c = 0
                    elif mflag & (_PAIR_RF | _PAIR_RR):
                        c = 1
                    else:
                        c = pos & 1
                if c:
                    flag |= 0x20
            if mflag and len(name) >= 2 and name[-2] == "/":
                flag |= 0x40 if name[-1] == "1" else 0x80
                name = name[:-2]
            w("%s\t%d\t" % (name, flag))
            w("%s\t%d\t" % (names[seqid], (pos >> 1) + 1))
            if mflag == 130:
                c = se_mapq if se_mapq < 128 else se_mapq - 256
                w("%d\t" % alt_qual)
                if c == 0:
                    w("%dM\t" % size)
                elif c > 0:
                    w("%dM%dI%dM\t" % (map_qual, c, size - map_qual - c))
                else:
                    w("%dM%dD%dM\t" % (map_qual, -c, size - map_qual))
                se_mapq = 0
            else:
                if flag & 4:
                    w("0\t*\t")
                else:
                    w("%d\t%dM\t" % (map_qual, size))
            w("*\t0\t%d\t" % dist)
            w("".join("N" if b == 0 else "ACGT"[(b >> 6) & 3]
                      for b in seq[:size]))
            w("\t")
            w("".join(chr((b & 0x3F) + 33) for b in seq[:size]))
            w("\t")
            if rg:
                w("RG:Z:%s\t" % rg)
            if flag & 4:
                w("MF:i:%d\n" % mflag)
            else:
                w("MF:i:%d\t" % mflag)
                if mflag:
                    w("AM:i:%d\tSM:i:%d\t" % (alt_qual, se_mapq))
                w("NM:i:%d\tUQ:i:%d\tH0:i:%d\tH1:i:%d\n"
                  % (info1 & 0xF, info2, c0, c1))
    return 0


# --------------------------------------------------------- fasta-sanitize

_SAN_FIRST_OK = r"0-9A-Za-z!#$%&+./:;?@^_|~\-"
_SAN_REST_OK = r"0-9A-Za-z!#$%&*+./:;=?@^_|~\-"
_SAN_RE = re.compile(r"^[0-9A-Za-z!#$%&+./:;?@^_|~-]"
                     r"[0-9A-Za-z!#$%&*+.\/:;=?@^_|~-]*$")


def main_fasta_sanitize(argv: list[str]) -> int:
    """misc/fasta-sanitize.pl: rewrite FASTA/FASTQ names to the SAM
    reference-name alphabet (invalid chars → '_')."""
    in_qual = False
    fastq = False
    seq_len = 0
    w = sys.stdout.write
    name_re = re.compile(r"^([>@])\s*(\S*)(.*)")
    for line in _input_lines(argv):
        m = name_re.match(line)
        if m and not in_qual:
            prefix, name, other = m.group(1), m.group(2), m.group(3)
            fastq = prefix == "@"
            if not _SAN_RE.match(name) and name:
                first = re.sub("[^" + _SAN_FIRST_OK + "]", "_", name[0])
                rest = re.sub("[^" + _SAN_REST_OK + "]", "_", name[1:])
                new_name = first + rest
                sys.stderr.write("Renaming reference %s to %s\n"
                                 % (name, new_name))
                name = new_name
                seq_len = 0
            w("%s%s%s\n" % (prefix, name, other.rstrip("\n")))
            continue
        if not in_qual:
            if fastq and line.startswith("+"):
                w(line)
                in_qual = True
                continue
            w(line)
            seq_len += len(line.rstrip("\n"))
        else:
            w(line)
            seq_len -= len(line.rstrip("\n"))
            if seq_len <= 0:
                in_qual = False
    return 0


# ------------------------------------------------------------------- novo

def _novo_indeltype(string: str):
    m = re.search(r"([A-Za-z]+)\>", string)
    if m:
        return ">", m.group(1)
    if "-" in string:
        return "-", ""
    m = re.search(r"\+([A-Za-z]+)", string)
    if m:
        return "+", m.group(1)
    return "", ""


def _novo_mdtag(variations, rdlen: int) -> str:
    md = ""
    t = q = 1
    deleteflag = False
    for string in variations:
        indeltype, insert = _novo_indeltype(string)
        if indeltype == "+":
            q += len(insert)
            continue
        m = re.match(r"^(\d+)", string)
        pos = int(m.group(1)) if m else 0
        ln = pos - t
        if ln != 0 or (deleteflag and indeltype == ">"):
            md += str(ln)
        t += ln
        q += ln
        if indeltype == ">":
            md += insert
            deleteflag = False
            t += 1
            q += 1
        if indeltype == "-":
            m2 = re.search(r"(\d+)\-([A-Za-z]+)", string)
            deletedbase = m2.group(2) if m2 else ""
            if not deleteflag:
                md += "^"
            md += deletedbase
            deleteflag = True
            t += 1
    ln = rdlen - q + 1
    if ln > 0:
        md += str(ln)
    return md


def _novo_newcigar(cigar: str, ch: str) -> str:
    copy = re.sub(r"^(%s+)" % ch, r"\1;", cigar)
    copy = re.sub(r"([^0-9%s])(%s+)" % (ch, ch), r"\1;\2;", copy)
    out = ""
    for el in copy.split(";"):
        if el and re.match(r"^%s+$" % ch, el):
            out += "%d%s" % (len(el), ch)
        else:
            out += el
    return out


def _novo_cigar(variations, rdlen: int) -> str:
    t = q = 1
    indeltype = ""
    cigar = ""
    for string in variations:
        if ">" in string:
            continue
        m = re.match(r"^(\d+)", string)
        pos = int(m.group(1)) if m else 0
        insert = ""
        m = re.search(r"\+([A-Za-z]+)", string)
        if m:
            indeltype, insert = "+", m.group(1)
        else:
            m = re.search(r"\-([A-Za-z]+)", string)
            if m:
                indeltype, insert = "-", m.group(1)
        ln = pos - t
        if ln > 0:
            cigar += "%dM" % ln
        t += ln
        q += ln
        if indeltype == "-":
            cigar += "D"
            t += 1
        if indeltype == "+":
            li = len(insert)
            if li == 1:
                cigar += "I"
            elif li > 1:
                cigar += "%dI" % li
            q += li
    ln = rdlen - q + 1
    if ln > 0:
        cigar += "%dM" % ln
    cigar = _novo_newcigar(cigar, "D")
    cigar = _novo_newcigar(cigar, "I")
    return cigar


_NOVO_COMP = str.maketrans("ACGTRYMKWSNacgtrymkwsn",
                           "TGCAYRKMWSNtgcayrkmwsn")


def _novo_aux(line: str, is_paired: bool):
    t = _split_ws(line)
    if len(t) < 5 or t[4] != "U":
        return []
    variations = t[13:]
    ln = len(t[2])
    s = [None] * 11
    s[0] = re.sub(r"/[12]$", "", t[0][1:])
    s[1] = 1 | (1 << (6 if t[1] == "L" else 7))
    if t[10] == ".":
        s[1] |= 2
    if t[9] == "R":
        s[9] = t[2][::-1].translate(_NOVO_COMP)
        s[10] = t[3][::-1]
    else:
        s[9], s[10] = t[2], t[3]
    if not variations:
        s[5] = "%dM" % ln
    elif re.search(r"\+|\-", " ".join(variations)):
        s[5] = _novo_cigar(variations, ln)
    else:
        s[5] = "%dM" % ln
    s[2] = t[7][1:]
    s[3] = int(t[8])
    if t[9] == "R":
        s[1] |= 0x10
    s[4] = int(t[5]) if float(t[5]) > float(t[6]) else int(t[6])
    s[6], s[7], s[8] = "*", 0, 0
    s.append("NM:i:%d" % len(variations))
    s.append("MD:Z:%s" % _novo_mdtag(variations, ln))
    return s


def main_novo2sam(argv: list[str]) -> int:
    is_paired = "-p" in argv
    args = [v for v in argv if v != "-p"]
    if not args:
        sys.stderr.write("Usage: novo2sam.pl [-p] <aln.novo>\n")
        return 1
    s_last: list = []

    def put(s):
        sys.stdout.write("\t".join(str(v) for v in s) + "\n")

    for line in _input_lines(args):
        if line.startswith("#"):
            continue
        if re.search(r"(QC|NM)\s*$", line) or re.search(r"(R\s+\d+)\s*$",
                                                        line):
            continue
        s_curr = _novo_aux(line, is_paired)
        if not s_curr:
            if s_last:
                put(s_last)
            s_last = []
            continue
        if s_last and s_last[0] == s_curr[0]:
            _mating(s_last, s_curr)
            put(s_last)
            put(s_curr)
            s_last = []
        else:
            if s_last:
                put(s_last)
            s_last = s_curr
    if s_last:
        put(s_last)
    return 0


# ----------------------------------------------------------------- export

_EXPORT_SIZE = 22


def _export_rc_matchdesc(md: str) -> str:
    rev = md[::-1].translate(str.maketrans("ACGT^$", "TGCA$^"))
    return "".join(p[::-1] if p.isdigit() else p
                   for p in re.split(r"(\d+)", rev))


def _export_frag_len(part: str) -> int:
    ln = 0
    for f in re.split(r"([ACGTN]+)", part):
        if not f:
            continue
        m = re.search(r"(\d+)", f)
        ln += int(m.group(1)) if m else len(f)
    return ln


def _export_md_to_cigar(md: str) -> str:
    cigar = ""
    for part in re.split(r"(\^.*?\$)", md):
        if not part:
            continue
        m = re.match(r"^\^([ACGTN]+)\$$", part)
        if m:
            cigar += "%dD" % len(m.group(1))
            continue
        m = re.match(r"^\^(\d+)\$$", part)
        if m:
            cigar += "%sI" % m.group(1)
            continue
        cigar += "%dM" % _export_frag_len(part)
    return cigar


def _export_aux(line: str, line_no: int, conv, is_paired: bool,
                read_no: int, nofilter: bool):
    t = _split_tab(line)
    if len(t) < _EXPORT_SIZE:
        sys.stderr.write(
            "\nERROR: Unexpected number of fields in export record on "
            "line %d of read%d export file. Found %d fields but expected "
            "%d.\n\t...erroneous export record:\n%s\n\n"
            % (line_no, read_no, len(t), _EXPORT_SIZE,
               line.rstrip("\n")))
        raise SystemExit(1)
    pass_filt = t[21] == "Y"
    if not (pass_filt or nofilter):
        return []
    s = [None] * 11
    prefix = t[0] + ("_%d" % int(t[1]) if t[1] != "" else "")
    s[0] = ":".join([prefix, str(int(t[2])), str(int(t[3])),
                     str(int(t[4])), str(int(t[5]))])
    s[1] = 0
    if is_paired:
        if int(t[7]) != read_no:
            sys.stderr.write(
                "\nERROR: read%d export file contains record with read "
                "number: %s on line: %d\n\n" % (read_no, t[7], line_no))
            raise SystemExit(1)
        s[1] |= 1 | (1 << (5 + read_no))
    if not pass_filt:
        s[1] |= 0x200
    is_rev = t[13] == "R"
    if is_rev:
        s[9] = t[8][::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))
        s[10] = t[9][::-1]
    else:
        s[9], s[10] = t[8], t[9]
    qual = []
    for ch in s[10].encode("latin-1"):
        val = conv[ch] if ch < len(conv) else None
        if val is None:
            msg = ("\nERROR: can't interpret export quality value: %d in "
                   "read%d export file, line: %d\n" % (ch, read_no,
                                                       line_no))
            if ch < 64:
                msg += ("  Use --qlogodds flag to translate logodds "
                        "(solexa) quality values.\n")
            sys.stderr.write(msg + "\n")
            raise SystemExit(1)
        qual.append(val)
    s[10] = "".join(chr(v) for v in qual)
    has_coor = False
    s[2] = "*"
    if t[10] in ("NM", "QC", "RM", "CONTROL"):
        s[1] |= 0x4
        if t[10] != "NM":
            s.append("XC:Z:%s" % t[10])
    else:
        m = re.search(r"(\d+):(\d+):(\d+)", t[10])
        if m:
            s[1] |= 0x4
            s += ["H0:i:%s" % m.group(1), "H1:i:%s" % m.group(2),
                  "H2:i:%s" % m.group(3)]
        elif float(t[12] or 0) < 1:
            s[1] |= 0x4
        else:
            s[2] = t[10] + ("/" + t[11] if t[11] != "" else "")
            has_coor = True
    s[3] = int(t[12]) if has_coor else 0
    match_desc = ""
    s[5] = "*"
    if has_coor:
        match_desc = _export_rc_matchdesc(t[14]) if is_rev else t[14]
        if "^" in match_desc:
            s[5] = _export_md_to_cigar(match_desc)
        else:
            s[5] = "%dM" % len(s[9])
    if has_coor and is_rev:
        s[1] |= 0x10
    if has_coor:
        semap = int(t[15]) if t[15] != "" else 0
        pemap = 0
        if is_paired:
            pemap = int(t[16]) if t[16] != "" else 0
            if pemap > 0:
                s[1] |= 0x02
        s[4] = min(254, max(semap, pemap))
    else:
        s[4] = 0
    s[6], s[7], s[8] = "*", 0, 0
    if t[6]:
        s.append("BC:Z:%s" % t[6])
    if has_coor:
        s.append("XD:Z:%s" % match_desc)
        if t[15] != "":
            s.append("SM:i:%s" % t[15])
        if is_paired and t[16] != "":
            s.append("AS:i:%s" % t[16])
    return s


def main_export2sam(argv: list[str]) -> int:
    """misc/export2sam.pl v2.3.1 (GERALD export → SAM)."""
    progname = "export2sam.pl"
    version = "2.3.1"
    usage = (
        "\n%s converts GERALD export files to SAM format.\n\n"
        "Usage: %s --read1=FILENAME [ options ] | --version | --help\n\n"
        "  --read1=FILENAME  read1 export file or '-' for stdin "
        "(mandatory)\n"
        "                      (file may be gzipped with \".gz\" "
        "extension)\n"
        "  --read2=FILENAME  read2 export file or '-' for stdin\n"
        "                      (file may be gzipped with \".gz\" "
        "extension)\n"
        "  --nofilter        include reads that failed the basecaller\n"
        "                      purity filter\n"
        "  --qlogodds        assume export file(s) use logodds quality "
        "values\n"
        "                      as reported by OLB (Pipeline) prior to "
        "v1.3\n"
        "                      (default: phred quality values)\n\n"
        % (progname, progname))
    qlogodds = nofilter = print_version = False
    read1file = read2file = None
    rest = []
    for v in argv:
        if v == "--qlogodds":
            qlogodds = True
        elif v == "--nofilter":
            nofilter = True
        elif v.startswith("--read1="):
            read1file = v[8:]
        elif v.startswith("--read2="):
            read2file = v[8:]
        elif v == "--version":
            print_version = True
        elif v in ("--help", "-h"):
            sys.stderr.write(usage)
            return 1
        else:
            rest.append(v)
    if not argv:
        sys.stderr.write(usage)
        return 1
    if rest:
        sys.stderr.write("\nERROR: Unrecognized arguments: %s\n\n%s"
                         % (" ".join(rest), usage))
        return 1
    if print_version:
        sys.stderr.write("\n%s version: %s\n\n" % (progname, version))
        return 1
    if read1file is None:
        sys.stderr.write("\nERROR: read1 export file must be "
                         "specified\n\n" + usage)
        return 1
    import math
    conv: list = []
    if qlogodds:
        for v in range(-64, 65):
            conv.append(int(33 + 10 * math.log(1 + 10 ** (v / 10.0))
                            / math.log(10) + 0.499))
    else:
        conv = [None] * 64 + [33 + v for v in range(65)]

    def opener(path):
        if path == "-":
            return sys.stdin
        if path.endswith(".gz"):
            return gzip.open(path, "rt")
        return open(path, "rt")

    cmdline = progname + " " + " ".join(argv)
    sys.stdout.write("@PG\tID:%s\tVN:%s\tCL:%s\n"
                     % (progname, version, cmdline))
    fh1 = opener(read1file)
    fh2 = opener(read2file) if read2file else None
    is_paired = fh2 is not None
    line_no = 0
    for line in fh1:
        line_no += 1
        s1 = _export_aux(line, line_no, conv, is_paired, 1, nofilter)
        s2 = []
        if is_paired:
            line2 = fh2.readline()
            if not line2:
                sys.stderr.write(
                    "\nERROR: read1 and read2 export files do not "
                    "contain the same number of reads.\n  Extra reads "
                    "observed in read1 file at line no: %d.\n\n"
                    % line_no)
                return 1
            s2 = _export_aux(line2, line_no, conv, is_paired, 2,
                             nofilter)
            if s1 and s2:
                if s1[0] != s2[0]:
                    sys.stderr.write(
                        "\nERROR: Non-paired reads in export files on "
                        "line: %d.\n  Read1: %s  Read2: %s\n"
                        % (line_no, line, line2))
                    return 1
                isize = 0
                if s1[2] != "*" and s1[2] == s2[2]:
                    x1 = s1[3] + len(s1[9]) if s1[1] & 0x10 else s1[3]
                    x2 = s2[3] + len(s2[9]) if s2[1] & 0x10 else s2[3]
                    isize = x2 - x1
                for sa, sb, isz in ((s1, s2, isize), (s2, s1, -isize)):
                    if sb[2] != "*":
                        sa[6] = "=" if sb[2] == sa[2] else sb[2]
                        sa[7] = sb[3]
                        sa[8] = isz
                        if sb[1] & 0x10:
                            sa[1] |= 0x20
                    else:
                        sa[1] |= 0x8
        if s1:
            sys.stdout.write("\t".join(str(v) for v in s1) + "\n")
        if s2 and is_paired:
            sys.stdout.write("\t".join(str(v) for v in s2) + "\n")
    if is_paired:
        extra = fh2.readline()
        if extra:
            sys.stderr.write(
                "\nERROR: read1 and read2 export files do not contain "
                "the same number of reads.\n  Extra reads observed in "
                "read2 file at line no: %d.\n\n" % (line_no + 1))
            return 1
    return 0


# ------------------------------------------------------------------ blast

def main_blast2sam(argv: list[str]) -> int:
    """misc/blast2sam.pl: NCBI blastn default-format output → SAM."""
    show_seq = "-s" in argv or "-sd" in argv or "-ds" in argv
    dummy_score = "-d" in argv or "-sd" in argv or "-ds" in argv
    args = [v for v in argv if v not in ("-s", "-d", "-sd", "-ds")]
    if not args and sys.stdin.isatty():
        sys.stderr.write("Usage: blast2sam.pl <in.blastn>\n")
        return 1
    sam: list = [None] * 13
    sam[0], sam[4] = "", 255
    sam[6], sam[7], sam[8], sam[10] = "*", 0, 0, "*"
    cigar: list = []
    cmaux = [0, 0, 0, ""]
    started_cm = False
    qlen = qend = 0
    qbeg = 0

    def aln2cm(qs: str, ss: str):
        for qc, sc in zip(qs, ss):
            op = 1 if qc == "-" else 2 if sc == "-" else 0
            if cmaux[0] == op:
                cmaux[1] += 1
            else:
                cigar.append("%d%s" % (cmaux[1], "MDI"[cmaux[0]]))
                cmaux[0], cmaux[1] = op, 1

    def print_sam():
        cigar.append("%d%s" % (cmaux[1], "MDI"[cmaux[0]]))
        cg = list(cigar)
        s9 = sam[9] or ""
        if sam[1] is not None and sam[1] & 0x10:
            cg = list(reversed(cg))
            s9 = s9[::-1].translate(str.maketrans(
                "atgcrymkswATGCRYMKSW", "tacgyrkmswTACGYRKMSW"))
        if s9:
            q10 = "I" * len(s9) if dummy_score else sam[10]
        else:
            s9 = "*"
            q10 = sam[10]
        sam[5] = "".join(cg)
        row = list(sam)
        row[9], row[10] = s9, q10
        sys.stdout.write("\t".join(
            "" if v is None else str(v) for v in row) + "\n")

    lines = _input_lines(args)
    for line in lines:
        if ((cigar or started_cm)
                and (line.startswith("Query=")
                     or re.search(r"Score =.*bits.*Expect", line)
                     or re.match(r"^>\S+", line))):
            print_sam()
            cigar[:] = []
            started_cm = False
        m = re.match(r"^Query=\s(\S+)", line)
        if m:
            sam[2] = None
            sam[0] = m.group(1)
            nxt = next(lines, "")
            m2 = re.match(r"^(\S+)$", nxt.rstrip("\n"))
            if m2:
                sam[0] += m2.group(1)
            continue
        m = re.search(r"(\S+)\s+total letters", line)
        if m:
            qlen = int(m.group(1).replace(",", ""))
            continue
        m = re.match(r"^>(\S+)", line)
        if m:
            sam[2] = m.group(1)
            continue
        m = re.search(r"Score\s+=\s+(\S+) bits.+Expect(\(\d+\))?\s+=\s+"
                      r"(\S+)", line)
        if m:
            as_score = int(float(m.group(1)) + 0.499)
            ev = m.group(3)
            if ev.startswith("e"):
                ev = "1" + ev
            sam[1], sam[3], sam[9] = 0, 0, ""
            sam[11] = "AS:i:%d" % as_score
            sam[12] = "EV:Z:%s" % ev
            cigar[:] = []
            qbeg = 0
            cmaux[:] = [0, 0, 0, ""]
            started_cm = True
            continue
        m = re.search(r"Strand=(\S+)/(\S+)", line)
        if m:
            if m.group(2) == "Minus":
                sam[1] |= 0x10
            continue
        m = re.search(r"Query\s+(\d+)\s*(\S+)\s+(\d+)", line)
        if m:
            q = m.group(2)
            if not qbeg:
                qbeg = int(m.group(1))
                if qbeg > 1:
                    cigar.append("%dH" % (qbeg - 1))
            qend = int(m.group(3))
            if show_seq:
                sam[9] = (sam[9] or "") + q.replace("-", "")
            last_q = q
            continue
        m = re.search(r"Sbjct:*\s+(\d+)\s*(\S+)\s+(\d+)", line)
        if m:
            s_aln = m.group(2)
            if sam[1] & 0x10:
                sam[3] = int(m.group(3))
            elif not sam[3]:
                sam[3] = int(m.group(1))
            aln2cm(last_q, s_aln)
            continue
    if sam[2]:
        print_sam()
    _ = qlen, qend
    return 0


# ------------------------------------------------------- interpolate_sam

def main_interpolate_sam(argv: list[str]) -> int:
    """misc/interpolate_sam.pl: per-base open-fragment counts from a
    name-annotated SAM (RNAME carrying :...:...:...:...:size)."""
    if not argv:
        sys.stderr.write("No sam file defined on arg 1\n")
        return 1
    path = argv[0]
    import os as _os
    if not _os.path.isfile(path):
        sys.stderr.write("Sam file does not exist: %s\n" % path)
        return 1
    w = sys.stdout.write
    cur_loc = ""
    cur_size = 0
    cur_pos = 1
    open_n = 0
    close: dict[int, int] = {}

    def parse_cigar(cg: str):
        md = {"M": 0, "I": 0, "D": 0}
        for m in re.finditer(r"([0-9]+)([A-Z])", cg):
            nt = m.group(2)
            if nt not in ("M", "D", "I"):
                nt = "M"
            md[nt] += int(m.group(1))
        return md

    with open(path) as f:
        for line in f:
            t = line.split("\t")
            if cur_loc != t[2]:
                for i in range(cur_pos, cur_size + 1):
                    if i in close:
                        open_n -= close.pop(i)
                    w("%d\n" % open_n)
                if cur_loc != "":
                    w("\n")
                lt = t[2].split(":")
                cur_pos = 1
                cur_loc = t[2]
                cur_size = int(lt[4]) if len(lt) > 4 else 0
                open_n = 0
                close = {}
                w("#%s\n" % t[2])
                for _i in range(1, int(t[3])):
                    w("%d\n" % open_n)
                cur_pos = int(t[3])
            else:
                p3 = int(t[3])
                if p3 > cur_pos:
                    for i in range(cur_pos, p3):
                        if i in close:
                            open_n -= close.pop(i)
                        w("%d\n" % open_n)
                    cur_pos = p3
            open_n += 1
            fl = int(t[1])
            if ((fl & 0x80 or fl & 0x40) and fl & 0x10 and fl & 0x2):
                open_n -= 1
                pc = parse_cigar(t[5])
                end = int(t[3]) + pc["M"] + pc["D"] - 1
                close[end + 1] = close.get(end + 1, 0) + 1
            elif not (fl & 0x1) or not (fl & 0x2):
                pc = parse_cigar(t[5])
                end = int(t[3]) + pc["M"] + pc["D"] - 1
                close[end + 1] = close.get(end + 1, 0) + 1
    for i in range(cur_pos, cur_size + 1):
        if i in close:
            open_n -= close.pop(i)
        w("%d\n" % open_n)
    w("\n")
    return 0
