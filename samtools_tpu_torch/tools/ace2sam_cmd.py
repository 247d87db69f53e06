"""ace2sam — phrap/CAP3 ACE assembly to SAM converter.

Counterpart of samtools_tpu/tools/ace2sam_cmd.py (samtools'
misc/ace2sam.c): per
contig (CO) the padded consensus defines the reference (unpadded by
default, padded with -p); AF lines carry placement, RD/QA carry read
sequence and align-clip bounds; the CIGAR is derived by flattening the
read's pads against the consensus pads (M/I/D/P runs, surplus pads
squeezed, soft clips from QA).  Header (H/S prefixed) goes to stderr,
headerless SAM to stdout, exactly as samtools' tool does.  A host
command: no device work.
"""

from __future__ import annotations

import gzip
import sys

LINE_LEN = 60
OPS = "MIDNSHP=X"


def usage(fp):
    fp.write(
        "\nUsage:   ace2sam [-pc] <in.ace>\n\n"
        "Options: -p     output padded SAM\n"
        "         -c     write the contig sequence in SAM\n\n")


def _open(path):
    f = open(path, "rb") if path != "-" else sys.stdin.buffer
    head = f.peek(2) if hasattr(f, "peek") else b""
    if head[:2] == b"\x1f\x8b":
        return gzip.open(f, "rt")
    import io
    return io.TextIOWrapper(f, encoding="latin-1")


def _tokens(fh):
    for line in fh:
        yield line.rstrip("\n")


def main_ace2sam(argv: list[str]) -> int:
    is_padded = write_cns = False
    args = []
    for a in argv:
        if a == "-p":
            is_padded = True
        elif a == "-c":
            write_cns = True
        elif a == "-pc" or a == "-cp":
            is_padded = write_cns = True
        else:
            args.append(a)
    if not args:
        usage(sys.stderr)
        return 1
    fh = _open(args[0])
    out = sys.stdout
    err = sys.stderr

    name = ""
    padded = ""          # padded consensus
    unpadded = ""
    p2u: list[int] = []
    af: list[tuple[int, int, int]] = []   # (pos, neg, reversed)
    af_i = 0
    rd_name = ""
    rd_seq = ""
    cns_line: list[str] | None = None

    def padded2cigar(sp: str) -> list[int]:
        cig = []
        l_m = l_d = 0
        for ch in sp:
            if ch == "*":
                if l_m:
                    cig.append(l_m << 4)
                l_d += 1
                l_m = 0
            else:
                if l_d:
                    cig.append(l_d << 4 | 2)
                l_m += 1
                l_d = 0
        if l_m:
            cig.append(l_m << 4)
        else:
            cig.append(l_d << 4 | 2)
        return cig

    it = iter(fh)
    pending: list[str] = []

    def next_line():
        if pending:
            return pending.pop()
        return next(it, None)

    line = next_line()
    while line is not None:
        f = line.split()
        if not f:
            line = next_line()
            continue
        tag = f[0]
        if tag == "CO":
            name = f[1]
            padded_parts = []
            while True:
                line = next_line()
                if line is None or not line.strip():
                    break
                padded_parts.append(line.strip())
            padded = "".join(padded_parts)
            unpadded = padded.replace("*", "")
            p2u = []
            k = 0
            for ch in padded:
                p2u.append(k)
                if ch != "*":
                    k += 1
            af = []
            af_i = 0
            ln = len(padded) if is_padded else len(unpadded)
            err.write("H @SQ\tSN:%s\tLN:%d\n" % (name, ln))
            cns = padded if is_padded else unpadded
            err.write("S >%s\n" % name)
            for i in range(0, len(cns), LINE_LEN):
                err.write("S " + cns[i:i + LINE_LEN] + "\n")
            if write_cns:
                cig = (padded2cigar(padded) if is_padded
                       else [len(unpadded) << 4])
                cstr = "".join("%d%c" % (c >> 4, OPS[c & 0xF])
                               for c in cig)
                cns_line = [name, "516", name, "1", "60", cstr, "*",
                            "0", "0", unpadded, "*"]
        elif tag == "BQ":
            quals = []
            while len(quals) < len(unpadded):
                line = next_line()
                if line is None:
                    err.write("E truncated contig quality\n")
                    break
                quals.extend(line.split())
            line = next_line()  # the empty separator line
            if write_cns and cns_line is not None:
                q = "".join(chr(min(int(x) + 33, 126))
                            for x in quals[:len(unpadded)])
                cns_line[-1] = q
                out.write("\t".join(cns_line) + "\n")
                cns_line = None
        elif tag == "AF":
            if write_cns and cns_line is not None:
                out.write("\t".join(cns_line) + "\n")
                cns_line = None
            pos = int(f[3])
            af.append((abs(pos), 1 if pos < 0 else 0,
                       1 if f[2] == "C" else 0))
        elif tag == "RD":
            rd_name = f[1]
            rd_parts = []
            while True:
                line = next_line()
                if line is None or not line.strip():
                    break
                rd_parts.append(line.strip())
            rd_seq = "".join(rd_parts)
        elif tag == "QA":
            beg = int(f[3]) - 1
            end = int(f[4])
            pos, neg, rev = af[af_i]
            if neg:
                pos = -pos
            pos += beg      # 1-based padded position
            nopad = rd_seq.replace("*", "")
            cig: list[int] = []
            if beg:
                cig.append(beg << 4 | 4)
            if is_padded:
                body = padded2cigar(rd_seq)
                if beg and len(body) >= 1:
                    body[0] -= beg << 4
                if end < len(rd_seq) and body:
                    body[-1] -= (len(rd_seq) - end) << 4
                cig += body
            else:
                codes = []
                k = pos - 1
                for i in range(beg, end):
                    rch = rd_seq[i]
                    cch = padded[k] if 0 <= k < len(padded) else "N"
                    if rch != "*":
                        codes.append(0 if cch != "*" else 1)
                    else:
                        codes.append(2 if cch != "*" else 6)
                    k += 1
                runs: list[int] = []
                for cde in codes:
                    if runs and (runs[-1] & 0xF) == cde:
                        runs[-1] += 1 << 4
                    else:
                        runs.append(1 << 4 | cde)
                # squeeze surplus P between non-I ops, merging
                for i in range(2, len(runs)):
                    if (runs[i] & 0xF) != 1 and \
                            (runs[i - 1] & 0xF) == 6 and \
                            (runs[i - 2] & 0xF) != 1:
                        runs[i - 1] = 0
                        if (runs[i] & 0xF) == (runs[i - 2] & 0xF):
                            runs[i] += runs[i - 2]
                            runs[i - 2] = 0
                runs = [r for r in runs if r]
                cig += runs
            if end < len(rd_seq):
                cig.append((len(rd_seq) - end) << 4 | 4)
            cstr = "".join("%d%c" % (c >> 4, OPS[c & 0xF]) for c in cig)
            samp = pos if is_padded else (p2u[pos - 1] + 1
                                          if 0 < pos <= len(p2u)
                                          else pos)
            out.write("%s\t%d\t%s\t%d\t60\t%s\t*\t0\t0\t%s\t*\n"
                      % (rd_name, 16 if rev else 0, name, samp, cstr,
                         nopad))
            af_i += 1
        line = next_line()
    return 0
