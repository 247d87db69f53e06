"""wgsim_eval — evaluate alignments/variant calls on wgsim-simulated data.

Counterpart of samtools_tpu/tools/wgsim_eval_cmd.py, samtools'
misc/wgsim_eval.pl (alneval / vareval / unique / uniqcmp), byte-identical
output for identical input.  Pairs with the `wgsim` simulator subcommand
to close samtools' simulate→align→evaluate loop.  A host command: no
device work.
"""

from __future__ import annotations

import re
import sys


def _getopts(argv, optstr):
    """perl Getopt::Std-ish: returns (opts dict, remaining args)."""
    takes = {optstr[i]: (i + 1 < len(optstr) and optstr[i + 1] == ":")
             for i in range(len(optstr)) if optstr[i] != ":"}
    opts = {}
    rest = []
    it = iter(argv)
    for v in it:
        if v.startswith("-") and len(v) == 2 and v[1] in takes:
            if takes[v[1]]:
                opts[v[1]] = next(it, "")
            else:
                opts[v[1]] = True
        else:
            rest.append(v)
    return opts, rest


def _lines(args):
    if args:
        for p in args:
            with (sys.stdin if p == "-" else open(p)) as f:
                yield from f
    else:
        yield from sys.stdin


def _alneval(argv):
    opts, args = _getopts(argv, "pcag:")
    if not args and sys.stdin.isatty():
        sys.stderr.write("Usage: wgsim_eval.pl alneval [options] "
                         "<in.sam>\n")
        return 1
    gap = int(opts.get("g", 5))
    flag = (1 if "p" in opts else 0) | (2 if "c" in opts else 0)
    roc = "a" in opts
    c0: dict[int, int] = {}
    c1: dict[int, int] = {}
    fnfp: dict[int, list] = {}
    max_q = 0
    for line in _lines(args):
        if line.startswith("@"):
            continue
        t = line.split("\t")
        if len(t) < 11:
            continue
        q = int(int(t[4]) / 10)
        is_correct = 1
        chrom, left = t[2], int(t[3])
        rght = left
        if q > max_q:
            max_q = q
        for m in re.finditer(r"(\d+)([MDN=X])", t[5]):
            rght += int(m.group(1))
        rght -= 1
        left0, rght0 = left, rght
        m = re.match(r"^(\d+)[SH]", t[5])
        if m:
            left -= int(m.group(1))
            rght0 += int(m.group(1))
        m = re.search(r"(\d+)[SH]$", t[5])
        if m:
            rght += int(m.group(1))
            left0 -= int(m.group(1))
        fl = int(t[1])
        if (fl & 0x4) or chrom == "*":
            continue
        m = re.match(r"^(\S+)_(\d+)_(\d+)_", t[0])
        if not m:
            sys.stderr.write("[wgsim_eval] read '%s' was not generated "
                             "by wgsim?\n" % t[0])
            continue
        p2, p3 = int(m.group(2)), int(m.group(3))
        if m.group(1) != chrom:
            is_correct = 0
        elif flag & 2:
            if (fl & 0x40) and not (fl & 0x10):
                if abs(p2 - left) > gap and abs(p2 - left0) > gap:
                    is_correct = 0
            elif (fl & 0x40) and (fl & 0x10):
                if abs(p3 - rght) > gap and abs(p3 - rght0) > gap:
                    is_correct = 0
            elif (fl & 0x80) and not (fl & 0x10):
                if abs(p3 - left) > gap and abs(p3 - left0) > gap:
                    is_correct = 0
            else:
                if abs(p2 - rght) > gap and abs(p3 - rght0) > gap:
                    is_correct = 0
        else:
            if fl & 0x10:
                if abs(p3 - rght) > gap and abs(p3 - rght0) > gap:
                    is_correct = 0
            else:
                if abs(p2 - left) > gap and abs(p2 - left0) > gap:
                    is_correct = 0
        c0[q] = c0.get(q, 0) + 1
        if not is_correct:
            c1[q] = c1.get(q, 0) + 1
        mq = int(t[4])
        fnfp.setdefault(mq, [0, 0])
        fnfp[mq][0] += 1
        if not is_correct:
            fnfp[mq][1] += 1
        if (flag & 1) and not is_correct and q > 0:
            sys.stderr.write(line)
    cc0 = cc1 = 0
    if not roc:
        for i in range(max_q, -1, -1):
            v0 = c0.get(i, 0)
            v1 = c1.get(i, 0)
            cc0 += v0
            cc1 += v1
            if cc0:
                sys.stdout.write("%.2dx %12d / %-12d  %12d  %.3e\n"
                                 % (i, v1, v0, cc0, cc1 / cc0))
    else:
        for mq in sorted(fnfp, reverse=True):
            if mq == 0:
                continue
            cc0 += fnfp[mq][0]
            cc1 += fnfp[mq][1]
            sys.stdout.write("%d\t%d\t%d\n" % (mq, cc0, cc1))
    return 0


def _vareval(argv):
    opts, args = _getopts(argv, "g:p")
    skip = int(opts.get("g", 10))
    Q = 200
    if len(args) < 1:
        sys.stderr.write("Usage: wgsim_eval.pl vareval [-g %d] "
                         "<wgsim.snp> <pileup.flt>\n" % skip)
        return 1
    is_print = "p" in opts
    snp: dict = {}
    indel: dict = {}
    with open(args[0]) as fh:
        for line in fh:
            t = line.split()
            if len(t) != 5 or t[2] == "-" or t[3] == "-":
                if t:
                    indel.setdefault(t[0], {})[int(t[1])] = 1
            else:
                snp.setdefault(t[0], {})[int(t[1])] = t[3]
    cnt = [[0] * (Q + 1) for _ in range(4)]
    for line in _lines(args[1:]):
        t = line.split()
        if len(t) < 6 or t[2] == t[3]:
            continue
        q = int(float(t[5]))
        if q > Q:
            q = Q
        if t[2] == "*":
            hit = 0
            cnt[2][q] += 1
            d = indel.get(t[0], {})
            for i in range(int(t[1]) - skip, int(t[1]) + skip + 1):
                if i in d:
                    hit = 1
                    break
            if not hit:
                cnt[3][q] += 1
                if is_print:
                    sys.stderr.write(line)
        else:
            cnt[0][q] += 1
            if int(t[1]) not in snp.get(t[0], {}):
                cnt[1][q] += 1
                if is_print:
                    sys.stderr.write(line)
    for i in range(Q - 1, -1, -1):
        for j in range(4):
            cnt[j][i] += cnt[j][i + 1]
    for i in range(Q, -1, -1):
        sys.stdout.write("%d\t%d\t%d\t%d\t%d\n"
                         % (i, cnt[0][i], cnt[1][i], cnt[2][i],
                            cnt[3][i]))
    return 0


def _unique(argv):
    opts, args = _getopts(argv, "Qf:q:r:a:b:m")
    f_fac = float(opts.get("f", 250.0))
    qo = int(opts.get("q", 5))
    ro = int(opts.get("r", 2))
    ao = int(opts.get("a", 1))
    if not args and sys.stdin.isatty():
        sys.stderr.write("Usage: wgsim_eval.pl unique [options] "
                         "<in.sam>\n")
        return 1
    recal = "Q" in opts
    multi_only = "m" in opts
    last = ""
    acc: list = []

    def flush():
        mx = mx2 = 0
        mi = -1
        for i, (score, _t) in enumerate(acc):
            if score > mx:
                mx2, mx, mi = mx, score, i
            elif score > mx2:
                mx2 = score
        if recal and (not multi_only or len(acc) > 1):
            qv = int(f_fac * (mx - mx2) / mx + 0.499)
            if qv > 250:
                qv = 250
            acc[mi][1][4] = str(qv)
        sys.stdout.write("\t".join(acc[mi][1]))
        acc.clear()

    for line in _lines(args):
        score = -1
        if line.startswith("@"):
            sys.stdout.write(line)
        m = re.search(r"AS:i:(\d+)", line)
        if m:
            score = int(m.group(1))
        t = line.split("\t")
        if len(t) < 11:
            continue
        if score < 0:
            mm = go = ge = 0
            for g in re.finditer(r"(\d+)[ID]", t[5]):
                go += 1
                ge += int(g.group(1))
            for g in re.finditer(r"(\d+)M", t[5]):
                mm += int(g.group(1))
            score = mm * ao - go * qo - ge * ro
        if score < 1:
            score = 1
        if t[0] != last:
            if acc:
                flush()
            last = t[0]
        acc.append([score, t])
    if acc:
        flush()
    return 0


def _uniqcmp(argv):
    opts, args = _getopts(argv, "pq:s:b:")
    qq = int(opts.get("q", 20))
    ss = int(opts.get("s", 100))
    bb = int(opts.get("b", 4))
    if len(args) < 2:
        sys.stderr.write("Usage: wgsim_eval.pl uniqcmp [options] "
                         "<in1.sam> <in2.sam>\n")
        return 1
    a: dict = {}

    def read(fn, which):
        for line in open(fn):
            t = line.split()
            if len(t) < 11:
                continue
            nm = 0
            m = re.search(r"NM:i:(\d+)", line)
            if m:
                nm = int(m.group(1))
            x = 0
            for g in re.finditer(r"(\d+)[M=XI]", t[5]):
                x += int(g.group(1))
            rec = [1 if int(t[1]) & 0x10 else 0, t[2], int(t[3]),
                   int(t[4]), "%d:%d" % (x, nm), x - bb * nm]
            a.setdefault(t[0], [None, None])[which] = rec

    sys.stderr.write("[uniqcmp] read the first file...\n")
    read(args[0], 0)
    sys.stderr.write("[uniqcmp] read the second file...\n")
    read(args[1], 1)
    sys.stderr.write("[uniqcmp] stats...\n")
    cnt = [0] * 10
    for x, p in a.items():
        if p[0] is not None and p[1] is not None:
            z = 0 if (p[0][0] == p[1][0] and p[0][1] == p[1][1]
                      and abs(p[0][2] - p[1][2]) < ss) else 1
            if p[0][3] >= qq and p[1][3] >= qq:
                cnt[z * 3 + 0] += 1
            elif p[0][3] >= qq:
                cnt[z * 3 + 1] += 1
            elif p[1][3] >= qq:
                cnt[z * 3 + 2] += 1
            if z and "p" in opts and (p[0][3] >= qq or p[1][3] >= qq):
                sys.stderr.write(
                    "%s\t%s:%d\t%d\t%s\t%s:%d\t%d\t%s\t%d\n"
                    % (x, p[0][1], p[0][2], p[0][3], p[0][4], p[1][1],
                       p[1][2], p[1][3], p[1][4], p[0][5] - p[1][5]))
        elif p[0] is not None:
            cnt[6 if p[0][3] >= qq else 7] += 1
            if "p" in opts and p[0][3] >= qq:
                sys.stderr.write("%s\t%s:%d\t%d\t%s\t*\t0\t*\t%d\n"
                                 % (x, p[0][1], p[0][2], p[0][3],
                                    p[0][4], p[0][5]))
        else:
            if "p" in opts and p[1][3] >= qq:
                sys.stderr.write("%s\t*\t0\t*\t%s:%d\t%d\t%s\t%d\n"
                                 % (x, p[1][1], p[1][2], p[1][3],
                                    p[1][4], -p[1][5]))
            cnt[9 if p[1][3] < qq else 8] += 1
    w = sys.stdout.write
    w("Consistent (high, high):   %d\n" % cnt[0])
    w("Consistent (high, low ):   %d\n" % cnt[1])
    w("Consistent (low , high):   %d\n" % cnt[2])
    w("Inconsistent (high, high): %d\n" % cnt[3])
    w("Inconsistent (high, low ): %d\n" % cnt[4])
    w("Inconsistent (low , high): %d\n" % cnt[5])
    w("Second missing (high):     %d\n" % cnt[6])
    w("Second missing (low ):     %d\n" % cnt[7])
    w("First  missing (high):     %d\n" % cnt[8])
    w("First  missing (low ):     %d\n" % cnt[9])
    return 0


def main_wgsim_eval(argv: list[str]) -> int:
    if not argv:
        sys.stderr.write(
            "\nUsage:   wgsim_eval.pl <command> <arguments>\n\n"
            "Command: alneval       evaluate alignment in the SAM "
            "format\n"
            "         vareval       evaluate variant calls in the "
            "pileup format\n"
            "         unique        keep the top scoring hit in SAM\n"
            "         uniqcmp       compare two alignments without "
            "multiple hits\n\n")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "alneval":
        return _alneval(rest)
    if cmd == "vareval":
        return _vareval(rest)
    if cmd == "unique":
        return _unique(rest)
    if cmd == "uniqcmp":
        return _uniqcmp(rest)
    sys.stderr.write("[wgsim_eval] unrecognized command.\n")
    return 1
