"""samtools ampliconstats: statistics of an amplicon sequencing run.

Counterpart of samtools_tpu/tools/ampliconstats_cmd.py (samtools'
amplicon_stats.c): the primers of a BED file, in file order, make the
amplicons (``bed2amplicon``; alternative primers joined with commas);
each file's reads are walked a record at a time (``accumulate_stats``)
into per-contig counters, which ``dump_stats`` prints as the per-file
sections (FSS, FREADS, FVDEPTH, FRPERC, FDEPTH, FPCOV, FDP_ALL,
FDP_VALID, FTCOORD, FAMP), and ``append_lstats`` adds into the combined
ones (C*, with their means and deviations), which
``plot-ampliconstats`` draws.  A host command: no device work.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import flags as F
from ..io.files import read_alignments
from .ampliconclip_cmd import load_bed_multi_ref
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)
from .flags_cmd import str2flag

TCOORD_MIN_COUNT = 10
MAX_AMP = 1000
MAX_AMP_LEN = 1000
MAX_PRIMER_PER_AMPLICON = 4
MAX_DEPTH = 5
U32MAX = 0xFFFFFFFF


class Amplicon:
    __slots__ = ("left", "right", "max_left", "min_right", "min_left",
                 "max_right")

    def __init__(self):
        self.left: list[int] = []
        self.right: list[int] = []
        self.max_left = 0
        self.min_right = 2**63 - 1
        self.min_left = 2**63 - 1
        self.max_right = 0


class AStats:
    """Per-reference accumulators (amplicon_stats.c:92-116)."""

    def __init__(self, max_len: int, max_amp: int, max_amp_len: int):
        self.max_amp = max_amp
        self.max_amp_len = max_amp_len
        self.max_len = max_len
        self.nseq = 0
        self.nfiltered = 0
        self.nfailprimer = 0
        self.nreads = np.zeros(max_amp, np.int64)
        self.nreads2 = np.zeros(max_amp, np.int64)
        self.nfull_reads = np.zeros(max_amp, np.float64)
        self.nrperc = np.zeros(max_amp, np.float64)
        self.nrperc2 = np.zeros(max_amp, np.float64)
        self.nbases = np.zeros(max_amp, np.int64)
        self.nbases2 = np.zeros(max_amp, np.int64)
        self.coverage = np.zeros((max_amp, max_amp_len), np.int64)
        self.covered_perc = np.zeros((max_amp, MAX_DEPTH), np.float64)
        self.covered_perc2 = np.zeros((max_amp, MAX_DEPTH), np.float64)
        self.tcoord: list[dict] = [dict() for _ in range(max_amp + 1)]
        self.amp_dist = np.zeros((max_amp, 3), np.int64)
        self.depth_valid = np.zeros(max_len, np.int64)
        self.depth_all = np.zeros(max_len, np.int64)
        self.qend: dict[str, int] = {}

    def reset(self):
        self.nseq = self.nfiltered = self.nfailprimer = 0
        self.nreads[:] = 0
        self.nreads2[:] = 0
        self.nfull_reads[:] = 0
        self.nrperc[:] = 0
        self.nrperc2[:] = 0
        self.nbases[:] = 0
        self.nbases2[:] = 0
        self.coverage[:] = 0
        self.covered_perc[:] = 0
        self.covered_perc2[:] = 0
        for d in self.tcoord:
            for k in [k for k, v in d.items() if (v & U32MAX) < 5]:
                del d[k]
            for k in d:
                d[k] = 0
        self.qend.clear()
        self.depth_valid[:] = 0
        self.depth_all[:] = 0
        self.amp_dist[:] = 0


class RefAmps:
    __slots__ = ("tid", "namp", "len", "sites", "amp", "lstats", "gstats",
                 "ref", "first_amp")

    def __init__(self):
        self.sites = None
        self.amp = None
        self.lstats = None
        self.gstats = None
        self.namp = 0
        self.len = 0
        self.ref = None
        self.first_amp = 0


def count_amplicon(sites) -> int:
    namp = 0
    last_rev = 0
    for e in sites:
        if e.rev == 0 and last_rev:
            namp += 1
        last_rev = e.rev
    return namp + 1


def bed2amplicon(args, sites, amp: list[Amplicon], do_title: bool,
                 ref: str, first_amp: int, out):
    """Collapse BED primers to amplicon interiors + AMPLICON report
    (amplicon_stats.c:217-336).  Returns (namp, max_right) or None."""
    max_right = 0
    last_rev = 0
    j = 0
    if do_title:
        out.write("# Amplicon locations from BED file.\n")
        out.write("# LEFT/RIGHT are <start>-<end> format and "
                  "comma-separated for alt-primers.\n")
        if args["multi_ref"]:
            out.write("#\n# AMPLICON\tREF\tNUMBER\tLEFT\tRIGHT\n")
        else:
            out.write("#\n# AMPLICON\tNUMBER\tLEFT\tRIGHT\n")
    for i, e in enumerate(sites):
        if i == 0 and e.rev != 0:
            sys.stderr.write("[ampliconstats] error: BED file should start"
                             " with the + strand primer\n")
            return None
        if e.rev == 0 and last_rev:
            j += 1
            if j >= args["max_amp"]:
                sys.stderr.write("[ampliconstats] error: too many amplicons"
                                 " (%d). Use -a option to raise this.\n"
                                 % j)
                return None
        if e.rev == 0:
            if i == 0 or last_rev:
                if j > 0:
                    out.write("\n")
                if args["multi_ref"]:
                    out.write("AMPLICON\t%s\t%d" % (ref, j + 1 + first_amp))
                else:
                    out.write("AMPLICON\t%d" % (j + 1))
            if len(amp[j].left) >= MAX_PRIMER_PER_AMPLICON:
                print_error("ampliconstats",
                            "too many primers per amplicon (%d).",
                            MAX_PRIMER_PER_AMPLICON)
                return None
            amp[j].left.append(e.right)
            amp[j].max_left = max(amp[j].max_left, e.right + 1)
            amp[j].min_left = min(amp[j].min_left, e.right + 1)
            out.write("%c%d-%d" % ("\t,"[int(len(amp[j].left) > 1)],
                                   e.left + 1, e.right))
        else:
            if len(amp[j].right) >= MAX_PRIMER_PER_AMPLICON:
                print_error("ampliconstats",
                            "too many primers per amplicon (%d)",
                            MAX_PRIMER_PER_AMPLICON)
                return None
            amp[j].right.append(e.left)
            amp[j].min_right = min(amp[j].min_right, e.left - 1)
            if amp[j].max_right < e.left - 1:
                amp[j].max_right = e.left - 1
                if amp[j].max_right - amp[j].min_left + 1 >= \
                        args["max_amp_len"]:
                    sys.stderr.write(
                        "[ampliconstats] error: amplicon longer (%d) than"
                        " max_amp_len option (%d)\n"
                        % (amp[j].max_right - amp[j].min_left + 2,
                           args["max_amp_len"]))
                    return None
                max_right = max(max_right, amp[j].max_right)
            out.write("%c%d-%d" % ("\t,"[int(len(amp[j].right) > 1)],
                                   e.left + 1, e.right))
        last_rev = e.rev
    if last_rev != 1:
        out.write("\n")
        sys.stderr.write("[ampliconstats] error: bed file does not end on"
                         " a reverse strand primer.\n")
        return None
    namp = j + 1
    if namp:
        out.write("\n")
    if namp >= args["max_amp"]:
        sys.stderr.write("[ampliconstats] error: too many amplicons (%d)."
                         " Use -a option to raise this." % namp)
        return None
    return namp, max_right


def initialise_amp_pos_lookup(args, ra: RefAmps):
    """Position -> amplicon number lookup (amplicon_stats.c:154-194)."""
    max_len = ra.len
    pos2start = np.full(max_len + 1, -1, np.int64)
    pos2end = np.full(max_len + 1, -1, np.int64)
    delta = args["max_delta"]
    if ra.amp:
        for i in range(ra.namp):
            for lp in ra.amp[i].left:
                lo = max(lp - delta, 1)
                hi = min(lp + delta, max_len)
                if hi >= lo:
                    pos2start[lo - 1:hi] = i
            for rp in ra.amp[i].right:
                lo = max(rp - delta, 1)
                hi = min(rp + delta, max_len)
                if hi >= lo:
                    pos2end[lo - 1:hi] = i
    return pos2start, pos2end


def accumulate_stats(args, ra: RefAmps, pos2start, pos2end, flag, start,
                     end, isize, qname):
    """Per-record accumulation (amplicon_stats.c:481-649)."""
    stats = ra.lstats
    amp = ra.amp
    length = ra.len
    if stats is None:
        return

    stats.nseq += 1
    if (flag & args["flag_require"]) != args["flag_require"] or \
            (flag & args["flag_filter"]) != 0:
        stats.nfiltered += 1
        return

    mstart = start
    prev_start = prev_end = 0
    if (flag & F.FPAIRED) and \
            not (flag & (F.FSUPPLEMENTARY | F.FSECONDARY)):
        prev = stats.qend.pop(qname, None)
        if prev is not None:
            prev_start = prev & U32MAX
            prev_end = prev >> 32
            mstart = max(mstart, prev_end)
        else:
            stats.qend[qname] = start | (end << 32)
    hi = min(end, length)
    if mstart < hi:
        stats.depth_all[mstart:hi] += 1
    if hi < end:
        print_error("ampliconstats",
                    "record %s overhangs end of reference", qname)

    if (flag & F.FREVERSE) or not (flag & F.FPAIRED):
        anum = int(pos2end[end - 1]) if 0 <= end - 1 < length else -1
    else:
        anum = int(pos2start[start]) if 0 <= start < length else -1

    if end == start and (args["flag_filter"] & F.FUNMAP):
        stats.nfiltered += 1
        return

    if anum == -1:
        stats.nfailprimer += 1

    if anum >= 0:
        c = min(end, amp[anum].min_right + 1) - max(start,
                                                    amp[anum].max_left)
        if c > 0:
            stats.nreads[anum] += 1
            stats.nbases[anum] += c
            s = max(start, 0)
            e = min(end, length)
            ostart = max(s, amp[anum].min_left - 1)
            oend = min(e, amp[anum].max_right)
            offset = amp[anum].min_left - 1
            if ostart < oend:
                stats.coverage[anum, ostart - offset:oend - offset] += 1
        else:
            stats.nfailprimer += 1

    oth_anum = -1
    if flag & F.FPAIRED:
        t_end = (end if flag & F.FREVERSE else start) + isize
        t_end += -args["tlen_adj"] if isize > 0 else args["tlen_adj"]
        if 0 < t_end < length and isize != 0:
            oth_anum = int(pos2start[t_end]) if flag & F.FREVERSE \
                else int(pos2end[t_end])
    else:
        oth_anum = int(pos2start[start])
        t_end = end

    astatus = 2
    if anum != -1 and oth_anum != -1:
        astatus = 0 if oth_anum == anum else 1
        if start <= t_end:
            stats.amp_dist[anum][astatus] += 1
    elif anum >= 0:
        astatus = 2
        stats.amp_dist[anum][astatus] += 1

    if astatus == 0 and not (flag & (F.FUNMAP | F.FMUNMAP)):
        if prev_end and mstart > prev_end:
            # 2nd read with gap to 1st; undo previous increment
            stats.depth_valid[prev_start:prev_end] -= 1
            stats.nfull_reads[anum] -= 0.5 if flag & F.FPAIRED else 1
        else:
            stats.depth_valid[mstart:end] += 1
            stats.nfull_reads[anum] += 0.5 if flag & F.FPAIRED else 1

    if (flag & F.FPAIRED) and isize <= 0:
        return

    t_end = start + isize - 1 if flag & F.FPAIRED else end
    tcoord = min(start + 1, U32MAX) | (min(t_end + 1, U32MAX) << 32)
    d = stats.tcoord[anum + 1]
    v = d.get(tcoord)
    v = 1 if v is None else v + 1
    d[tcoord] = v | (astatus << 32)


def append_lstats(l: AStats, g: AStats, namp: int, all_nseq: int):
    """amplicon_stats.c:653-713."""
    g.nseq += l.nseq
    g.nfiltered += l.nfiltered
    g.nfailprimer += l.nfailprimer
    for a in range(-1, namp):
        gl = g.tcoord[a + 1]
        for k, v in l.tcoord[a + 1].items():
            if v == 0:
                continue
            gl[k] = ((gl[k] & U32MAX) if k in gl else 0) + v
        if a == -1:
            continue
        g.nreads[a] += l.nreads[a]
        g.nreads2[a] += l.nreads[a] * l.nreads[a]
        g.nfull_reads[a] += l.nfull_reads[a]
        nrperc = 100.0 * l.nreads[a] / all_nseq if all_nseq else 0.0
        g.nrperc[a] += nrperc
        g.nrperc2[a] += nrperc * nrperc
        g.nbases[a] += l.nbases[a]
        g.nbases2[a] += l.nbases[a] * l.nbases[a]
        for d in range(MAX_DEPTH):
            g.covered_perc[a][d] += l.covered_perc[a][d]
            g.covered_perc2[a][d] += l.covered_perc[a][d] ** 2
        for d in range(3):
            g.amp_dist[a][d] += l.amp_dist[a][d]
    g.depth_valid[:l.max_len] += l.depth_valid[:l.max_len]
    g.depth_all[:l.max_len] += l.depth_all[:l.max_len]


def aggregate_tcoord(args, tpos: list):
    """Cluster near-identical template coords (amplicon_stats.c:771-838)."""
    tbin = args["tcoord_bin"]
    tpos.sort(key=lambda t: (-t[2], t[0], t[1]))
    n = len(tpos)
    j = 0
    while j < n:
        j2 = j + 1
        while j2 < n:
            if tpos[j][2] != tpos[j2][2]:
                break
            if tpos[j2][0] - tpos[j][0] >= tbin:
                break
            j2 += 1
        if j2 - 1 > j:
            m = (j2 - 1 + j) // 2
            while m > 1 and tpos[m][0] == tpos[m - 1][0]:
                m -= 1
            j3 = m + 1
            while j3 < j2:
                if tpos[m][0] != tpos[j3][0]:
                    break
                if tpos[m][1] - tpos[j3][1] >= tbin:
                    break
                j3 += 1
            if j3 - 1 > m:
                m = (j3 - 1 + m) // 2
            tpos[j], tpos[m] = tpos[m], tpos[j]
            j = j2 - 1
        j += 1
    k = 0
    for j in range(n):
        if not tpos[j][2]:
            continue
        if k < j:
            tpos[k] = tpos[j]
        for j2 in range(j + 1, n):
            if abs(tpos[k][0] - tpos[j2][0]) < tbin // 2 and \
                    abs(tpos[k][1] - tpos[j2][1]) < tbin // 2 and \
                    tpos[k][3] == tpos[j2][3]:
                tpos[k] = (tpos[k][0], tpos[k][1],
                           tpos[k][2] + tpos[j2][2], tpos[k][3])
                tpos[j2] = (tpos[j2][0], tpos[j2][1], 0, tpos[j2][3])
        k += 1
    del tpos[k:]


def _rle_depth_row(out, depth, length, depth_bin):
    """Run-length encode a depth track (amplicon_stats.c:1143-1168)."""
    i = 0
    while i < length:
        dmin = dmax = int(depth[i])
        dmid = (dmin + dmax) / 2.0
        low = dmid * (1 - depth_bin)
        high = dmid * (1 + depth_bin)
        j = i + 1
        while j < length:
            d = int(depth[j])
            if d < low or d > high:
                break
            if dmin > d:
                dmin = d
                dmid = (dmin + dmax) / 2.0
                low = dmid * (1 - depth_bin)
                high = dmid * (1 + depth_bin)
            elif dmax < d:
                dmax = d
                dmid = (dmin + dmax) / 2.0
                low = dmid * (1 - depth_bin)
                high = dmid * (1 + depth_bin)
            j += 1
        out.write("\t%d,%d" % (int(dmid), j - i))
        i = j


def dump_stats(args, type_: str, name: str, nfile: int,
               amps: list[RefAmps], nref: int, local: bool, out) -> int:
    """One F/C report section set (amplicon_stats.c:840-1309)."""
    def st(r):
        return amps[r].lstats if local else amps[r].gstats

    out.write("# Summary stats.\n")
    out.write("# Use 'grep ^%cSS | cut -f 2-' to extract this part.\n"
              % type_)
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        nmatch = stats.nseq - stats.nfiltered - stats.nfailprimer
        name_ref = "%s\t%s" % (name, amps[r].ref) if args["multi_ref"] \
            else name
        out.write("%cSS\t%s\traw total sequences:\t%d\n"
                  % (type_, name_ref, stats.nseq))
        out.write("%cSS\t%s\tfiltered sequences:\t%d\n"
                  % (type_, name_ref, stats.nfiltered))
        out.write("%cSS\t%s\tfailed primer match:\t%d\n"
                  % (type_, name_ref, stats.nfailprimer))
        out.write("%cSS\t%s\tmatching sequences:\t%d\n"
                  % (type_, name_ref, nmatch))
        d = 0
        while True:
            start = covered = total = 0
            amp = amps[r].amp
            for i in range(amps[r].namp):
                offset = amp[i].min_left - 1
                if amp[i].min_right - amp[i].min_left > stats.max_amp_len:
                    sys.stderr.write(
                        "[ampliconstats] error: Maximum amplicon length"
                        " (%d) exceeded for '%s'\n"
                        % (stats.max_amp, name))
                    return -1
                for j in range(max(start, amp[i].max_left - 1),
                               max(start, amp[i].min_right)):
                    if stats.coverage[i, j - offset] >= \
                            args["min_depth"][d]:
                        covered += 1
                    total += 1
                start = max(start, amp[i].min_right)
            out.write("%cSS\t%s\tconsensus depth count < %d and >= %d:\t"
                      "%d\t%d\n" % (type_, name_ref, args["min_depth"][d],
                                    args["min_depth"][d], total - covered,
                                    covered))
            d += 1
            if not (d < MAX_DEPTH and args["min_depth"][d]):
                break

    out.write("# Absolute matching read counts per amplicon.\n")
    out.write("# Use 'grep ^%cREADS | cut -f 2-' to extract this part.\n"
              % type_)
    out.write("%cREADS\t%s" % (type_, name))
    for r in range(nref):
        if not amps[r].sites:
            continue
        for i in range(amps[r].namp):
            out.write("\t%d" % st(r).nreads[i])
    out.write("\n")

    out.write("%cVDEPTH\t%s" % (type_, name))
    for r in range(nref):
        if not amps[r].sites:
            continue
        for i in range(amps[r].namp):
            out.write("\t%d" % int(st(r).nfull_reads[i]))
    out.write("\n")

    if type_ == "C":
        out.write("CREADS\tMEAN")
        for r in range(nref):
            if not amps[r].sites:
                continue
            for i in range(amps[r].namp):
                out.write("\t%.1f" % (st(r).nreads[i] / nfile))
        out.write("\n")
        out.write("CREADS\tSTDDEV")
        for r in range(nref):
            if not amps[r].sites:
                continue
            stats = st(r)
            for i in range(amps[r].namp):
                n1 = float(stats.nreads[i])
                v = (math.sqrt(stats.nreads2[i] / nfile
                               - (n1 / nfile) ** 2)
                     if nfile > 1 and stats.nreads2[i] > 0 else 0)
                out.write("\t%.1f" % v)
        out.write("\n")

    out.write("# Read percentage of distribution between amplicons.\n")
    out.write("# Use 'grep ^%cRPERC | cut -f 2-' to extract this part.\n"
              % type_)
    out.write("%cRPERC\t%s" % (type_, name))
    all_nseq = 0
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        all_nseq += stats.nseq - stats.nfiltered - stats.nfailprimer
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        for i in range(amps[r].namp):
            if type_ == "C":
                out.write("\t%.3f" % (stats.nrperc[i] / nfile))
            else:
                out.write("\t%.3f" % (100.0 * stats.nreads[i] / all_nseq
                                      if all_nseq else 0))
    out.write("\n")

    if type_ == "C":
        out.write("CRPERC\tMEAN")
        for r in range(nref):
            if not amps[r].sites:
                continue
            for i in range(amps[r].namp):
                out.write("\t%.3f" % (st(r).nrperc[i] / nfile))
        out.write("\n")
        out.write("CRPERC\tSTDDEV")
        for r in range(nref):
            if not amps[r].sites:
                continue
            stats = st(r)
            for i in range(amps[r].namp):
                n1 = stats.nrperc[i]
                v = stats.nrperc2[i] / nfile - (n1 / nfile) ** 2
                out.write("\t%.3f" % (math.sqrt(v) if v > 0 else 0))
        out.write("\n")

    out.write("# Read depth per amplicon.\n")
    out.write("# Use 'grep ^%cDEPTH | cut -f 2-' to extract this part.\n"
              % type_)
    out.write("%cDEPTH\t%s" % (type_, name))
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        amp = amps[r].amp
        for i in range(amps[r].namp):
            nseq = stats.nseq - stats.nfiltered - stats.nfailprimer
            alen = amp[i].min_right - amp[i].max_left + 1
            out.write("\t%.1f" % (stats.nbases[i] / alen if nseq else 0))
    out.write("\n")

    if type_ == "C":
        out.write("CDEPTH\tMEAN")
        for r in range(nref):
            if not amps[r].sites:
                continue
            stats = st(r)
            amp = amps[r].amp
            nseq = stats.nseq - stats.nfiltered - stats.nfailprimer
            for i in range(amps[r].namp):
                alen = amp[i].min_right - amp[i].max_left + 1
                out.write("\t%.1f" % (stats.nbases[i] / alen / nfile
                                      if nseq else 0))
        out.write("\n")
        out.write("CDEPTH\tSTDDEV")
        for r in range(nref):
            if not amps[r].sites:
                continue
            stats = st(r)
            amp = amps[r].amp
            for i in range(amps[r].namp):
                alen = float(amp[i].min_right - amp[i].max_left + 1)
                n1 = stats.nbases[i] / alen
                v = stats.nbases2[i] / (alen * alen) / nfile \
                    - (n1 / nfile) ** 2
                out.write("\t%.1f" % (math.sqrt(v) if v > 0 else 0))
        out.write("\n")

    if type_ == "F":
        out.write("# Percentage coverage per amplicon\n")
        out.write("# Use 'grep ^%cPCOV | cut -f 2-' to extract this "
                  "part.\n" % type_)
        d = 0
        while True:
            out.write("%cPCOV-%d\t%s" % (type_, args["min_depth"][d],
                                         name))
            for r in range(nref):
                if not amps[r].sites:
                    continue
                stats = st(r)
                amp = amps[r].amp
                for i in range(amps[r].namp):
                    covered = 0
                    if amp[i].min_right - amp[i].min_left > \
                            stats.max_amp_len:
                        sys.stderr.write(
                            "[ampliconstats] error: Maximum amplicon"
                            " length (%d) exceeded for '%s'\n"
                            % (stats.max_amp, name))
                        return -1
                    offset = amp[i].min_left - 1
                    for j in range(amp[i].max_left - 1,
                                   amp[i].min_right):
                        if stats.coverage[i, j - offset] >= \
                                args["min_depth"][d]:
                            covered += 1
                    alen = amp[i].min_right - amp[i].max_left + 1
                    stats.covered_perc[i][d] = 100.0 * covered / alen
                    out.write("\t%.2f" % (100.0 * covered / alen))
            out.write("\n")
            d += 1
            if not (d < MAX_DEPTH and args["min_depth"][d]):
                break
    elif type_ == "C":
        d = 0
        while True:
            out.write("CPCOV-%d\tMEAN" % args["min_depth"][d])
            for r in range(nref):
                if not amps[r].sites:
                    continue
                stats = st(r)
                for i in range(amps[r].namp):
                    out.write("\t%.1f" % (stats.covered_perc[i][d]
                                          / nfile))
            out.write("\n")
            out.write("CPCOV-%d\tSTDDEV" % args["min_depth"][d])
            for r in range(nref):
                if not amps[r].sites:
                    continue
                stats = st(r)
                for i in range(amps[r].namp):
                    n1 = stats.covered_perc[i][d] / nfile
                    v = stats.covered_perc2[i][d] / nfile - n1 * n1
                    out.write("\t%.1f" % (math.sqrt(v) if v > 0 else 0))
            out.write("\n")
            d += 1
            if not (d < MAX_DEPTH and args["min_depth"][d]):
                break

    out.write("# Depth per reference base for ALL data.\n")
    out.write("# Use 'grep ^%cDP_ALL | cut -f 2-' to extract this part.\n"
              % type_)
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        if args["multi_ref"]:
            out.write("%cDP_ALL\t%s\t%s" % (type_, name, amps[r].ref))
        else:
            out.write("%cDP_ALL\t%s" % (type_, name))
        _rle_depth_row(out, stats.depth_all, amps[r].len,
                       args["depth_bin"])
        out.write("\n")

    out.write("# Depth per reference base for full-length valid amplicon"
              " data.\n")
    out.write("# Use 'grep ^%cDP_VALID | cut -f 2-' to extract this "
              "part.\n" % type_)
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        if args["multi_ref"]:
            out.write("%cDP_VALID\t%s\t%s" % (type_, name, amps[r].ref))
        else:
            out.write("%cDP_VALID\t%s" % (type_, name))
        _rle_depth_row(out, stats.depth_valid, amps[r].len,
                       args["depth_bin"])
        out.write("\n")

    out.write("# Distribution of aligned template coordinates.\n")
    out.write("# Use 'grep ^%cTCOORD | cut -f 2-' to extract this part.\n"
              % type_)
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        start_i = -1 if nref == 1 else 0
        for i in range(start_i, amps[r].namp):
            tpos = []
            for key, val in stats.tcoord[i + 1].items():
                if (val & U32MAX) == 0:
                    continue
                tpos.append((key & U32MAX, key >> 32, val & U32MAX,
                             val >> 32))
            if args["tcoord_bin"] > 1:
                aggregate_tcoord(args, tpos)
            out.write("%cTCOORD\t%s\t%d" % (type_, name,
                                            i + 1 + amps[r].first_amp))
            for t in tpos:
                if t[2] < args["tcoord_min_count"]:
                    continue
                out.write("\t%d,%d,%u,%u" % t)
            out.write("\n")

    out.write("# Classification of amplicon status.  Columns are\n")
    out.write("# number with both primers from this amplicon, number "
              "with\n")
    out.write("# primers from different amplicon, and number with a "
              "position\n")
    out.write("# not matching any valid amplicon primer site\n")
    out.write("# Use 'grep ^%cAMP | cut -f 2-' to extract this part.\n"
              % type_)
    out.write("%cAMP\t%s\t0" % (type_, name))
    amp_dist = [0, 0, 0]
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        for i in range(amps[r].namp):
            for d in range(3):
                amp_dist[d] += int(stats.amp_dist[i][d])
    out.write("\t%d\t%d\t%d\n" % tuple(amp_dist))
    for r in range(nref):
        if not amps[r].sites:
            continue
        stats = st(r)
        for i in range(amps[r].namp):
            out.write("%cAMP\t%s\t%d" % (type_, name,
                                         i + 1 + amps[r].first_amp))
            out.write("\t%d\t%d\t%d\n" % (stats.amp_dist[i][0],
                                          stats.amp_dist[i][1],
                                          stats.amp_dist[i][2]))
    return 0


def sample_name_for(path: str, header, use_sample_name: bool) -> str:
    if use_sample_name:
        sm = header.find_tag_values("RG", "SM")
        if sm:
            return sm[0]
    base = os.path.basename(path)
    for ext in (".bam", ".sam", ".cram"):
        if base.endswith(ext):
            return base[:-len(ext)]
    return base


USAGE = """
Usage: samtools ampliconstats [options] primers.bed *.bam > astats.txt

Options:
  -f, --required-flag STR|INT
  -F, --filter-flag STR|INT
  -a, --max-amplicons INT
  -l, --max-amplicon-length INT
  -d, --min-depth INT[,INT]...
  -m, --pos-margin INT
  -o, --output FILE
  -s, --use-sample-name
  -t, --tlen-adjust INT
  -b, --tcoord-bin INT
  -c, --tcoord-min-count INT
  -D, --depth-bin FRACTION
  -S, --single-ref
"""

LONGOPTS = ["help", "flag-require=", "flag-filter=", "min-depth=",
            "output=", "pos-margin=", "use-sample-name", "max-amplicons=",
            "max-amplicon-length=", "tlen-adjust=", "tcoord-min-count=",
            "tcoord-bin=", "depth-bin=", "single-ref"]


def main_ampliconstats(argv: list[str]) -> int:
    ga = GlobalArgs()
    args = {
        "flag_require": 0,
        "flag_filter": 0x10B04,
        "max_delta": 30,
        "min_depth": [1, 0, 0, 0, 0],
        "use_sample_name": 0,
        "max_amp": MAX_AMP,
        "max_amp_len": MAX_AMP_LEN,
        "tlen_adj": 0,
        "tcoord_min_count": TCOORD_MIN_COUNT,
        "tcoord_bin": 1,
        "depth_bin": 0.01,
        "multi_ref": 1,
    }
    out = sys.stdout
    try:
        opts, rest = gnu_getopt(argv, "hf:F:@:p:m:d:sa:l:t:o:c:b:D:S",
                                LONGOPTS)
    except UsageError:
        sys.stderr.write(USAGE)
        return 1
    try:
        for o, v in opts:
            if o in ("-f", "--flag-require"):
                fl = str2flag(v)
                if fl < 0:
                    print_error("ampliconstats", "Unknown flag '%s'\n", v)
                    return 1
                args["flag_require"] = fl
            elif o in ("-F", "--flag-filter"):
                fl = str2flag(v)
                if args["flag_filter"] & 0x10000:
                    args["flag_filter"] = 0
                if fl < 0:
                    print_error("ampliconstats", "Unknown flag '%s'\n", v)
                    return 1
                args["flag_filter"] |= fl
            elif o in ("-m", "--pos-margin"):
                args["max_delta"] = int(v)
            elif o in ("-D", "--depth-bin"):
                args["depth_bin"] = float(v)
            elif o in ("-d", "--min-depth"):
                for i, p in enumerate(v.split(",")[:MAX_DEPTH]):
                    args["min_depth"][i] = int(p)
            elif o in ("-a", "--max-amplicons"):
                args["max_amp"] = int(v) + 1
            elif o in ("-l", "--max-amplicon-length"):
                args["max_amp_len"] = int(v) + 1
            elif o in ("-c", "--tcoord-min-count"):
                args["tcoord_min_count"] = int(v)
            elif o in ("-b", "--tcoord-bin"):
                args["tcoord_bin"] = max(int(v), 1)
            elif o in ("-t", "--tlen-adjust"):
                args["tlen_adj"] = int(v)
            elif o in ("-s", "--use-sample-name"):
                args["use_sample_name"] = 1
            elif o == "-o":
                # a later -o opens another file; the earlier one stays
                # empty
                if out is not sys.stdout:
                    out.close()
                try:
                    out = open(v, "w")
                except OSError as e:
                    out = sys.stdout
                    sys.stderr.write("%s: %s\n" % (v, e.strerror))
                    return 1
            elif o in ("-S", "--single-ref"):
                args["multi_ref"] = 0
            elif o in ("-h", "--help"):
                sys.stdout.write(USAGE)
                return 0
            elif not handle_global_opt(ga, o, v):
                # --output and -p, which USAGE and the short options
                # name but nothing handles, are refused
                sys.stderr.write(USAGE)
                return 1

        if not rest:
            sys.stdout.write(USAGE)
            return 0
        return _run(args, ga, argv, rest, out)
    finally:
        if out is not sys.stdout:
            out.close()


def _run(args: dict, ga: GlobalArgs, argv: list[str], rest: list[str],
         out) -> int:
    """The report of the BED file ``rest[0]`` over the files after it
    (standard input when none) into ``out``."""
    loaded = load_bed_multi_ref(rest[0], True, sort_by_pos=False)
    if loaded is None:
        print_error_errno("ampliconstats",
                          'Could not read file "%s"', rest[0])
        return 1
    bed_lists = loaded[0]
    if len(bed_lists) > 1 and not args["multi_ref"]:
        print_error("ampliconstats",
                    "Single-ref mode is not permitted for BED files\n"
                    "containing more than one reference.")
        return 1

    files = rest[1:] if len(rest) > 1 else ["-"]

    # the first file's header sets the contigs and the SS block
    try:
        f0 = read_alignments(files[0], threads=ga.nthreads)
    except Exception:
        print_error_errno("ampliconstats",
                          'Cannot open input file "%s"', files[0])
        return 1
    header0 = f0.header
    nref = header0.n_refs
    amps = [RefAmps() for _ in range(nref)]
    out.write("# Summary statistics, used for scaling the plots.\n")
    out.write("SS\tSamtools version: %s\n" % SAMTOOLS_PARITY_VERSION)
    out.write("SS\tCommand line: %s\n" % ("ampliconstats "
                                            + " ".join(argv)))
    out.write("SS\tNumber of files:\t%d\n" % len(files))
    for i in range(nref):
        rn = header0.ref_name(i)
        if rn not in bed_lists:
            continue
        ra = amps[i]
        ra.tid = i
        ra.ref = rn
        ra.sites = bed_lists[rn]
        ra.namp = count_amplicon(ra.sites)
        ra.amp = [Amplicon() for _ in range(len(ra.sites))]
        if args["multi_ref"]:
            out.write("SS\tNumber of amplicons:\t%s\t%d\n"
                      % (rn, ra.namp))
        else:
            out.write("SS\tNumber of amplicons:\t%d\n" % ra.namp)
        ra.len = header0.ref_lens[i]
        if args["multi_ref"]:
            out.write("SS\tReference length:\t%s\t%d\n" % (rn, ra.len))
        else:
            out.write("SS\tReference length:\t%d\n" % ra.len)
        ra.lstats = AStats(ra.len, args["max_amp"], args["max_amp_len"])
        ra.gstats = AStats(ra.len, args["max_amp"], args["max_amp_len"])
    out.write("SS\tEnd of summary\n")

    offset = 0
    first_title = True
    for i in range(nref):
        if not amps[i].sites:
            continue
        amps[i].first_amp = offset
        res = bed2amplicon(args, amps[i].sites, amps[i].amp,
                           first_title, amps[i].ref, offset, out)
        first_title = False
        if res is None:
            return 1
        amps[i].namp = res[0]
        offset += amps[i].namp

    nfile = len(files)
    for fi, path in enumerate(files):
        try:
            fa = f0 if fi == 0 else read_alignments(path,
                                                    threads=ga.nthreads)
        except Exception:
            print_error_errno("ampliconstats",
                              'Cannot open input file "%s"', path)
            return 1
        header = fa.header
        if header.n_refs != nref:
            print_error("ampliconstats",
                        "SAM headers are not consistent across input"
                        " files")
            return 1
        for r in range(nref):
            if not amps[r].sites:
                continue
            if amps[r].ref != header.ref_name(r) or \
                    amps[r].len != header.ref_lens[r]:
                print_error("ampliconstats",
                            "SAM headers are not consistent across "
                            "input files")
                return 1
        sname = sample_name_for(path, header, args["use_sample_name"])

        for r in range(nref):
            if amps[r].sites:
                amps[r].lstats.reset()

        b = fa.batch
        # bam_endpos semantics: pos + rlen for mapped reads WITH a cigar
        # (even if rlen is 0, e.g. 100% soft-clipped), else pos + 1
        spans = b.ref_span()
        has_cig = b.n_cigar > 0
        mapped = (b.flag & F.FUNMAP) == 0
        ends = b.pos + np.where(mapped & has_cig, spans, 1)
        last_ref = -9
        pos2start = pos2end = None
        for ri in range(b.n):
            tid = int(b.tid[ri])
            if tid < 0:
                continue
            if last_ref != tid:
                last_ref = tid
                pos2start, pos2end = initialise_amp_pos_lookup(args,
                                                               amps[tid])
            accumulate_stats(args, amps[tid], pos2start, pos2end,
                             int(b.flag[ri]), int(b.pos[ri]),
                             int(ends[ri]), int(b.tlen[ri]),
                             b.qname_str(ri))

        if dump_stats(args, "F", sname, nfile, amps, nref, True,
                      out) < 0:
            return 1

        all_nseq = 0
        for r in range(nref):
            if not amps[r].sites:
                continue
            s = amps[r].lstats
            all_nseq += s.nseq - s.nfiltered - s.nfailprimer
        for r in range(nref):
            if amps[r].sites:
                append_lstats(amps[r].lstats, amps[r].gstats,
                              amps[r].namp, all_nseq)

    if dump_stats(args, "C", "COMBINED", nfile, amps, nref, False,
                  out) < 0:
        return 1
    return 0
