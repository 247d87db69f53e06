"""samtools coverage on the port: the per-contig table.

Counterpart of samtools_tpu/tools/coverage_cmd.py (``usage``,
``readable_bps``, ``qlen_query``, ``_tab_line``, ``main_coverage``'s
tabular branches and ``_coverage_streamed``); its output is the JAX
tool's host branch, byte for byte.  Without ``-r`` the BAMs stream
through ``WindowedReader`` in windows of 1 Mi columns; with ``-r`` they
are read whole and the region is scanned in windows of 16 Mi columns.
Each window's census runs through ``coverage_window_device`` (K1's
generic form and the coverage reduction, on the card), or with
``SAMTPU_DEVICE=0|host`` through the numpy ``window_host``.  Both sum
every quality whole and in int64; the JAX package's device branch caps a
base's quality at 127 and sums in int32.  ``-m``/``-D`` (the terminal
histograms, ``_coverage_hist``) read the files whole and build each
contig's pileup table (``ops.pileup.build_pileup``, ordered by K13 on the
card, or by the host's numpy sort with ``SAMTPU_DEVICE=0|host``).  When
any input is not a BGZF BAM (SAM text, gzip'd SAM, standard input) every
file is read whole, as in the JAX tool; ``-r`` never reads an index
there either.  A CRAM is such an input: it is decoded whole on the host
(``io/cram_decode.py``).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import flags as F
from ..core.batch import ragged_gather_indices
from ..core.regions import RegionError, parse_region
from ..io.files import read_alignments
from ..io.stream import WindowedReader
from ..ops.cigar import expand_ops
from ..ops.pileup import build_pileup
from ..ops.pileup_engine import coverage_window_device
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, open_streams, pick_device,
                     print_error, print_error_errno)
from .flags_cmd import str2flag

DEFAULT_FF = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP

# columns per window: streamed, and of the -r scan
STREAM_COLS = 1 << 20
REGION_COLS = 16 << 20

BLOCK8 = ["\u2581", "\u2582", "\u2583", "\u2584", "\u2585", "\u2586",
          "\u2587", "\u2588"]
BLOCK2 = [".", ":"]


def usage(fp):
    fp.write(
        "Usage: samtools coverage [options] in1.bam [in2.bam [...]]\n\n"
        "Input options:\n"
        "  -b, --bam-list FILE     list of input BAM filenames, one per line\n"
        "  -l, --min-read-len INT  ignore reads shorter than INT bp [0]\n"
        "  -q, --min-MQ INT        mapping quality threshold [0]\n"
        "  -Q, --min-BQ INT        base quality threshold [0]\n"
        "  --rf <int|str>          required flags: skip reads with mask bits unset []\n"
        "  --ff <int|str>          filter flags: skip reads with mask bits set\n"
        "                                      [UNMAP,SECONDARY,QCFAIL,DUP]\n"
        "  -d, --depth INT         maximum allowed coverage depth [1000000]\n"
        "  --min-depth INT         minimum coverage depth below which a position is ignored [1]\n"
        "  -r, --region REG        show specified region.\n"
        "\nOutput options:\n"
        "  -m, --histogram         show histogram instead of tabular output\n"
        "  -A, --ascii             show only ASCII characters in histogram\n"
        "  -D, --plot-depth        plot depth instead of tabular output\n"
        "  -o, --output FILE       write output to FILE [stdout]\n"
        "  -H, --no-header         don't print a header in tabular mode\n"
        "  -w, --n-bins INT        number of bins in histogram [terminal width - 40]\n"
        "  -h, --help              help (this page)\n")


def readable_bps(n: float) -> str:
    units = ["", "K", "M", "G", "T"]
    i = 0
    while n >= 1000 and i < 4:
        n /= 1000
        i += 1
    return "%.*f%s" % (i, n, units[i])


def qlen_query(batch) -> np.ndarray:
    """bam_cigar2qlen: the bases of the query-consuming ops."""
    ops = (batch.cigar & 0xF).astype(np.int64)
    lens = (batch.cigar >> 4).astype(np.int64)
    cq = np.array(F.CIGAR_CONSUMES_QUERY, np.int64)
    csum = np.concatenate([[0], np.cumsum(lens * cq[ops])])
    return csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]


class _Stats:
    """coverage.c's per-contig accumulators."""

    def __init__(self, n: int):
        (self.n_reads, self.n_selected, self.summed_mapq, self.n_cov_bases,
         self.summed_cov, self.summed_baseq) = (np.zeros(n, np.int64)
                                                for _ in range(6))

    def select(self, b, fail_flags, required_flags, min_mapq, min_len):
        """Count one batch's reads; the mask of the kept placed reads."""
        fl = b.flag.astype(np.int64)
        placed = b.tid >= 0
        np.add.at(self.n_reads, b.tid[placed], 1)
        keep = np.ones(b.n, bool)
        if fail_flags:
            keep &= (fl & fail_flags) == 0
        if required_flags:
            keep &= (fl & required_flags) != 0
        keep &= b.mapq.astype(np.int64) >= min_mapq
        if min_len:
            keep &= qlen_query(b) >= min_len
        kp = keep & placed
        np.add.at(self.n_selected, b.tid[kp], 1)
        np.add.at(self.summed_mapq, b.tid[kp], b.mapq[kp].astype(np.int64))
        return kp

    def add(self, t: int, acc: np.ndarray):
        """Add one window's (n_cov_bases, summed_cov, summed_baseq)."""
        self.n_cov_bases[t] += acc[0]
        self.summed_cov[t] += acc[1]
        self.summed_baseq[t] += acc[2]

    def line(self, out, header, t, beg, end, hdr_flag):
        """One table row (and the header before the first)."""
        if hdr_flag[0]:
            out.write("#rname\tstartpos\tendpos\tnumreads\tcovbases\t"
                      "coverage\tmeandepth\tmeanbaseq\tmeanmapq\n")
            hdr_flag[0] = False
        # the quality bases are the depth summed over the counted positions
        _tab_line(out, header.ref_names[t], beg, end, self.n_selected[t],
                  self.n_cov_bases[t], self.summed_cov[t],
                  self.summed_baseq[t], self.summed_cov[t],
                  self.summed_mapq[t])


def _tab_line(out, name, beg, end, n_selected, n_cov_bases, summed_cov,
              summed_baseq, quality_bases, summed_mapq):
    L = float(end - beg)
    out.write("%s\t%d\t%d\t%d\t%d\t%g\t%g\t%.3g\t%.3g\n" % (
        name, beg + 1, end, n_selected, n_cov_bases,
        100.0 * n_cov_bases / L if L else 0,
        summed_cov / L if L else 0,
        summed_baseq / quality_bases if quality_bases > 0 else 0,
        summed_mapq / n_selected if n_selected > 0 else 0))


def window_host(parts, wb: int, we: int, min_baseq: int,
                min_depth: int) -> np.ndarray:
    """The numpy census of one window across files: int64
    (n_cov_bases, summed_cov, summed_baseq) over the positions of
    [wb, we) with some pileup entry (an M/=/X/D/N base) and an okq count
    (M bases of quality >= min_baseq) > 0 and >= min_depth.

    parts: iterable of (batch, sel) pairs, one per input file."""
    L = we - wb
    depth = np.zeros(L, np.int64)
    bq_sum = np.zeros(L, np.int64)
    vis = np.zeros(L, np.int64)
    for b, sel in parts:
        if sel.size == 0:
            continue
        sub = b.take(sel, ragged=("cigar", "qual"))
        t = expand_ops(sub)
        e_ops = np.nonzero(np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF,
                                          F.CDEL, F.CREF_SKIP)))[0]
        e_len = t.oplen[e_ops]
        pos = ragged_gather_indices(t.rpos[e_ops], e_len)
        inw = (pos >= wb) & (pos < we)
        is_m_e = np.repeat(np.isin(t.op[e_ops], (F.CMATCH, F.CEQUAL,
                                                 F.CDIFF)), e_len)
        rid = np.repeat(t.rid[e_ops], e_len)
        qpos = ragged_gather_indices(t.qpos[e_ops], e_len)
        rel = pos - wb
        vis += np.bincount(rel[inw], minlength=L)
        mb = inw & is_m_e
        qm = sub.qual[sub.seq_off[rid[mb]] + qpos[mb]].astype(np.int64)
        okq = qm >= min_baseq
        pr = rel[mb][okq]
        depth += np.bincount(pr, minlength=L)
        # float64 sums of 8-bit qualities: exact far past any depth
        bq_sum += np.bincount(pr, weights=qm[okq], minlength=L).astype(
            np.int64)
    ok = (vis > 0) & (depth > 0) & (depth >= min_depth)
    return np.array([ok.sum(), depth[ok].sum(), bq_sum[ok].sum()], np.int64)


def _window(dev, parts, wb, we, min_baseq, min_depth) -> np.ndarray:
    if dev is None:
        return window_host(parts, wb, we, min_baseq, min_depth)
    return coverage_window_device(parts, wb, we, min_baseq, min_depth,
                                  device=dev)


def main_coverage(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    min_len = 0
    min_mapq = 0
    min_baseq = 0
    required_flags = 0
    fail_flags = DEFAULT_FF
    min_depth = 1
    reg = None
    file_list = None
    out_file = None
    print_header = True
    histogram = plot_depth = False
    full_utf = full_width = True
    n_bins = -1
    try:
        opts, args = gnu_getopt(argv, "o:l:q:Q:hHw:r:b:mAd:D",
                                ["rf=", "ff=", "incl-flags=", "excl-flags=",
                                 "bam-list=", "min-read-len=", "min-MQ=",
                                 "min-mq=", "min-BQ=", "min-bq=",
                                 "histogram", "ascii", "plot-depth",
                                 "output=", "no-header", "n-bins=",
                                 "region=", "help", "depth=", "min-depth="])
    except UsageError:
        usage(sys.stdout)
        return 1
    for o, v in opts:
        if o in ("--rf", "--incl-flags"):
            required_flags = str2flag(v)
        elif o in ("--ff", "--excl-flags"):
            fail_flags = str2flag(v)
        elif o == "--min-depth":
            min_depth = int(v)
        elif o in ("-o", "--output"):
            out_file = v
            full_width = False
        elif o in ("-l", "--min-read-len"):
            min_len = int(v)
        elif o in ("-q", "--min-MQ", "--min-mq"):
            min_mapq = int(v)
        elif o in ("-Q", "--min-BQ", "--min-bq"):
            min_baseq = int(v)
        elif o in ("-d", "--depth"):
            int(v)   # the depth cap: no cap here (as the JAX tool)
        elif o in ("-w", "--n-bins"):
            n_bins = int(v)
            full_width = False
        elif o in ("-r", "--region"):
            reg = v
        elif o in ("-b", "--bam-list"):
            file_list = v
        elif o in ("-m", "--histogram"):
            histogram = True
        elif o in ("-D", "--plot-depth"):
            histogram = plot_depth = True
        elif o in ("-A", "--ascii"):
            full_utf = False
        elif o in ("-H", "--no-header"):
            print_header = False
        elif o in ("-h", "--help"):
            usage(sys.stdout)
            return 0
        elif not handle_global_opt(ga, o, v):
            usage(sys.stdout)
            return 1
    if file_list:
        try:
            args = [l.strip() for l in open(file_list) if l.strip()] + args
        except OSError as e:
            print_error_errno("coverage", 'Cannot open file list "%s".',
                              file_list, exc=e)
            return 1
    if not args:
        usage(sys.stdout)
        return 1
    if n_bins <= 0 or full_width:
        cols = int(os.environ.get("COLUMNS", "0") or 0)
        n_bins = cols - 40 if cols > 60 else 40
    try:
        dev = pick_device(device)
    except RuntimeError as e:
        return no_card("coverage", e)

    # no-region tables stream in bounded windows; -r, the histograms,
    # standard input and SAM read whole files
    streams = []
    if reg is None and not histogram:
        try:
            streams = open_streams(args, ga.nthreads)
        except OSError as e:
            print_error_errno("coverage", 'Could not open "%s"', e.filename,
                              exc=e)
            return 1
    if streams:
        out = open(out_file, "w") if out_file and out_file != "-" \
            else sys.stdout
        try:
            return _coverage_streamed(streams, dev, fail_flags,
                                      required_flags, min_mapq, min_len,
                                      min_baseq, min_depth, out,
                                      print_header)
        finally:
            for st in streams:
                st.close()
            if out is not sys.stdout:
                out.close()

    files = []
    for path in args:
        try:
            files.append(read_alignments(path, threads=ga.nthreads))
        except OSError as e:
            print_error_errno("coverage", 'Could not open "%s"', path,
                              exc=e)
            return 1
    header = files[0].header
    region = None
    if reg:
        try:
            region = parse_region(reg, header.tid)
        except RegionError:
            print_error("coverage", 'Failed to parse region "%s".', reg)
            return 1
    out = open(out_file, "w") if out_file and out_file != "-" \
        else sys.stdout
    try:
        if histogram:
            _coverage_hist(files, header, region, dev, fail_flags,
                           required_flags, min_mapq, min_len, min_baseq,
                           min_depth, out, n_bins, full_utf, plot_depth)
        else:
            _coverage_in_memory(files, header, region, dev, fail_flags,
                                required_flags, min_mapq, min_len,
                                min_baseq, min_depth, out, print_header)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _coverage_in_memory(files, header, region, dev, fail_flags,
                        required_flags, min_mapq, min_len, min_baseq,
                        min_depth, out, print_header) -> None:
    """Whole files in memory (``-r``, or standard input): each contig's
    span, or the region, in windows of REGION_COLS columns clipped to the
    reads' extent."""
    n_targets = header.n_refs
    stats = _Stats(n_targets)
    selected = [stats.select(f.batch, fail_flags, required_flags, min_mapq,
                             min_len) for f in files]
    tids = sorted(set(int(t) for f, kp in zip(files, selected)
                      for t in np.unique(f.batch.tid[kp])))
    if region is not None:
        tids = [region.tid] if region.tid in tids else []
    for t in tids:
        beg = region.beg if region else 0
        end = min(region.end, header.ref_lens[t]) if region \
            else header.ref_lens[t]
        parts = []
        for f, kp in zip(files, selected):
            b = f.batch
            sel = np.nonzero(kp & (b.tid == t))[0]
            if region is not None and sel.size:
                sel = sel[(b.pos[sel] < end) & (b.end_pos()[sel] > beg)]
            parts.append((b, sel))
        # clip the scan to the data: positions outside [first read, last
        # read end] contribute nothing
        dlo, dhi = end, beg
        for b, sel in parts:
            if sel.size:
                dlo = min(dlo, int(b.pos[sel].min()))
                dhi = max(dhi, int(b.end_pos()[sel].max()))
        for wb in range(max(beg, dlo), min(end, dhi), REGION_COLS):
            we = min(wb + REGION_COLS, min(end, dhi))
            wparts = [(b, sel[(b.pos[sel] < we) & (b.end_pos()[sel] > wb)]
                       if sel.size else sel) for b, sel in parts]
            stats.add(t, _window(dev, wparts, wb, we, min_baseq, min_depth))
    hdr_flag = [print_header]
    for t in tids:
        beg = region.beg if region else 0
        end = min(region.end, header.ref_lens[t]) if region \
            else header.ref_lens[t]
        stats.line(out, header, t, beg, end, hdr_flag)
    if region is None:
        covered = set(tids)
        for t in range(n_targets):
            if t not in covered:
                stats.line(out, header, t, 0, header.ref_lens[t], hdr_flag)


def _coverage_streamed(streams, dev, fail_flags, required_flags, min_mapq,
                       min_len, min_baseq, min_depth, out,
                       print_header) -> int:
    """Bounded-memory table: the per-read tallies accumulate in the
    stream filter (each read is seen once), the census of each window of
    STREAM_COLS columns (coverage.c's accumulators) in ``_window``."""
    header = streams[0].header
    n_targets = header.n_refs
    stats = _Stats(n_targets)

    def make_filter():
        return lambda b: stats.select(b, fail_flags, required_flags,
                                      min_mapq, min_len)

    covered = np.zeros(n_targets, bool)
    for tid, wb, we, subs in WindowedReader(
            streams, window_cols=STREAM_COLS,
            filter_fn=[make_filter() for _ in streams]):
        covered[tid] = True
        we = min(we, int(header.ref_lens[tid]))
        if we <= wb:
            continue
        stats.add(tid, _window(dev, [(s, np.arange(s.n)) for s in subs],
                               wb, we, min_baseq, min_depth))
    hdr_flag = [print_header]
    for t in ([t for t in range(n_targets) if covered[t]]
              + [t for t in range(n_targets) if not covered[t]]):
        stats.line(out, header, t, 0, header.ref_lens[t], hdr_flag)
    return 0


def _coverage_hist(files, header, region, dev, fail_flags, required_flags,
                   min_mapq, min_len, min_baseq, min_depth, out, n_bins,
                   full_utf, plot_depth) -> None:
    """-m/-D: per contig (or the region), the pileup of each file's reads
    (``build_pileup``; K13 orders it on ``dev``), the depth of the M bases
    of quality >= min_baseq per position, and a histogram of the covered
    share (-m) or the depth (-D) in ``n_bins`` bins."""
    stats = _Stats(header.n_refs)
    selected = [stats.select(f.batch, fail_flags, required_flags, min_mapq,
                             min_len) for f in files]
    tids = sorted(set(int(t) for f, kp in zip(files, selected)
                      for t in np.unique(f.batch.tid[kp])))
    if region is not None:
        tids = [region.tid]
    blocks = []
    for t in tids:
        beg = region.beg if region else 0
        end = min(region.end, header.ref_lens[t]) if region \
            else header.ref_lens[t]
        L = max(end - beg, 1)
        depth = np.zeros(L, np.int64)
        visited = np.zeros(L, bool)
        bq_sum = np.zeros(L, np.int64)
        for f, kp in zip(files, selected):
            b = f.batch
            sel = np.nonzero(kp & (b.tid == t))[0]
            if region is not None and sel.size:
                sel = sel[(b.pos[sel] < end) & (b.end_pos()[sel] > beg)]
            sub = b.take(sel)
            p = build_pileup(sub, dev)
            inreg = (p.pos >= beg) & (p.pos < end)
            visited |= np.bincount(p.pos[inreg] - beg, minlength=L) > 0
            real = inreg & ~(p.is_del | p.is_refskip)
            quals = sub.qual[sub.seq_off[p.rid[real]] + p.qpos[real]] \
                .astype(np.int64)
            okq = quals >= min_baseq
            pr = p.pos[real][okq] - beg
            np.add.at(depth, pr, 1)
            np.add.at(bq_sum, pr, quals[okq])
        pos_ok = visited & (depth > 0) & (depth >= min_depth)
        # set, not added: one contig is one block
        stats.n_cov_bases[t] = int(pos_ok.sum())
        stats.summed_cov[t] = int(depth[pos_ok].sum())
        stats.summed_baseq[t] = int(bq_sum[pos_ok].sum())
        nb = min(n_bins, L)
        bw = max(L // max(nb, 1), 1)
        hist = np.zeros(nb, np.int64)
        idx = np.minimum(np.arange(L) // bw, nb - 1)
        np.add.at(hist, idx, depth if plot_depth else pos_ok.astype(np.int64))
        blocks.append((t, beg, end, hist, bw, nb))
    for i, (t, beg, end, hist, bw, nb) in enumerate(blocks):
        _print_hist(out, header, stats, t, beg, end, hist, bw, nb, full_utf,
                    plot_depth)
        if i < len(blocks) - 1:
            out.write("\n")


def _print_hist(out, header, stats, t, beg, end, hist, bw, nb, full_utf,
                plot_depth) -> None:
    """coverage.c's terminal histogram of one contig, with its summary
    beside it (the quality bases are the depth summed over the counted
    positions)."""
    blocks = BLOCK8 if full_utf else BLOCK2
    blen = len(blocks)
    vline = "\u2502" if full_utf else "|"
    L = float(end - beg)
    data = [(1 if plot_depth else 100) * h / bw for h in hist]
    max_val = max(data) if data else 0.0
    n_sel, n_reads = stats.n_selected[t], stats.n_reads[t]
    out.write("%s (%sbp)\n" % (header.ref_names[t],
                               readable_bps(header.ref_lens[t])))
    n_rows = 10
    row_bin = max_val / n_rows
    for i in range(n_rows - 1, -1, -1):
        cur = row_bin * i
        if plot_depth:
            out.write(">%8.1f " % (i * row_bin))
        else:
            out.write(">%7.2f%% " % cur)
        out.write(vline)
        for col in range(nb):
            diff = round(blen * (data[col] - cur) / row_bin) - 1 \
                if row_bin > 0 else -1
            out.write(" " if diff < 0 else blocks[min(diff, blen - 1)])
        out.write(vline + " ")
        if i == 9:
            out.write("Number of reads: %d" % n_sel)
        elif i == 8 and n_reads - n_sel > 0:
            out.write("    (%d filtered)" % (n_reads - n_sel))
        elif i == 7:
            out.write("Covered bases:   %sbp"
                      % readable_bps(stats.n_cov_bases[t]))
        elif i == 6:
            out.write("Percent covered: %.4g%%"
                      % (100.0 * stats.n_cov_bases[t] / L))
        elif i == 5:
            out.write("Mean coverage:   %.3gx" % (stats.summed_cov[t] / L))
        elif i == 4:
            out.write("Mean baseQ:      %.3g"
                      % (stats.summed_baseq[t] / stats.summed_cov[t]
                         if stats.summed_cov[t] else 0))
        elif i == 3:
            out.write("Mean mapQ:       %.3g"
                      % (stats.summed_mapq[t] / n_sel if n_sel else 0))
        elif i == 1:
            out.write("Histo bin width: %sbp" % readable_bps(bw))
        elif i == 0:
            out.write("Histo max bin:   %.5g" % max_val if plot_depth
                      else "Histo max bin:   %.5g%%" % max_val)
        out.write("\n")
