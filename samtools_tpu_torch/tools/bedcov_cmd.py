"""samtools bedcov on the port: summed depth per BED region.

Counterpart of samtools_tpu/tools/bedcov_cmd.py (``usage``,
``_build_states_streaming``, ``_mspan_depth``, ``main_bedcov``,
``_header_cols``); its output is the JAX tool's, byte for byte.  Per
contig, a region's sum of pileup entries is a difference of prefix sums
of two interval depths: the reads' whole footprints (M/D/N) and, for
``-j``, their M/=/X spans.  As in the JAX package, BAM paths stream
through numpy only; the in-memory branch (standard input, ``-``)
computes the M/=/X depth with ``depth_window_device`` (K1's generic form
and the depth scan, on the card), or with ``SAMTPU_DEVICE=0|host`` with
the numpy ``_mspan_depth``.  When any input is not a BGZF BAM (SAM
text, gzip'd SAM) every file takes the in-memory branch, as in the JAX
tool; so does a CRAM, decoded whole on the host (``io/cram_decode.py``).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import flags as F
from ..io.files import read_alignments
from ..io.native import FIELD_CIGAR
from ..ops.cigar import expand_ops
from ..ops.pileup_engine import depth_window_device
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, open_streams, pick_device,
                     print_error, print_error_errno)
from .flags_cmd import str2flag

DEFAULT_FLAGS = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
BEDCOLS = ["chrom", "chromStart", "chromEnd", "name", "score", "strand",
           "thickStart", "thickEnd", "itemRgb", "blockCount", "blockSizes",
           "blockStarts"]


def usage(fp):
    fp.write(
        "Usage: samtools bedcov [options] <in.bed> <in1.bam> [...]\n\n"
        "Options:\n"
        "      -Q, --min-MQ <int>  mapping quality threshold [0]\n"
        "      -X                  use customized index files\n"
        "      -g <flags>          remove the specified flags from the set "
        "used to filter out reads\n"
        "      -G <flags>          add the specified flags to the set used "
        "to filter out reads\n"
        "                          The default set is "
        "UNMAP,SECONDARY,QCFAIL,DUP or 0x704\n"
        "      -j                  do not include deletions (D) and ref "
        "skips (N) in bedcov computation\n"
        "      --max-depth <int>   sets the maximum depth used in the "
        "mpileup algorithm\n"
        "      -d <int>            depth threshold\n"
        "      -c                  add an additional column showing read "
        "count\n"
        "      -H                  print a comment/header line with column "
        "information.\n")


def _count(idx: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(idx, minlength=n).astype(np.int64, copy=False)


def _prefix(d: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(d)])


def _build_states_streaming(states, streams, needed, header, flags,
                            min_mapq, min_depth, do_rcount) -> None:
    """One pass over each stream: whole-contig difference arrays of the
    footprints and the M/=/X spans for every contig the BED names, then
    the prefix sums the per-region lookups read."""
    nf = len(streams)
    acc: dict = {}   # (file, tid) -> [d_incl, d_real, pos list, end list]
    for fi, st in enumerate(streams):
        for b in st.batches(fields=FIELD_CIGAR):
            fl = b.flag.astype(np.int64)
            keep = ((fl & flags) == 0) \
                & (b.mapq.astype(np.int64) >= min_mapq)
            for t in np.unique(b.tid[(b.tid >= 0) & keep]):
                t = int(t)
                if t not in needed:
                    continue
                L = int(header.ref_lens[t])
                a = acc.get((fi, t))
                if a is None:
                    a = acc[(fi, t)] = [np.zeros(L + 1, np.int64),
                                        np.zeros(L + 1, np.int64), [], []]
                sub = b.take(np.nonzero(keep & (b.tid == t))[0],
                             ragged=("cigar",))
                e = sub.end_pos()
                a[0] += (_count(np.clip(sub.pos, 0, L), L + 1)
                         - _count(np.clip(e, 0, L), L + 1))
                tt = expand_ops(sub)
                m = np.isin(tt.op, (F.CMATCH, F.CEQUAL, F.CDIFF))
                a[1] += (_count(np.clip(tt.rpos[m], 0, L), L + 1)
                         - _count(np.clip(tt.rpos[m] + tt.oplen[m], 0, L),
                                  L + 1))
                if do_rcount:
                    a[2].append(sub.pos.copy())
                    a[3].append(e)

    for t in needed:
        L = int(header.ref_lens[t])
        if not any((fi, t) in acc for fi in range(nf)):
            states[t] = None
            continue
        per_file = []
        vis = np.zeros(L, bool)
        for fi in range(nf):
            a = acc.get((fi, t))
            d_incl = (np.cumsum(a[0])[:L] if a is not None
                      else np.zeros(L, np.int64))
            d_real = (np.cumsum(a[1])[:L] if a is not None
                      else np.zeros(L, np.int64))
            vis |= d_incl > 0
            per_file.append((d_incl, d_real, a))
        state = []
        for d_incl, d_real, a in per_file:
            Sind = (_prefix(vis & (d_real >= min_depth)) if min_depth >= 0
                    else None)
            if do_rcount and a is not None and a[2]:
                rp = np.concatenate(a[2])
                rend = np.concatenate(a[3])
                order = np.argsort(rp, kind="stable")
                rp, rend = rp[order], rend[order]
            else:
                rp = rend = np.empty(0, np.int64)
            state.append((_prefix(d_incl), _prefix(d_real), Sind, rp, rend))
        states[t] = (0, L, state)


def _mspan_depth(b, sel: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """int64[hi-lo]: the M/=/X depth by difference events, in numpy (the
    host twin of depth_window_device with min_qual=0)."""
    L = hi - lo
    if sel.size == 0:
        return np.zeros(L, np.int64)
    sub = b.take(np.asarray(sel, np.int64), ragged=("cigar",))
    t = expand_ops(sub)
    m = np.isin(t.op, (F.CMATCH, F.CEQUAL, F.CDIFF))
    rs = np.clip(t.rpos[m] - lo, 0, L)
    re = np.clip(t.rpos[m] + t.oplen[m] - lo, 0, L)
    return np.cumsum(_count(rs, L + 1) - _count(re, L + 1))[:L]


class _InMemoryStates:
    """Per-contig depth state of whole files in memory, built on first
    use: (lo, hi, per file (footprint prefix sums, M/=/X prefix sums,
    threshold prefix counts, read starts, read ends))."""

    def __init__(self, files, flags, min_mapq, min_depth, dev):
        self.files = files
        self.flags = flags
        self.min_mapq = min_mapq
        self.min_depth = min_depth
        self.dev = dev
        self.states: dict = {}

    def get(self, tid: int):
        if tid not in self.states:
            self.states[tid] = self._build(tid)
        return self.states[tid]

    def _build(self, tid: int):
        sels = []
        lo = hi = None
        for f in self.files:
            b = f.batch
            fl = b.flag.astype(np.int64)
            sel = np.nonzero((b.tid == tid) & ((fl & self.flags) == 0)
                             & (b.mapq.astype(np.int64) >= self.min_mapq))[0]
            sels.append(sel)
            if sel.size:
                l0, h0 = int(b.pos[sel].min()), int(b.end_pos()[sel].max())
                lo = l0 if lo is None else min(lo, l0)
                hi = h0 if hi is None else max(hi, h0)
        if lo is None:
            return None
        L = hi - lo
        dev = self.dev is not None and L < (1 << 31)
        vis = np.zeros(L, bool)
        per_file = []
        for f, sel in zip(self.files, sels):
            b = f.batch
            if dev and sel.size:
                d_real = depth_window_device(b, sel, lo, hi, 0, False,
                                             device=self.dev
                                             ).astype(np.int64)
            else:
                d_real = _mspan_depth(b, sel, lo, hi)
            # the whole footprint (M/D/N): 2 events per read
            d_incl = np.zeros(L, np.int64)
            if sel.size:
                d_incl = np.cumsum(_count(b.pos[sel] - lo, L + 1)
                                   - _count(b.end_pos()[sel] - lo, L + 1)
                                   )[:L]
            vis |= d_incl > 0
            per_file.append((d_incl, d_real))
        state = []
        for (d_incl, d_real), f, sel in zip(per_file, self.files, sels):
            Sind = (_prefix(vis & (d_real >= self.min_depth))
                    if self.min_depth >= 0 else None)
            rpos = f.batch.pos[sel]
            rend = f.batch.end_pos()[sel]
            order = np.argsort(rpos, kind="stable")
            state.append((_prefix(d_incl), _prefix(d_real), Sind,
                          rpos[order], rend[order]))
        return (lo, hi, state)


def main_bedcov(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    min_mapq = 0
    flags = DEFAULT_FLAGS
    skip_dn = False
    min_depth = -1
    do_rcount = False
    print_header = False
    has_index_file = False
    try:
        opts, args = gnu_getopt(argv, "Q:Xg:G:jd:Hc",
                                ["min-MQ=", "min-mq=", "max-depth="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-Q", "--min-MQ", "--min-mq"):
            min_mapq = int(v)
        elif o == "-X":
            has_index_file = True
        elif o == "-c":
            do_rcount = True
        elif o == "-H":
            print_header = True
        elif o in ("-g", "-G"):
            fl = str2flag(v)
            if fl < 0 or fl > ((F.FSUPPLEMENTARY << 1) - 1):
                print_error("bedcov", 'Flag value "%s" is not supported', v)
                return 1
            flags = flags & ~fl if o == "-g" else flags | fl
        elif o == "-j":
            skip_dn = True
        elif o == "-d":
            min_depth = int(v)
        elif o == "--max-depth":
            pass  # the depth cap: unbounded here
        elif not handle_global_opt(ga, o, v):
            usage(sys.stderr)
            return 1
    if len(args) < 2:
        usage(sys.stderr)
        return 1
    bed_path = args[0]
    bam_paths = (args[1:1 + (len(args) - 1) // 2] if has_index_file
                 else args[1:])
    try:
        dev = pick_device(device)
    except RuntimeError as e:
        return no_card("bedcov", e)

    # BGZF BAMs stream; when any input is not one (standard input, SAM)
    # every file is read whole, as in the JAX tool
    files = []
    try:
        streams = open_streams(bam_paths, ga.nthreads)
        if not streams:
            for path in bam_paths:
                files.append(read_alignments(path, threads=ga.nthreads))
    except OSError as e:
        sys.stderr.write(f"ERROR: fail to open index BAM file "
                         f"'{e.filename}'\n")
        return 2
    use_stream = bool(streams)
    header = streams[0].header if use_stream else files[0].header

    try:
        bed_data = open(bed_path, "rt").read()
    except OSError as e:
        for st in streams:
            st.close()
        print_error_errno("bedcov", "can't open BED file '%s'", bed_path,
                          exc=e)
        return 2

    if use_stream:
        # one bounded-memory pass over each stream builds the state of
        # every contig the BED names
        states: dict = {}
        needed = set()
        for line in bed_data.split("\n"):
            p = line.split()
            if len(p) >= 3 and not line.startswith(("#", "track ",
                                                    "browser ")):
                t = header.tid(p[0])
                if t >= 0:
                    needed.add(t)
        try:
            _build_states_streaming(states, streams, needed, header, flags,
                                    min_mapq, min_depth, do_rcount)
        finally:
            for st in streams:
                st.close()
        get_state = states.get
    else:
        get_state = _InMemoryStates(files, flags, min_mapq, min_depth,
                                    dev).get
    return _regions(sys.stdout, bed_data, header, bam_paths, get_state,
                    skip_dn, min_depth, do_rcount, print_header)


def _regions(out, bed_data, header, bam_paths, get_state, skip_dn,
             min_depth, do_rcount, print_header) -> int:
    """One output row per BED region; the exit code."""
    status = 0
    hdr_done = not print_header
    for line in bed_data.split("\n"):
        if not line:
            continue
        if line[0] == "#":
            if not hdr_done and line.startswith("#chrom\t"):
                out.write(line)
                _header_cols(out, bam_paths, min_depth, do_rcount)
                hdr_done = True
            continue
        if line.startswith("track ") or line.startswith("browser "):
            continue
        if not hdr_done:
            cols = [BEDCOLS[i] if i < len(BEDCOLS) else "."
                    for i in range(line.count("\t") + 1)]
            out.write("#" + "\t".join(cols))
            _header_cols(out, bam_paths, min_depth, do_rcount)
            hdr_done = True
        parts = line.split()
        if len(parts) < 3:
            sys.stderr.write(f"Errors in BED line '{line}'\n")
            status = 2
            continue
        tid = header.tid(parts[0])
        try:
            beg = int(parts[1])
            end = int(parts[2])
        except ValueError:
            sys.stderr.write(f"Errors in BED line '{line}'\n")
            status = 2
            continue
        if tid < 0 or end < beg:
            sys.stderr.write(f"Errors in BED line '{line}'\n")
            status = 2
            continue
        st = get_state(tid)
        cols, depth_cols, count_cols = [], [], []
        for fi in range(len(bam_paths)):
            if st is None:
                cols.append(0)
                if min_depth >= 0:
                    depth_cols.append(0)
                if do_rcount:
                    count_cols.append(0)
                continue
            lo, hi, per_file = st
            S2i, S2r, Sind, rpos, rend = per_file[fi]
            a = min(max(beg - lo, 0), hi - lo)
            z = min(max(end - lo, 0), hi - lo)
            S = S2r if skip_dn else S2i
            cols.append(int(S[z] - S[a]))
            if min_depth >= 0:
                depth_cols.append(int(Sind[z] - Sind[a]))
            if do_rcount:
                # reads overlapping [beg, end): those starting before end
                # (a prefix of the start-sorted reads) that end past beg
                k = int(np.searchsorted(rpos, end, side="left"))
                count_cols.append(int((rend[:k] > beg).sum()))
        out.write(line + "".join("\t%d" % v for v in cols + depth_cols
                                 + count_cols) + "\n")
    return status


def _header_cols(out, bam_paths, min_depth, do_rcount):
    for p in bam_paths:
        out.write(f"\t{p}_cov")
    if min_depth >= 0:
        for p in bam_paths:
            out.write(f"\t{p}_depth")
    if do_rcount:
        for p in bam_paths:
            out.write(f"\t{p}_count")
    out.write("\n")
