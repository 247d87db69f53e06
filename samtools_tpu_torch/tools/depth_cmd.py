"""samtools depth on the port: per-position depth.

Counterpart of samtools_tpu/tools/depth_cmd.py (``usage``, ``qlen_used``,
``_emit``, ``main_depth``); its output is the JAX tool's, byte for byte.
Whole files are read (SAM too), except that ``-r`` on an indexed BAM
reads the index's chunks for the region (``try_region_read``); each
contig's window of each file goes through ``depth_window_device`` (K1's
generic form and the depth scan, on the card), or with
``SAMTPU_DEVICE=0|host`` through the numpy ``ops.depth.depth_window``.
A CRAM is decoded whole on the host (``io/cram_decode.py``; ``-r``
filters it, with no index query, as in the JAX tool).
``SAMTPU_SHARDS`` above 1 on several cards (capped at their count, as the
JAX tool caps it) spreads each window's tiles over a (1, n) mesh of them
(``parallel/mesh.depth_window_sharded``), with the same bytes.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import flags as F
from ..core.regions import RegionError, parse_region
from ..io import bed as bedmod
from ..io.files import read_alignments
from ..ops import depth as dops
from ..ops.pileup_engine import depth_window_device
from ..parallel.mesh import depth_window_sharded, make_mesh
from . import common
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     device_shards, no_card, pick_device,
                     print_error, print_error_errno, try_region_read)
from .flags_cmd import str2flag

DEFAULT_EXCL = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP

# rows formatted per block by _emit
EMIT_ROWS = 1 << 20


def usage(fp):
    fp.write(
        "Usage: samtools depth [options] in.bam [in.bam ...]\n"
        "\nOptions:\n"
        "  -a           Output all positions (including zero depth)\n"
        "  -a -a, -aa   Output absolutely all positions, including unused ref seqs\n"
        "  -r REG       Specify a region in chr or chr:from-to syntax\n"
        "  -b FILE      Use bed FILE for list of regions\n"
        "  -f FILE      Specify list of input BAM/SAM/CRAM filenames\n"
        "  -X           Use custom index files (in -X *.bam *.bam.bai order)\n"
        "  -g INT       Remove specified flags from default filter-out flag list\n"
        "  -G, --excl-flags FLAGS\n"
        "               Add specified flags to the  default filter-out flag list\n"
        "               [UNMAP,SECONDARY,QCFAIL,DUP]\n"
        "      --incl-flags FLAGS\n"
        "               Only include records with at least one the FLAGs present [0]\n"
        "      --require-flags FLAGS\n"
        "               Only include records with all of the FLAGs present [0]\n"
        "  -H           Print a file header line\n"
        "  -l INT       Minimum read length [0]\n"
        "  -o FILE      Write output to FILE [stdout]\n"
        "  -q, --min-BQ INT\n"
        "               Filter bases with base quality smaller than INT [0]\n"
        "  -Q, --min-MQ INT\n"
        "               Filter alignments with mapping quality smaller than INT [0]\n"
        "  -J           Include reads with deletions in depth computation\n"
        "  -s           Do not count overlapping reads within a template\n")


def qlen_used(batch) -> np.ndarray:
    """bam2depth.c's qlen_used: the query length less the soft clips at
    either end (the CIGAR's query length for reads without bases)."""
    ops = (batch.cigar & 0xF).astype(np.int64)
    lens = (batch.cigar >> 4).astype(np.int64)
    is_q = np.isin(ops, (F.CMATCH, F.CINS, F.CEQUAL, F.CDIFF))
    csum = np.concatenate([[0], np.cumsum(np.where(is_q, lens, 0))])
    cig_q = csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]
    edge = np.zeros(batch.n, np.int64)
    for i in range(batch.n):
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        k = s
        while k < e and ops[k] == F.CSOFT_CLIP:
            edge[i] += lens[k]
            k += 1
        kl = k
        k = e - 1
        while k > kl and ops[k] == F.CSOFT_CLIP:
            edge[i] += lens[k]
            k -= 1
    lq = batch.l_qseq
    return np.where(lq > 0, lq - edge, cig_q)


def _digits(v: np.ndarray) -> np.ndarray:
    """Decimal digits of each non-negative int64."""
    n = np.ones(v.shape, np.int64)
    p = 10
    for _ in range(18):
        big = v >= p
        if not big.any():
            break
        n += big
        p *= 10
    return n


def _rows_bytes(prefix: bytes, fields: list[np.ndarray]) -> bytes:
    """Rows prefix + f0 [\\t f1 ...] + \\n of non-negative int64 fields,
    formatted as "%d" does, in one uint8 buffer."""
    widths = [_digits(f) for f in fields]
    rowlen = len(prefix) + sum(widths) + len(fields)
    start = np.cumsum(rowlen) - rowlen
    buf = np.empty(int(rowlen.sum()), np.uint8)
    for j, ch in enumerate(prefix):
        buf[start + j] = ch
    cur = start + len(prefix)
    for i, (f, w) in enumerate(zip(fields, widths)):
        stop = cur + w
        v = f.copy()
        wmin = int(w.min())
        for k in range(int(w.max())):
            at = stop - 1 - k
            if k >= wmin:
                live = w > k
                at, digit = at[live], v[live] % 10
            else:
                digit = v % 10
            buf[at] = 48 + digit
            v //= 10
        buf[stop] = 9 if i + 1 < len(fields) else 10
        cur = stop + 1
    return buf.tobytes()


def _emit(out, name: str, pos1: np.ndarray, cols: list[np.ndarray]):
    """Write rows name\\tpos\\td1[\\td2...] for the given 1-based
    positions and their depths ("%d" of each; neither is ever
    negative)."""
    if pos1.size == 0:
        return
    fields = [np.asarray(pos1, np.int64)] + [np.asarray(c, np.int64)
                                             for c in cols]
    prefix = (name + "\t").encode()
    for r0 in range(0, pos1.size, EMIT_ROWS):
        out.write(_rows_bytes(prefix, [f[r0:r0 + EMIT_ROWS]
                                       for f in fields]).decode())


def main_depth(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    excl = DEFAULT_EXCL
    incl_flag = 0
    require_flag = 0
    min_qual = 0
    min_mqual = 0
    min_len = 0
    count_del = False
    all_pos = 0
    remove_overlaps = False
    header_line = False
    reg = None
    bedidx = None
    out_file = None
    file_list = None
    has_index_file = False
    try:
        opts, args = gnu_getopt(argv, "@:q:Q:JHd:m:l:g:G:o:ar:Xf:b:s",
                                ["min-MQ=", "min-mq=", "min-BQ=", "min-bq=",
                                 "excl-flags=", "incl-flags=",
                                 "require-flags="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-a":
            all_pos += 1
        elif o == "-b":
            try:
                bedidx = bedmod.read_bed(v)
            except OSError as e:
                print_error_errno("depth", 'Could not read file "%s"', v,
                                  exc=e)
                return 1
        elif o == "-f":
            file_list = v
        elif o in ("-d", "-m"):
            pass  # depth limit, ignored (as in samtools)
        elif o == "-g":
            fl = str2flag(v)
            if fl < 0:
                print_error("depth", "Unknown flag '%s'", v)
                return 1
            excl &= ~fl
        elif o in ("-G", "--excl-flags"):
            fl = str2flag(v)
            if fl < 0:
                print_error("depth", "Unknown flag '%s'", v)
                return 1
            excl |= fl
        elif o == "--incl-flags":
            incl_flag |= str2flag(v)
        elif o == "--require-flags":
            require_flag |= str2flag(v)
        elif o == "-l":
            min_len = int(v)
        elif o == "-H":
            header_line = True
        elif o in ("-q", "--min-BQ", "--min-bq"):
            min_qual = int(v)
        elif o in ("-Q", "--min-MQ", "--min-mq"):
            min_mqual = int(v)
        elif o == "-J":
            count_del = True
        elif o == "-o":
            out_file = v
        elif o == "-r":
            reg = v
        elif o == "-s":
            remove_overlaps = True
        elif o == "-X":
            has_index_file = True
        elif not handle_global_opt(ga, o, v):
            usage(sys.stderr)
            return 1

    if file_list:
        with open(file_list) as f:
            args = [l.strip() for l in f if l.strip()]
    if has_index_file:
        args = args[: len(args) // 2]  # drop the index arguments
    if not args:
        usage(sys.stdout)
        return 0
    try:
        dev = pick_device(device)
    except RuntimeError as e:
        return no_card("depth", e)

    files = []
    for path in args:
        try:
            got = try_region_read(path, ga.nthreads, reg) if reg else None
            files.append(got[0] if got else
                         read_alignments(path, threads=ga.nthreads))
        except RegionError:
            print_error("depth", 'could not parse region "%s"', reg)
            return 1
        except OSError as e:
            print_error_errno("depth", 'Could not open "%s"', path, exc=e)
            return 1
    header = files[0].header
    region = None
    if reg:
        try:
            region = parse_region(reg, header.tid)
        except RegionError:
            print_error("depth", 'could not parse region "%s"', reg)
            return 1

    out = open(out_file, "w") if out_file else sys.stdout
    try:
        return _run(out, files, args, header, region, bedidx, dev, excl,
                    incl_flag, require_flag, min_mqual, min_len, min_qual,
                    count_del, all_pos, remove_overlaps, header_line)
    finally:
        if out is not sys.stdout:
            out.close()


def _depth_fn(dev):
    """The depth of one file's window (the JAX branch,
    samtools_tpu/tools/depth_cmd.py:334-346): numpy for the host branch
    (``dev`` None); a (1, n) mesh when SAMTPU_SHARDS asks for more than
    one of ``dev``'s devices; else K1 on ``dev``."""
    if dev is None:
        return dops.depth_window
    n = device_shards(dev)
    if n > 1:
        mesh = make_mesh(n_data=1, n_region=n,
                         devices=common.mesh_devices(dev, n))
        return lambda *a: depth_window_sharded(mesh, *a)
    return lambda *a: depth_window_device(*a, device=dev)


def _run(out, files, args, header, region, bedidx, dev, excl, incl_flag,
         require_flag, min_mqual, min_len, min_qual, count_del, all_pos,
         remove_overlaps, header_line) -> int:
    depth_fn = _depth_fn(dev)
    if header_line:
        out.write("#CHROM\tPOS")
        for path in args:
            out.write("\t" + path)
        out.write("\n")

    # per file: filter, sortedness check, overlap clips
    selected, clips, ends = [], [], []
    for f in files:
        b = f.batch
        fl = b.flag.astype(np.int64)
        keep = (b.tid >= 0)
        keep &= (fl & excl) == 0
        if incl_flag:
            keep &= (fl & incl_flag) != 0
        keep &= (fl & require_flag) == require_flag
        keep &= b.mapq.astype(np.int64) >= min_mqual
        if min_len:
            keep &= qlen_used(b) >= min_len
        sel = np.nonzero(keep)[0]
        # position-sorted check (bam2depth.c:330-335)
        t = b.tid[sel]
        if t.size and (np.diff(t) < 0).any():
            print_error_errno("depth", "Data is not position sorted")
            return 1
        selected.append(sel)
        ends.append(b.end_pos())
        clips.append(dops.overlap_clips(b, sel) if remove_overlaps
                     else None)

    used = np.zeros(header.n_refs, bool)
    for f, sel in zip(files, selected):
        tids = np.unique(f.batch.tid[sel])
        used[tids[tids >= 0]] = True

    for t in ([region.tid] if region is not None else range(header.n_refs)):
        ref_len = header.ref_lens[t]
        name = header.ref_names[t]
        rbeg = region.beg if region else 0
        rend = min(region.end, ref_len) if region else ref_len
        if not used[t]:
            if (all_pos > 1 and region is None) or (all_pos and region):
                posz = np.arange(rbeg, rend, dtype=np.int64)
                if bedidx is not None:
                    posz = posz[bedidx.overlap(name, posz, posz + 1)]
                _emit(out, name, posz + 1,
                      [np.zeros(posz.size, np.int64)] * len(files))
            continue

        # the window over the reads present
        wbeg_list, wend_list, subsels = [], [], []
        for f, sel, end in zip(files, selected, ends):
            s = sel[f.batch.tid[sel] == t]
            if region is not None and s.size:
                s = s[(f.batch.pos[s] < region.end) & (end[s] > region.beg)]
            subsels.append(s)
            if s.size:
                wbeg_list.append(int(f.batch.pos[s].min()))
                wend_list.append(int(end[s].max()))
        if not wbeg_list:
            if all_pos:
                posz = np.arange(rbeg, rend, dtype=np.int64)
                if bedidx is not None:
                    posz = posz[bedidx.overlap(name, posz, posz + 1)]
                _emit(out, name, posz + 1,
                      [np.zeros(posz.size, np.int64)] * len(files))
            continue
        wbeg, wend = min(wbeg_list), max(wend_list)
        if region is not None:
            wbeg, wend = max(wbeg, region.beg), min(wend, region.end)
        if wend <= wbeg:
            continue

        cols, env_pos, env_end = [], [], []
        for f, s, cl, end in zip(files, subsels, clips, ends):
            cols.append(depth_fn(f.batch, s, wbeg, wend, min_qual,
                                 count_del, cl))
            if s.size:
                env_pos.append(f.batch.pos[s])
                env_end.append(end[s])
        env = dops.coverage_envelope(
            np.concatenate(env_pos) if env_pos else np.empty(0, np.int64),
            np.concatenate(env_end) if env_end else np.empty(0, np.int64),
            wbeg, wend)

        if all_pos:
            pos0 = np.arange(rbeg, rend, dtype=np.int64)
            depth_cols = []
            lo = max(wbeg, rbeg) - rbeg
            hi = min(wend, rend) - rbeg
            for c in cols:
                full = np.zeros(rend - rbeg, np.int64)
                if hi > lo:
                    a = max(wbeg, rbeg) - wbeg
                    full[lo:hi] = c[a:a + (hi - lo)]
                depth_cols.append(full)
        else:
            sel_pos = np.nonzero(env)[0]
            pos0 = sel_pos + wbeg
            depth_cols = [c[sel_pos].astype(np.int64) for c in cols]

        if bedidx is not None:
            m = bedidx.overlap(name, pos0, pos0 + 1)
            pos0 = pos0[m]
            depth_cols = [c[m] for c in depth_cols]
        _emit(out, name, pos0 + 1, depth_cols)
    return 0
