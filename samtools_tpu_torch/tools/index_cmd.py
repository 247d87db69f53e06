"""samtools index: build a BAI or CSI for a BAM, a CRAI for a CRAM.

Counterpart of samtools_tpu/tools/index_cmd.py (samtools' bam_index.c
:36-160, options -b/-c/-m/-M/-o/-@).  For a BAM the whole file is read
with each record's virtual offsets and the index is built in one
vectorised pass (``io/index.build_index``); for a CRAM one ``.crai``
line per slice comes from the container and slice headers, with no
record decoded.  A host command: it does no device work.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.flags import FUNMAP
from ..io import index as idxmod
from ..io.bam import read_bam_indexed, reg2bin_vec
from ..io.cram import CramReader, parse_block, parse_slice_header
from ..io.cram_encode import write_crai
from ..io.files import detect_format
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)


def usage(fp):
    fp.write(
        "Usage: samtools index -M [-bc] [-m INT] <in1.bam> <in2.bam>...\n"
        "   or: samtools index [-bc] [-m INT] <in.bam> [out.index]\n"
        "Options:\n"
        "  -b, --bai            Generate BAI-format index for BAM files [default]\n"
        "  -c, --csi            Generate CSI-format index for BAM files\n"
        "  -m, --min-shift INT  Set minimum interval size for CSI indices to 2^INT [14]\n"
        "  -M                   Interpret all filename arguments as files to be indexed\n"
        "  -o, --output FILE    Write index to FILE [alternative to <out.index> as an argument]\n"
        "  -@ INT               Sets the number of threads [none]\n")


def _reg2bin_csi(beg, end, min_shift: int, depth: int) -> np.ndarray:
    """reg2bin of each interval [beg, end) for any min_shift and depth
    (CSI)."""
    beg = beg.astype(np.int64)
    e = end.astype(np.int64) - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for level in range(depth, 0, -1):
        s = min_shift + (depth - level) * 3
        t = ((1 << (level * 3)) - 1) // 7
        hit = (~done) & ((beg >> s) == (e >> s))
        out[hit] = t + (beg[hit] >> s)
        done |= hit
    return out.astype(np.uint32)


def build_index_for(path: str, out_path: str | None, csi: bool,
                    min_shift: int, threads: int) -> int:
    """Write the index of one BAM or CRAM; the command's exit code."""
    fmt = detect_format(path)
    if fmt == "cram":
        return _build_crai(path, out_path)
    if fmt != "bam":
        print_error("index",
                    '"%s" is in a format that cannot be usefully indexed',
                    path)
        return 1
    header, b, vstart, vend = read_bam_indexed(path, threads or 2)
    end = b.end_pos()
    mapped = (b.flag & FUNMAP) == 0
    if not csi and (np.asarray(header.ref_lens, np.int64) > (1 << 29)).any():
        # a BAI cannot address past 2^29: CSI, as htslib switches
        csi, min_shift = True, 14
        out_path = out_path and out_path + ".csi"
    if csi:
        depth = 5
        # grow the depth until the longest contig fits (hts_idx_init)
        max_len = max(header.ref_lens + [0])
        while max_len > (1 << (min_shift + depth * 3)):
            depth += 1
        bins = _reg2bin_csi(b.pos, end, min_shift, depth)
        idx = idxmod.build_index(b.tid, b.pos, end, vstart, vend, bins,
                                 mapped, header.n_refs, min_shift=min_shift,
                                 depth=depth)
        idxmod.write_csi(out_path or path + ".csi", idx)
    else:
        bins = reg2bin_vec(b.pos.astype(np.int64), end.astype(np.int64))
        idx = idxmod.build_index(b.tid, b.pos, end, vstart, vend, bins,
                                 mapped, header.n_refs)
        idxmod.write_bai(out_path or path + ".bai", idx)
    return 0


def _build_crai(path: str, out_path: str | None) -> int:
    """A CRAI from the CRAM's container and slice headers (htslib's
    cram_index_build): one line per slice, with its seq_id, start, span,
    the container's offset, the slice header's offset within the
    container and the slice's byte size."""
    with open(path, "rb") as f:
        data = f.read()
    rd = CramReader(data)
    lines = []
    for cont, i in rd.containers():
        cstart = rd.pos        # the container header's offset
        if rd.is_eof_container(cont):
            break
        if cont.n_records == 0 and cont.n_bases == 0:
            continue
        for lm in cont.landmarks:
            sl_start = i + lm
            blk, j = parse_block(data, sl_start, rd.major)
            sh = parse_slice_header(blk.data(), rd.major)
            for _ in range(sh.n_blocks):
                _, j = parse_block(data, j, rd.major)
            lines.append((sh.ref_seq_id, sh.ref_start, sh.ref_span,
                          cstart, lm, j - sl_start))
    write_crai(out_path or path + ".crai", lines)
    return 0


def main_index(argv: list[str]) -> int:
    ga = GlobalArgs()
    csi = False
    min_shift = 14
    multiple = False
    out_path = None
    try:
        opts, args = gnu_getopt(argv, "bcm:Mo:@:",
                                ["bai", "csi", "min-shift=", "output="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-b", "--bai"):
            csi = False
        elif o in ("-c", "--csi"):
            csi = True
        elif o in ("-m", "--min-shift"):
            csi = True
            min_shift = int(v)
        elif o == "-M":
            multiple = True
        elif o in ("-o", "--output"):
            out_path = v
        elif not handle_global_opt(ga, o, v):
            usage(sys.stderr)
            return 1
    if not args:
        usage(sys.stdout)
        return 1
    if not multiple and len(args) == 2:
        out_path = args[1]
        args = args[:1]
    elif len(args) > 1 and not multiple:
        print_error("index",
                    "too many files to index. Use -M to index multiple files")
        return 1
    for path in args:
        try:
            rc = build_index_for(path, out_path if len(args) == 1 else None,
                                 csi, min_shift, ga.nthreads)
        except OSError as e:
            print_error_errno("index", 'failed to open "%s"', path, exc=e)
            return 1
        if rc:
            return 1
    return 0
