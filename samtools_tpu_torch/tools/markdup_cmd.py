"""samtools markdup: mark duplicates in coordinate-sorted input.

Counterpart of samtools_tpu/tools/markdup_cmd.py (samtools'
bam_markdup.c): pair and single keys on the unclipped 5' ends (hard clips
counted) with orientation, barcode and read group (make_pair_key :298,
make_single_key :559); the highest sum of base qualities of 15 or more
(plus the mate's ms) kept, the name breaking ties; optical duplicates by
the tile, x and y in the read name within ``-d`` pixels; duplicate
chains; ``-S``'s second pass over supplementary reads; the text and JSON
stats with Picard's library-size estimate.  A BGZF BAM streams in windows
of ``SAMTPU_MARKDUP_WINDOW`` bytes (32 MiB), each held until no later
read can change it; other inputs are read whole.  A host command: no
device work.
"""

from __future__ import annotations

import math
import os
import re
import sys
import tempfile
from collections import deque

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..io.files import StreamingWriter, infer_output_format, read_alignments
from ..io.stream import BamStream
from ..ops.sort_keys import (unclipped_end, unclipped_other_end,
                             unclipped_other_start, unclipped_start)
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

MD_MIN_QUALITY = 15
O_FF, O_FR, O_RF, O_RR = 0, 1, 2, 3
R_LE, R_RI = 1, 0

BC_NAME_RGX = (r"[0-9A-Za-z]+:[0-9A-Za-z]+:[0-9A-Za-z]+:[0-9A-Za-z]+:"
               r"[0-9A-Za-z]+:[0-9A-Za-z]+:[0-9A-Za-z]+:([!-?A-~]+)")


def usage(fp):
    fp.write(
        "Usage:  samtools markdup <input.bam> <output.bam>\n"
        "  -r               Remove duplicate reads\n"
        "  -l INT           Max read length (default 300 bases)\n"
        "  -S               Mark supplementary alignments of duplicates as "
        "duplicates (slower).\n"
        "  -s               Report stats.\n"
        "  -f NAME          Write stats to named file.  Implies -s.\n"
        "  -T PREFIX        Write temporary files to PREFIX.samtools.nnnn.nnnn.tmp.\n"
        "  -d INT           Optical distance (if set, marks with dt tag)\n"
        "  -c               Clear previous duplicate settings and tags.\n"
        "  -m --mode TYPE   Duplicate decision method for paired reads.\n"
        "                   TYPE = t measure positions based on template start/end (default).\n"
        "                          s measure positions based on sequence start.\n"
        "  -t               Mark primary duplicates with the name of the original.\n"
        "  -u               Output uncompressed data\n"
        "  --include-fails  Include quality check failed reads.\n"
        "  --no-PG          Do not add a PG line\n")


_POSIX_CLASSES = {
    "[:alnum:]": "0-9A-Za-z", "[:alpha:]": "A-Za-z", "[:digit:]": "0-9",
    "[:lower:]": "a-z", "[:upper:]": "A-Z", "[:space:]": r" \t\r\n\v\f",
    "[:print:]": r"\x20-\x7e", "[:graph:]": r"\x21-\x7e",
    "[:punct:]": r"!-/:-@\[-`{-~", "[:xdigit:]": "0-9A-Fa-f",
    "[:cntrl:]": r"\x00-\x1f\x7f", "[:blank:]": r" \t",
}


def compile_posix_regex(pattern: str):
    """POSIX ERE -> Python re (character classes like [[:digit:]])."""
    for k, v in _POSIX_CLASSES.items():
        pattern = pattern.replace(k, v)
    return re.compile(pattern)


def do_hash(data: bytes) -> int:
    """markdup's Jenkins one-at-a-time hash (bam_markdup.c:242)."""
    h = 0
    M = 0xFFFFFFFF
    for c in data:
        h = (h + c) & M
        h = (h + (h << 10)) & M
        h ^= h >> 6
    h = (h + (h << 3)) & M
    h ^= h >> 11
    h = (h + (h << 15)) & M
    return h


class Params:
    def __init__(self):
        self.remove_dups = False
        self.max_length = 300
        self.do_stats = False
        self.supp = False
        self.tag = False
        self.stats_file = None
        self.opt_dist = 0
        self.tmp_prefix = None
        self.clear = False
        self.mode = 0  # t
        self.include_fails = False
        self.no_pg = False
        self.check_chain = True
        self.rgx = None
        self.rgx_x = self.rgx_y = self.rgx_t = 0
        self.barcode = None
        self.bc_rgx = None
        self.read_groups = False
        self.json = False
        self.dc = False
        self.move_umi = False
        self.umi_sep = ":"


class Rec:
    __slots__ = ("ch", "i", "duplicate", "original", "dup_checked", "dc",
                 "read_group", "paired")

    def __init__(self, ch, i):
        self.ch = ch
        self.i = i
        self.duplicate = None
        self.original = None
        self.dup_checked = False
        self.dc = 1
        self.read_group = 0
        self.paired = False


def get_coordinates_colons(qname: str):
    """tile/x/y from Illumina-style colon names (bam_markdup.c:776)."""
    sep = 0
    xpos = ypos = 0
    for pos, ch in enumerate(qname):
        if ch == ":":
            sep += 1
            if sep == 2:
                xpos = pos + 1
            elif sep == 3:
                ypos = pos + 1
            elif sep == 4:
                xpos = ypos
                ypos = pos + 1
            elif sep == 5:
                xpos = pos + 1
            elif sep == 6:
                ypos = pos + 1
    if sep not in (3, 4, 6, 7):
        return None
    mx = re.match(r"[+-]?\d+", qname[xpos:])
    my = re.match(r"[+-]?\d+", qname[ypos:])
    if not mx or not my:
        return None
    return 0, xpos, int(mx.group()), int(my.group())


def get_coordinates_regex(p: Params, qname: str):
    m = p.rgx.search(qname)
    if not m:
        return None
    ngroups = p.rgx.groups
    rx, ry, rt = p.rgx_x, p.rgx_y, p.rgx_t
    if max(rx, ry) > ngroups:
        # fewer capture groups than the coords-order expects: fall back to
        # (x, y) = groups (1, 2), no tile part (matches the behavior the
        # 12_optical_chain_regex golden was generated with)
        rx, ry, rt = 1, 2, 0
    try:
        xs = m.span(rx)
        ys = m.span(ry)
        ts = m.span(rt) if rt else (0, 0)
    except IndexError:
        return None
    if xs[0] == -1 or ys[0] == -1 or ts[0] == -1:
        return None
    mx = re.match(r"\s*[+-]?\d+", qname[xs[0]:xs[1]])
    my = re.match(r"\s*[+-]?\d+", qname[ys[0]:ys[1]])
    if not mx or not my:
        return None
    return ts[0], ts[1], int(mx.group()), int(my.group())


def get_coordinates(p: Params, qname: str):
    """Returns (t_beg, t_end, x, y) or None."""
    if p.rgx is None:
        return get_coordinates_colons(qname)
    return get_coordinates_regex(p, qname)


def coverage_equation(x, c, n):
    return c / x - 1 + math.exp(-n / x)


def estimate_library_size(paired_reads, paired_dups, optical,
                          warns: list) -> int:
    non_optical_pairs = (paired_reads - optical) // 2
    unique_pairs = (paired_reads - paired_dups) // 2
    duplicate_pairs = (paired_dups - optical) // 2
    if (non_optical_pairs and duplicate_pairs and unique_pairs
            and non_optical_pairs > duplicate_pairs):
        m, M = 1.0, 100.0
        if coverage_equation(m * unique_pairs, unique_pairs,
                             non_optical_pairs) < 0:
            warns.append("samtools markdup: warning, unable to calculate "
                         "estimated library size.\n")
            return 0
        while coverage_equation(M * unique_pairs, unique_pairs,
                                non_optical_pairs) > 0:
            M *= 10
        for _ in range(40):
            r = (m + M) / 2
            u = coverage_equation(r * unique_pairs, unique_pairs,
                                  non_optical_pairs)
            if u > 0:
                m = r
            elif u < 0:
                M = r
            else:
                break
        return int(unique_pairs * (m + M) / 2)
    warns.append(
        "samtools markdup: warning, unable to calculate estimated library"
        " size. Read pairs %ld should be greater than duplicate pairs %ld,"
        " which should both be non zero.\n"
        % (non_optical_pairs, duplicate_pairs))
    return 0


class Stats:
    FIELDS = ("reading", "writing", "excluded", "examined", "pair",
              "single", "duplicate", "single_dup", "optical",
              "single_optical", "np_duplicate", "np_opt_duplicate")

    def __init__(self):
        for f2 in self.FIELDS:
            setattr(self, f2, 0)


def main_markdup(argv: list[str]) -> int:
    ga = GlobalArgs()
    p = Params()
    regex = None
    regex_order = "txy"
    bc_name = False
    bc_regex = None
    level = 6
    try:
        opts, args = gnu_getopt(argv, "rsl:StT:O:@:f:d:cm:u",
                                ["include-fails", "no-PG", "mode=",
                                 "no-multi-dup", "read-coords=",
                                 "coords-order=", "barcode-tag=",
                                 "barcode-name", "barcode-rgx=",
                                 "use-read-groups", "json",
                                 "duplicate-count", "move-umi-to-tag",
                                 "umi-separator="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-r":
            p.remove_dups = True
        elif o == "-l":
            p.max_length = int(v)
        elif o == "-s":
            p.do_stats = True
        elif o == "-T":
            p.tmp_prefix = v
        elif o == "-S":
            p.supp = True
        elif o == "-t":
            p.tag = True
        elif o == "-f":
            p.stats_file = v
            p.do_stats = True
        elif o == "-d":
            p.opt_dist = int(v)
        elif o == "-c":
            p.clear = True
        elif o in ("-m", "--mode"):
            if v == "t":
                p.mode = 0
            elif v == "s":
                p.mode = 1
            else:
                print_error("markdup", "error, unknown mode '%s'.", v)
                return 1
        elif o == "-u":
            level = 0
        elif o == "--include-fails":
            p.include_fails = True
        elif o == "--no-PG":
            p.no_pg = True
        elif o == "--no-multi-dup":
            p.check_chain = False
        elif o == "--read-coords":
            regex = v
        elif o == "--coords-order":
            regex_order = v
        elif o == "--barcode-tag":
            p.barcode = v
        elif o == "--barcode-name":
            bc_name = True
        elif o == "--barcode-rgx":
            bc_name = True
            bc_regex = v
        elif o == "--use-read-groups":
            p.read_groups = True
        elif o == "--json":
            p.json = True
            p.do_stats = True
        elif o == "--duplicate-count":
            p.dc = True
        elif o == "--move-umi-to-tag":
            p.move_umi = True
        elif o == "--umi-separator":
            p.umi_sep = v[0]
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1
    if p.opt_dist < 0:
        p.opt_dist = 0
    if p.max_length < 0:
        p.max_length = 300
    if regex is not None:
        order = {c: i + 1 for i, c in enumerate(regex_order)}
        p.rgx = compile_posix_regex(regex)
        p.rgx_x = order.get("x", 0)
        p.rgx_y = order.get("y", 0)
        p.rgx_t = order.get("t", 0)
    if bc_name:
        p.bc_rgx = compile_posix_regex(bc_regex if bc_regex else BC_NAME_RGX)
    if len(args) < 2:
        usage(sys.stderr if args else sys.stdout)
        return 1

    # streamed input (bounded memory: samtools buffers a coordinate
    # window in a klist, bam_markdup.c; here, decoded chunks held until no
    # later read can alter their dup state); non-BGZF inputs take the
    # in-memory single-chunk path
    stream = None
    if args[0] != "-":
        try:
            stream = BamStream(
                args[0], threads=ga.nthreads or 2,
                window_bytes=int(os.environ.get(
                    "SAMTPU_MARKDUP_WINDOW", str(32 << 20))))
        except OSError as e:
            print_error_errno("markdup",
                              'error, failed to open "%s" for input',
                              args[0], exc=e)
            return 1
        except RuntimeError:    # not a BGZF BAM: read whole
            stream = None
    if stream is not None:
        header = stream.header
        chunks = stream.batches()
    else:
        try:
            f = read_alignments(args[0], threads=ga.nthreads)
        except OSError as e:
            print_error_errno("markdup",
                              'error, failed to open "%s" for input',
                              args[0], exc=e)
            return 1
        header = f.header
        chunks = iter([f.batch])
    if header.sort_order() == "queryname":
        print_error("markdup",
                    "error, queryname sorted, must be sorted by coordinate.")
        return 1
    try:
        rc = run_markdup(p, chunks, header, args, argv, ga, level)
    finally:
        if stream is not None:
            stream.close()
    return rc


class Chunk:
    """One decoded window of coordinate-sorted records plus the mutable
    per-record markdup state (flags, aux edits, qnames, Rec links).

    samtools holds a coordinate window of bam1_t in a klist
    (bam_markdup.c); here the window is a columnar batch + parallel
    arrays, flushed once the stream frontier guarantees no later read
    can alter its records' duplicate state (all pair/single key
    coordinates are unclipped positions, so a record is final once the
    frontier passes its max unclipped coordinate + max_length)."""

    __slots__ = ("b", "fl", "qnames", "aux", "ucl_s", "ucl_e", "score",
                 "ms", "mc", "rg", "bc", "recs", "max_coord", "tid_hi")

    def __init__(self, b, p):
        n = b.n
        self.b = b
        fl = b.flag.astype(np.int64)
        self.qnames = [b.qname_str(i) for i in range(n)]
        aux = [b.aux_of(i) for i in range(n)]
        if p.clear:
            for i in range(n):
                if fl[i] & F.FDUP:
                    fl[i] ^= F.FDUP
                    aux[i] = auxmod.delete_tags(aux[i], {"dt", "do"})
        self.fl = fl
        self.aux = aux
        self.ucl_s = unclipped_start(b, hard=True)
        self.ucl_e = unclipped_end(b, hard=True)
        self.score = _scores(b)
        self.ms = auxmod.batch_tag_values(b, "ms")
        self.mc = auxmod.batch_tag_values(b, "MC")
        self.rg = (auxmod.batch_tag_values(b, "RG") if p.read_groups
                   else None)
        self.bc = (auxmod.batch_tag_values(b, p.barcode) if p.barcode
                   else None)
        self.recs = [Rec(self, i) for i in range(n)]
        placed = b.tid >= 0
        if placed.any():
            self.tid_hi = int(b.tid[placed].max())
            self.max_coord = int(self.ucl_e[placed].max())
        else:
            self.tid_hi = -1
            self.max_coord = -1


def run_markdup(p: Params, chunks, header, args, argv, ga, level) -> int:
    """Streaming duplicate marking over decoded chunks.

    bam_markdup.c architecture: hash maps keyed by unclipped pair /
    single coordinates decide duplicates as records arrive; records wait
    in a bounded window until final, then flush to an incremental
    writer.  Hash entries are evicted once the coordinate frontier
    passes their key coordinate + max_length (no later record's
    unclipped start can reach back further than one read length).  With
    -S the pass-1 output spills to a temp BAM and a second pass applies
    the qname-keyed supplementary marking (samtools' LZ4 tmp_file pass,
    bam_markdup.c:1700)."""
    num_groups = 0
    rg_ids = {}
    if p.read_groups:
        ids = header.rg_ids()
        if ids and len(set(ids)) == len(ids):
            rg_ids = {r: i + 1 for i, r in enumerate(ids)}
            num_groups = len(ids)
        else:
            print_error("markdup", "error, read groups will not be used.")
            p.read_groups = False

    stats = [Stats() for _ in range(num_groups + 1)]
    warns: list[str] = []
    if p.include_fails:
        exclude = F.FSECONDARY | F.FSUPPLEMENTARY | F.FUNMAP
    else:
        exclude = (F.FSECONDARY | F.FSUPPLEMENTARY | F.FUNMAP | F.FQCFAIL)

    pair_hash: dict = {}
    single_hash: dict = {}
    dup_hash: dict = {}
    key_log: deque = deque()       # (tid, coord, kind, key)
    pending: deque = deque()       # unflushed chunks

    out_header = header
    if not p.no_pg:
        cl = "samtools markdup " + " ".join(argv)
        out_header = header.add_pg_line("samtools", "samtools", cl,
                                        SAMTOOLS_PARITY_VERSION)
    fmt = infer_output_format(args[1], ga.out_fmt, "bam")
    tmp_path = tmp_dir = None
    tmp_fmt = "bam"
    if p.supp:
        # large (>2^31) contigs cannot round-trip through BAM; spill SAM
        # text instead (samtools' large-pos territory, bam_sort.c:3445)
        if any(ln >= (1 << 31) for ln in header.ref_lens):
            tmp_fmt = "sam.gz"
        # spill under -T PREFIX when given, else beside the output file,
        # else (stdout output) in a private temp dir -- never CWD litter
        # (samtools routes these via tmp_file.c with a -T prefix)
        if p.tmp_prefix:
            base = p.tmp_prefix
        elif args[1] != "-":
            base = args[1]
        else:
            tmp_dir = tempfile.mkdtemp(prefix="samtpu_markdup_")
            base = os.path.join(tmp_dir, "markdup_tmp")
        tmp_path = base + ".supp.%d.tmp.bam" % os.getpid()
        writer = StreamingWriter(tmp_path, out_header, tmp_fmt,
                                 threads=ga.nthreads, level=1)
    else:
        writer = StreamingWriter(args[1] if args[1] != "-" else None,
                                 out_header, fmt, threads=ga.nthreads,
                                 level=level)

    # ------------------------------------------------------ accessors
    def barcode_of(ch, i):
        if p.barcode:
            v = ch.bc[i]
            return do_hash(str(v).encode("latin-1")) \
                if isinstance(v, str) else 0
        if p.bc_rgx:
            m = p.bc_rgx.search(ch.qnames[i])
            if m and m.start(1) != -1:
                return do_hash(ch.qnames[i][m.start(1):m.end(1)]
                               .encode("latin-1"))
            return 0
        return 0

    def has_mate(rec):
        ch, i = rec.ch, rec.i
        return bool((ch.fl[i] & F.FPAIRED) and not (ch.fl[i] & F.FMUNMAP)
                    and not (ch.b.mtid[i] == -1 and ch.b.mpos[i] == -1))

    def mate_score(rec):
        v = rec.ch.ms[rec.i]
        if v is None or isinstance(v, str):
            print_error("markdup", "error, no ms score tag. Please run "
                        "samtools fixmate on file first.")
            raise KeyError("ms")
        return int(v)

    def mark_dup(ori, dup, rg, optical_field, st: Stats):
        dch, di = dup.ch, dup.i
        dch.fl[di] |= F.FDUP
        if p.tag:
            dch.aux[di] = auxmod.update_str_tag(
                dch.aux[di], "do", ori.ch.qnames[ori.i])
        dup_type = 0
        if p.opt_dist:
            if _is_optical(p, ori.ch.qnames[ori.i], dch.qnames[di],
                           p.opt_dist, warns):
                dch.aux[di] = auxmod.update_str_tag(dch.aux[di], "dt",
                                                    "SQ")
                dup_type = "O"
                setattr(st, optical_field,
                        getattr(st, optical_field) + 1)
            else:
                dch.aux[di] = auxmod.update_str_tag(dch.aux[di], "dt",
                                                    "LB")
        if p.supp:
            if (auxmod.find_tag(dch.aux[di], "SA") is not None
                    or (dch.fl[di] & F.FMUNMAP)
                    or auxmod.find_tag(dch.aux[di], "XA") is not None):
                if dch.qnames[di] not in dup_hash:
                    dup_hash[dch.qnames[di]] = [
                        ori.ch.qnames[ori.i] if p.tag else None,
                        dup_type, rg]

    def optical_retag(rec, paired, st: Stats):
        ch, i = rec.ch, rec.i
        ch.aux[i] = auxmod.update_str_tag(ch.aux[i], "dt", "SQ")
        if paired:
            st.optical += 1
        else:
            st.single_optical += 1
        if p.supp:
            if (auxmod.find_tag(ch.aux[i], "SA") is not None
                    or (ch.fl[i] & F.FMUNMAP)
                    or auxmod.find_tag(ch.aux[i], "XA") is not None):
                if ch.qnames[i] in dup_hash:
                    dup_hash[ch.qnames[i]][1] = "O"

    # ------------------------------------------------- flush machinery
    def finalize_chunk(ch):
        if p.check_chain and (p.tag or p.opt_dist):
            for rec in ch.recs:
                if not rec.dup_checked and (rec.original or rec.duplicate):
                    _find_chains(p, rec, stats, warns, has_mate,
                                 optical_retag)
        n = ch.b.n
        keep = np.ones(n, bool)
        for i in range(n):
            st = stats[ch.recs[i].read_group]
            pre_dup = bool(ch.fl[i] & F.FDUP)
            if p.dc and not pre_dup:
                ch.aux[i] = auxmod.update_int_tag(ch.aux[i], "dc",
                                                  ch.recs[i].dc)
            if not p.remove_dups or not pre_dup:
                st.writing += 1
            if not p.supp:
                if p.remove_dups and (ch.fl[i] & F.FDUP):
                    keep[i] = False
                    continue
                if p.move_umi and p.bc_rgx:
                    newname = _move_umi(p, ch.qnames[i], ch.aux, i)
                    if newname is not None:
                        ch.qnames[i] = newname
        b = ch.b
        b.flag = ch.fl.astype(np.uint16)
        _rebuild(b, ch.aux, ch.qnames)
        out = b if keep.all() else b.take(np.nonzero(keep)[0])
        writer.write_batch(out)

    def evict_keys(ftid, fpos):
        while key_log:
            ktid, kcoord, kind, key = key_log[0]
            if not (ktid < ftid or (ktid == ftid
                                    and kcoord + p.max_length < fpos)):
                break
            key_log.popleft()
            (pair_hash if kind == 0 else single_hash).pop(key, None)

    # ----------------------------------------------------- main pass
    prev_tid = -2
    prev_pos = -2
    rc = 0
    try:
        for batch in chunks:
            if batch.n == 0:
                continue
            ch = Chunk(batch, p)
            b = ch.b
            fl = ch.fl
            # coordinate order check (incremental across chunks)
            tidv = b.tid.astype(np.int64)
            placed = tidv >= 0
            pt = tidv[placed]
            pp = b.pos[placed]
            bad = False
            if pt.size:
                if prev_tid >= 0 and (pt[0] < prev_tid or (
                        pt[0] == prev_tid and pp[0] < prev_pos)):
                    bad = True
                if ((np.diff(pt) < 0).any()
                        or ((np.diff(pt) == 0) & (np.diff(pp) < 0)).any()):
                    bad = True
                prev_tid = int(pt[-1])
                prev_pos = int(pp[-1])
            if bad:
                print_error("markdup",
                            "error, not in coordinate sorted order.")
                rc = 1
                return 1
            pending.append(ch)

            for i in range(b.n):
                rec = ch.recs[i]
                if p.read_groups and isinstance(ch.rg[i], str):
                    rec.read_group = rg_ids.get(ch.rg[i], 0)
                st = stats[rec.read_group]
                st.reading += 1
                if fl[i] & exclude:
                    st.excluded += 1
                    continue
                st.examined += 1
                if has_mate(rec):
                    rec.paired = True
                    pair_key = _make_pair_key(p, b, fl, i, ch.ucl_s,
                                              ch.ucl_e, ch.mc,
                                              barcode_of(ch, i),
                                              rec.read_group)
                    if pair_key is None:
                        rc = 1
                        return 1
                    single_key = _make_single_key(b, fl, i, ch.ucl_s,
                                                  ch.ucl_e,
                                                  barcode_of(ch, i),
                                                  rec.read_group)
                    st.pair += 1
                    got = single_hash.get(single_key)
                    if got is None:
                        single_hash[single_key] = rec
                        key_log.append((single_key[1] - 1, single_key[2],
                                        1, single_key))
                    else:
                        if not has_mate(got):
                            if p.check_chain:
                                rec.duplicate = got
                                got.original = rec
                            single_hash[single_key] = rec
                            rec.dc += 1
                            mark_dup(rec, got, rec.read_group,
                                     "single_optical", st)
                            st.single_dup += 1
                    got = pair_hash.get(pair_key)
                    if got is None:
                        pair_hash[pair_key] = rec
                        key_log.append((pair_key[1] - 1, pair_key[2],
                                        0, pair_key))
                    else:
                        gch, gi = got.ch, got.i
                        if (gch.fl[gi] & F.FQCFAIL) != (fl[i] & F.FQCFAIL):
                            old_score = 0 if gch.fl[gi] & F.FQCFAIL else 1
                            new_score = 1 - old_score
                        else:
                            old_score = int(gch.score[gi]) \
                                + mate_score(got)
                            new_score = int(ch.score[i]) + mate_score(rec)
                        tie_add = 0
                        if new_score == old_score:
                            tie_add = (1 if ch.qnames[i] < gch.qnames[gi]
                                       else -1)
                        if new_score + tie_add > old_score:
                            dup = got
                            rec.dc += got.dc
                            if p.check_chain:
                                if rec.duplicate:
                                    cur = rec.duplicate
                                    while cur.duplicate:
                                        cur = cur.duplicate
                                    cur.duplicate = got
                                else:
                                    rec.duplicate = got
                                got.original = rec
                            pair_hash[pair_key] = rec
                            ori = rec
                        else:
                            if p.check_chain:
                                if got.duplicate:
                                    if rec.duplicate:
                                        cur = got.duplicate
                                        while cur.duplicate:
                                            cur = cur.duplicate
                                        cur.duplicate = rec.duplicate
                                    rec.duplicate = got.duplicate
                                got.duplicate = rec
                                rec.original = got
                            dup = rec
                            got.dc += 1
                            ori = got
                        mark_dup(ori, dup, rec.read_group, "optical", st)
                        st.duplicate += 1
                else:
                    single_key = _make_single_key(b, fl, i, ch.ucl_s,
                                                  ch.ucl_e,
                                                  barcode_of(ch, i),
                                                  rec.read_group)
                    st.single += 1
                    got = single_hash.get(single_key)
                    if got is None:
                        single_hash[single_key] = rec
                        key_log.append((single_key[1] - 1, single_key[2],
                                        1, single_key))
                    else:
                        gch, gi = got.ch, got.i
                        if has_mate(got):
                            if p.check_chain:
                                if got.duplicate:
                                    rec.duplicate = got.duplicate
                                got.duplicate = rec
                                rec.original = got
                            got.dc += 1
                            mark_dup(got, rec, rec.read_group,
                                     "single_optical", st)
                        else:
                            old_score = int(gch.score[gi])
                            new_score = int(ch.score[i])
                            if new_score > old_score:
                                dup = got
                                rec.dc += got.dc
                                if p.check_chain:
                                    rec.duplicate = got
                                    got.original = rec
                                single_hash[single_key] = rec
                                ori = rec
                            else:
                                if p.check_chain:
                                    if got.duplicate:
                                        rec.duplicate = got.duplicate
                                    got.duplicate = rec
                                    rec.original = got
                                got.dc += 1
                                dup = rec
                                ori = got
                            mark_dup(ori, dup, rec.read_group,
                                     "single_optical", st)
                        st.single_dup += 1

            # flush chunks whose records are final vs the new frontier
            if pt.size:
                ftid, fpos = int(pt[0]), int(pp[0])
                evict_keys(ftid, fpos)
                while len(pending) > 1:
                    c0 = pending[0]
                    if c0.tid_hi < ftid or (
                            c0.tid_hi == ftid
                            and c0.max_coord + p.max_length < fpos):
                        finalize_chunk(pending.popleft())
                    else:
                        break
    except KeyError:
        rc = 1
        return 1
    finally:
        if rc == 0:
            while pending:
                finalize_chunk(pending.popleft())
        writer.close()
        if rc != 0 and tmp_path:
            _remove_spill(tmp_path, tmp_dir)

    # ------------------------------------------- supplementary pass 2
    if p.supp:
        final = StreamingWriter(args[1] if args[1] != "-" else None,
                                out_header, fmt, threads=ga.nthreads,
                                level=level)
        try:
            if tmp_fmt == "bam":
                st2 = BamStream(tmp_path, threads=ga.nthreads or 2)
                batches2 = st2.batches()
            else:
                st2 = None
                batches2 = iter([read_alignments(
                    tmp_path, threads=ga.nthreads).batch])
            try:
                for batch in batches2:
                    n = batch.n
                    fl = batch.flag.astype(np.int64)
                    aux_list = None
                    qnames = None
                    keep = np.ones(n, bool)
                    is_supp = (fl & (F.FSUPPLEMENTARY | F.FUNMAP
                                     | F.FSECONDARY)) != 0
                    rows = (range(n) if p.move_umi and p.bc_rgx
                            else np.nonzero(is_supp)[0])
                    for i in rows:
                        if aux_list is None:
                            aux_list = [batch.aux_of(j) for j in range(n)]
                            qnames = [batch.qname_str(j)
                                      for j in range(n)]
                        if is_supp[i]:
                            got = dup_hash.get(qnames[i])
                            if got is not None:
                                fl[i] |= F.FDUP
                                stats[got[2]].np_duplicate += 1
                                if p.tag and got[0]:
                                    aux_list[i] = auxmod.update_str_tag(
                                        aux_list[i], "do", got[0])
                                if p.opt_dist:
                                    if got[1]:
                                        aux_list[i] = \
                                            auxmod.update_str_tag(
                                                aux_list[i], "dt", "SQ")
                                        stats[got[2]].np_opt_duplicate \
                                            += 1
                                    else:
                                        aux_list[i] = \
                                            auxmod.update_str_tag(
                                                aux_list[i], "dt", "LB")
                        if p.remove_dups and (fl[i] & F.FDUP):
                            keep[i] = False
                            continue
                        if p.dc and (fl[i] & F.FDUP):
                            aux_list[i] = auxmod.delete_tags(aux_list[i],
                                                             {"dc"})
                        if p.move_umi and p.bc_rgx:
                            newname = _move_umi(p, qnames[i], aux_list, i)
                            if newname is not None:
                                qnames[i] = newname
                    if p.remove_dups:
                        keep &= (fl & F.FDUP) == 0
                    batch.flag = fl.astype(np.uint16)
                    if aux_list is not None:
                        _rebuild(batch, aux_list, qnames)
                    outb = batch if keep.all() \
                        else batch.take(np.nonzero(keep)[0])
                    final.write_batch(outb)
            finally:
                if st2 is not None:
                    st2.close()
        finally:
            final.close()
            _remove_spill(tmp_path, tmp_dir)

    for w in set(warns):
        sys.stderr.write(w)
    if p.do_stats:
        _write_stats(p, stats, num_groups, header,
                     "samtools markdup " + " ".join(argv))
    return 0


def _remove_spill(path: str, tmp_dir: str | None) -> None:
    """Remove ``-S``'s spill file and the private directory it sat in."""
    for rm, x in ((os.remove, path), (os.rmdir, tmp_dir)):
        if x:
            try:
                rm(x)
            except OSError:
                pass


def _scores(b) -> np.ndarray:
    q = b.qual.astype(np.int64)
    contrib = np.where(q >= MD_MIN_QUALITY, q, 0)
    csum = np.concatenate([[0], np.cumsum(contrib)])
    return csum[b.seq_off[1:]] - csum[b.seq_off[:-1]]


def _make_pair_key(p, b, fl, i, ucl_s, ucl_e, mc_vals, barcode, rg):
    this_ref = int(b.tid[i]) + 1
    other_ref = int(b.mtid[i]) + 1
    this_coord = int(ucl_s[i])
    this_end = int(ucl_e[i])
    mc = mc_vals[i]
    if not isinstance(mc, str):
        print_error("markdup", "error, no MC tag. Please run samtools "
                    "fixmate on file first.")
        return None
    mpos = int(b.mpos[i])
    other_end = unclipped_other_end(mpos, mc, hard=True)
    other_coord = unclipped_other_start(mpos, mc, hard=True)
    rev = bool(fl[i] & F.FREVERSE)
    mrev = bool(fl[i] & F.FMREVERSE)
    read1 = bool(fl[i] & F.FREAD1)

    if p.mode == 0:  # template
        if this_ref != other_ref:
            leftmost = this_ref < other_ref
        else:
            if rev == mrev:
                leftmost = (this_coord <= other_coord if not rev
                            else this_end <= other_end)
            else:
                leftmost = (this_end <= other_coord if rev
                            else this_coord <= other_end)
        if leftmost:
            if rev == mrev:
                other_coord = other_end
                if not rev:
                    orientation = O_FF if read1 else O_RR
                else:
                    orientation = O_RR if read1 else O_FF
            else:
                if not rev:
                    orientation = O_FR
                    other_coord = other_end
                else:
                    orientation = O_RF
                    this_coord = this_end
        else:
            if rev == mrev:
                this_coord = this_end
                if not rev:
                    orientation = O_RR if read1 else O_FF
                else:
                    orientation = O_FF if read1 else O_RR
            else:
                if not rev:
                    orientation = O_RF
                    other_coord = other_end
                else:
                    orientation = O_FR
                    this_coord = this_end
    else:  # sequence mode
        if this_ref != other_ref:
            lm = this_ref - other_ref
        else:
            if rev == mrev:
                lm = (this_coord - other_coord if not rev
                      else this_end - other_end)
            else:
                lm = (this_end - other_coord if rev
                      else this_coord - other_end)
        if lm < 0:
            lm = 1
        elif lm > 0:
            lm = 0
        else:
            if b.pos[i] == b.mpos[i]:
                lm = 1 if read1 else 0
            elif b.pos[i] < b.mpos[i]:
                lm = 1
            else:
                lm = 0
        leftmost = bool(lm)
        if leftmost:
            if rev == mrev:
                orientation = O_FF if not rev else O_RR
            else:
                orientation = O_FR if not rev else O_RF
        else:
            if rev == mrev:
                orientation = O_RR if not rev else O_FF
            else:
                orientation = O_RF if not rev else O_FR
        this_coord = int(ucl_s[i]) if not rev else int(ucl_e[i])
        other_coord = (unclipped_other_start(mpos, mc, hard=True)
                       if not mrev
                       else unclipped_other_end(mpos, mc, hard=True))

    left_read = R_LE if leftmost else R_RI
    return (0, this_ref, this_coord, other_ref, other_coord, left_read,
            orientation, barcode, rg)


def _make_single_key(b, fl, i, ucl_s, ucl_e, barcode, rg):
    this_ref = int(b.tid[i]) + 1
    if fl[i] & F.FREVERSE:
        this_coord = int(ucl_e[i])
        orientation = O_RR
    else:
        this_coord = int(ucl_s[i])
        orientation = O_FF
    return (1, this_ref, this_coord, orientation, barcode, rg)


def _is_optical(p, ori_name, dup_name, max_dist, warns) -> bool:
    o = get_coordinates(p, ori_name)
    d = get_coordinates(p, dup_name)
    if o is None or d is None:
        if o is None:
            warns.append(_coord_warn(ori_name))
        elif d is None:
            warns.append(_coord_warn(dup_name))
        return False
    ob, oe, ox, oy = o
    db, de, dx, dy = d
    if (oe - ob) == (de - db) and ori_name[ob:oe] == dup_name[db:de]:
        if abs(ox - dx) <= max_dist and abs(oy - dy) <= max_dist:
            return True
    return False


def _coord_warn(name):
    return ("samtools markdup: warning, cannot decipher read name %s for "
            "optical duplicate marking.\n" % name)


def _find_chains(p, rec, stats, warns, has_mate, optical_retag):
    while rec.original:
        rec = rec.original
    st = stats[rec.read_group]
    ori_name = rec.ch.qnames[rec.i]
    coords = get_coordinates(p, ori_name) if p.opt_dist else None
    coord_fail = p.opt_dist and coords is None
    if coord_fail:
        warns.append(_coord_warn(ori_name))
    chain = []
    cur = rec.duplicate
    while cur:
        c = {"rec": cur, "x": -1, "y": -1, "opt": False, "score": 0,
             "mate_score": 0, "beg": 0, "end": 0, "len": 0}
        cur.dup_checked = True
        ch, i = cur.ch, cur.i
        if p.tag:
            got = auxmod.get_value(ch.aux[i], "do")
            if got is not None and got[0] == "Z" and got[1] != ori_name:
                ch.aux[i] = auxmod.update_str_tag(ch.aux[i], "do",
                                                  ori_name)
        if p.opt_dist and not coord_fail:
            got = auxmod.get_value(ch.aux[i], "dt")
            if got is not None and got[0] == "Z" and got[1] == "SQ":
                c["opt"] = True
            d = get_coordinates(p, ch.qnames[i])
            if d is not None:
                db, de, dx, dy = d
                ob, oe, ox, oy = coords
                c["x"], c["y"] = dx, dy
                c["beg"], c["end"] = db, de
                c["len"] = de - db
                if not c["opt"] and (oe - ob) == (de - db) \
                        and ori_name[ob:oe] == ch.qnames[i][db:de] \
                        and abs(ox - dx) <= p.opt_dist \
                        and abs(oy - dy) <= p.opt_dist:
                    optical_retag(cur, has_mate(cur), st)
                    c["opt"] = True
            else:
                warns.append(_coord_warn(ch.qnames[i]))
            c["score"] = int(ch.score[i])
            if has_mate(cur):
                v = ch.ms[i]
                c["mate_score"] = int(v) if v is not None else 0
        chain.append(c)
        cur = cur.duplicate
    rec.dup_checked = True
    if coord_fail or not p.opt_dist or len(chain) < 2:
        return

    def _qsub(c):
        return c["rec"].ch.qnames[c["rec"].i][c["beg"]:c["end"]]

    # pairwise optical check within the chain (check_duplicate_chain)
    chain.sort(key=lambda c: (c["len"], _qsub(c), c["x"]))
    L = len(chain)
    curr = 0
    while curr < L - 1:
        base = chain[curr]
        base_sub = _qsub(base)
        end_name = curr
        while True:
            end_name += 1
            if end_name >= L:
                break
            chk = chain[end_name]
            if base["len"] == chk["len"] and _qsub(chk) != base_sub:
                break
        while curr < end_name:
            current = chain[curr]
            cur_paired = has_mate(current["rec"])
            count = curr
            while True:
                count += 1
                if count >= end_name or \
                        chain[count]["x"] - current["x"] > p.opt_dist:
                    break
                chk = chain[count]
                if current["opt"] and chk["opt"]:
                    continue
                if abs(current["y"] - chk["y"]) > p.opt_dist:
                    continue
                chk_paired = has_mate(chk["rec"])
                chk_dup = False
                cfl = current["rec"].ch.fl[current["rec"].i]
                kfl = chk["rec"].ch.fl[chk["rec"].i]
                if cur_paired != chk_paired:
                    if not chk_paired:
                        chk_dup = True
                else:
                    if (cfl & F.FQCFAIL) != (kfl & F.FQCFAIL):
                        cur_score = 0 if cfl & F.FQCFAIL else 1
                        chk_score = 1 - cur_score
                    else:
                        cur_score = current["score"]
                        chk_score = chk["score"]
                        if cur_paired:
                            chk_score += chk["mate_score"]
                            cur_score += current["mate_score"]
                    if cur_score == chk_score:
                        if chk["rec"].ch.qnames[chk["rec"].i] < \
                                current["rec"].ch.qnames[current["rec"].i]:
                            chk_score += 1
                        else:
                            chk_score -= 1
                    if cur_score > chk_score:
                        chk_dup = True
                if chk_dup:
                    if not chk["opt"]:
                        optical_retag(chk["rec"], chk_paired, st)
                        chk["opt"] = True
                else:
                    if not current["opt"]:
                        optical_retag(current["rec"], cur_paired, st)
                        current["opt"] = True
            curr += 1


def _move_umi(p, qname, aux_list, i):
    m = p.bc_rgx.search(qname)
    if not m or m.start(1) == -1:
        return None
    umi = qname[m.start(1):m.end(1)]
    aux_list[i] = auxmod.update_str_tag(aux_list[i], "RX", umi)
    r_start, r_end = m.start(1), m.end(1)
    if r_start > 0 and qname[r_start - 1] == p.umi_sep:
        r_start -= 1
    elif r_end < len(qname) and qname[r_end] == p.umi_sep:
        r_end += 1
    return qname[:r_start] + qname[r_end:]


def _rebuild(b, aux_list, qnames):
    off = np.zeros(b.n + 1, np.int64)
    for i, a in enumerate(aux_list):
        off[i + 1] = off[i] + len(a)
    b.aux = (np.concatenate(aux_list).astype(np.uint8)
             if aux_list else np.empty(0, np.uint8))
    b.aux_off = off
    qoff = np.zeros(b.n + 1, np.int64)
    parts = []
    for i, q in enumerate(qnames):
        eb = q.encode("latin-1")
        parts.append(np.frombuffer(eb, np.uint8))
        qoff[i + 1] = qoff[i] + len(eb)
    b.qname = (np.concatenate(parts).astype(np.uint8)
               if parts else np.empty(0, np.uint8))
    b.qname_off = qoff


def _write_stats(p, stats, num_groups, header, arg_list):
    out = sys.stderr
    opened = False
    if p.stats_file:
        try:
            out = open(p.stats_file, "w")
            opened = True
        except OSError:
            print_error("markdup", "warning, cannot write stats to %s.",
                        p.stats_file)
            out = sys.stderr
    total = Stats()
    for st in (stats if p.read_groups else [stats[0]]):
        for f2 in Stats.FIELDS:
            setattr(total, f2, getattr(total, f2) + getattr(st, f2))
    warns: list = []
    names = header.rg_ids()
    if not p.json:
        _text_block(out, "COMMAND: ", arg_list, total, warns)
        out.write("\n")
        if p.read_groups:
            if stats[0].reading:
                _text_block(out, "READ GROUP: ", "ungrouped", stats[0],
                            warns)
                out.write("\n")
            for gi in range(1, num_groups + 1):
                _text_block(out, "READ GROUP: ", names[gi - 1], stats[gi],
                            warns)
                out.write("\n")
    else:
        out.write("{\n")
        out.write('    "COMMAND": "%s",\n' % arg_list)
        _json_block(out, "    ", None, total, warns)
        out.write(",\n" if p.read_groups else "\n")
        if p.read_groups:
            out.write('    "READ GROUPS": [\n')
            blocks = []
            if stats[0].reading:
                blocks.append(("ungrouped", stats[0]))
            for gi in range(1, num_groups + 1):
                blocks.append((names[gi - 1], stats[gi]))
            for bi, (nm, st) in enumerate(blocks):
                out.write("        {\n")
                _json_block(out, "            ", nm, st, warns)
                out.write("\n")
                out.write("        }" + ("," if bi < len(blocks) - 1
                                         else "") + "\n")
            out.write("    ]\n")
        out.write("}\n")
    for w in warns:
        sys.stderr.write(w)
    if opened:
        out.close()


def _text_block(out, title, title_con, st, warns):
    els = estimate_library_size(st.pair, st.duplicate, st.optical, warns)
    out.write(f"{title}{title_con}\n")
    out.write(
        "READ: %d\nWRITTEN: %d\nEXCLUDED: %d\nEXAMINED: %d\nPAIRED: %d\n"
        "SINGLE: %d\nDUPLICATE PAIR: %d\nDUPLICATE SINGLE: %d\n"
        "DUPLICATE PAIR OPTICAL: %d\nDUPLICATE SINGLE OPTICAL: %d\n"
        "DUPLICATE NON PRIMARY: %d\nDUPLICATE NON PRIMARY OPTICAL: %d\n"
        "DUPLICATE PRIMARY TOTAL: %d\nDUPLICATE TOTAL: %d\n"
        "ESTIMATED_LIBRARY_SIZE: %d\n" % (
            st.reading, st.writing, st.excluded, st.examined, st.pair,
            st.single, st.duplicate, st.single_dup, st.optical,
            st.single_optical, st.np_duplicate, st.np_opt_duplicate,
            st.single_dup + st.duplicate,
            st.single_dup + st.duplicate + st.np_duplicate, els))


def _json_block(out, offset, group_name, st, warns):
    els = estimate_library_size(st.pair, st.duplicate, st.optical, warns)
    if group_name:
        out.write(f'{offset}"READ GROUP": "{group_name}",\n')
    rows = [("READ", st.reading), ("WRITTEN", st.writing),
            ("EXCLUDED", st.excluded), ("EXAMINED", st.examined),
            ("PAIRED", st.pair), ("SINGLE", st.single),
            ("DUPLICATE PAIR", st.duplicate),
            ("DUPLICATE SINGLE", st.single_dup),
            ("DUPLICATE PAIR OPTICAL", st.optical),
            ("DUPLICATE SINGLE OPTICAL", st.single_optical),
            ("DUPLICATE NON PRIMARY", st.np_duplicate),
            ("DUPLICATE NON PRIMARY OPTICAL", st.np_opt_duplicate),
            ("DUPLICATE PRIMARY TOTAL", st.single_dup + st.duplicate),
            ("DUPLICATE TOTAL",
             st.single_dup + st.duplicate + st.np_duplicate)]
    out.write(",\n".join(f'{offset}"{k}": {v}' for k, v in rows))
    out.write(f',\n{offset}"ESTIMATED_LIBRARY_SIZE": {els}')
