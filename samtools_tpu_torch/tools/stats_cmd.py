"""samtools stats on the port — comprehensive per-file statistics (former
bamcheck).

Counterpart of samtools_tpu/tools/stats_cmd.py (``StatsInfo``, ``Barcode``,
``Stats`` with its per-record oracle ``collect``, ``output`` and
``collect_refstats``, ``main_stats``); its output is the JAX tool's, byte
for byte, and samtools' stats.c is the target of both.  The accumulator
follows collect_stats (stats.c:1207) record order exactly — filters,
checksum, per-cycle matrices, insert sizes, indels, GC-depth bins,
coverage round buffer — and output_stats (stats.c:1542) section for
section; float32 is used exactly where the C code computes in `float`.

A BGZF BAM streams in windows through the batch engine
(``stats_batch.collect_batch``), whose per-base histograms run through
K12 (``ops/stats_kernels.py``) on the command's device, or through the
host library with ``SAMTPU_DEVICE=0|host``.  Target regions (``-t``),
read groups (``-I``), ``-p``, ``-S`` splits and regions on the command
line take the per-record oracle, as ``SAMTPU_STATS_SCALAR=1`` makes
every run do.  A BGZF BAM streams; SAM and other inputs are read whole
(regions select from the reads, with no index query, as in the JAX
tool).  A CRAM is read whole, decoded on the host
(``io/cram_decode.py``).

Sections: CHK SN FFQ LFQ MPC GCF GCL GCC GCT FBC FTC LBC LTC (barcodes:
BCC/QTQ/CRC/CYQ/OXC/BZQ/RXC/QXQ) IS RL FRL LRL MAPQ ID IC COV GCD RFS.
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..core.regions import HTS_POS_MAX, parse_region
from ..io import fasta as fastamod
from ..io.files import read_alignments
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, open_stream, pick_device,
                     print_error, print_error_errno)
from .flags_cmd import str2flag

BWA_MIN_RDLEN = 35            # stats.c:66
READ_ORDER_FIRST = 1
READ_ORDER_LAST = 2

# nt16 code -> column in acgtno arrays (a,c,g,t,n,other)
_ACGTNO_COL = np.full(16, 5, np.int64)
_ACGTNO_COL[1] = 0   # A
_ACGTNO_COL[2] = 1   # C
_ACGTNO_COL[4] = 2   # G
_ACGTNO_COL[8] = 3   # T
_ACGTNO_COL[15] = 4  # N

# ACGT ascii -> 1/2/4/8, else 0 (read_ref_seq, stats.c:563)
_REF_CODE = np.zeros(256, np.uint8)
for _c, _v in (("A", 1), ("C", 2), ("G", 4), ("T", 8)):
    _REF_CODE[ord(_c)] = _v
    _REF_CODE[ord(_c.lower())] = _v

_CONSUMES_REF = np.array(F.CIGAR_CONSUMES_REF, np.int64)


class StatsError(SystemExit):
    pass


def error(msg: str):
    sys.stderr.write(msg)
    raise StatsError(1)


class StatsInfo:
    """Options shared across splits (stats_info_t, stats.c:139)."""

    def __init__(self):
        self.flag_require = 0
        self.flag_filter = 0
        self.fai: fastamod.FastaIndex | None = None
        self.gcd_bin_size = 20000          # int, stats.c:2318
        self.nisize = 8000
        self.trim_qual = 0
        self.isize_main_bulk = 0.99
        self.cov_min, self.cov_max, self.cov_step = 1, 1000, 1
        self.filter_readlen = -1
        self.split_tag: str | None = None
        self.split_prefix: str | None = None
        self.remove_overlaps = 0
        self.cov_threshold = 0
        self.ref_stats = 0
        self.ref_chunksz = 1024 * 1024
        self.header = None
        self.argv: list[str] = []
        # where the batch engine's per-base histograms run: a torch device
        # (K12), or None for the host library (SAMTPU_DEVICE=0)
        self.device = None


class Barcode:
    def __init__(self, tag: str, qual: str):
        self.tag_name = tag
        self.qual_name = qual
        self.nbases = 0
        self.tag_sep = -1
        self.max_qual = -1
        self.acgtno = None    # [nbases,6]
        self.quals = None     # [nbases,257]


class Stats:
    """One accumulator (stats_t, stats.c:190).  nquals=257, ngc=200,
    nbases starts at 300 and grows (realloc_buffers, stats.c:697)."""

    NQUALS = 257
    NGC = 200

    def __init__(self, info: StatsInfo, group_id: str | None = None,
                 targets: str | None = None, split_name: str | None = None):
        self.info = info
        self.split_name = split_name
        self.nbases = 300
        self.nindels = 300          # fixed: realloc does not touch nindels
        self.max_qual = 0
        n, q = self.nbases, self.NQUALS
        self.quals_1st = np.zeros((n, q), np.int64)   # [cycle][qual]
        self.quals_2nd = np.zeros((n, q), np.int64)
        self.mpc_buf = np.zeros((n, q), np.int64) if info.fai else None
        self.acgtno_cycles_1st = np.zeros((n, 6), np.int64)
        self.acgtno_cycles_2nd = np.zeros((n, 6), np.int64)
        self.acgtno_revcomp = np.zeros((n, 6), np.int64)
        self.read_lengths = np.zeros(n, np.int64)
        self.read_lengths_1st = np.zeros(n, np.int64)
        self.read_lengths_2nd = np.zeros(n, np.int64)
        self.insertions = np.zeros(n, np.int64)
        self.deletions = np.zeros(n, np.int64)
        self.ins_cycles_1st = np.zeros(n + 1, np.int64)
        self.ins_cycles_2nd = np.zeros(n + 1, np.int64)
        self.del_cycles_1st = np.zeros(n + 1, np.int64)
        self.del_cycles_2nd = np.zeros(n + 1, np.int64)
        self.gc_1st = np.zeros(self.NGC, np.int64)
        self.gc_2nd = np.zeros(self.NGC, np.int64)
        self.mapping_qualities = np.zeros(256, np.int64)
        # insert sizes: dense [nisize+1,3] or sparse dict
        if info.nisize > 0:
            self.isize = np.zeros((info.nisize + 1, 3), np.int64)
            self.isize_sparse = None
        else:
            self.isize = None
            self.isize_sparse: dict[int, list] = {}
            self.isize_sparse_max = 0
        # coverage bins (init_stat_structs, stats.c:2400)
        step = info.cov_step
        if step > info.cov_max - info.cov_min + 1:
            step = info.cov_max - info.cov_min
            if step <= 0:
                step = 1
            info.cov_step = step
        self.ncov = 3 + (info.cov_max - info.cov_min) // info.cov_step
        info.cov_max = (info.cov_min
                        + ((info.cov_max - info.cov_min) // info.cov_step + 1)
                        * info.cov_step - 1)
        self.cov = np.zeros(self.ncov, np.int64)
        self.rbuf = np.zeros(self.nbases * 5, np.int32)
        self.rbuf_start = 0
        self.rbuf_pos = 0
        # scalar counters
        self.nreads_filtered = 0
        self.nreads_1st = self.nreads_2nd = self.nreads_other = 0
        self.nreads_dup = self.total_len_dup = 0
        self.nreads_QCfailed = self.nreads_paired_tech = 0
        self.nreads_secondary = self.nreads_supplementary = 0
        self.nreads_unmapped = self.nreads_single_mapped = 0
        self.nreads_paired_and_mapped = self.nreads_properly_paired = 0
        self.nreads_anomalous = self.nreads_mq0 = 0
        self.total_len = self.total_len_1st = self.total_len_2nd = 0
        self.nbases_mapped = self.nbases_mapped_cigar = 0
        self.nbases_trimmed = 0
        self.nmismatches = 0
        self.max_len = self.max_len_1st = self.max_len_2nd = 0
        self.sum_qual = 0.0
        self.chk_names = self.chk_reads = self.chk_quals = 0
        self.is_sorted = 1
        self.pos = 0
        self.tid = -1
        # GC-depth bins; gcd[0] is the untouched zero bin (igcd starts 0)
        self.gcd: list[list] = [[np.float32(0.0), 0]]
        self.igcd = 0
        self.gcd_pos = -1
        # reference sequence buffer (fai mode)
        self.mrseq_buf = max(self.nbases * 10, info.gcd_bin_size)
        self.rseq_buf = np.zeros(self.mrseq_buf, np.uint8)
        self.rseq_pos = -1
        self.nrseq_buf = 0
        self.rseq_tid = -1   # read_ref_seq stores into stats->tid; but the
        # C code genuinely shares one field for sorting + rseq; mirror that:
        # self.tid plays both roles below (kept single like C).
        # regions / targets
        self.regions: dict[int, dict] = {}
        self.have_regions = False
        self.target_count = 0
        self.reg_from = self.reg_to = 0
        self.chunks: list[tuple[int, int]] = []
        self.rg_set: set[str] | None = None
        # barcodes (init_barcode_tags, stats.c:2379)
        self.tags_barcode = [Barcode("BC", "QT"), Barcode("CR", "CY"),
                             Barcode("OX", "BZ"), Barcode("RX", "QX")]
        self.error_number = 0
        self.last_pair_tid = -2
        self.rstat = None
        if group_id is not None:
            self._init_group_id(group_id)
        if targets is not None:
            self._init_regions(targets)

    # ------------------------------------------------------------ regions

    def _init_group_id(self, gid: str):
        """-I: select RG IDs matching the ID itself or its SM sample
        (init_group_id, stats.c:2151)."""
        self.rg_set = set()
        hdr = self.info.header
        for line in hdr.text.splitlines():
            if not line.startswith("@RG"):
                continue
            fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                          if ":" in f)
            rg_id = fields.get("ID")
            if rg_id is None:
                continue
            if rg_id == gid or fields.get("SM") == gid:
                self.rg_set.add(rg_id)

    def _init_regions(self, path: str):
        """-t targets file: 'name beg end' per line, 1-based inclusive
        (init_regions, stats.c:1957)."""
        hdr = self.info.header
        try:
            fp = open(path, "rt")
        except OSError as e:
            error("%s: %s\n" % (path, e.strerror))
        warned = False
        prev_tid, prev_pos = -1, -1
        with fp:
            for line in fp:
                line = line.rstrip("\n")
                if not line or line[0] == "#":
                    continue
                i = 0
                while i < len(line) and not line[i].isspace():
                    i += 1
                if i >= len(line):
                    error("Could not parse the file: %s [%s]\n"
                          % (path, line))
                name = line[:i]
                tid = hdr.tid(name)
                if tid < 0:
                    if not warned:
                        sys.stderr.write(
                            "Warning: Some sequences not present in the BAM,"
                            " e.g. \"%s\". This message is printed only "
                            "once.\n" % name)
                    warned = True
                    continue
                parts = line[i + 1:].split()
                if len(parts) < 2:
                    error("Could not parse the region [%s]\n" % line[i + 1:])
                try:
                    beg, end = int(parts[0]), int(parts[1])
                except ValueError:
                    error("Could not parse the region [%s]\n" % line[i + 1:])
                reg = self.regions.setdefault(tid, {"pos": [], "cpos": 0})
                if prev_tid == -1 or prev_tid != tid:
                    prev_tid, prev_pos = tid, beg
                if prev_pos > beg:
                    error("The positions are not in chromosomal order "
                          "(%s:%d comes after %d)\n" % (name, beg, prev_pos))
                reg["pos"].append([beg, end])
        if not self.regions:
            error("Unable to map the -t sequences to the BAM sequences.\n")
        # sort + merge (only when end < next beg stay separate)
        for reg in self.regions.values():
            pos = sorted(reg["pos"], key=lambda p: (p[0], p[1]))
            merged = [pos[0]]
            for p in pos[1:]:
                if merged[-1][1] < p[0]:
                    merged.append(p)
                elif merged[-1][1] < p[1]:
                    merged[-1][1] = p[1]
            reg["pos"] = merged
        self._count_targets()
        self.have_regions = True

    def _count_targets(self):
        hdr = self.info.header
        self.target_count = 0
        for tid, reg in self.regions.items():
            for beg, end in reg["pos"]:
                if end < HTS_POS_MAX:
                    self.target_count += end - beg + 1
                else:
                    hdr_end = hdr.ref_lens[tid]
                    if hdr_end:
                        self.target_count += hdr_end - beg + 1

    def replicate_regions(self, merged: dict[int, list]):
        """Copy the multi-region iterator's merged interval list
        (replicate_regions, stats.c:2104); intervals are 0-based
        half-open here, stored 1-based inclusive."""
        for tid, ivals in merged.items():
            self.regions[tid] = {
                "pos": [[b + 1, e] for b, e in ivals], "cpos": 0}
        self._count_targets()
        self.have_regions = True

    def is_in_regions(self, tid: int, pos: int, endpos: int) -> bool:
        """stats.c:2068 — also fills reg_from/reg_to and chunks."""
        if not self.have_regions:
            return True
        if tid < 0 or tid not in self.regions:
            return False
        if not self.is_sorted:
            error("The BAM must be sorted in order for -t to work.\n")
        reg = self.regions[tid]
        pos_list = reg["pos"]
        i = reg["cpos"]
        npos = len(pos_list)
        if i == npos:
            return False
        while i < npos and pos_list[i][1] <= pos:
            i += 1
        if i >= npos:
            reg["cpos"] = npos
            return False
        if endpos < pos_list[i][0]:
            return False
        reg["cpos"] = i
        self.reg_from, self.reg_to = pos_list[i]
        self.chunks = []
        while i < npos:
            if pos < pos_list[i][1] and endpos >= pos_list[i][0]:
                self.chunks.append((max(pos + 1, pos_list[i][0]),
                                    min(endpos, pos_list[i][1])))
            i += 1
        return True

    # ------------------------------------------------------- realloc

    def _realloc_buffers(self, read_len: int):
        """realloc_buffers (stats.c:697): n = 2*(1+len-nbases)+nbases; the
        coverage round buffer grows to len*5 with the C byte-vs-int memcpy
        quirk reproduced exactly."""
        n = 2 * (1 + read_len - self.nbases) + self.nbases

        def grow2(a, rows):
            out = np.zeros((rows, a.shape[1]), a.dtype)
            out[:a.shape[0]] = a
            return out

        def grow1(a, rows):
            out = np.zeros(rows, a.dtype)
            out[:a.shape[0]] = a
            return out

        self.quals_1st = grow2(self.quals_1st, n + 1)
        self.quals_2nd = grow2(self.quals_2nd, n + 1)
        if self.mpc_buf is not None:
            self.mpc_buf = grow2(self.mpc_buf, n)
        self.acgtno_cycles_1st = grow2(self.acgtno_cycles_1st, n)
        self.acgtno_cycles_2nd = grow2(self.acgtno_cycles_2nd, n)
        self.acgtno_revcomp = grow2(self.acgtno_revcomp, n)
        self.read_lengths = grow1(self.read_lengths, n)
        self.read_lengths_1st = grow1(self.read_lengths_1st, n)
        self.read_lengths_2nd = grow1(self.read_lengths_2nd, n)
        self.insertions = grow1(self.insertions, n)
        self.deletions = grow1(self.deletions, n)
        self.ins_cycles_1st = grow1(self.ins_cycles_1st, n + 1)
        self.ins_cycles_2nd = grow1(self.ins_cycles_2nd, n + 1)
        self.del_cycles_1st = grow1(self.del_cycles_1st, n + 1)
        self.del_cycles_2nd = grow1(self.del_cycles_2nd, n + 1)
        self.nbases = n
        # round buffer: C memcpy copies BYTE counts where it means ints
        # (stats.c:769 'memcpy(rbuffer,...,n)' with n in elements) —
        # replicate the byte-level result for parity.
        new = np.zeros(read_len * 5, np.int32)
        old_b = self.rbuf.view(np.uint8)
        new_b = new.view(np.uint8)
        nb = self.rbuf.size - self.rbuf_start
        src = old_b[self.rbuf_start * 4:]
        new_b[:nb] = src[:nb]
        if self.rbuf_start > 1:
            new_b[nb * 4:nb * 4 + self.rbuf_start] = old_b[:self.rbuf_start]
        self.rbuf = new
        self.rbuf_start = 0
        # realloc_rseq_buffer
        m = max(self.nbases * 10, self.info.gcd_bin_size)
        if self.mrseq_buf < m:
            buf = np.zeros(m, np.uint8)
            buf[:self.mrseq_buf] = self.rseq_buf
            self.rseq_buf = buf
            self.mrseq_buf = m

    # -------------------------------------------------- coverage round buf

    def _cov_idx_vec(self, v: np.ndarray) -> np.ndarray:
        info = self.info
        idp = 1 + (v - info.cov_min) // info.cov_step
        idp = np.where(v < info.cov_min, 0, idp)
        idp = np.where(v > info.cov_max, self.ncov - 1, idp)
        return idp

    def round_buffer_flush(self, pos: int):
        """stats.c:329"""
        if pos == self.rbuf_pos:
            return
        size = self.rbuf.size
        new_pos = pos
        if pos == -1 or pos - self.rbuf_pos >= size:
            pos = self.rbuf_pos + size - 1
        if pos < self.rbuf_pos:
            error("Expected coordinates in ascending order, got %d after "
                  "%d\n" % (pos, self.rbuf_pos))
        ifrom = self.rbuf_start
        ito = (self.rbuf_start + (pos - 1 - self.rbuf_pos) % size) % size
        if ifrom > ito:
            self._flush_span(ifrom, size)
            ifrom = 0
        self._flush_span(ifrom, ito + 1)
        self.rbuf_start = (0 if new_pos == -1 else
                           (self.rbuf_start + (pos - self.rbuf_pos) % size)
                           % size)
        self.rbuf_pos = new_pos

    def _flush_span(self, a: int, b: int):
        seg = self.rbuf[a:b]
        nz = seg[seg != 0]
        if nz.size:
            np.add.at(self.cov, self._cov_idx_vec(nz.astype(np.int64)), 1)
            seg[:] = 0

    def round_buffer_insert_read(self, frm: int, to: int):
        """stats.c:372 — [frm, to) 0-based half-open."""
        size = self.rbuf.size
        if to - frm > size:
            error("The read length too big (%d), please increase the buffer"
                  " length (currently %d)\n" % (to - frm, size))
        if frm < self.rbuf_pos:
            error("The reads are not sorted (%d comes after %d).\n"
                  % (frm, self.rbuf_pos))
        ifrom = (self.rbuf_start + (frm - self.rbuf_pos) % size) % size
        ito = (self.rbuf_start + (to - self.rbuf_pos) % size) % size
        if ifrom > ito:
            self.rbuf[ifrom:size] += 1
            ifrom = 0
        self.rbuf[ifrom:ito] += 1

    # -------------------------------------------------------- ref sequence

    def read_ref_seq(self, tid: int, pos: int, end: int):
        """stats.c:563"""
        if end < pos + self.mrseq_buf - 1:
            end = pos + self.mrseq_buf - 1
        elif self.mrseq_buf < end - pos:
            sz = end - pos
            buf = np.zeros(sz, np.uint8)
            buf[:self.mrseq_buf] = self.rseq_buf[:self.mrseq_buf]
            self.rseq_buf = buf
            self.mrseq_buf = sz
        name = self.info.header.ref_name(tid)
        if not self.info.fai.has(name):
            error("Failed to fetch the sequence \"%s\"\n" % name)
        raw = self.info.fai.fetch(name, pos, pos + self.mrseq_buf)
        arr = _REF_CODE[np.frombuffer(raw, np.uint8)]
        self.rseq_buf[:arr.size] = arr
        self.rseq_buf[arr.size:self.mrseq_buf] = 0
        self.nrseq_buf = arr.size
        self.rseq_pos = pos
        self.tid = tid

    def fai_gc_content(self, pos: int, length: int) -> np.float32:
        """stats.c:611 — float32 division like C."""
        i = pos - self.rseq_pos
        ito = min(i + length, self.nrseq_buf)
        seg = self.rseq_buf[i:ito]
        gc = int(((seg == 2) | (seg == 4)).sum())
        count = gc + int(((seg == 1) | (seg == 8)).sum())
        return (np.float32(gc) / np.float32(count) if count
                else np.float32(0))

    # ------------------------------------------------------------- collect

    def _isize_inc(self, isize: int, col: int):
        if self.isize is not None:
            self.isize[isize, col] += 1
        else:
            rec = self.isize_sparse.setdefault(isize, [0, 0, 0])
            rec[col] += 1
            if isize > self.isize_sparse_max:
                self.isize_sparse_max = isize

    def collect(self, rec, read_pairs: dict):
        """collect_stats (stats.c:1207).  rec is a _Rec."""
        info = self.info
        if not self.is_in_regions(rec.tid, rec.pos, rec.endpos):
            return
        if self.rg_set is not None:
            got = auxmod.get_value(rec.aux, "RG")
            if got is None or str(got[1]) not in self.rg_set:
                return
        if info.flag_require and \
                (rec.flag & info.flag_require) != info.flag_require:
            self.nreads_filtered += 1
            return
        if info.flag_filter and (rec.flag & info.flag_filter):
            self.nreads_filtered += 1
            return
        if info.filter_readlen != -1 and rec.l_qseq != info.filter_readlen:
            return

        # update_checksum (stats.c:783)
        self.chk_names = (self.chk_names + zlib.crc32(rec.qname)) \
            & 0xFFFFFFFF
        if rec.l_qseq:
            self.chk_reads = (self.chk_reads
                              + zlib.crc32(rec.packed_seq())) & 0xFFFFFFFF
            self.chk_quals = (self.chk_quals
                              + zlib.crc32(rec.qual.tobytes())) & 0xFFFFFFFF

        if rec.flag & F.FSECONDARY:
            self.nreads_secondary += 1
            return
        if rec.flag & F.FSUPPLEMENTARY:
            self.nreads_supplementary += 1
        seq_len = rec.l_qseq
        if not seq_len:
            return
        if rec.flag & F.FDUP:
            self.total_len_dup += seq_len
            self.nreads_dup += 1

        order = ((1 if rec.flag & F.FREAD1 else 0)
                 + (2 if rec.flag & F.FREAD2 else 0)) \
            if rec.flag & F.FPAIRED else READ_ORDER_FIRST

        read_len = rec.unclipped_length()
        if read_len >= self.nbases:
            self._realloc_buffers(read_len)
        if self.max_len < read_len:
            self.max_len = read_len
        if order == READ_ORDER_FIRST and self.max_len_1st < read_len:
            self.max_len_1st = read_len
        if order == READ_ORDER_LAST and self.max_len_2nd < read_len:
            self.max_len_2nd = read_len
        if (rec.flag & (F.FUNMAP | F.FSECONDARY | F.FSUPPLEMENTARY
                        | F.FQCFAIL | F.FDUP)) == 0:
            self.mapping_qualities[rec.mapq] += 1

        gc_count = 0
        is_original = (rec.flag & (F.FSECONDARY | F.FSUPPLEMENTARY)) == 0
        if is_original:
            self.read_lengths[read_len] += 1
            if order == READ_ORDER_FIRST:
                self.read_lengths_1st[read_len] += 1
            if order == READ_ORDER_LAST:
                self.read_lengths_2nd[read_len] += 1
            gc_count = self._collect_orig_read_stats(rec, order)

        if rec.flag & F.FUNMAP:
            return

        self._count_indels(rec, order)

        paired_and_mapped = ((rec.flag & F.FPAIRED)
                             and not (rec.flag & F.FUNMAP)
                             and not (rec.flag & F.FMUNMAP))
        if paired_and_mapped and is_original:
            isize = rec.tlen
            if isize < 0:
                isize = -isize
            if info.nisize > 0 and isize > info.nisize:
                isize = info.nisize
            if isize > 0 or rec.tid == rec.mtid:
                pos_fst = rec.mpos - rec.pos
                is_fst = 1 if rec.flag & F.FREAD1 else -1
                is_fwd = -1 if rec.flag & F.FREVERSE else 1
                is_mfwd = -1 if rec.flag & F.FMREVERSE else 1
                if is_fwd * is_mfwd > 0:
                    self._isize_inc(isize, 2)
                elif is_fst * pos_fst > 0:
                    self._isize_inc(isize, 0 if is_fst * is_fwd > 0 else 1)
                elif is_fst * pos_fst < 0:
                    self._isize_inc(isize, 1 if is_fst * is_fwd > 0 else 0)
                else:
                    self._isize_inc(isize, 0)

        got = auxmod.get_value(rec.aux, "NM")
        if got is not None:
            self.nmismatches += int(got[1])

        if rec.cigar.size == 0:
            error("FIXME: mapped read with no cigar?\n")
        readlen = self._count_mapped_bases(rec, seq_len)

        if self.tid == rec.tid and rec.pos < self.pos:
            self.is_sorted = 0
        self.pos = rec.pos

        if self.is_sorted:
            if self.tid == -1 or self.tid != rec.tid:
                self.round_buffer_flush(-1)
            if self.last_pair_tid != rec.tid:
                read_pairs.clear()
                self.last_pair_tid = rec.tid

            # GC-depth bins (stats.c:1404)
            if info.fai is not None:
                inc_ref, inc_gcd = 0, 0
                if (self.rseq_pos == -1 or self.tid != rec.tid
                        or self.rseq_pos + self.nrseq_buf
                        < rec.pos + readlen):
                    inc_ref = rec.pos + readlen
                    inc_gcd = 1
                elif (self.gcd_pos + info.gcd_bin_size
                        < rec.pos + readlen):
                    inc_gcd = 1
                    if (self.rseq_pos + self.nrseq_buf
                            < rec.pos + info.gcd_bin_size):
                        inc_ref = rec.pos + info.gcd_bin_size
                if inc_gcd:
                    self.igcd += 1
                    while self.igcd >= len(self.gcd):
                        self.gcd.append([np.float32(0.0), 0])
                    if inc_ref:
                        self.read_ref_seq(rec.tid, rec.pos, inc_ref)
                    self.gcd_pos = rec.pos
                    self.gcd[self.igcd][0] = self.fai_gc_content(
                        self.gcd_pos, info.gcd_bin_size)
                self._count_mismatches_per_cycle(rec, read_len)
            elif (self.gcd_pos == -1 or self.tid != rec.tid
                    or rec.pos - self.gcd_pos > info.gcd_bin_size):
                self.tid = rec.tid
                self.gcd_pos = rec.pos
                self.igcd += 1
                while self.igcd >= len(self.gcd):
                    self.gcd.append([np.float32(0.0), 0])
            self.gcd[self.igcd][1] += 1
            if info.fai is None:
                self.gcd[self.igcd][0] = np.float32(
                    self.gcd[self.igcd][0]
                    + np.float32(gc_count) / np.float32(seq_len))

            # Coverage distribution (stats.c:1453)
            self.round_buffer_flush(rec.pos)
            cig = rec.cigar
            ops = cig & 0xF
            lens = (cig >> 4).astype(np.int64)
            if self.have_regions:
                p = rec.pos
                j, i = 0, 0
                nchunks = len(self.chunks)
                while j < cig.size and i < nchunks:
                    op, oplen = int(ops[j]), int(lens[j])
                    if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
                        pmin = max(p, self.chunks[i][0] - 1)
                        pmax = min(p + oplen, self.chunks[i][1])
                        if pmax > pmin:
                            if info.remove_overlaps:
                                self._remove_overlaps(rec, read_pairs,
                                                      pmin, pmax)
                            else:
                                self.round_buffer_insert_read(pmin, pmax)
                    pnew = p + (oplen if _CONSUMES_REF[op] else 0)
                    if pnew >= self.chunks[i][1]:
                        i += 1
                    else:
                        j += 1
                        p = pnew
            else:
                p = rec.pos
                for j in range(cig.size):
                    op, oplen = int(ops[j]), int(lens[j])
                    if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
                        if info.remove_overlaps:
                            self._remove_overlaps(rec, read_pairs,
                                                  p, p + oplen)
                        else:
                            self.round_buffer_insert_read(p, p + oplen)
                    if _CONSUMES_REF[op]:
                        p += oplen
            if info.remove_overlaps:
                self._remove_overlaps(rec, read_pairs, -1, -1)

    def _collect_orig_read_stats(self, rec, order: int) -> int:
        """stats.c:917 — returns gc_count."""
        seq_len = rec.l_qseq
        self.total_len += seq_len
        if rec.flag & F.FQCFAIL:
            self.nreads_QCfailed += 1
        if rec.flag & F.FPAIRED:
            self.nreads_paired_tech += 1
        seq = rec.seq
        reverse = bool(rec.flag & F.FREVERSE)
        idx = np.arange(seq_len)
        read_cycle = (seq_len - 1 - idx) if reverse else idx
        cols = _ACGTNO_COL[seq]
        acgt = (self.acgtno_cycles_1st if order == READ_ORDER_FIRST
                else self.acgtno_cycles_2nd if order == READ_ORDER_LAST
                else None)
        gc_count = int(((seq == 2) | (seq == 4)).sum())
        if acgt is not None:
            np.add.at(acgt, (read_cycle, cols), 1)
            mask = (seq == 1) | (seq == 2) | (seq == 4) | (seq == 8)
            c2 = cols[mask]
            if reverse:
                c2 = 3 - c2
            np.add.at(self.acgtno_revcomp, (read_cycle[mask], c2), 1)
        gc_idx_min = gc_count * (self.NGC - 1) // seq_len
        gc_idx_max = min((gc_count + 1) * (self.NGC - 1) // seq_len,
                         self.NGC - 1)

        quals = None
        if order == READ_ORDER_FIRST:
            quals = self.quals_1st
            self.nreads_1st += 1
            self.total_len_1st += seq_len
            self.gc_1st[gc_idx_min:gc_idx_max] += 1
        elif order == READ_ORDER_LAST:
            quals = self.quals_2nd
            self.nreads_2nd += 1
            self.total_len_2nd += seq_len
            self.gc_2nd[gc_idx_min:gc_idx_max] += 1
        else:
            self.nreads_other += 1
        if self.info.trim_qual > 0:
            self.nbases_trimmed += _bwa_trim_read(
                self.info.trim_qual, rec.qual, seq_len, reverse)

        if quals is not None:
            q = rec.qual[::-1] if reverse else rec.qual
            q = q.astype(np.int64)
            mq = int(q.max()) if q.size else 0
            if mq > self.max_qual:
                self.max_qual = mq
            np.add.at(quals, (idx, q), 1)
            self.sum_qual += float(q.sum())

        if order == READ_ORDER_FIRST:
            self._collect_barcode_stats(rec)

        if rec.flag & F.FUNMAP:
            self.nreads_unmapped += 1
        else:
            self.nbases_mapped += seq_len
            if not rec.mapq:
                self.nreads_mq0 += 1
            paired_and_mapped = ((rec.flag & F.FPAIRED)
                                 and not (rec.flag & F.FUNMAP)
                                 and not (rec.flag & F.FMUNMAP))
            if not paired_and_mapped:
                self.nreads_single_mapped += 1
            else:
                self.nreads_paired_and_mapped += 1
                if rec.flag & F.FPROPER_PAIR:
                    self.nreads_properly_paired += 1
                if rec.tid != rec.mtid:
                    self.nreads_anomalous += 1
        return gc_count

    def _collect_barcode_stats(self, rec):
        """stats.c:801"""
        for bc_info in self.tags_barcode:
            got = auxmod.get_value(rec.aux, bc_info.tag_name)
            if got is None or got[0] != "Z":
                continue
            barcode = str(got[1])
            if not barcode:
                continue
            if not bc_info.nbases:
                bc_info.nbases = len(barcode)
                bc_info.acgtno = np.zeros((bc_info.nbases, 6), np.int64)
                bc_info.quals = np.zeros((bc_info.nbases, self.NQUALS),
                                         np.int64)
            if len(barcode) > bc_info.nbases:
                sys.stderr.write(
                    "Barcodes with tag %s differ in length at sequence "
                    "'%s'\n" % (bc_info.tag_name,
                                rec.qname.decode("latin-1")))
                continue
            error_flag = False
            for i, ch in enumerate(barcode):
                if ch == "A":
                    bc_info.acgtno[i, 0] += 1
                elif ch == "C":
                    bc_info.acgtno[i, 1] += 1
                elif ch == "G":
                    bc_info.acgtno[i, 2] += 1
                elif ch == "T":
                    bc_info.acgtno[i, 3] += 1
                elif ch == "N":
                    bc_info.acgtno[i, 4] += 1
                else:
                    if bc_info.tag_sep >= 0:
                        if bc_info.tag_sep != i:
                            if self.error_number < 200:
                                sys.stderr.write(
                                    "Barcode separator for tag %s is in a "
                                    "different position or wrong barcode "
                                    "content('%s') at sequence '%s'\n"
                                    % (bc_info.tag_name, barcode,
                                       rec.qname.decode("latin-1")))
                                self.error_number += 1
                            error_flag = True
                    else:
                        bc_info.tag_sep = i
                if error_flag:
                    break
            if error_flag:
                continue
            got = auxmod.get_value(rec.aux, bc_info.qual_name)
            if got is None or got[0] != "Z":
                continue
            barqual = str(got[1])
            if len(barqual) == len(barcode):
                for i, ch in enumerate(barqual):
                    qual = ord(ch) - ord("!")
                    if 0 <= qual < self.NQUALS:
                        bc_info.quals[i, qual] += 1
                        if qual > bc_info.max_qual:
                            bc_info.max_qual = qual
            else:
                self.error_number += 1
                if self.error_number <= 200:
                    sys.stderr.write(
                        "%s length and %s length don't match for sequence "
                        "'%s'\n" % (bc_info.tag_name, bc_info.qual_name,
                                    rec.qname.decode("latin-1")))

    def _count_indels(self, rec, order: int):
        """stats.c:421"""
        is_fwd = not (rec.flag & F.FREVERSE)
        icycle = 0
        read_len = rec.l_qseq
        for c in rec.cigar:
            op = int(c) & 0xF
            ncig = int(c) >> 4
            if not ncig:
                continue
            if op == F.CINS:
                idx = icycle if is_fwd else read_len - icycle - ncig
                if idx < 0 or idx >= self.nbases:
                    error("FIXME: %d vs %d\n" % (idx, self.nbases))
                if order == READ_ORDER_FIRST:
                    self.ins_cycles_1st[idx] += 1
                if order == READ_ORDER_LAST:
                    self.ins_cycles_2nd[idx] += 1
                icycle += ncig
                if ncig <= self.nindels:
                    self.insertions[ncig - 1] += 1
                continue
            if op == F.CDEL:
                idx = icycle - 1 if is_fwd else read_len - icycle - 1
                if idx < 0:
                    continue
                if idx >= self.nbases:
                    error("FIXME: %d vs %d\n" % (idx, self.nbases))
                if order == READ_ORDER_FIRST:
                    self.del_cycles_1st[idx] += 1
                if order == READ_ORDER_LAST:
                    self.del_cycles_2nd[idx] += 1
                if ncig <= self.nindels:
                    self.deletions[ncig - 1] += 1
                continue
            if op not in (F.CREF_SKIP, F.CHARD_CLIP, F.CPAD):
                icycle += ncig

    def _count_mapped_bases(self, rec, seq_len: int) -> int:
        """'bases mapped (cigar)' + readlen incl. deletions
        (stats.c:1337)."""
        readlen = seq_len
        cig = rec.cigar
        ops = cig & 0xF
        lens = (cig >> 4).astype(np.int64)
        if self.have_regions:
            iref = rec.pos + 1
            for j in range(cig.size):
                op, ncig = int(ops[j]), int(lens[j])
                ncig_init = ncig
                if not ncig:
                    continue
                if op == F.CDEL:
                    readlen += ncig
                elif op in (F.CMATCH, F.CEQUAL, F.CDIFF):
                    if iref < self.reg_from:
                        ncig -= self.reg_from - iref
                    if iref + ncig_init - 1 > self.reg_to:
                        ncig -= iref + ncig_init - 1 - self.reg_to
                    if ncig < 0:
                        ncig = 0
                    self.nbases_mapped_cigar += ncig
                    iref += ncig_init
                elif op == F.CINS:
                    iref += ncig
                    if self.reg_from <= iref <= self.reg_to:
                        self.nbases_mapped_cigar += ncig
        else:
            m = ((ops == F.CMATCH) | (ops == F.CINS) | (ops == F.CEQUAL)
                 | (ops == F.CDIFF))
            self.nbases_mapped_cigar += int(lens[m].sum())
            readlen += int(lens[ops == F.CDEL].sum())
        return readlen

    def _count_mismatches_per_cycle(self, rec, read_len: int):
        """stats.c:477 — mpc_buf[cycle][0]=N count, [cycle][q+1]=mismatch
        at base quality q."""
        is_fwd = not (rec.flag & F.FREVERSE)
        iread = icycle = 0
        iref = rec.pos - self.rseq_pos
        seq, quals = rec.seq, rec.qual
        mpc = self.mpc_buf
        for c in rec.cigar:
            op = int(c) & 0xF
            ncig = int(c) >> 4
            if op == F.CINS:
                iread += ncig
                icycle += ncig
                continue
            if op == F.CDEL:
                iref += ncig
                continue
            if op == F.CSOFT_CLIP:
                icycle += ncig
                iread += ncig
                continue
            if op == F.CHARD_CLIP:
                icycle += ncig
                continue
            if op in (F.CREF_SKIP, F.CPAD):
                continue
            if op not in (F.CMATCH, F.CEQUAL, F.CDIFF):
                error("TODO: cigar %d\n" % op)
            if ncig + iref > self.nrseq_buf:
                error("FIXME: %d+%d > %d\n" % (ncig, iref, self.nrseq_buf))
            cread = seq[iread:iread + ncig]
            cref = self.rseq_buf[iref:iref + ncig]
            cyc = np.arange(icycle, icycle + ncig)
            if not is_fwd:
                cyc = read_len - cyc - 1
            is_n = cread == 15
            if is_n.any():
                np.add.at(mpc, (cyc[is_n], 0), 1)
            mism = (cref != 0) & (cread != 0) & (cref != cread) & ~is_n
            if mism.any():
                # `uint8_t qual = quals[iread] + 1` in C wraps 0xFF
                # (missing qual) to column 0 — the N column quirk
                q = (quals[iread:iread + ncig][mism].astype(np.int64)
                     + 1) & 0xFF
                np.add.at(mpc, (cyc[mism], q), 1)
            iref += ncig
            iread += ncig
            icycle += ncig

    def _remove_overlaps(self, rec, read_pairs: dict, pmin: int, pmax: int):
        """-p pair-overlap removal (stats.c:1089); [pmin,pmax) 0-based."""
        order = ((1 if rec.flag & F.FREAD1 else 0)
                 + (2 if rec.flag & F.FREAD2 else 0))
        if (not (rec.flag & F.FPAIRED) or (rec.flag & F.FMUNMAP)
                or abs(rec.tlen) >= 2 * rec.l_qseq
                or order not in (READ_ORDER_FIRST, READ_ORDER_LAST)):
            if pmin >= 0:
                self.round_buffer_insert_read(pmin, pmax)
            return
        qname = rec.qname
        pc = read_pairs.get(qname)
        if pc is None:
            if pmin == -1:
                return
            read_pairs[qname] = {"first": order, "chunks": [[pmin, pmax]]}
        else:
            if order == pc["first"]:
                if pmin == -1:
                    return
                pc["chunks"].append([pmin, pmax])
            else:
                if pmin == -1:
                    del read_pairs[qname]
                    return
                for beg, end in pc["chunks"]:
                    if pmin >= end:
                        continue
                    if pmax <= beg:
                        break
                    if pmin < beg:
                        self.round_buffer_insert_read(pmin, beg)
                        pmin = beg
                    if pmax <= end:
                        self.nbases_mapped_cigar -= pmax - pmin
                        return
                    self.nbases_mapped_cigar -= end - pmin
                    pmin = end
        self.round_buffer_insert_read(pmin, pmax)

    # -------------------------------------------------------------- output

    def _isize_nitems(self) -> int:
        if self.isize is not None:
            return self.isize.shape[0]
        return self.isize_sparse_max + 1

    def _isize_get(self, i: int) -> list:
        if self.isize is not None:
            return self.isize[i]
        return self.isize_sparse.get(i, [0, 0, 0])

    def _isize_halve(self, i: int):
        if self.isize is not None:
            self.isize[i] //= 2
        elif i in self.isize_sparse:
            r = self.isize_sparse[i]
            r[0] //= 2
            r[1] //= 2
            r[2] //= 2

    def output(self, to, sparse: bool):
        """output_stats (stats.c:1542)."""
        info = self.info
        nitems = self._isize_nitems()
        nisize = nisize_in = nisize_out = nisize_other = 0
        for i in range(nitems):
            self._isize_halve(i)
            r = self._isize_get(i)
            nisize_in += int(r[0])
            nisize_out += int(r[1])
            nisize_other += int(r[2])
        nisize = nisize_in + nisize_out + nisize_other

        ibulk = 0
        bulk = avg_isize = 0.0
        for i in range(nitems):
            r = self._isize_get(i)
            num = int(r[0]) + int(r[1]) + int(r[2])
            if num > 0:
                ibulk = i + 1
            bulk += num
            avg_isize += i * num
            if nisize and bulk / nisize > info.isize_main_bulk:
                ibulk = i + 1
                nisize = bulk
                break
        avg_isize /= nisize if nisize else 1
        sd_isize = 0.0
        for i in range(1, ibulk):
            r = self._isize_get(i)
            num = int(r[0]) + int(r[1]) + int(r[2])
            sd_isize += (num * (i - avg_isize) * (i - avg_isize)
                         / (nisize if nisize else 1))
        sd_isize = float(np.sqrt(sd_isize))

        w = to.write
        w("# This file was produced by samtools stats (%s+htslib-%s) and "
          "can be plotted using plot-bamstats\n"
          % (SAMTOOLS_PARITY_VERSION, SAMTOOLS_PARITY_VERSION))
        if self.split_name is not None:
            w("# This file contains statistics only for reads with tag: "
              "%s=%s\n" % (info.split_tag, self.split_name))
        else:
            w("# This file contains statistics for all reads.\n")
        w("# The command line was:  %s\n" % " ".join(info.argv))
        w("# CHK, Checksum\t[2]Read Names\t[3]Sequences\t[4]Qualities\n")
        w("# CHK, CRC32 of reads which passed filtering followed by "
          "addition (32bit overflow)\n")
        w("CHK\t%08x\t%08x\t%08x\n"
          % (self.chk_names, self.chk_reads, self.chk_quals))
        w("# Summary Numbers. Use `grep ^SN | cut -f 2-` to extract this "
          "part.\n")
        nseq = self.nreads_1st + self.nreads_2nd + self.nreads_other
        w("SN\traw total sequences:\t%d\t# excluding supplementary and "
          "secondary reads\n" % (self.nreads_filtered + nseq))
        w("SN\tfiltered sequences:\t%d\n" % self.nreads_filtered)
        w("SN\tsequences:\t%d\n" % nseq)
        w("SN\tis sorted:\t%d\t# %s by coordinate\n"
          % (1 if self.is_sorted else 0,
             "sorted" if self.is_sorted else "not sorted"))
        w("SN\t1st fragments:\t%d\n" % self.nreads_1st)
        w("SN\tlast fragments:\t%d\n" % self.nreads_2nd)
        w("SN\treads mapped:\t%d\n"
          % (self.nreads_paired_and_mapped + self.nreads_single_mapped))
        w("SN\treads mapped and paired:\t%d\t# paired-end technology bit "
          "set + both mates mapped\n" % self.nreads_paired_and_mapped)
        w("SN\treads unmapped:\t%d\n" % self.nreads_unmapped)
        w("SN\treads properly paired:\t%d\t# proper-pair bit set\n"
          % self.nreads_properly_paired)
        w("SN\treads paired:\t%d\t# paired-end technology bit set\n"
          % self.nreads_paired_tech)
        w("SN\treads duplicated:\t%d\t# PCR or optical duplicate bit set\n"
          % self.nreads_dup)
        w("SN\treads MQ0:\t%d\t# mapped and MQ=0\n" % self.nreads_mq0)
        w("SN\treads QC failed:\t%d\n" % self.nreads_QCfailed)
        w("SN\tnon-primary alignments:\t%d\n" % self.nreads_secondary)
        w("SN\tsupplementary alignments:\t%d\n" % self.nreads_supplementary)
        w("SN\ttotal length:\t%d\t# ignores clipping\n" % self.total_len)
        w("SN\ttotal first fragment length:\t%d\t# ignores clipping\n"
          % self.total_len_1st)
        w("SN\ttotal last fragment length:\t%d\t# ignores clipping\n"
          % self.total_len_2nd)
        w("SN\tbases mapped:\t%d\t# ignores clipping\n" % self.nbases_mapped)
        w("SN\tbases mapped (cigar):\t%d\t# more accurate\n"
          % self.nbases_mapped_cigar)
        w("SN\tbases trimmed:\t%d\n" % self.nbases_trimmed)
        w("SN\tbases duplicated:\t%d\n" % self.total_len_dup)
        w("SN\tmismatches:\t%d\t# from NM fields\n" % self.nmismatches)
        w("SN\terror rate:\t%e\t# mismatches / bases mapped (cigar)\n"
          % (float(np.float32(self.nmismatches)
                   / np.float32(self.nbases_mapped_cigar))
             if self.nbases_mapped_cigar else 0.0))
        avg_read_length = (np.float32(self.total_len) / np.float32(nseq)
                           if nseq else np.float32(0))
        w("SN\taverage length:\t%.0f\n" % float(avg_read_length))
        w("SN\taverage first fragment length:\t%.0f\n"
          % (float(np.float32(self.total_len_1st)
                   / np.float32(self.nreads_1st)) if self.nreads_1st else 0))
        w("SN\taverage last fragment length:\t%.0f\n"
          % (float(np.float32(self.total_len_2nd)
                   / np.float32(self.nreads_2nd)) if self.nreads_2nd else 0))
        w("SN\tmaximum length:\t%d\n" % self.max_len)
        w("SN\tmaximum first fragment length:\t%d\n" % self.max_len_1st)
        w("SN\tmaximum last fragment length:\t%d\n" % self.max_len_2nd)
        w("SN\taverage quality:\t%.1f\n"
          % (self.sum_qual / self.total_len if self.total_len else 0))
        w("SN\tinsert size average:\t%.1f\n" % avg_isize)
        w("SN\tinsert size standard deviation:\t%.1f\n" % sd_isize)
        w("SN\tinward oriented pairs:\t%d\n" % nisize_in)
        w("SN\toutward oriented pairs:\t%d\n" % nisize_out)
        w("SN\tpairs with other orientation:\t%d\n" % nisize_other)
        w("SN\tpairs on different chromosomes:\t%d\n"
          % (self.nreads_anomalous // 2))
        w("SN\tpercentage of properly paired reads (%%):\t%.1f\n"
          % (float(np.float32(100 * self.nreads_properly_paired)
                   / np.float32(nseq)) if nseq else 0))
        if self.target_count:
            w("SN\tbases inside the target:\t%d\n" % self.target_count)
            cov_sum = int(self.cov[info.cov_threshold + 1:self.ncov].sum())
            w("SN\tpercentage of target genome with coverage > %d (%%):\t"
              "%.2f\n" % (info.cov_threshold,
                          float(np.float32(100 * cov_sum)
                                / np.float32(self.target_count))))

        if self.max_len < self.nbases:
            self.max_len += 1
        if self.max_qual + 1 < self.NQUALS and self.max_qual < 255:
            self.max_qual += 1
        mq = self.max_qual

        w("# First Fragment Qualities. Use `grep ^FFQ | cut -f 2-` to "
          "extract this part.\n")
        w("# Columns correspond to qualities and rows to cycles. First "
          "column is the cycle number.\n")
        for ibase in range(self.max_len_1st):
            row = self.quals_1st[ibase, :mq + 1]
            w("FFQ\t%d\t%s\n" % (ibase + 1,
                                 "\t".join(str(int(x)) for x in row)))
        w("# Last Fragment Qualities. Use `grep ^LFQ | cut -f 2-` to "
          "extract this part.\n")
        w("# Columns correspond to qualities and rows to cycles. First "
          "column is the cycle number.\n")
        for ibase in range(self.max_len_2nd):
            row = self.quals_2nd[ibase, :mq + 1]
            w("LFQ\t%d\t%s\n" % (ibase + 1,
                                 "\t".join(str(int(x)) for x in row)))
        if self.mpc_buf is not None:
            w("# Mismatches per cycle and quality. Use `grep ^MPC | cut "
              "-f 2-` to extract this part.\n")
            w("# Columns correspond to qualities, rows to cycles. First "
              "column is the cycle number, second\n")
            w("# is the number of N's and the rest is the number of "
              "mismatches\n")
            for ibase in range(self.max_len):
                row = self.mpc_buf[ibase, :mq + 1]
                w("MPC\t%d\t%s\n" % (ibase + 1,
                                     "\t".join(str(int(x)) for x in row)))
        w("# GC Content of first fragments. Use `grep ^GCF | cut -f 2-` "
          "to extract this part.\n")
        self._gc_section(w, "GCF", self.gc_1st)
        w("# GC Content of last fragments. Use `grep ^GCL | cut -f 2-` "
          "to extract this part.\n")
        self._gc_section(w, "GCL", self.gc_2nd)

        w("# ACGT content per cycle. Use `grep ^GCC | cut -f 2-` to "
          "extract this part. The columns are: cycle; A,C,G,T base counts "
          "as a percentage of all A/C/G/T bases [%]; and N and O counts as "
          "a percentage of all A/C/G/T bases [%]\n")
        for ibase in range(self.max_len):
            c1 = self.acgtno_cycles_1st[ibase]
            c2 = self.acgtno_cycles_2nd[ibase]
            s = int(c1[:4].sum() + c2[:4].sum())
            if not s:
                continue
            w("GCC\t%d\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\n"
              % (ibase + 1, 100. * (c1[0] + c2[0]) / s,
                 100. * (c1[1] + c2[1]) / s, 100. * (c1[2] + c2[2]) / s,
                 100. * (c1[3] + c2[3]) / s, 100. * (c1[4] + c2[4]) / s,
                 100. * (c1[5] + c2[5]) / s))
        w("# ACGT content per cycle, read oriented. Use `grep ^GCT | cut "
          "-f 2-` to extract this part. The columns are: cycle; A,C,G,T "
          "base counts as a percentage of all A/C/G/T bases [%]\n")
        for ibase in range(self.max_len):
            c = self.acgtno_revcomp[ibase]
            s = int(c[:4].sum())
            if not s:
                continue
            w("GCT\t%d\t%.2f\t%.2f\t%.2f\t%.2f\n"
              % (ibase + 1, 100. * c[0] / s, 100. * c[1] / s,
                 100. * c[2] / s, 100. * c[3] / s))

        for prefix, total_prefix, acgt, which in (
                ("FBC", "FTC", self.acgtno_cycles_1st, "first"),
                ("LBC", "LTC", self.acgtno_cycles_2nd, "last")):
            tA = tC = tG = tT = tN = 0
            w("# ACGT content per cycle for %s fragments. Use `grep ^%s | "
              "cut -f 2-` to extract this part. The columns are: cycle; "
              "A,C,G,T base counts as a percentage of all A/C/G/T bases "
              "[%%]; and N and O counts as a percentage of all A/C/G/T "
              "bases [%%]\n" % (which, prefix))
            for ibase in range(self.max_len):
                c = acgt[ibase]
                s = int(c[:4].sum())
                tA += int(c[0])
                tC += int(c[1])
                tG += int(c[2])
                tT += int(c[3])
                tN += int(c[4])
                if s:
                    w("%s\t%d\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\n"
                      % (prefix, ibase + 1, 100. * c[0] / s,
                         100. * c[1] / s, 100. * c[2] / s, 100. * c[3] / s,
                         100. * c[4] / s, 100. * c[5] / s))
            w("# ACGT raw counters for %s fragments. Use `grep ^%s | cut "
              "-f 2-` to extract this part. The columns are: A,C,G,T,N "
              "base counters\n" % (which, total_prefix))
            w("%s\t%d\t%d\t%d\t%d\t%d\n"
              % (total_prefix, tA, tC, tG, tT, tN))

        for bc_info in self.tags_barcode:
            if not bc_info.nbases:
                continue
            w("# ACGT content per cycle for barcodes. Use `grep ^%sC | cut "
              "-f 2-` to extract this part. The columns are: cycle; "
              "A,C,G,T base counts as a percentage of all A/C/G/T bases "
              "[%%]; and N counts as a percentage of all A/C/G/T bases "
              "[%%]\n" % bc_info.tag_name)
            for ibase in range(bc_info.nbases):
                if ibase == bc_info.tag_sep:
                    continue
                c = bc_info.acgtno[ibase]
                s = int(c[:4].sum())
                if not s:
                    continue
                half = (1 if bc_info.tag_sep < 0 or ibase < bc_info.tag_sep
                        else 2)
                cyc = (ibase + 1 if half == 1 else ibase - bc_info.tag_sep)
                w("%sC%d\t%d\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\n"
                  % (bc_info.tag_name, half, cyc, 100. * c[0] / s,
                     100. * c[1] / s, 100. * c[2] / s, 100. * c[3] / s,
                     100. * c[4] / s))
            w("# Barcode Qualities. Use `grep ^%sQ | cut -f 2-` to extract "
              "this part.\n" % bc_info.qual_name)
            w("# Columns correspond to qualities and rows to barcode "
              "cycles. First column is the cycle number.\n")
            for ibase in range(bc_info.nbases):
                if ibase == bc_info.tag_sep:
                    continue
                half = (1 if bc_info.tag_sep < 0 or ibase < bc_info.tag_sep
                        else 2)
                cyc = (ibase + 1 if half == 1 else ibase - bc_info.tag_sep)
                row = bc_info.quals[ibase, :bc_info.max_qual + 1]
                w("%sQ%d\t%d%s\n"
                  % (bc_info.qual_name, half, cyc,
                     "".join("\t%d" % int(x) for x in row)))

        w("# Insert sizes. Use `grep ^IS | cut -f 2-` to extract this "
          "part. The columns are: insert size, pairs total, inward "
          "oriented pairs, outward oriented pairs, other pairs\n")
        for i in range(ibulk):
            r = self._isize_get(i)
            a, b, c = int(r[0]), int(r[1]), int(r[2])
            if not sparse or a + b + c > 0:
                w("IS\t%d\t%d\t%d\t%d\t%d\n" % (i, a + b + c, a, b, c))

        w("# Read lengths. Use `grep ^RL | cut -f 2-` to extract this "
          "part. The columns are: read length, count\n")
        for ilen in range(self.max_len):
            if self.read_lengths[ilen + 1] > 0:
                w("RL\t%d\t%d\n" % (ilen + 1, int(self.read_lengths[ilen + 1])))
        w("# Read lengths - first fragments. Use `grep ^FRL | cut -f 2-` "
          "to extract this part. The columns are: read length, count\n")
        for ilen in range(self.max_len_1st):
            if self.read_lengths_1st[ilen + 1] > 0:
                w("FRL\t%d\t%d\n"
                  % (ilen + 1, int(self.read_lengths_1st[ilen + 1])))
        w("# Read lengths - last fragments. Use `grep ^LRL | cut -f 2-` "
          "to extract this part. The columns are: read length, count\n")
        for ilen in range(self.max_len_2nd):
            if self.read_lengths_2nd[ilen + 1] > 0:
                w("LRL\t%d\t%d\n"
                  % (ilen + 1, int(self.read_lengths_2nd[ilen + 1])))

        w("# Mapping qualities for reads !(UNMAP|SECOND|SUPPL|QCFAIL|DUP)."
          " Use `grep ^MAPQ | cut -f 2-` to extract this part. The columns"
          " are: mapq, count\n")
        for imapq in range(256):
            if self.mapping_qualities[imapq] > 0:
                w("MAPQ\t%d\t%d\n"
                  % (imapq, int(self.mapping_qualities[imapq])))

        w("# Indel distribution. Use `grep ^ID | cut -f 2-` to extract "
          "this part. The columns are: length, number of insertions, "
          "number of deletions\n")
        for ilen in range(self.nindels):
            if self.insertions[ilen] > 0 or self.deletions[ilen] > 0:
                w("ID\t%d\t%d\t%d\n" % (ilen + 1, int(self.insertions[ilen]),
                                        int(self.deletions[ilen])))

        w("# Indels per cycle. Use `grep ^IC | cut -f 2-` to extract this "
          "part. The columns are: cycle, number of insertions (fwd), .. "
          "(rev) , number of deletions (fwd), .. (rev)\n")
        for ilen in range(self.nbases + 1):
            if (self.ins_cycles_1st[ilen] > 0 or self.ins_cycles_2nd[ilen] > 0
                    or self.del_cycles_1st[ilen] > 0
                    or self.del_cycles_2nd[ilen] > 0):
                w("IC\t%d\t%d\t%d\t%d\t%d\n"
                  % (ilen + 1, int(self.ins_cycles_1st[ilen]),
                     int(self.ins_cycles_2nd[ilen]),
                     int(self.del_cycles_1st[ilen]),
                     int(self.del_cycles_2nd[ilen])))

        if self.is_sorted:
            w("# Coverage distribution. Use `grep ^COV | cut -f 2-` to "
              "extract this part.\n")
            if self.cov[0]:
                w("COV\t[<%d]\t%d\t%d\n"
                  % (info.cov_min, info.cov_min - 1, int(self.cov[0])))
            for icov in range(1, self.ncov - 1):
                if self.cov[icov]:
                    w("COV\t[%d-%d]\t%d\t%d\n"
                      % (info.cov_min + (icov - 1) * info.cov_step,
                         info.cov_min + icov * info.cov_step - 1,
                         info.cov_min + icov * info.cov_step - 1,
                         int(self.cov[icov])))
            if self.cov[self.ncov - 1]:
                edge = info.cov_min + (self.ncov - 2) * info.cov_step - 1
                w("COV\t[%d<]\t%d\t%d\n"
                  % (edge, edge, int(self.cov[self.ncov - 1])))

            w("# GC-depth. Use `grep ^GCD | cut -f 2-` to extract this "
              "part. The columns are: GC%, unique sequence percentiles, "
              "10th, 25th, 50th, 75th and 90th depth percentile\n")
            for g in self.gcd[:self.igcd]:
                if info.fai is not None:
                    g[0] = np.float32(np.rint(np.float32(100.) * g[0]))
                elif g[1]:
                    g[0] = np.float32(np.rint(np.float32(100.) * g[0]
                                              / np.float32(g[1])))
            items = sorted(self.gcd[:self.igcd + 1],
                           key=lambda g: (float(g[0]), g[1]))
            igcd = 0
            while igcd < self.igcd:
                nbins, itmp = 0, igcd
                gc = items[igcd][0]
                while (itmp < self.igcd
                       and abs(float(items[itmp][0]) - float(gc)) < 0.1):
                    nbins += 1
                    itmp += 1
                group = items[igcd:igcd + nbins]
                scale = float(avg_read_length) / info.gcd_bin_size
                w("GCD\t%.1f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\n"
                  % (float(gc), (igcd + nbins + 1) * 100. / (self.igcd + 1),
                     _gcd_percentile(group, 10) * scale,
                     _gcd_percentile(group, 25) * scale,
                     _gcd_percentile(group, 50) * scale,
                     _gcd_percentile(group, 75) * scale,
                     _gcd_percentile(group, 90) * scale))
                igcd += nbins

        if self.rstat is not None:
            rs = self.rstat
            w("# Reference statistics. Use `grep ^RFS | cut -f 2-` to "
              "extract this part.\n")
            w("# Total count, Output count, Average GC, Min length, Max "
              "length, Average length, Total length in first row.\n")
            w("# Sequence name, Length, GC content, Unknown count in "
              "following rows.\n")
            w("RFS\t%d\t%d\t%.2f\t%d\t%d\t%.2f\t%d\n"
              % (rs["total_count"], rs["count"], float(rs["avggc"]),
                 rs["minlen"], rs["maxlen"], float(rs["avglen"]),
                 rs["combinedlen"]))
            for name, rlen, rgc, rn in rs["rows"]:
                if name is None:
                    continue
                w("RFS\t%s\t%d\t%.2f\t%d\n" % (name, rlen, float(rgc), rn))

    def _gc_section(self, w, prefix: str, gc: np.ndarray):
        prev = 0
        for ibase in range(self.NGC):
            if gc[ibase] == gc[prev]:
                continue
            w("%s\t%.2f\t%d\n" % (prefix,
                                  (ibase + prev) * 0.5 * 100. / (self.NGC - 1),
                                  int(gc[prev])))
            prev = ibase

    # ----------------------------------------------------------- ref stats

    def collect_refstats(self):
        """--ref-stats (collect_refstats, stats.c:2535)."""
        info = self.info
        hdr = info.header
        rs = {"total_count": hdr.n_refs, "count": 0, "combinedlen": 0,
              "minlen": 0, "maxlen": 0, "avglen": np.float32(-1),
              "avggc": np.float32(-1), "rows": []}
        alltrgts = not self.have_regions
        if alltrgts:
            self.regions = {
                tid: {"pos": [[1, HTS_POS_MAX]], "cpos": 0}
                for tid in range(hdr.n_refs)}
            self.have_regions = True
        gcsum = np.float32(0)
        warned = False
        for tid in sorted(self.regions.keys()):
            reg = self.regions[tid]
            if not reg["pos"]:
                continue
            name = hdr.ref_name(tid)
            if name is None:
                continue
            for beg, end0 in reg["pos"]:
                start, end = beg, end0
                if end == HTS_POS_MAX:
                    end = hdr.ref_lens[tid]
                if end < start:
                    rs["rows"].append((None, 0, 0, 0))
                    continue
                rs["count"] += 1
                if not alltrgts:
                    if beg == 1 and end0 == HTS_POS_MAX:
                        rname = name
                    else:
                        rname = "%s:%d-%d" % (name, start, end)
                    hdr_len = hdr.ref_lens[tid]
                    rlen = min(end - start + 1, hdr_len)
                else:
                    rname = name
                    rlen = hdr.ref_lens[tid]
                rs["combinedlen"] += rlen
                if not rs["minlen"] or rs["minlen"] > rlen:
                    rs["minlen"] = rlen
                if rs["maxlen"] < rlen:
                    rs["maxlen"] = rlen
                rgc, rn = np.float32(-1), -1
                if info.fai is None:
                    gcsum = np.float32(-1)
                    rs["rows"].append((rname, rlen, rgc, rn))
                    continue
                if not info.fai.has(name):
                    if not warned:
                        sys.stderr.write(
                            "Warning: Some sequences not present in the "
                            "reference, e.g. \"%s\".                      "
                            "       This message is printed only once.\n"
                            % name)
                    warned = True
                    rs["rows"].append((rname, rlen, rgc, rn))
                    continue
                raw = info.fai.fetch(name, start - 1, end)
                a = np.frombuffer(raw, np.uint8)
                gc = int(np.isin(a, np.frombuffer(b"GgCc", np.uint8)).sum())
                at = int(np.isin(a, np.frombuffer(b"AaTt", np.uint8)).sum())
                cnt_n = int(np.isin(a, np.frombuffer(b"Nn", np.uint8)).sum())
                tot = gc + at
                rgc = (np.float32(gc) / np.float32(tot) if tot
                       else np.float32(0))
                gcsum = np.float32(gcsum + rgc)
                rs["rows"].append((rname, rlen, rgc, cnt_n))
        if rs["count"]:
            rs["avglen"] = np.float32(rs["combinedlen"]) \
                / np.float32(rs["count"])
            rs["avggc"] = (np.float32(-1) if gcsum < 0
                           else gcsum / np.float32(rs["count"]))
        else:
            rs["avglen"] = np.float32(-1)
            rs["avggc"] = np.float32(-1)
        self.rstat = rs


def _gcd_percentile(group: list, p: int) -> float:
    """gcd_percentile (stats.c:1526) — float32 arithmetic."""
    N = len(group)
    n = np.float32(p) * np.float32(N + 1) / np.float32(100)
    k = int(n)
    if k <= 0:
        return float(group[0][1])
    if k >= N:
        return float(group[N - 1][1])
    d = np.float32(n) - np.float32(k)
    return float(np.float32(group[k - 1][1])
                 + d * (np.float32(group[k][1])
                        - np.float32(group[k - 1][1])))


def _bwa_trim_read(trim_qual: int, quals: np.ndarray, length: int,
                   reverse: bool) -> int:
    """stats.c:398"""
    if length < BWA_MIN_RDLEN:
        return 0
    max_trimmed = length - BWA_MIN_RDLEN + 1
    s = max_sum = max_l = 0
    for l in range(max_trimmed):
        s += trim_qual - int(quals[l if reverse else length - 1 - l])
        if s < 0:
            break
        if s > max_sum:
            max_sum = s
            max_l = l
    return max_l


class _Rec:
    """Lightweight per-record view over a ReadBatch."""

    __slots__ = ("flag", "tid", "pos", "mapq", "mtid", "mpos", "tlen",
                 "l_qseq", "cigar", "seq", "qual", "qname", "aux",
                 "endpos", "_packed")

    def __init__(self, b, i: int):
        self.flag = int(b.flag[i])
        self.tid = int(b.tid[i])
        self.pos = int(b.pos[i])
        self.mapq = int(b.mapq[i])
        self.mtid = int(b.mtid[i])
        self.mpos = int(b.mpos[i])
        self.tlen = int(b.tlen[i])
        self.cigar = b.cigar_of(i)
        self.seq = b.seq_of(i)
        self.qual = b.qual_of(i)
        self.l_qseq = self.seq.size
        self.qname = b.qname_str(i).encode("latin-1")
        self.aux = b.aux_of(i)
        self._packed = None
        if self.flag & F.FUNMAP:
            self.endpos = self.pos + 1
        else:
            ops = self.cigar & 0xF
            rlen = int((self.cigar >> 4)[_CONSUMES_REF[ops] > 0].sum()) \
                if self.cigar.size else 0
            self.endpos = self.pos + rlen if rlen else self.pos + 1

    def unclipped_length(self) -> int:
        n = self.l_qseq
        if self.cigar.size:
            hc = (self.cigar & 0xF) == F.CHARD_CLIP
            n += int((self.cigar >> 4)[hc].sum())
        return n

    def packed_seq(self) -> bytes:
        if self._packed is None:
            s = self.seq
            if s.size % 2:
                s = np.concatenate([s, np.zeros(1, np.uint8)])
            self._packed = ((s[0::2] << 4) | s[1::2]).astype(
                np.uint8).tobytes()
        return self._packed


def usage(fp):
    fp.write(
        "About: The program collects statistics from BAM files. The output"
        " can be visualized using plot-bamstats.\n"
        "Usage: samtools stats [OPTIONS] file.bam\n"
        "       samtools stats [OPTIONS] file.bam chr:from-to\n")


LONG_OPTS = ["help", "remove-dups", "sam", "customized-index-file",
             "ref-seq=", "coverage=", "read-length=", "insert-size=",
             "most-inserts=", "trim-quality=", "target-regions=",
             "required-flag=", "filtering-flag=", "id=", "GC-depth=",
             "sparse", "split=", "split-prefix=", "remove-overlaps",
             "cov-threshold=", "ref-stats", "ref-stats-chunk="]


def main_stats(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    info = StatsInfo()
    info.argv = ["stats"] + list(argv)
    targets = None
    group_id = None
    sparse = 0
    has_index_file = False
    try:
        opts, args = gnu_getopt(argv, "?hdsXxpr:c:l:i:t:m:q:f:F:g:I:S:P:@:",
                                LONG_OPTS)
    except UsageError:
        usage(sys.stdout)
        return 1
    try:
        for o, v in opts:
            if o in ("-f", "--required-flag"):
                fl = str2flag(v)
                if fl < 0:
                    print_error("stats", "Unknown flag '%s'", v)
                    return 1
                info.flag_require = fl
            elif o in ("-F", "--filtering-flag"):
                fl = str2flag(v)
                if fl < 0:
                    print_error("stats", "Unknown flag '%s'", v)
                    return 1
                info.flag_filter |= fl
            elif o in ("-d", "--remove-dups"):
                info.flag_filter |= F.FDUP
            elif o in ("-X", "--customized-index-file"):
                has_index_file = True
            elif o in ("-s", "--sam"):
                pass
            elif o in ("-r", "--ref-seq"):
                try:
                    info.fai = fastamod.load_fasta(v)
                except OSError:
                    error("Could not load faidx: %s\n" % v)
            elif o == "--GC-depth":
                info.gcd_bin_size = int(float(v))
            elif o in ("-c", "--coverage"):
                try:
                    cmin, cmax, cstep = (int(x) for x in v.split(","))
                except ValueError:
                    error("Unable to parse -c %s\n" % v)
                info.cov_min, info.cov_max, info.cov_step = cmin, cmax, cstep
            elif o in ("-l", "--read-length"):
                info.filter_readlen = int(v)
            elif o in ("-i", "--insert-size"):
                info.nisize = int(v)
            elif o in ("-m", "--most-inserts"):
                info.isize_main_bulk = float(v)
            elif o in ("-q", "--trim-quality"):
                info.trim_qual = int(v)
            elif o in ("-t", "--target-regions"):
                targets = v
            elif o in ("-I", "--id"):
                group_id = v
            elif o in ("-x", "--sparse"):
                sparse = 1
            elif o in ("-S", "--split"):
                info.split_tag = v
            elif o in ("-P", "--split-prefix"):
                info.split_prefix = v
            elif o in ("-p", "--remove-overlaps"):
                info.remove_overlaps = 1
            elif o in ("-g", "--cov-threshold"):
                info.cov_threshold = int(v)
                if info.cov_threshold < 0:
                    error("Unsupported value for coverage threshold %d\n"
                          % info.cov_threshold)
            elif o == "--ref-stats":
                info.ref_stats = 1
            elif o == "--ref-stats-chunk":
                sz = int(v)
                if sz <= 0:
                    sz = 1
                info.ref_chunksz = sz * 1024 * 1024
            elif o in ("-h", "-?", "--help"):
                usage(sys.stdout)
                return 1
            elif handle_global_opt(ga, o, v):
                pass
            else:
                usage(sys.stdout)
                return 1

        if not args:
            if sys.stdin.isatty():
                usage(sys.stdout)
                return 1
            args = ["-"]
        bam_fname = args[0]
        rest = args[1:]
        if has_index_file:
            if not rest:
                sys.stderr.write("No index file provided\n")
                return 1
            rest = rest[1:]   # index path (we find indices by name anyway)
        region_args = rest
        try:
            info.device = pick_device(device)
        except RuntimeError as e:     # no CUDA card
            return no_card("stats", e)

        # BGZF BAMs stream in bounded windows (the reference's
        # one-record-at-a-time memory profile, stats.c:1212); other
        # formats fall back to the in-memory reader
        stream = None
        b = None
        try:
            stream = open_stream(bam_fname, ga.nthreads)
        except OSError as e:
            print_error_errno("stats", "failed to open \"%s\"", bam_fname,
                              exc=e)
            return 1
        if stream is not None:
            info.header = stream.header
        else:
            try:
                f = read_alignments(bam_fname, threads=ga.nthreads)
            except OSError as e:
                print_error_errno("stats", "failed to open \"%s\"",
                                  bam_fname, exc=e)
                return 1
            info.header = f.header
            b = f.batch

        all_stats = Stats(info, group_id=group_id, targets=targets)
        split_hash: dict[str, Stats] = {}
        read_pairs: dict = {}
        read_pairs_split: dict[str, dict] = {}

        merged: dict[int, list] = {}
        if region_args:
            for ra in region_args:
                r = parse_region(ra, info.header.tid)
                tid, beg, end = r.tid, r.beg, r.end
                if tid < 0:
                    continue
                merged.setdefault(tid, []).append([beg, end])
            for tid, ivals in merged.items():
                ivals.sort()
                out = [ivals[0][:]]
                for bgn, e in ivals[1:]:
                    if bgn <= out[-1][1]:
                        out[-1][1] = max(out[-1][1], e)
                    else:
                        out.append([bgn, e])
                merged[tid] = out
            if not targets:
                all_stats.replicate_regions(merged)
        elif info.cov_threshold > 0 and not targets:
            sys.stderr.write("Coverage percentage calculation requires"
                             " a list of target regions\n")
            return 1

        def _region_sel(wb):
            sel_mask = np.zeros(wb.n, bool)
            endp = _batch_endpos(wb)
            for tid, ivals in merged.items():
                for bgn, e in ivals:
                    sel_mask |= ((wb.tid == tid) & (wb.pos < e)
                                 & (endp > bgn))
            return np.nonzero(sel_mask)[0]

        def _windows():
            if stream is not None:
                for wb in stream.batches():
                    yield wb, (_region_sel(wb) if region_args
                               else range(wb.n))
            else:
                yield b, (_region_sel(b) if region_args else range(b.n))

        # vectorized fast path: whole windows as numpy segment sums, K12's
        # per-base histograms and the host library's sequential residue
        # (stats_batch.py); the per-record loop
        # below stays as the parity oracle and the fallback for
        # per-record-only options.  SAMTPU_STATS_SCALAR=1 forces it.
        from . import stats_batch
        use_batch = (os.environ.get("SAMTPU_STATS_SCALAR") != "1"
                     and not info.split_tag
                     and stats_batch.eligible(all_stats))
        for wb, indices in _windows():
          if use_batch:
            # bounded record chunks keep the flat per-base arrays small
            # (state carries across calls exactly as across windows)
            ind = np.asarray(indices, np.int64)
            step = stats_batch.CHUNK_RECORDS
            for c0 in range(0, ind.size, step):
                stats_batch.collect_batch(all_stats, wb,
                                          ind[c0:c0 + step])
            continue
          for i in indices:
            rec = _Rec(wb, int(i))
            if info.split_tag:
                got = auxmod.get_value(rec.aux, info.split_tag)
                if got is None:
                    error("Tag '%s' not found in bam_line.\n"
                          % info.split_tag)
                split_name = str(got[1])
                cur = split_hash.get(split_name)
                if cur is None:
                    cur = Stats(info, targets=targets,
                                split_name=split_name)
                    split_hash[split_name] = cur
                    read_pairs_split[split_name] = {}
                cur.collect(rec, read_pairs_split[split_name])
            all_stats.collect(rec, read_pairs)

        if info.ref_stats:
            all_stats.collect_refstats()
        all_stats.round_buffer_flush(-1)
        all_stats.output(sys.stdout, sparse)
        if info.split_tag:
            for split_name, st in split_hash.items():
                st.round_buffer_flush(-1)
                prefix = info.split_prefix or bam_fname
                out_path = "%s_%s.bamstat" % (prefix, split_name)
                try:
                    with open(out_path, "w") as to:
                        st.output(to, sparse)
                except OSError:
                    error("Could not open '%s' for writing.\n" % out_path)
        return 0
    except StatsError as e:
        return e.code if isinstance(e.code, int) else 1


def _batch_endpos(b) -> np.ndarray:
    ops = b.cigar & 0xF
    lens = (b.cigar >> 4).astype(np.int64)
    consumes = _CONSUMES_REF[ops] * lens
    cum = np.concatenate([[0], np.cumsum(consumes)])
    rlen = cum[b.cigar_off[1:]] - cum[b.cigar_off[:-1]]
    endp = b.pos + np.maximum(rlen, 1)
    endp = np.where(b.flag & F.FUNMAP, b.pos + 1, endp)
    return endp
