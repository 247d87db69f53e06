"""samtools consensus on the port: FASTA/FASTQ/pileup consensus calling.

Counterpart of samtools_tpu/tools/consensus_cmd.py (:61-1737 and
``main_consensus`` :1912-2257); its output is the JAX tool's, byte for
byte (samtools' bam_consensus.c and consensus_pileup.c).  The gap5
Bayesian caller (with the fast_log2/fast_exp approximations, whose
rounding shows up in output quality values), the simple frequency
caller, the per-read pileup state machine with insertion columns (nth),
the NM/qual-adjust machinery behind --use-MQ, and the fasta/fastq/pileup
writers are copies.

The gap5 modes run the vectorised engine (``_pileup_vec``) over windows
of the pileup table (``ops.pileup.build_pileup``, ordered by K13 on the
card): per-read preparation in the host library (``nm_init_batch``),
then the column sums through K10 (``ops.consensus_vec.
gap5_scores_device``, f64 in entry order: the host loop's sums bit for
bit), where the JAX tool sums in f32 and recomputes the columns its
``finalize_risky`` flags; ``SAMTPU_DEVICE=0|host`` sums with the f64
``gap5_scores`` loop and sorts with numpy.  ``-m simple``,
``-f pileup`` and windows holding pad (P) ops run the scalar engine
(``pileup_loop``).  A BGZF BAM streams in windows of 1 Mi columns; with
``-r`` or ``--regions-file`` an indexed BAM is read through the index,
a window (or, for the scalar engine, a region) at a time
(``BamStream.query``).  An unindexed BAM then takes the JAX tool's
``_NoIndex`` fallback in the port's form: it is read whole and the
region's reads are selected in memory, for both engines (the JAX tool
runs the scalar engine over a streamed scan; the bytes are the same).
SAM and CRAM (decoded on the host, ``io/cram_decode.py``) are read
whole.

``SAMTPU_SHARDS=N`` above 1 on a BGZF BAM, with no region, runs the JAX
tool's span workers where the genome makes two or more spans of at least
1 Mi (``_run_sharded_consensus``): one ``python -m samtools_tpu_torch
consensus`` worker a span, N at a time on the parent's device, each under
``SAMTPU_CONSENSUS_SPAN=tid:beg:end`` (``_span_worker``: the vectorised
engine over the span, read through the index, and the raw ``#SPANMETA
first last`` / sequence / quality records); the parent stitches the spans
with the serial emitter's gap rules.  A worker on an unindexed BAM exits
3, and when every failed worker did so the run is serial, as in the JAX
tool; any other failure exits 1 with the worker's standard error.
"""

from __future__ import annotations

import math
import os
import struct
import sys
import tempfile

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ragged_gather_indices
from ..core.regions import RegionError, parse_region
from ..io import fasta as fastamod
from ..io import native as natmod
from ..io.files import read_alignments
from ..io.stream import WindowedReader
from ..ops import consensus_vec as CV
from ..ops.cigar import expand_ops
from ..ops.pileup import _ENTRY_LUT, build_pileup
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     n_shards, no_card, open_stream, pick_device,
                     print_error, print_error_errno, report_failed,
                     run_span_workers, spans, strip_args, worker_device,
                     worker_env)
from .flags_cmd import str2flag

MODE_SIMPLE = 0
MODE_BAYES_116 = 1
MODE_RECALL = 2
MODE_PRECISE = 3
MODE_MIXED = 4

FASTA, FASTQ, PILEUP = 0, 1, 2

P_HET = 1e-3
P_INDEL = 2e-4
P_HOMOPOLY = 0.5
P_HET_SCALE = 1.0
TENLOG2OVERLOG10 = 3.0103
DBL_MIN = 2.2250738585072014e-308
MIN_E_EXP = -1021 * math.log(2) + 1

CONS_MQUAL = 16

# q2p[i] = 10^(-i/10); mqual_pow_1m[i] = 10^(-(i*0.9)/10), [255]=[10]
# (bam_consensus_tab.h:28)
Q2P = [10 ** (-i / 10.0) for i in range(101)]
MQUAL_POW_1M = [10 ** (-(i * 0.9) / 10.0) for i in range(255)] + [0.0]
MQUAL_POW_1M[255] = MQUAL_POW_1M[10]

# nt16 -> acgt*n order (gap5 L table, bam_consensus.c:1369)
L_TAB = [5, 0, 1, 5, 2, 5, 5, 5, 3, 5, 5, 5, 5, 5, 5, 5] + [4] * 16

MAP_SING = [0, 5, 5, 5, 5, 1, 5, 5, 5, 2, 5, 5, 3, 5, 4]
MAP_HET = [0, 1, 2, 3, 4, 6, 7, 8, 9, 12, 13, 14, 18, 19, 24]
PURE = {0, 5, 9, 12, 14}

E_TAB = [math.exp(i) for i in range(-500, 501)]        # e_tab[i+500]
E_TAB2 = [math.exp(i / 10.0) for i in range(-500, 501)]


def fast_log2(val: float) -> float:
    """bam_consensus.c:898 — Taylor deg-3 log2 via double bit tricks."""
    x = struct.unpack("<Q", struct.pack("<d", val))[0]
    E = ((x >> 52) & 2047) - 1024
    x &= ~(2047 << 52)
    x += 1023 << 52
    m = struct.unpack("<d", struct.pack("<Q", x))[0]
    return E + ((-1 / 3.0) * m + 2) * m - 2 / 3.0


def ph_log(x: float) -> float:
    return -TENLOG2OVERLOG10 * fast_log2(x)


def fast_exp(y: float) -> float:
    if -50 <= y <= 50:
        return E_TAB2[int(y * 10) + 500]
    if y < -500:
        y = -500.0
    if y > 500:
        y = 500.0
    return E_TAB[int(y) + 500]


class Qcal:
    def __init__(self):
        self.smap = list(range(100))
        self.umap = list(range(100))
        self.omap = list(range(100))


_QCAL_STATIC: dict[str, tuple] | None = None


def _load_static_qcal():
    """The five non-flat calibration tables, selectable with -X (FLAT is
    the identity)."""
    # measured calibration constants, as data (samtools'
    # bam_consensus.c:451 static_qcal)
    hifi_s = [10, 11, 11, 12, 13, 14, 15, 16, 18, 19, 20, 21, 22, 23, 24,
              25, 27, 28, 29, 30, 31, 32, 33, 33, 34, 35, 36, 36, 37, 38,
              38, 39, 39, 40, 40, 41, 41, 41, 41, 42, 42, 42, 42, 43, 43,
              43, 43, 43, 43, 43] + [44] * 50
    hifi_u = [4, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 11, 12, 13, 14, 15,
              15, 16, 17, 18, 19, 19, 20, 20, 21, 22, 23, 23, 24, 25, 25,
              25, 26, 26, 26, 27, 27, 28, 28, 28, 28, 27, 27, 27, 28, 28,
              28, 28, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27,
              26, 26, 25, 26, 26, 27, 27, 27, 26, 26, 26, 26, 26, 26, 26,
              26, 27, 27, 28, 29, 28, 28, 28, 27, 27, 27, 27, 27, 27, 28,
              28, 30, 30, 30, 30, 30, 30, 30]
    hifi_o = [8, 8, 8, 8, 9, 10, 11, 12, 13, 14, 15, 15, 16, 17, 18, 19,
              19, 20, 20, 21, 21, 22, 22, 23, 23, 23, 24, 24, 24, 25, 25,
              25, 25, 25, 25, 26, 26, 26, 26, 27, 27, 27, 27, 27, 27, 28,
              28, 28, 28, 28, 29, 29, 29, 29, 29, 29] + [30] * 44
    hiseq_s = [2, 2, 2, 3, 3, 4, 5, 5, 6, 7, 8, 9, 10, 11, 11, 12, 13,
               14, 15, 16, 17, 17, 18, 19, 20, 21, 22, 22, 23, 24, 25,
               26, 27, 28, 28, 29, 30, 31, 32, 33, 34, 34, 35, 36, 37,
               38, 39, 39, 40, 41, 42, 43, 44, 45, 45, 46, 47, 48, 49,
               50, 51, 51, 52, 53, 54, 55, 56, 56, 57, 58, 59, 60, 61,
               62, 62, 63, 64, 65, 66, 67, 68, 68, 69, 70, 71, 72, 73,
               73, 74, 75, 76, 77, 78, 79, 79, 80, 81, 82, 83, 84]
    hiseq_uo = []
    for dec in range(10):
        base = [1, 2, 3, 4, 5, 7, 8, 9, 10, 11]
        hiseq_uo.extend(x + 12 * dec for x in base)
    ont_s = [0, 2, 2, 2, 3, 4, 4, 5, 6, 7, 7, 8, 9, 12, 13, 14, 15, 15,
             16, 17, 18, 19, 20, 22, 24, 25, 26, 27, 28, 29, 30, 31, 33,
             34, 36, 37, 38, 38, 39, 39, 40, 40, 40, 40, 40, 40, 40, 41,
             40, 40, 41, 41, 40, 40, 40, 40, 41, 40, 40, 40, 40, 41, 41,
             40, 40, 41, 40, 40, 39, 41, 40, 41, 40, 40, 41, 41, 41, 40,
             40, 40] + [40] * 20
    ont_u = [0, 2, 2, 2, 3, 4, 5, 6, 7, 8, 8, 9, 9, 10, 10, 10, 11, 12,
             12, 13, 13, 13, 14, 14, 15, 16, 16, 17, 18, 18, 19, 19, 20,
             21, 22, 23, 24, 25, 25, 25, 25, 25, 25, 25, 25, 25, 26, 26,
             26, 26, 26, 26, 26, 26, 27, 27, 27, 27, 27, 27, 27, 27, 27,
             27, 27, 27, 27, 28, 28, 28] + [28] * 30
    ont_o = [0, 4, 6, 6, 6, 7, 7, 8, 9, 9, 9, 10, 10, 11, 11, 12, 12,
             13, 13, 14, 15, 15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20,
             20, 21, 22, 22, 23, 23, 24, 24] + [24] * 60
    ult_s = [2, 2, 3, 4, 5, 6, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 14,
             15, 16, 17, 18, 18, 19, 21, 22, 23, 23, 24, 25, 26, 27, 27,
             28, 29, 30, 31, 31, 32, 33, 34, 35, 35, 36, 37, 38, 39, 39,
             40, 42, 43, 44, 44, 45, 46, 47, 48, 48, 49, 50, 51, 52, 52,
             53, 54, 55, 56, 56, 57, 58, 59, 60, 60, 61, 63, 64, 65, 65,
             66, 67, 68, 69, 69, 70, 71, 72, 73, 73, 74, 75, 76, 77, 77,
             78, 79, 80, 81, 81, 82, 84, 85]
    ult_u = [1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
             10, 10, 10, 11, 12, 13, 13, 13, 14, 15, 16, 16, 16, 17, 18,
             18, 19, 19, 20, 20, 21, 21, 22, 22, 22, 22, 23, 23, 24, 24,
             25, 25, 25, 25, 25, 25, 25, 26, 26, 26, 26, 26, 26, 27, 27,
             27, 27, 27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 28, 28, 28,
             28] + [28] * 20
    return {
        "hifi": (hifi_s, hifi_u, hifi_o),
        "hiseq": (hiseq_s, hiseq_uo, hiseq_uo),
        "r10.4_sup": (ont_s, ont_u, ont_o),
        "r10.4_dup": (hifi_s, hifi_u, hifi_o),
        "ultima": (ult_s, ult_u, ult_u),
    }


class ConsProbs:
    """cons_probs (bam_consensus.c:361) built by consensus_init."""

    def __init__(self, p_het, p_indel, het_scale, poly_mul, qcal: Qcal,
                 mode: int):
        self.poly_mul = poly_mul
        prior = [p_het / 6] * 25
        for i in (0, 6, 12, 18, 24):
            prior[i] = 1.0
        for i in range(4, 24, 5):
            prior[i] = p_indel / 6
        for i in range(20, 24):
            prior[i] = p_indel / 6
        self.lprior15 = [math.log(prior[i]) for i in
                         (0, 1, 2, 3, 4, 6, 7, 8, 9, 12, 13, 14, 18, 19,
                          24)]
        n = 101
        self.pMM = [0.0] * n
        self.pxx = [0.0] * n
        self.pxM = [0.0] * n
        self.pox = [0.0] * n
        self.poM = [0.0] * n
        self.poo = [0.0] * n
        self.puu = [0.0] * n
        self.pum = [0.0] * n
        self.pmm = [0.0] * n
        for i in range(1, 101):
            prob = 1 - 10 ** (-qcal.smap[min(i, 99)] / 10.0) \
                if i < 100 else 1 - 10 ** (-qcal.smap[99] / 10.0)
            # C indexes qcal->smap[i] with i up to 100 on a [101]-array
            # but the table is size 100; i==100 reads past — clamp to 99
            # which matches the adjacent memory layout (umap[0]) only by
            # luck; in practice quals cap at 93 so it is unreachable.
            self.pMM[i] = math.log(prob)
            self.pxx[i] = math.log((1 - prob) / 3)
            self.pxM[i] = math.log(
                (math.exp(self.pMM[i]) + math.exp(self.pxx[i])) / 2)
            self.pxM[i] += math.log(het_scale)
            if mode == MODE_BAYES_116:
                self.pmm[i] = self.pMM[i]
                self.poM[i] = self.pxM[i]
                self.pum[i] = self.pxM[i]
                self.pox[i] = self.pxx[i]
                self.poo[i] = self.pxx[i]
                self.puu[i] = self.pxx[i]
            else:
                prob = 1 - 10 ** (-qcal.omap[min(i, 99)] / 10.0)
                self.poo[i] = math.log((1 - prob) / 3)
                if self.poo[i] > self.pMM[i] - .5:
                    self.poo[i] = self.pMM[i] - .5
                self.pox[i] = math.log(
                    (math.exp(self.poo[i]) + math.exp(self.pxx[i])) / 2)
                self.poM[i] = math.log(
                    (math.exp(self.poo[i]) + math.exp(self.pMM[i])) / 2)
                if self.poM[i] > self.pxM[i] + .5:
                    self.poM[i] = self.pxM[i] + .5
                prob = 1 - 10 ** (-qcal.umap[min(i, 99)] / 10.0)
                self.pmm[i] = math.log(prob)
                self.puu[i] = math.log((1 - prob) / 3)
                if self.puu[i] > self.pMM[i] - .5:
                    self.puu[i] = self.pMM[i] - .5
                self.pum[i] = math.log(
                    (math.exp(self.puu[i]) + math.exp(self.pmm[i])) / 2)
        for t in (self.pMM, self.pxx, self.pxM, self.pmm, self.poo,
                  self.pox, self.poM, self.puu, self.pum):
            t[0] = t[1]


class Opts:
    def __init__(self):
        self.mode = MODE_RECALL
        self.use_qual = 0
        self.min_qual = 0
        self.adj_qual = 1
        self.use_mqual = 1
        self.scale_mqual = 1.0
        self.nm_adjust = 1
        self.nm_halo = 50
        self.sc_cost = 60
        self.low_mqual = 1
        self.high_mqual = 60
        self.min_depth = 1
        self.call_fract = 0.75
        self.het_fract = 0.5
        self.het_only = 0
        self.fmt = FASTA
        self.cons_cutoff = 10
        self.ambig = 0
        self.line_len = 70
        self.default_qual = 10
        self.all_bases = 0
        self.show_del = 0
        self.show_ins = 1
        self.mark_ins = 0
        self.incl_flags = 0
        self.excl_flags = (F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP)
        self.min_mqual = 0
        self.P_het = P_HET
        self.P_indel = P_INDEL
        self.het_scale = P_HET_SCALE
        self.homopoly_fix = 0.0
        self.homopoly_redux = 0.01
        self.qcal = Qcal()
        self.ref_fn = None
        self.ref_qual = 0
        self.reg = None
        self.bed = None
        self.fp_out = sys.stdout
        self.header = None
        self.fai = None
        self.cp_recall = None
        self.cp_precise = None
        self.dev = None     # where K10 and K13 run; None: the host branch


# ------------------------------------------------------------------ pileup

class PRead:
    """pileup_t (consensus_pileup.h) per-read state."""

    __slots__ = ("tid", "rpos", "mapq", "flag", "seq", "qual_arr",
                 "cigar", "qname", "md",
                 "pos", "nth", "seq_offset", "cigar_ind", "cigar_len",
                 "cigar_op", "start", "eof", "first_del", "ref_skip",
                 "padding", "base", "base4", "qual", "b_is_rev", "cd",
                 "l_qseq")

    def __init__(self, b, i):
        self.tid = int(b.tid[i])
        self.rpos = int(b.pos[i])
        self.mapq = int(b.mapq[i])
        self.flag = int(b.flag[i])
        self.seq = b.seq_of(i)
        self.qual_arr = b.qual_of(i)
        self.cigar = b.cigar_of(i)
        self.l_qseq = self.seq.size
        self.md = None
        got = auxmod.get_value(b.aux_of(i), "MD")
        if got is not None and got[0] == "Z":
            self.md = str(got[1])
        self.pos = self.rpos  # set properly on add (pos-1 semantics)
        self.nth = 0
        self.seq_offset = -1
        self.cigar_ind = 0
        self.cigar_len = 0
        self.cigar_op = -1
        self.start = 2
        self.eof = 0
        self.first_del = 0
        self.ref_skip = 0
        self.padding = 0
        self.base = 0
        self.base4 = 0
        self.qual = 0
        self.b_is_rev = bool(self.flag & F.FREVERSE)
        self.cd = None

    def qual_at(self, i):
        if 0 <= i < self.l_qseq:
            return int(self.qual_arr[i])
        return 0


BASE_CHARS = "NACMGRSVTWYHKDBN"


def get_next_base(p: PRead, pos: int, nth: int) -> tuple[int, int]:
    """consensus_pileup.c:81.  Returns (got_base, is_insert)."""
    op = p.cigar_op
    ncigar = p.cigar.size
    if p.start > 0:
        p.start -= 1
    if p.first_del and op != F.CPAD:
        p.first_del = 0
    is_insert = 0

    while p.pos < pos:
        p.nth = 0
        if p.cigar_len == 0:
            if p.cigar_ind >= ncigar:
                p.eof = 1
                return 0, 0
            c = int(p.cigar[p.cigar_ind])
            op = p.cigar_op = c & 0xF
            p.cigar_len = c >> 4
            p.cigar_ind += 1
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF) \
                and p.cigar_len <= pos - p.pos:
            p.seq_offset += p.cigar_len
            p.pos += p.cigar_len
            p.cigar_len = 0
        else:
            if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
                p.seq_offset += 1
                p.pos += 1
                p.cigar_len -= 1
            elif op in (F.CDEL, F.CREF_SKIP):
                p.pos += 1
                p.cigar_len -= 1
            elif op in (F.CINS, F.CSOFT_CLIP):
                p.seq_offset += p.cigar_len
                p.cigar_len = 0
            elif op in (F.CPAD, F.CHARD_CLIP):
                p.cigar_len = 0
            else:
                return -1, 0

    while p.nth < nth:
        if p.cigar_len == 0:
            if p.cigar_ind >= ncigar:
                p.eof = 1
                return 0, 0
            c = int(p.cigar[p.cigar_ind])
            op = p.cigar_op = c & 0xF
            p.cigar_len = c >> 4
            p.cigar_ind += 1
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF, F.CSOFT_CLIP, F.CDEL,
                  F.CREF_SKIP):
            break
        elif op == F.CINS:
            p.seq_offset += 1
            p.cigar_len -= 1
            p.nth += 1
        elif op == F.CPAD:
            p.cigar_len -= 1
            p.nth += 1
        elif op == F.CHARD_CLIP:
            p.cigar_len = 0
        else:
            return -1, 0

    p.ref_skip = 0
    if p.nth < nth and op != F.CINS:
        p.base = "*"
        p.base4 = 16
        p.padding = 1
        if p.seq_offset < p.l_qseq:
            p.qual = min(p.qual, p.qual_at(p.seq_offset + 1))
        else:
            p.qual = 0
    else:
        p.padding = 0
        if op == F.CDEL or op == F.CPAD:
            p.base = "*"
            p.base4 = 16
            if p.seq_offset + 1 < p.l_qseq:
                p.qual = min(p.qual, p.qual_at(p.seq_offset + 1))
            else:
                p.qual = min(p.qual, p.qual_at(p.seq_offset))
        elif op == F.CREF_SKIP:
            p.base = "."
            p.base4 = 0
            p.qual = 0
            p.eof = 2 if p.eof else 3
            p.ref_skip = 1
        else:
            if p.seq_offset < p.l_qseq:
                p.qual = int(p.qual_arr[p.seq_offset])
                p.base4 = int(p.seq[p.seq_offset])
                p.base = BASE_CHARS[p.base4]
            else:
                p.base = "N"
                p.base4 = 15
                p.qual = 0xFF

    if p.eof and p.base != ".":
        p.start = 1
        p.ref_skip = 1
        p.eof = 0

    if p.start and p.cigar_op == F.CDEL:
        p.first_del = 1

    if p.cigar_len == 0:
        if p.cigar_ind < ncigar:
            c = int(p.cigar[p.cigar_ind])
            op = p.cigar_op = c & 0xF
            p.cigar_len = c >> 4
            p.cigar_ind += 1
            if op == F.CREF_SKIP:
                p.eof = 3
                p.ref_skip = 1
        else:
            p.eof = 1

    if op in (F.CPAD, F.CINS):
        is_insert = p.cigar_len
    elif op == F.CSOFT_CLIP:
        p.eof = 1 if (p.cigar_ind == ncigar
                      or (p.cigar_ind + 1 == ncigar
                          and (int(p.cigar[p.cigar_ind]) & 0xF)
                          == F.CHARD_CLIP)) else 0
    elif op == F.CHARD_CLIP:
        p.eof = 1

    return 1, is_insert


def pileup_loop(records, seq_init, seq_column, client):
    """consensus_pileup.c:305 — records is an iterator of PRead."""
    plist: list[PRead] = []
    nth = 0
    col = 0
    last_ref = -1
    it = iter(records)
    pend = None
    while True:
        if pend is None:
            pnew = next(it, None)
        else:
            pnew = pend
            pend = None
        if pnew is not None:
            if pnew.flag & F.FUNMAP or pnew.tid == -1:
                continue
            if pnew.tid == last_ref:
                pos = pnew.rpos + 1
            else:
                pos = None  # HTS_POS_MAX
        else:
            pos = None

        if pos is not None and col > pos:
            sys.stderr.write("BAM/SAM file is not sorted by position. "
                             "Aborting\n")
            return -1

        while (pos is None or col < pos) and plist:
            is_insert = 0
            depth = 0
            keep = []
            eofs = []
            for p in plist:
                got, ins = get_next_base(p, col, nth)
                if got < 0:
                    return -1
                if got == 0:
                    p.eof = 1
                if p.eof == 1:
                    eofs.append(p)
                else:
                    keep.append(p)
                if is_insert < ins:
                    is_insert = ins
                depth += 1
            v = seq_column(client, plist, depth, col, nth, is_insert)
            plist = keep
            if v == 1:
                break
            if v != 0:
                return -1
            if is_insert:
                nth += 1
            else:
                nth = 0
                col += 1

        if pnew is None:
            break
        col = pos if pos is not None else col

        if pnew.tid != last_ref:
            last_ref = pnew.tid
            pos = pnew.rpos + 1
            nth = 0
            col = pos

        p = pnew
        p.pos = pos - 1
        if seq_init is not None:
            v = seq_init(client, p)
            if v == -1:
                return -1
            if v == 1:
                plist.append(p)
        else:
            plist.append(p)
    return 0


# --------------------------------------------------------- gap5 machinery

def nm_init(client, p: PRead) -> int:
    """bam_consensus.c:1012 — local NM / qual adjust / poly lengths."""
    opts = client.opts
    if not opts.use_mqual:
        return 1
    qlen = p.l_qseq
    if qlen <= 0:
        return 0
    local_nm = [0] * qlen
    p.cd = local_nm
    poly_adj = opts.homopoly_fix if opts.homopoly_fix else 1.0
    qual = p.qual_arr
    seq = p.seq

    if opts.adj_qual:
        qhalo = 8
        qhalop = 2
        qmin = int(qual[0]) if qlen else 0
        qminp = int(qual[0]) if qlen else 0
        base = int(seq[0]) if qlen else 0
        polyl = polyr = 0
        for i in range(1, qlen):
            if int(seq[i]) != base:
                break
            if i < qhalop and qminp > int(qual[i]):
                qminp = int(qual[i])
        i = 0
        while i < qlen and i < qhalo:
            if qmin > int(qual[i]):
                qmin = int(qual[i])
            i += 1
        while i < qlen - qhalo:
            if opts.homopoly_fix and int(seq[i]) != base:
                polyl = i
                base = int(seq[i])
                qminp = int(qual[i])
                j = i + 1
                while j < qlen:
                    if int(seq[j]) != base:
                        break
                    if i < qhalop and qminp > int(qual[j]):
                        qminp = int(qual[j])
                    j += 1
                polyr = j - 1
            else:
                polyr = polyl
            pl = polyr - polyl
            if opts.mode == MODE_BAYES_116:
                t = (int(qual[i]) + 5 * qmin) // 4
            else:
                t = int(int(qual[i]) / 3 + (qminp - pl * 2) * poly_adj)
            if t < int(qual[i]):
                local_nm[i] += int(qual[i]) - t
            qminp = int(qual[i])
            for k in range(max(polyl, i - qhalop),
                           min(polyr, i + qhalop) + 1):
                if qminp > int(qual[k]):
                    qminp = int(qual[k])
            if qmin > int(qual[i + qhalo]):
                qmin = int(qual[i + qhalo])
            elif qmin <= int(qual[i - qhalo]):
                qmin = 99
                for j in range(i - qhalo + 1, i + qhalo + 1):
                    if qmin > int(qual[j]):
                        qmin = int(qual[j])
            i += 1
        while i < qlen:
            if opts.mode == MODE_BAYES_116:
                t = (int(qual[i]) + 5 * qmin) // 4
            else:
                t = int(int(qual[i]) / 3 + qminp * poly_adj)
            if t < int(qual[i]):
                local_nm[i] += int(qual[i]) - t
            i += 1

    if opts.homopoly_fix:
        _homopoly_qual_fix(p)

    # poly-X lengths into top bits
    i = 0
    while i < qlen:
        base = int(seq[i])
        j = i + 1
        while j < qlen and int(seq[j]) == base:
            j += 1
        poly = min(j - i - 1, 100)
        for k in range(i, j):
            local_nm[k] = (max(poly, local_nm[k] >> 24) << 24) \
                | (local_nm[k] & ((1 << 24) - 1))
        i = j

    if p.md is None:
        return 1
    halo = opts.nm_halo
    cig = p.cigar
    ncig = cig.size
    if ncig:
        op0 = int(cig[0]) & 0xF
        op1 = int(cig[1]) & 0xF if ncig > 1 else -1
        if op0 == F.CSOFT_CLIP or (op0 == F.CHARD_CLIP and ncig > 1
                                   and op1 == F.CSOFT_CLIP):
            i = 0
            while i < halo and i < qlen:
                local_nm[i] += opts.sc_cost
                i += 1
            while i < halo * 2 and i < qlen:
                local_nm[i] += opts.sc_cost >> 1
                i += 1
        opn = int(cig[ncig - 1]) & 0xF
        opn1 = int(cig[ncig - 2]) & 0xF if ncig > 1 else -1
        if opn == F.CSOFT_CLIP or (opn == F.CHARD_CLIP and ncig > 1
                                   and opn1 == F.CSOFT_CLIP):
            i = qlen - 1
            while i >= qlen - halo and i >= 0:
                local_nm[i] += opts.sc_cost
                i -= 1
            while i >= qlen - halo * 2 and i >= 0:
                local_nm[i] += opts.sc_cost >> 1
                i -= 1

    md = p.md
    mi = 0
    pos = 0
    n = len(md)
    while mi < n:
        ch = md[mi]
        if ch.isdigit():
            j = mi
            while j < n and md[j].isdigit():
                j += 1
            pos += int(md[mi:j])
            mi = j
            continue
        if ch == "^":
            mi += 1
            while mi < n and not md[mi].isdigit():
                mi += 1
            continue
        i = pos - halo * 2 if pos - halo * 2 >= 0 else 0
        while i < pos - halo and i < qlen:
            local_nm[i] += 5
            i += 1
        while i < pos + halo and i < qlen:
            local_nm[i] += 10
            i += 1
        while i < pos + halo * 2 and i < qlen:
            local_nm[i] += 5
            i += 1
        mi += 1
    return 1


def _homopoly_qual_fix(p: PRead):
    """bam_consensus.c:943"""
    qual = p.qual_arr
    seq = p.seq
    qlen = p.l_qseq
    i = 0
    while i < qlen:
        s = i
        base = int(seq[i])
        while i + 1 < qlen and int(seq[i + 1]) == base:
            i += 1
        if s != i:
            j, k = s, i
            while j < k:
                e = 10 ** (int(qual[j]) / -10.0) \
                    + 10 ** (int(qual[k]) / -10.0)
                v = int(-fast_log2(e / 2) * 3.0104 + .49)
                qual[j] = v
                qual[k] = v
                j += 1
                k -= 1
        i += 1


def nm_local(p: PRead, pos: int) -> float:
    nm = p.cd
    if not nm:
        return 0
    pos -= p.rpos
    if pos < 0:
        return nm[0] & ((1 << 24) - 1)
    if pos >= p.l_qseq:
        return nm[p.l_qseq - 1] & ((1 << 24) - 1)
    return (nm[pos] & ((1 << 24) - 1)) / 10.0


def poly_len(p: PRead, pos: int) -> int:
    nm = p.cd
    if not nm:
        return 0
    pos -= p.rpos
    if 0 <= pos < p.l_qseq:
        return nm[pos] >> 24
    return 0


class Consensus:
    __slots__ = ("call", "het_call", "het_logodd", "phred", "depth",
                 "discrep")


def calculate_consensus_gap5(pos, flags, depth, plist, opts,
                             cp: ConsProbs) -> Consensus:
    """bam_consensus.c:1258"""
    S = [0.0] * 15
    counts = [0] * 6
    td = depth
    depth = 0
    for p in plist:
        if p.qual < opts.min_qual:
            continue
        if p.ref_skip:
            continue
        base = p.base4
        qual = p.qual
        if qual == 255 or (qual == 0 and p.l_qseq
                           and int(p.qual_arr[0]) == 255):
            qual = opts.default_qual
        base = L_TAB[base] if base < 32 else 4

        if flags & CONS_MQUAL:
            mqual = float(p.mapq)
            if opts.nm_adjust:
                mqual /= nm_local(p, p.rpos + p.seq_offset + 1) + 1
                mqual *= 1 + 2 * (0.5 - (30 if td > 30 else td) / 60.0)
            mqual *= opts.scale_mqual
            if mqual < opts.low_mqual:
                mqual = opts.low_mqual
            if mqual > opts.high_mqual:
                mqual = opts.high_mqual
            P = Q2P[min(qual, 100)]
            M = MQUAL_POW_1M[int(mqual)]
            qual = int(ph_log(P + .75 * M - P * M))
        if qual < 1:
            qual = 1
        qual = min(qual, 100)

        poly = poly_len(p, p.rpos + p.seq_offset + 1)
        qual2 = max(1, int(qual - (poly - 2) * cp.poly_mul))
        qual2 = min(qual2, 100)

        xx = cp.pxx[qual]
        MM = cp.pMM[qual] - xx
        xM = cp.pxM[qual] - xx
        oo = cp.poo[qual2] - xx
        oM = cp.poM[qual2] - xx
        ox = cp.pox[qual2] - xx
        uu = cp.puu[qual2] - xx
        um = cp.pum[qual2] - xx
        mm = cp.pmm[qual2] - xx

        counts[base] += 1

        if base == 0:
            S[0] += MM; S[1] += xM; S[2] += xM; S[3] += xM; S[4] += oM
            S[8] += ox; S[11] += ox; S[13] += ox; S[14] += oo
        elif base == 1:
            S[1] += xM; S[5] += MM; S[6] += xM; S[7] += xM; S[8] += oM
            S[4] += ox; S[11] += ox; S[13] += ox; S[14] += oo
        elif base == 2:
            S[2] += xM; S[6] += xM; S[9] += MM; S[10] += xM; S[11] += oM
            S[4] += ox; S[8] += ox; S[13] += ox; S[14] += oo
        elif base == 3:
            S[3] += xM; S[7] += xM; S[10] += xM; S[12] += MM; S[13] += oM
            S[4] += ox; S[8] += ox; S[11] += ox; S[14] += oo
        elif base == 4:
            S[0] += uu; S[1] += uu; S[2] += uu; S[3] += uu; S[4] += um
            S[5] += uu; S[6] += uu; S[7] += uu; S[8] += um
            S[9] += uu; S[10] += uu; S[11] += um
            S[12] += uu; S[13] += um
            S[14] += mm
        else:  # N
            S[0] += MM; S[1] += MM; S[2] += MM; S[3] += MM; S[4] += oM
            S[5] += MM; S[6] += MM; S[7] += MM; S[8] += oM
            S[9] += MM; S[10] += MM; S[11] += oM
            S[12] += MM; S[13] += oM
            S[14] += oo
        depth += 1

    cons = Consensus()
    shift = -1e308
    mx = -1e308
    max_het = -1e308
    call = 0
    het_call = 0
    for j in range(15):
        S[j] += cp.lprior15[j]
        if shift < S[j]:
            shift = S[j]
        if j not in PURE:
            if max_het < S[j]:
                max_het = S[j]
                het_call = j
            continue
        if mx < S[j]:
            mx = S[j]
            call = j

    norm = [0.0] * 15
    for j in range(15):
        S[j] -= shift
        e = fast_exp(S[j])
        S[j] = e if S[j] > MIN_E_EXP else DBL_MIN
    tot1 = tot2 = 0.0
    for j in range(15):
        norm[j] += tot1
        norm[14 - j] += tot2
        tot1 += S[j]
        tot2 += S[14 - j]

    if not depth or depth == counts[5]:
        cons.call = 4
        cons.het_call = 0
        cons.het_logodd = 0
        cons.phred = 0
        cons.depth = 0
        cons.discrep = 0
        return cons

    cons.depth = depth
    if norm[call] == 0:
        norm[call] = DBL_MIN
    if S[call] == 1 and norm[call] < .01:
        ph = int(ph_log(norm[call]) + .5)
    else:
        ph = int(ph_log(1 - S[call] / (norm[call] + S[call])) + .5)
    cons.call = MAP_SING[call]
    cons.phred = 0 if ph < 0 else ph
    if norm[het_call] == 0:
        norm[het_call] = DBL_MIN
    ph = int(TENLOG2OVERLOG10 * (fast_log2(S[het_call])
                                 - fast_log2(norm[het_call])) + .5)
    cons.het_call = MAP_HET[het_call]
    cons.het_logodd = ph
    cons.discrep = 0
    return cons


def calculate_consensus_gap5m(pos, flags, depth, plist, opts) -> Consensus:
    """bam_consensus.c:1799 — mixed-mode blending."""
    if opts.mode != MODE_MIXED:
        cp = opts.cp_precise if opts.mode == MODE_PRECISE \
            else opts.cp_recall
        return calculate_consensus_gap5(pos, flags, depth, plist, opts, cp)
    consP = calculate_consensus_gap5(pos, flags, depth, plist, opts,
                                     opts.cp_precise)
    consR = calculate_consensus_gap5(pos, flags, depth, plist, opts,
                                     opts.cp_recall)
    cons = consP
    if consP.phred > 0 and consR.phred > 0 and consP.call == consR.call:
        cons.phred += min(20, consR.phred)
    elif (consP.het_logodd >= 0 and consR.het_logodd >= 0
          and consP.het_call == consR.het_call):
        cons.het_logodd += min(20, consR.het_logodd)
    elif consP.het_logodd >= 0:
        q2 = max(consR.phred, consR.het_logodd)
        cons.het_logodd = max(1, cons.het_logodd - q2 // 2)
    elif consR.het_logodd >= 70:
        q1 = consP.phred
        q2 = consR.het_logodd
        cons = consR
        cons.het_logodd = int(min(15, max((q2 - q1 * 2) / 2,
                                          1 + q2 / (q1 + 1.0))))
    elif consR.het_logodd >= 0:
        q1 = consP.phred
        q2 = consR.het_logodd
        cons = consR
        cons.het_logodd = int(max(1, q2 - 0.3 * q1)
                              + 5 * (consP.het_call == consR.het_call))
        cons.phred = 0
    else:
        consR.phred //= 2
        if consR.phred > consP.phred:
            cons = consR
        cons.phred = max(10, cons.phred)
    return cons


SEQI2A = [0, 8, 0, 4, 0, 4, 0, 2, 0, 4, 0, 2, 0, 2, 0, 1]
SEQI2C = [0, 0, 8, 4, 0, 0, 4, 2, 0, 0, 4, 2, 0, 0, 2, 1]
SEQI2G = [0, 0, 0, 0, 8, 4, 4, 1, 0, 0, 0, 0, 4, 2, 2, 1]
SEQI2T = [0, 0, 0, 0, 0, 0, 0, 0, 8, 4, 4, 2, 8, 2, 2, 1]
HET_STR = "NACMGRSVTWYHKDBN" "*ac?g???t???????"


def calculate_consensus_simple(plist, opts) -> tuple[int, int]:
    """bam_consensus.c:1907.  Returns (base_char, qual)."""
    min_qual = opts.min_qual
    tot_depth = 0
    freq = [0] * 17
    score = [0] * 17
    for p in plist:
        q = p.qual
        if q < min_qual:
            continue
        b = p.base4
        if b < 16:
            for tab, idx in ((SEQI2A, 1), (SEQI2C, 2), (SEQI2G, 4),
                             (SEQI2T, 8)):
                Q = tab[b] * (q if opts.use_qual else 1)
                if Q:
                    freq[idx] += 1
                    score[idx] += Q
        else:
            freq[16] += 1
            score[16] += 8 * (q if opts.use_qual else 1)
        tot_depth += 1

    tscore = sum(score[1 << i] for i in range(5))
    call1 = call2 = 15
    score1 = score2 = 0
    for i in range(5):
        c = 1 << i
        if score1 < score[c]:
            score2, call2 = score1, call1
            score1, call1 = score[c], c
        elif score2 < score[c]:
            score2, call2 = score[c], c
    used_score = score1
    used_base = call1
    if score2 >= opts.het_fract * score1 and opts.ambig:
        used_base |= call2
        used_score += score2
    if tot_depth < opts.min_depth or used_score < opts.call_fract * tscore:
        used_base = 16 if call1 == 16 else 0
    q = int(100.0 * used_score / tscore) if (used_base and tscore) else 0
    return ord(HET_STR[used_base]), q


HET_CHARS = "AMRWa" "MCSYc" "RSGKg" "WYKTt" "acgt*"


def consensus_base(opts: Opts, plist, pos, depth) -> tuple[int, int]:
    """bam_consensus.c:2139"""
    if opts.mode != MODE_SIMPLE:
        cons = calculate_consensus_gap5m(
            pos, CONS_MQUAL if opts.use_mqual else 0, depth, plist, opts)
        if cons.depth < opts.min_depth and cons.call != 4:
            cb, cq = ord("N"), 0
        elif cons.het_logodd > 0 and opts.ambig:
            cb = ord(HET_CHARS[cons.het_call])
            cq = cons.het_logodd
        else:
            cb = ord("ACGT*"[cons.call])
            cq = cons.phred
        if cq < opts.cons_cutoff and cb != ord("*") \
                and cons.het_call % 5 != 4 and cons.het_call // 5 != 4:
            cb, cq = ord("N"), 0
        return cb, cq
    return calculate_consensus_simple(plist, opts)


# -------------------------------------------------------------- output ctx

class Ctx:
    def __init__(self, opts):
        self.opts = opts
        self.seq = []
        self.qual = []
        self.last_tid = -1
        self.last_pos = -1
        self.iter = None        # (tid, beg, end) 0-based half-open
        self.ref = None
        self.ref_tid = -1
        self.out = opts.fp_out


def update_ref(c: Ctx, tid: int):
    opts = c.opts
    if not opts.ref_fn:
        return 0
    if tid == c.ref_tid and c.ref is not None:
        return len(c.ref)
    name = opts.header.ref_name(tid)
    if not opts.fai.has(name):
        return -1
    c.ref = opts.fai.fetch(name).decode("latin-1")
    c.ref_tid = tid
    return len(c.ref)


def empty_pileup2(c: Ctx, tid, start, end) -> int:
    opts = c.opts
    name = opts.header.ref_name(tid)
    rseq = None
    if opts.ref_fn:
        if update_ref(c, tid) <= 0:
            return -1
        rseq = c.ref
    w = c.out.write
    for i in range(start, end):
        w("%s\t%d\t0\t0\t%c\t0\t*\t*\n"
          % (name, i + 1, rseq[i] if rseq else "N"))
    return 0


def basic_pileup(c: Ctx, plist, depth, pos, nth, is_insert) -> int:
    opts = c.opts
    if not opts.show_ins and nth:
        return 0
    if not plist:
        return 0
    tid = plist[0].tid
    if c.iter:
        if c.iter[1] >= pos or c.iter[2] < pos:
            return 0
    if opts.all_bases:
        if tid != c.last_tid and c.last_tid >= -1:
            if c.last_tid >= 0:
                ln = opts.header.ref_lens[c.last_tid]
                if c.iter:
                    ln = min(c.iter[2], ln)
                if empty_pileup2(c, c.last_tid, c.last_pos, ln) < 0:
                    return -1
            c.last_pos = c.iter[1] if c.iter else 0
        if not c.iter and tid > c.last_tid and opts.all_bases > 1:
            while c.last_tid + 1 < tid:
                c.last_tid += 1
                ln = opts.header.ref_lens[c.last_tid]
                if empty_pileup2(c, c.last_tid, 0, ln) < 0:
                    return -1
        if c.last_pos >= 0 and pos > c.last_pos + 1:
            if empty_pileup2(c, tid, c.last_pos, pos - 1) < 0:
                return -1
        elif c.last_pos < 0:
            if empty_pileup2(c, tid, c.iter[1] if c.iter else 0,
                             pos - 1) < 0:
                return -1

    cb, cq = consensus_base(opts, plist, pos, depth)
    if not opts.show_del and cb == ord("*"):
        return 0
    name = opts.header.ref_name(tid)
    bases = []
    quals = []
    for p in plist:
        if p.b_is_rev:
            bases.append("#" if p.base == "*" else p.base.lower())
        else:
            bases.append(p.base)
        quals.append(chr(min(p.qual, 93) + 33))
    c.out.write("%s\t%d\t%d\t%d\t%c\t%d\t%s\t%s\n"
                % (name, pos, nth, depth, cb, cq,
                   "".join(bases), "".join(quals)))
    c.last_pos = pos
    c.last_tid = tid
    return 0


def basic_fasta(c: Ctx, plist, depth, pos, nth, is_insert) -> int:
    opts = c.opts
    if not opts.show_ins and nth:
        return 0
    if not plist:
        return 0
    tid = plist[0].tid
    if c.iter:
        if c.iter[1] >= pos or c.iter[2] < pos:
            return 0
    if _fasta_tid_switch(c, tid, pos) < 0:
        return -1
    cb, cq = consensus_base(opts, plist, pos, depth)
    return _fasta_emit(c, tid, pos, nth, cb, cq)


def _fasta_tid_switch(c: Ctx, tid, pos) -> int:
    opts = c.opts
    if getattr(c, "span_first", None) is None:
        c.span_first = pos
    while tid != c.last_tid:
        if c.last_tid != -1:
            if opts.all_bases:
                if c.iter:
                    c.last_pos = max(c.last_pos, c.iter[1] - 1)
                    N = c.iter[2]
                else:
                    N = 1 << 62
                N = min(N, opts.header.ref_lens[c.last_tid]) - c.last_pos
                if N > 0:
                    if c.ref is not None and opts.ref_fn:
                        if update_ref(c, c.last_tid) < 0:
                            return -1
                        for i in range(N):
                            c.seq.append(c.ref[c.last_pos + i])
                            c.qual.append(chr(opts.ref_qual + 33))
                    else:
                        c.seq.extend("N" * N)
                        c.qual.extend("!" * N)
            dump_fastq(opts, opts.header.ref_name(c.last_tid),
                       c.seq, c.qual)
        if update_ref(c, tid) < 0:
            return -1
        c.seq = []
        c.qual = []
        if not c.iter and opts.all_bases > 1 and c.last_tid + 1 < tid:
            c.last_tid += 1
            c.last_pos = 0
            continue
        c.last_tid = tid
        if c.iter:
            c.last_pos = c.iter[1] if opts.all_bases else pos - 1
        else:
            c.last_pos = 0 if opts.all_bases else pos - 1
        break
    return 0


def _fasta_emit(c: Ctx, tid, pos, nth, cb, cq) -> int:
    opts = c.opts
    if not opts.show_del and cb == ord("*"):
        c.last_pos = pos
        c.last_tid = tid
        return 0
    if opts.mark_ins and nth and cb != ord("*"):
        c.seq.append("_")
        c.qual.append("_")

    if pos > c.last_pos:
        if c.last_pos > 0 or opts.all_bases:
            if update_ref(c, tid) < 0:
                return -1
            gap = pos - (c.last_pos + 1)
            if c.ref is not None and opts.ref_fn:
                c.seq.extend(c.ref[c.last_pos:c.last_pos + gap])
                c.qual.extend(chr(opts.ref_qual + 33) * gap)
            else:
                c.seq.extend("N" * gap)
                c.qual.extend("!" * gap)
    if ((nth and opts.show_ins and cb != ord("*"))
            or cb != ord("*")
            or (pos > c.last_pos and opts.show_del)):
        c.seq.append(chr(cb))
        c.qual.append(chr(min(cq, ord("~") - ord("!")) + ord("!")))
    c.last_pos = pos
    c.last_tid = tid
    return 0


def dump_fastq(opts, name, seq, qual):
    if not seq:
        return
    fp = opts.fp_out
    fp.write("%c%s\n" % (">@"[opts.fmt == FASTQ], name))
    ll = opts.line_len
    s = "".join(seq)
    for i in range(0, len(s), ll):
        fp.write(s[i:i + ll] + "\n")
    if opts.fmt == FASTQ:
        fp.write("+\n")
        q = "".join(qual)
        for i in range(0, len(q), ll):
            fp.write(q[i:i + ll] + "\n")


# ------------------------------------------------------------------- main

def _filtered_reads(b, opts, sel):
    for i in sel:
        i = int(i)
        fl = int(b.flag[i])
        if opts.incl_flags and not (fl & opts.incl_flags):
            continue
        if opts.excl_flags and (fl & opts.excl_flags):
            continue
        if int(b.mapq[i]) < opts.min_mqual:
            continue
        yield PRead(b, i)


def _stream_reads(src, opts, c: Ctx):
    """Record iterator for pileup_loop: the batches of a BamStream (with a
    region, the reads its index gives), or the selection of an in-memory
    batch."""
    if isinstance(src, tuple):  # ("stream", BamStream)
        st = src[1]
        if c.iter:
            qb = st.query(*c.iter)
            yield from _filtered_reads(qb, opts, np.arange(qb.n))
            return
        for wb in st.batches():
            yield from _filtered_reads(wb, opts, np.arange(wb.n))
        return
    b = src
    if c.iter:
        tid, beg, end = c.iter
        endp = _endpos_arr(b)
        sel = np.nonzero((b.tid == tid) & (b.pos < end)
                         & (endp > beg))[0]
    else:
        sel = np.arange(b.n)
    yield from _filtered_reads(b, opts, sel)


def _pileup_vec(opts, src, c: Ctx) -> int:
    """Vectorized gap5 column engine over windowed entry tables
    (ops/consensus_vec; bit-exact differential tests against the scalar
    loop): per-column 15-hypothesis scoring as bulk table gathers and
    segment sums (K10) instead of the per-read-per-column cursor walk
    (bam_consensus.c:1258 via consensus_pileup.c:81).  Insertion
    sub-columns run an exact engine over all of a window's sites at once
    (``_ins_sites_vec``); windows containing pad (P) ops fall back to the
    scalar pileup_loop with column gating."""
    use_mq = bool(opts.use_mqual)
    cps = []
    if opts.mode == MODE_MIXED:
        cps = [opts.cp_precise, opts.cp_recall]
    elif opts.mode == MODE_PRECISE:
        cps = [opts.cp_precise]
    else:
        cps = [opts.cp_recall]

    def flt(b):
        fl = b.flag.astype(np.int64)
        keep = (b.tid >= 0) & ((fl & F.FUNMAP) == 0)
        if opts.incl_flags:
            keep &= (fl & opts.incl_flags) != 0
        if opts.excl_flags:
            keep &= (fl & opts.excl_flags) == 0
        keep &= b.mapq.astype(np.int64) >= opts.min_mqual
        return keep

    it_tid = it_beg = it_end = None
    if c.iter:
        it_tid, it_beg, it_end = c.iter

    def windows():
        if c.iter:
            # region windows of 1 Mi columns: read through the index, or
            # selected from the whole file's reads
            W = 1 << 20
            if isinstance(src, tuple):
                for blk in range(it_beg, it_end, W):
                    be = min(blk + W, it_end)
                    qb = src[1].query(it_tid, blk, be)
                    yield it_tid, blk, be, [qb.take(np.nonzero(flt(qb))[0])]
                return
            b = src
            keep = flt(b)
            endp = _endpos_arr(b)
            for blk in range(it_beg, it_end, W):
                be = min(blk + W, it_end)
                sel = np.nonzero(keep & (b.tid == it_tid)
                                 & (b.pos < be) & (endp > blk))[0]
                yield it_tid, blk, be, [b.take(sel)]
            return
        if isinstance(src, tuple):
            yield from WindowedReader([src[1]], window_cols=1 << 20,
                                      filter_fn=[flt])
        else:
            b = src
            keep = flt(b)
            for t in np.unique(b.tid[keep & (b.tid >= 0)]):
                sel = np.nonzero(keep & (b.tid == t))[0]
                yield int(t), 0, 1 << 62, [b.take(sel)]

    def gated_col(wb, we):
        def fn(cc, plist, depth, pos, nth, is_insert):
            if pos - 1 < wb or pos - 1 >= we:
                return 0
            return basic_fasta(cc, plist, depth, pos, nth, is_insert)
        return fn

    for tid, wb, we, subs in windows():
        sub = subs[0]
        if sub.n == 0:
            continue
        if sub.cigar.size and ((sub.cigar & 0xF) == F.CPAD).any():
            # pad ops: scalar engine over this window's reads
            recs = (PRead(sub, i) for i in range(sub.n))
            if pileup_loop(recs, nm_init, gated_col(wb, we), c) < 0:
                return -1
            continue

        qual_flat = sub.qual
        nm_flat = None
        if use_mq:
            md_vals = auxmod.batch_tag_values(sub, "MD")
            parts = [(v.encode("latin-1") if isinstance(v, str) else b"")
                     for v in md_vals]
            md_off = np.zeros(sub.n + 1, np.int64)
            for i, pb in enumerate(parts):
                md_off[i + 1] = md_off[i] + len(pb)
            md_arr = np.frombuffer(b"".join(parts), np.uint8).copy() \
                if parts else np.empty(0, np.uint8)
            nm_flat, qual_flat = natmod.nm_init_batch(
                sub.qual.copy(), sub.seq, sub.seq_off, sub.cigar,
                sub.cigar_off, md_arr, md_off, 1, opts.adj_qual,
                1 if opts.mode == MODE_BAYES_116 else 0,
                opts.homopoly_fix, opts.nm_halo, opts.sc_cost)

        p = build_pileup(sub, opts.dev)
        if p.n_entries == 0:
            continue
        n = p.n_entries
        rid = p.rid.astype(np.int64)
        lq = sub.l_qseq[rid]
        qpos = p.qpos.astype(np.int64)
        is_del = p.is_del
        is_rs = p.is_refskip
        soff = sub.seq_off[rid]
        m_has = (~is_del) & (qpos < lq)
        base4 = np.where(is_del, 16, 15).astype(np.int64)
        base4[m_has] = sub.seq[soff[m_has] + qpos[m_has]]
        rawq = np.zeros(n, np.int64)
        rawq[m_has] = qual_flat[soff[m_has] + qpos[m_has]]
        rawq[(~is_del) & (qpos >= lq)] = 255
        # deletion quals (get_next_base D rule): zero when the run has
        # no preceding M base or crosses a ref-skip, else
        # min(prev base qual, next base qual); computed per cigar op
        # and carried through the sort permutation
        if is_del.any():
            t = expand_ops(sub)
            nops = t.op.size
            isMo = (t.op == F.CMATCH) | (t.op == F.CEQUAL) \
                | (t.op == F.CDIFF)
            isDo = t.op == F.CDEL
            isNo = t.op == F.CREF_SKIP
            idxo = np.arange(nops, dtype=np.int64)
            lastM = np.maximum.accumulate(np.where(isMo, idxo, -1))
            lastN = np.maximum.accumulate(np.where(isNo, idxo, -1))
            first_op = sub.cigar_off[:-1][t.rid]
            lastM = np.where(lastM >= first_op, lastM, -1)
            lastN = np.where(lastN >= first_op, lastN, -1)
            zero_del = (lastM == -1) | (lastN > lastM)
            so_r = sub.seq_off[t.rid]
            lq_o = sub.l_qseq[t.rid]
            qp_o = t.qpos
            prevq = np.where(qp_o >= 1,
                             qual_flat[so_r + np.maximum(qp_o - 1, 0)],
                             0).astype(np.int64)
            nxt = np.where(
                qp_o < lq_o, qual_flat[so_r + np.minimum(
                    qp_o, np.maximum(lq_o - 1, 0))].astype(np.int64),
                np.where((qp_o - 1 >= 0) & (qp_o - 1 < lq_o),
                         qual_flat[so_r + np.clip(qp_o - 1, 0,
                                                  None)].astype(
                             np.int64), 0))
            dval_op = np.where(zero_del, 0, np.minimum(prevq, nxt))
            # expand per-op values to entries in build_pileup's
            # pre-sort order, then permute with p.order
            emit = _ENTRY_LUT[t.op]
            e_ops = np.nonzero(emit)[0]
            e_len = t.oplen[e_ops]
            per_ent = np.repeat(
                np.where(isDo[e_ops], dval_op[e_ops],
                         np.where(isNo[e_ops], 0, -1)), e_len)
            per_ent = per_ent[p.order]
            dmask = per_ent >= 0
            rawq[dmask] = per_ent[dmask]
        so_ent = qpos - is_del.astype(np.int64)
        if use_mq:
            idx1 = so_ent + 1
            in_rng = (idx1 < lq) & (lq > 0)
            nm_loc = np.zeros(n, np.float64)
            nm_v = nm_flat[np.minimum(soff + np.minimum(idx1,
                                                        np.maximum(
                                                            lq - 1, 0)),
                                      nm_flat.size - 1)] \
                if nm_flat.size else np.zeros(n, np.int32)
            nm_masked = (nm_v.astype(np.int64) & ((1 << 24) - 1))
            nm_loc = np.where(in_rng, nm_masked / 10.0,
                              nm_masked.astype(np.float64))
            nm_loc = np.where(lq > 0, nm_loc, 0.0)
            poly = np.where(in_rng, nm_v.astype(np.int64) >> 24, 0)
        else:
            nm_loc = np.zeros(n, np.float64)
            poly = np.zeros(n, np.int64)
        cnt = np.diff(p.col_off)
        td_ent = np.repeat(cnt, cnt)
        q0v = np.zeros(n, bool)
        has0 = lq > 0
        q0v[has0] = qual_flat[soff[has0]] == 255
        q0flag = (rawq == 0) & q0v & (lq > 0)
        keep = (rawq >= opts.min_qual) & ~is_rs

        results = []
        for cp in cps:
            b6, q, q2 = CV.entry_quals(rawq, base4, sub.mapq[rid],
                                       nm_loc, poly, td_ent, opts,
                                       use_mq, q0flag)
            # K10 on the card (its plain version on the CPU), or the
            # host's loop: the same f64 sums
            S, counts, depth = (
                CV.gap5_scores_device(p.col_off, b6, q, q2, keep, cp,
                                      opts.dev)
                if opts.dev is not None else
                CV.gap5_scores(p.col_off, b6, q, q2, keep, cp))
            results.append(CV.gap5_finalize(S, counts, depth, cp))
        cons = (CV.gap5m_blend(results[0], results[1])
                if len(results) == 2 else results[0])
        cb, cq = CV.consensus_base_vec(cons, opts)

        colpos = p.col_pos
        inw = (colpos >= wb) & (colpos < we)
        if c.iter:
            inw &= (colpos >= it_beg) & (colpos < it_end)
        ins_by_col = {}
        if p.ins:
            for eidx, v in p.ins.items():
                ci = int(np.searchsorted(colpos, p.pos[eidx]))
                ins_by_col.setdefault(ci, []).append((eidx, v))
        cols = np.nonzero(inw)[0]
        if cols.size == 0:
            continue
        if _fasta_tid_switch(c, tid, int(colpos[cols[0]]) + 1) < 0:
            return -1
        # bulk emission: maximal runs of consecutive, non-'*', anchor
        # -free columns append their chars/quals in one go (the
        # per-column path handles gaps, deletions and insertions)
        simple = (cb[cols] != ord("*"))
        if ins_by_col:
            has_anchor = np.isin(cols, np.fromiter(
                ins_by_col, np.int64, len(ins_by_col)))
            simple &= ~has_anchor
        sites = {}
        if ins_by_col and opts.show_ins:
            site_cols = cols[has_anchor]
            sites = {ci: k for k, ci in enumerate(site_cols.tolist())}
            s_off, s_cb, s_cq = _ins_sites_vec(
                opts, sub, p, site_cols, ins_by_col, qual_flat, nm_flat,
                rawq, so_ent, cps, use_mq)
        consec = np.ones(cols.size, bool)
        consec[1:] = np.diff(colpos[cols]) == 1
        qch = np.minimum(cq[cols], ord("~") - ord("!")) + ord("!")
        k = 0
        ncols_w = cols.size
        while k < ncols_w:
            ci = int(cols[k])
            pos1 = int(colpos[ci]) + 1
            if simple[k] and pos1 == c.last_pos + 1:
                j = k + 1
                while j < ncols_w and simple[j] and consec[j]:
                    j += 1
                c.seq.extend(bytes(cb[cols[k:j]].astype(np.uint8))
                             .decode("latin-1"))
                c.qual.extend(bytes(qch[k:j].astype(np.uint8))
                              .decode("latin-1"))
                c.last_pos = int(colpos[cols[j - 1]]) + 1
                c.last_tid = tid
                k = j
                continue
            if _fasta_emit(c, tid, pos1, 0, int(cb[ci]),
                           int(cq[ci])) < 0:
                return -1
            site = sites.get(ci)
            if site is not None:
                for j in range(int(s_off[site]), int(s_off[site + 1])):
                    if _fasta_emit(c, tid, pos1, j - int(s_off[site]) + 1,
                                   int(s_cb[j]), int(s_cq[j])) < 0:
                        return -1
            k += 1
    return 0


def _ins_sites_vec(opts, sub, p, sites, ins_by_col, qual_flat, nm_flat,
                   rawq, so_ent, cps, use_mq):
    """The insertion sub-columns of every anchor site of a window at once
    (``sites``: the column indices, in order): the (pos, nth) grammar of
    consensus_pileup.c get_next_base, as the JAX package's per-site
    engine (``_ins_columns_vec``) runs it one site at a time.  A site's
    participants are its column's anchors and the reads that do not end
    there; at sub-column nth an anchor whose insertion is that long emits
    its inserted base (or a pad), every other participant pads '*' with
    the min-qual carry rule, and each sub-column is scored exactly (f64
    ``gap5_scores``, entries in participant order).  Returns (off, cb,
    cq): site k's sub-columns nth = 1, 2, ... are cb/cq[off[k]:off[k+1]]."""
    mask24 = (1 << 24) - 1
    nsite = sites.size
    lo = p.col_off[sites]
    ent = ragged_gather_indices(lo, p.col_off[sites + 1] - lo)
    site = np.repeat(np.arange(nsite), p.col_off[sites + 1] - lo)
    anchors = [e for ci in sites.tolist() for e, _ in ins_by_col[ci]]
    alen = np.zeros(p.n_entries, np.int64)
    qoff = np.zeros(p.n_entries, np.int64)
    qls = [p.ins[e][2] for e in anchors]
    a_ent = np.array(anchors, np.int64)
    alen[a_ent] = [len(p.ins[e][0]) for e in anchors]
    qoff[a_ent] = np.concatenate([[0], np.cumsum([len(q) for q in qls])
                                  ])[:-1]
    a_q = np.array([x for q in qls for x in q], np.int64)
    is_anchor = np.zeros(p.n_entries, bool)
    is_anchor[a_ent] = True
    part = is_anchor[ent] | ~p.is_tail[ent]
    ent, site = ent[part], site[part]
    k_site = np.bincount(site, minlength=nsite)
    maxn = np.zeros(nsite, np.int64)
    np.maximum.at(maxn, site, alen[ent])
    r = p.rid[ent].astype(np.int64)
    s0 = sub.seq_off[r]
    lqr = sub.seq_off[r + 1] - s0
    has_q = lqr > 0
    q0_255 = np.zeros(ent.size, bool)
    q0_255[has_q] = qual_flat[s0[has_q]] == 255
    mapq = sub.mapq[r].astype(np.int64)
    state_q = rawq[ent].astype(np.int64)
    state_so = so_ent[ent].astype(np.int64)
    L_a, q_at = alen[ent], qoff[ent]
    rows = []     # per nth: (site, participant, b4, rq, nm, poly)
    for nth in range(1, int(maxn.max(initial=0)) + 1):
        idx = np.nonzero(maxn[site] >= nth)[0]
        qp = np.full(idx.size, -1, np.int64)
        isa = L_a[idx] >= nth
        qp[isa] = a_q[q_at[idx[isa]] + nth - 1]
        hq = qp >= 0
        s0i, lqi = s0[idx], lqr[idx]
        b4 = np.full(idx.size, 16, np.int64)
        b4[hq] = sub.seq[s0i[hq] + qp[hq]]
        rq = np.empty(idx.size, np.int64)
        rq[hq] = qual_flat[s0i[hq] + qp[hq]]
        # pads: min(carried qual, the qual after the last query base)
        o = ~hq
        i2 = state_so[idx[o]] + 1
        inr = (i2 >= 0) & (i2 < lqi[o])
        nxtq = np.zeros(i2.size, np.int64)
        nxtq[inr] = qual_flat[s0i[o][inr] + i2[inr]]
        rq[o] = np.minimum(state_q[idx[o]], nxtq)
        state_q[idx] = rq
        state_so[idx[hq]] = qp[hq]
        nm = np.zeros(idx.size, np.float64)
        poly = np.zeros(idx.size, np.int64)
        if use_mq and nm_flat is not None:
            i1 = state_so[idx] + 1
            g = lqi > 0
            inr = (i1 >= 0) & (i1 < lqi)
            v = np.zeros(idx.size, np.int64)
            v[g] = nm_flat[s0i[g] + np.maximum(np.minimum(i1[g],
                                                          lqi[g] - 1), 0)]
            nm[g] = np.where(inr[g], (v[g] & mask24) / 10.0,
                             (v[g] & mask24).astype(np.float64))
            poly[g & inr] = v[g & inr] >> 24
        rows.append((site[idx] * (int(maxn.max()) + 1) + nth, idx, b4, rq,
                     nm, poly))
    if not rows:
        return np.zeros(nsite + 1, np.int64), np.empty(0), np.empty(0)
    key, idx, b4, rq, nm, poly = (np.concatenate(x) for x in zip(*rows))
    order = np.argsort(key, kind="stable")
    idx, b4, rq, nm, poly = idx[order], b4[order], rq[order], nm[order], \
        poly[order]
    # sub-columns in (site, nth) order; each holds its site's participants
    sub_cnt = np.repeat(k_site, maxn)
    col_off = np.concatenate([[0], np.cumsum(sub_cnt)]).astype(np.int64)
    keep = rq >= opts.min_qual
    q0 = (lqr[idx] > 0) & (rq == 0) & q0_255[idx]
    results = []
    for cp in cps:
        b6, q, q2 = CV.entry_quals(rq, b4, mapq[idx], nm, poly,
                                   k_site[site[idx]], opts, use_mq, q0)
        S, counts, depth = CV.gap5_scores(col_off, b6, q, q2, keep, cp)
        results.append(CV.gap5_finalize(S, counts, depth, cp))
    cons = (CV.gap5m_blend(results[0], results[1])
            if len(results) == 2 else results[0])
    cb, cq = CV.consensus_base_vec(cons, opts)
    return np.concatenate([[0], np.cumsum(maxn)]), cb, cq


def _run_one(opts, b, c: Ctx):
    """One pileup_loop pass + trailing output (pileup_loop_serial)."""
    seq_init = nm_init if opts.mode != MODE_SIMPLE else None
    col_fn = basic_pileup if opts.fmt == PILEUP else basic_fasta
    use_vec = (opts.fmt != PILEUP
               and opts.mode in (MODE_RECALL, MODE_PRECISE, MODE_MIXED)
               and os.environ.get("SAMTPU_CONSENSUS_VEC", "1") != "0")
    if use_vec:
        if _pileup_vec(opts, b, c) < 0:
            return -1
    elif pileup_loop(_stream_reads(b, opts, c), seq_init,
                                   col_fn, c) < 0:
        return -1

    if opts.fmt == PILEUP:
        if opts.all_bases:
            tid = c.iter[0] if c.iter else c.last_tid
            if tid >= 0:
                ln = opts.header.ref_lens[tid]
                pos = c.last_pos
                if c.iter:
                    ln = min(c.iter[2], ln)
                    pos = max(c.iter[1], pos)
                if empty_pileup2(c, tid, pos, ln) < 0:
                    return -1
        while not c.iter and opts.all_bases > 1 \
                and c.last_tid + 1 < opts.header.n_refs:
            c.last_tid += 1
            ln = opts.header.ref_lens[c.last_tid]
            if empty_pileup2(c, c.last_tid, 0, ln) < 0:
                return -1
    else:
        while True:
            if opts.all_bases:
                tid = c.iter[0] if c.iter else c.last_tid
                if tid >= 0:
                    ln = opts.header.ref_lens[tid]
                    pos = c.last_pos
                    if c.iter:
                        ln = min(c.iter[2], ln)
                        pos = max(c.iter[1], pos)
                        c.last_tid = c.iter[0]
                    if pos < ln:
                        if update_ref(c, c.last_tid) < 0:
                            return -1
                        while pos < ln:
                            pos += 1
                            if c.ref is not None and opts.ref_fn:
                                c.seq.append(c.ref[pos - 1])
                                c.qual.append(chr(opts.ref_qual + 33))
                            else:
                                c.seq.append("N")
                                c.qual.append("!")
            if c.last_tid >= 0:
                tid = c.iter[0] if c.iter else c.last_tid
                ln = opts.header.ref_lens[tid]
                if c.iter and (c.iter[1] > 0 or c.iter[2] < ln):
                    name = "%s:%d-%d" % (opts.header.ref_name(c.last_tid),
                                         c.iter[1] + 1,
                                         min(c.iter[2], ln))
                else:
                    name = opts.header.ref_name(c.last_tid)
                dump_fastq(opts, name, c.seq, c.qual)
            if not c.iter and opts.all_bases > 1 \
                    and c.last_tid + 1 < opts.header.n_refs:
                c.last_tid += 1
                c.last_pos = 0
                c.seq = []
                c.qual = []
                continue
            break
    return 0


def _endpos_arr(b):
    ops = b.cigar & 0xF
    lens = (b.cigar >> 4).astype(np.int64)
    consumes = np.array(F.CIGAR_CONSUMES_REF, np.int64)[ops] * lens
    cum = np.concatenate([[0], np.cumsum(consumes)])
    rlen = cum[b.cigar_off[1:]] - cum[b.cigar_off[:-1]]
    return b.pos + np.maximum(rlen, 1)


# a span worker's exit code on a BAM without an index (the JAX worker's
# ``_NoIndex``): the parent then runs serially
NO_INDEX = 3


def _span_worker(opts, b, stream, span: str) -> int:
    """The worker side of the span protocol (samtools_tpu/tools/
    consensus_cmd.py:2147-2169): SAMTPU_CONSENSUS_SPAN=tid:beg:end runs
    the vectorised engine over [beg, end) of contig tid, its reads
    through the index, and writes ``#SPANMETA first last`` (the first
    position called, -1 for none; the last position reached), then the
    sequence and the quality line.  Exits NO_INDEX on a BAM without an
    index."""
    if stream is not None and stream.index() is None:
        return NO_INDEX
    c = Ctx(opts)
    c.iter = tuple(int(x) for x in span.split(":"))
    c.last_pos = c.iter[1]
    if _pileup_vec(opts, b, c) < 0:
        return 1
    first = getattr(c, "span_first", None)
    w = opts.fp_out
    w.write("#SPANMETA %d %d\n" % (-1 if first is None else first,
                                   c.last_pos))
    w.write("".join(c.seq) + "\n")
    w.write("".join(c.qual) + "\n")
    return 0


def _run_sharded_consensus(opts, argv, shards: int, dev) -> int | None:
    """Span-block parallel consensus (samtools_tpu/tools/consensus_cmd.py:
    1774-1892; the reference's pileup_loop_parallel, bam_consensus.c:
    2626-2891): contiguous spans of max(ceil(len / shards), 1 Mi) per
    contig, one worker process a span (``_span_worker``), ``shards`` at a
    time on ``dev``, and the results stitched in order, the gaps between
    spans filled by the serial emitter's rules (``_span_fill``).  Returns
    None, to run serially, when every failed worker exited NO_INDEX; 1,
    with the failed workers' standard error, for any other failure."""
    header = opts.header
    jobs = spans(header, shards)
    # output and region options stripped: workers write temporary files
    fwd = strip_args(argv, ("-o", "--output", "-r", "--region"))
    base = worker_env(dev)
    base.pop("SAMTPU_SHARDS", None)
    tmps = []
    try:
        for _ in jobs:
            fd, name = tempfile.mkstemp(prefix="cons.span.", suffix=".raw")
            os.close(fd)
            tmps.append(name)
        workers = run_span_workers(
            [["consensus", *fwd, "-o", tmp] for tmp in tmps],
            [dict(base, SAMTPU_CONSENSUS_SPAN=f"{tid}:{beg}:{end}")
             for tid, beg, end in jobs], shards, dev)
        failed = [rc for rc, _ in workers if rc]
        if failed:
            if all(rc == NO_INDEX for rc in failed):
                return None
            report_failed(workers)
            return 1
        results: dict[int, list] = {tid: [] for tid, _, _ in jobs}
        for (tid, beg, end), name in zip(jobs, tmps):
            with open(name, "rb") as fh:
                meta = fh.readline().split()
                seq = fh.readline().rstrip(b"\n").decode("latin-1")
                qual = fh.readline().rstrip(b"\n").decode("latin-1")
            results[tid].append((beg, end, int(meta[1]), int(meta[2]),
                                 seq, qual))
    finally:
        for name in tmps:
            os.remove(name)

    c = Ctx(opts)
    for tid in results:
        name = header.ref_name(tid)
        ln = int(header.ref_lens[tid])
        if not any(r[2] >= 0 for r in results[tid]):
            if opts.all_bases > 1:
                fseq, fqual = _span_fill(opts, c, tid, 1, ln)
                dump_fastq(opts, name, [fseq], [fqual])
            continue
        seqs: list[str] = []
        quals: list[str] = []
        global_last = None
        for beg, end, first, last, seq, qual in results[tid]:
            if first < 0:
                continue
            first_eff = beg + 1 if opts.all_bases else first
            if global_last is None:
                if opts.all_bases and first_eff > 1:
                    fs, fq = _span_fill(opts, c, tid, 1, first_eff - 1)
                    seqs.append(fs)
                    quals.append(fq)
            elif first_eff > global_last + 1:
                fs, fq = _span_fill(opts, c, tid, global_last + 1,
                                    first_eff - 1)
                seqs.append(fs)
                quals.append(fq)
            seqs.append(seq)
            quals.append(qual)
            global_last = last
        if opts.all_bases and global_last < ln:
            fs, fq = _span_fill(opts, c, tid, global_last + 1, ln)
            seqs.append(fs)
            quals.append(fq)
        dump_fastq(opts, name, seqs, quals)
    return 0


def _span_fill(opts, c: Ctx, tid, lo1, hi1):
    """Gap fill for 1-based positions [lo1, hi1]: the lazy-fill rule of
    ``_fasta_emit`` (reference bases at ref_qual, else N and !)."""
    n = hi1 - lo1 + 1
    if n <= 0:
        return "", ""
    if opts.ref_fn and update_ref(c, tid) > 0 and c.ref is not None:
        return c.ref[lo1 - 1:hi1], chr(opts.ref_qual + 33) * n
    return "N" * n, "!" * n


def usage(fp):
    fp.write("Usage: samtools consensus [options] <in.bam>\n")


LONG_OPTS = [
    "use-qual", "no-use-qual", "adj-qual", "no-adj-qual", "use-MQ",
    "no-use-MQ", "adj-MQ", "no-adj-MQ", "NM-halo=", "SC-cost=",
    "scale-MQ=", "low-MQ=", "high-MQ=", "min-depth=", "call-fract=",
    "het-fract=", "region=", "regions-file=", "format=", "cutoff=",
    "ambig", "line-len=", "default-qual=", "het-only", "show-del=",
    "show-ins=", "mark-ins", "output=", "incl-flags=", "rf=",
    "excl-flags=", "ff=", "min-MQ=", "min-BQ=", "P-het=", "P-indel=",
    "het-scale=", "mode=", "homopoly-fix", "homopoly-score=",
    "homopoly-redux=", "qual-calibration=", "config=", "ref-qual=",
    "block-size=", "reference=",
]


def main_consensus(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    opts = Opts()
    out_path = None
    try:
        gopts, args = gnu_getopt(argv, "@:qd:c:H:r:5f:C:aAl:o:m:pt:X:T:Z:",
                                 LONG_OPTS)
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in gopts:
        if o == "-a":
            opts.all_bases += 1
        elif o in ("-q", "--use-qual"):
            opts.use_qual = 1
        elif o == "--no-use-qual":
            opts.use_qual = 0
        elif o == "--use-MQ":
            opts.use_mqual = 1
        elif o == "--no-use-MQ":
            opts.use_mqual = 0
        elif o == "--scale-MQ":
            opts.scale_mqual = float(v)
        elif o == "--low-MQ":
            opts.low_mqual = int(v)
        elif o == "--high-MQ":
            opts.high_mqual = int(v)
        elif o in ("-d", "--min-depth"):
            opts.min_depth = int(v)
        elif o in ("-c", "--call-fract"):
            opts.call_fract = float(v)
        elif o in ("-H", "--het-fract"):
            opts.het_fract = float(v)
        elif o in ("-r", "--region"):
            if opts.bed:
                print_error("consensus", "option -r and --regions-file "
                            "are incompatible")
                return 1
            opts.reg = v
        elif o == "--regions-file":
            if opts.reg:
                print_error("consensus", "option -r and --regions-file "
                            "are incompatible")
                return 1
            opts.bed = v
        elif o in ("-C", "--cutoff"):
            opts.cons_cutoff = int(v)
        elif o in ("-A", "--ambig"):
            opts.ambig = 1
        elif o in ("-p", "--homopoly-fix"):
            opts.homopoly_fix = P_HOMOPOLY
        elif o == "--homopoly-score":
            opts.homopoly_fix = float(v)
        elif o == "--homopoly-redux":
            opts.homopoly_redux = float(v)
        elif o == "--default-qual":
            opts.default_qual = int(v)
        elif o == "--het-only":
            opts.het_only = 1
        elif o == "--show-del":
            opts.show_del = 1 if v[:1] in "yY" else 0
        elif o == "--show-ins":
            opts.show_ins = 1 if v[:1] in "yY" else 0
        elif o == "--mark-ins":
            opts.mark_ins = 1
        elif o == "--min-MQ":
            opts.min_mqual = int(v)
        elif o == "--min-BQ":
            opts.min_qual = int(v)
        elif o == "--P-het":
            opts.P_het = float(v)
        elif o == "--P-indel":
            opts.P_indel = float(v)
        elif o == "--het-scale":
            opts.het_scale = float(v)
        elif o == "--adj-qual":
            opts.adj_qual = 1
        elif o == "--no-adj-qual":
            opts.adj_qual = 0
        elif o == "--adj-MQ":
            opts.nm_adjust = 1
        elif o == "--no-adj-MQ":
            opts.nm_adjust = 0
        elif o == "--NM-halo":
            opts.nm_halo = int(v)
        elif o == "--SC-cost":
            opts.sc_cost = int(v)
        elif o == "-Z" or o == "--block-size":
            pass
        elif o in ("-m", "--mode"):
            lv = v.lower()
            if lv == "simple":
                opts.mode = MODE_SIMPLE
            elif lv == "bayesian_m":
                opts.mode = MODE_MIXED
            elif lv == "bayesian_p":
                opts.mode = MODE_PRECISE
            elif lv in ("bayesian_r", "bayesian"):
                opts.mode = MODE_RECALL
            elif lv == "bayesian_116":
                opts.mode = MODE_BAYES_116
            else:
                sys.stderr.write("Unknown mode %s\n" % v)
                return 1
        elif o in ("-l", "--line-len"):
            opts.line_len = int(v)
            if opts.line_len <= 0:
                opts.line_len = 1 << 31
        elif o in ("-f", "--format"):
            lv = v.lower()
            if lv == "fasta":
                opts.fmt = FASTA
            elif lv == "fastq":
                opts.fmt = FASTQ
            elif lv == "pileup":
                opts.fmt = PILEUP
            else:
                sys.stderr.write("Unknown format %s\n" % v)
                return 1
        elif o in ("-o", "--output"):
            out_path = v
        elif o in ("-X", "--config"):
            global _QCAL_STATIC
            if _QCAL_STATIC is None:
                _QCAL_STATIC = _load_static_qcal()
            lv = v.lower()
            if lv not in _QCAL_STATIC:
                sys.stderr.write(
                    'Unrecognised configuration name: "%s"\n' % v)
                return 1
            s, u, om = _QCAL_STATIC[lv]
            opts.qcal.smap = list(s)
            opts.qcal.umap = list(u)
            opts.qcal.omap = list(om)
            opts.mode = MODE_RECALL
            if lv != "hiseq":
                opts.homopoly_fix = 0.3
                opts.homopoly_redux = 0.01
                opts.het_scale = 0.37
                if lv == "ultima":
                    opts.scale_mqual = 2
                    opts.low_mqual = 10
                else:
                    opts.low_mqual = 5
                    opts.scale_mqual = 1.5
            else:
                opts.homopoly_redux = 0.01
        elif o in ("--incl-flags", "--rf"):
            fl = str2flag(v)
            if fl < 0:
                print_error("consensus", "could not parse --rf %s", v)
                return 1
            opts.incl_flags = fl
        elif o in ("--excl-flags", "--ff"):
            fl = str2flag(v)
            if fl < 0:
                print_error("consensus", "could not parse --ff %s", v)
                return 1
            opts.excl_flags = fl
        elif o in ("-t", "--qual-calibration"):
            sys.stderr.write("qual-calibration files not supported yet\n")
            return 1
        elif o in ("-T", "--reference"):
            opts.ref_fn = v
        elif o == "--ref-qual":
            opts.ref_qual = int(v)
        elif o == "-5":
            pass
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1

    if opts.mode != MODE_SIMPLE:
        if opts.mode == MODE_PRECISE:
            opts.cp_precise = ConsProbs(opts.P_het, opts.P_indel,
                                        0.3 * opts.het_scale,
                                        opts.homopoly_redux, opts.qcal,
                                        MODE_PRECISE)
        if opts.mode == MODE_MIXED:
            opts.cp_precise = ConsProbs(opts.P_het ** 0.7,
                                        opts.P_indel ** 0.7,
                                        0.3 * opts.het_scale,
                                        opts.homopoly_redux, opts.qcal,
                                        MODE_PRECISE)
        opts.cp_recall = ConsProbs(
            opts.P_het, opts.P_indel, opts.het_scale,
            opts.homopoly_redux if opts.mode == MODE_RECALL else 0.01,
            opts.qcal, MODE_RECALL)

    if len(args) != 1:
        usage(sys.stdout if not args else sys.stderr)
        return 0 if not args else 1

    vec = opts.fmt != PILEUP and opts.mode != MODE_SIMPLE
    span = os.environ.get("SAMTPU_CONSENSUS_SPAN") if vec else None
    if span:
        device = worker_device(device)
    try:
        opts.dev = pick_device(device)
    except RuntimeError as e:     # no CUDA card
        return no_card("consensus", e)

    # a BGZF BAM streams in bounded windows (the reference's span-block
    # memory profile), and with regions reads them through its index;
    # without an index (the JAX tool's _NoIndex fallback) and for other
    # formats the file is read whole
    stream = None
    try:
        stream = open_stream(args[0], ga.nthreads)
        if (stream is not None and (opts.reg or opts.bed)
                and stream.index() is None):
            stream.close()
            stream = None
        if stream is not None:
            opts.header = stream.header
            b = ("stream", stream)
        else:
            f = read_alignments(args[0], threads=ga.nthreads)
            opts.header = f.header
            b = f.batch
    except OSError as e:
        print_error_errno("consensus", 'Cannot open input file "%s"',
                          args[0], exc=e)
        return 1

    if opts.ref_fn:
        try:
            opts.fai = fastamod.load_fasta(opts.ref_fn)
        except OSError:
            sys.stderr.write("Failed to load fai for %s\n" % opts.ref_fn)
            return 1

    if out_path:
        try:
            opts.fp_out = open(out_path, "w")
        except OSError as e:
            sys.stderr.write("%s: %s\n" % (out_path, e.strerror))
            return 1

    rc = None
    if span:
        rc = _span_worker(opts, b, stream, span)
    elif (vec and stream is not None and not (opts.reg or opts.bed)
          and n_shards() > 1 and len(spans(opts.header, n_shards())) > 1):
        rc = _run_sharded_consensus(opts, argv, n_shards(), opts.dev)
    if rc is not None:
        if stream is not None:
            stream.close()
        if opts.fp_out is not sys.stdout:
            opts.fp_out.close()
        return rc

    ret = 0
    if opts.bed:
        # --regions-file: iterate bed intervals
        try:
            bed_lines = open(opts.bed, "rt").read().split("\n")
        except OSError as e:
            print_error_errno("consensus", 'Could not read file "%s"',
                              opts.bed, exc=e)
            return 1
        by_tid: dict[int, list] = {}
        order: list[int] = []
        for line in bed_lines:
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            tid = opts.header.tid(parts[0])
            if tid < 0:
                continue
            if tid not in by_tid:
                order.append(tid)
            by_tid.setdefault(tid, []).append(
                [int(parts[1]), int(parts[2])])
        # NB: the reference iterates chromosomes in khash bucket order
        # (bedidx.c bed_reglist) which is not reproducible portably; we
        # use BED first-appearance order.  Intervals per chromosome are
        # sorted ascending and NOT merged, as in the reference.
        for tid in order:
            ivals = sorted(by_tid[tid])
            for bg, e in ivals:
                ln = opts.header.ref_lens[tid]
                if bg > e or bg > ln:
                    sys.stderr.write(
                        '[consensus] Warning: Invalid region "%s:%d-%d"'
                        "\n" % (opts.header.ref_name(tid), bg, e))
                    continue
                bg = max(bg, 0)
                e = min(e, ln)
                c = Ctx(opts)
                c.iter = (tid, bg, e)
                c.last_pos = bg
                if _run_one(opts, b, c) < 0:
                    ret = 1
                    break
    else:
        c = Ctx(opts)
        if opts.reg:
            try:
                r = parse_region(opts.reg, opts.header.tid)
            except RegionError:
                print_error("consensus", 'Failed to parse region "%s"',
                            opts.reg)
                return 1
            if r.tid < 0:
                print_error("consensus", 'Failed to parse region "%s"',
                            opts.reg)
                return 1
            end = min(r.end, opts.header.ref_lens[r.tid])
            c.iter = (r.tid, r.beg, end)
        if _run_one(opts, b, c) < 0:
            ret = 1

    if stream is not None:
        stream.close()
    if opts.fp_out is not sys.stdout:
        opts.fp_out.close()
    else:
        sys.stdout.flush()
    return ret
