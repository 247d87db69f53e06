"""samtools mpileup on the port.

Counterpart of samtools_tpu/tools/mpileup_cmd.py (``main_mpileup``,
``_run_pileup``, the window machinery, ``_prepare_sub``,
``_DeviceBaqEngine``, ``FileState``, ``build_entry_pieces``, the row
renderer and the per-column writer); its output is the JAX tool's, byte
for byte.

Windows: coordinate-sorted BAMs stream in windows of WINDOW_COLS columns
(one cursor per file, merged); with ``-r`` an indexed BAM gives the
index's chunks for the region (``try_region_read``) and any other input
is read whole, as are ``-`` (standard input) and SAM; then each contig
is one window (``wb = None``), filtered to the region's reads.  Per
window and file: the mplp_func read filters, the Illumina-1.3 quals,
BAQ, ``-C``'s mapping-quality cap, the mapq/orphan filters, the depth
cap and the overlap tweak.  Then one of
three writers, as in the JAX tool:

* one file with the default columns: the native text writer, with BAQ
  (at ``-C`` <= 10) through ``_DeviceBaqEngine`` (K4 -> K5 -> K1's
  census form on the card), or through ``apply_baq_batch`` (K8 on the
  card, the host HMM for the rest);
* otherwise the pileup table (``ops.pileup.build_pileup``, ordered by K13
  on the card) and ``build_entry_pieces``, rendered in bulk by
  ``_render_rows`` (numpy; it also renders the per-read extra columns,
  which the JAX renderer leaves to the per-column writer);
* with ``--output-extra`` aux tags, the per-column writer
  (``_append_file_column``).

``--checkpoint FILE`` (with ``-o``): after each streamed window the
output is flushed and FILE (written to FILE.tmp, then renamed) records
the window's end, the ``-a`` cursor, the output's length and, per file, a
record virtual offset from which re-streaming rebuilds every read still
held; a run that finds a FILE for the same inputs truncates the output
there and resumes.

``SAMTPU_DEVICE=0|host`` runs the host branch: the host HMM, the numpy
sort, no kernel.  A CRAM is decoded whole on the host
(``io/cram_decode.py``) and takes the same paths as a SAM; ``-r`` on it
filters the whole file, as in the JAX tool.

``SAMTPU_SHARDS=N`` above 1, with one input that is not standard input,
no ``-r`` and no ``--checkpoint``, runs the JAX tool's span workers
(``_run_sharded``): the contigs are cut into spans of at least 1 Mi, one
``python -m samtools_tpu_torch mpileup -r <span>`` worker a span, N at a
time, on the parent's device (all on one card when there is one), and
their outputs are joined in span order.  With fewer than two spans the
run is serial.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import types

import numpy as np
import torch

from ..core import aux as auxmod
from ..core import flags as F
from ..core import metrics
from ..core.batch import ReadBatch, ragged_gather_indices
from ..core.regions import RegionError, parse_region
from ..io import bed as bedmod
from ..io import fasta as fastamod
from ..io import native
from ..io.files import read_alignments
from ..ops import baq as baqmod
from ..ops import basemods
from ..ops.mpileup_device import (HOST_THREADS, NT16_TO4,
                                  DeviceCensusPipeline, _host_census,
                                  census_checksum, stored_baq_tags)
from ..ops.overlaps import tweak_overlaps
from ..ops.pileup import build_pileup
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     n_shards, no_card, open_stream, pick_device,
                     print_error_errno, report_failed, run_span_workers,
                     spans, strip_args, try_region_read, worker_device,
                     worker_env)
from .flags_cmd import str2flag

DEFAULT_FF = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP

# streamed pileup window (columns per block)
WINDOW_COLS = 1 << 20

# extra columns in output order (bam_plcmd.c's flag bits 11..26)
COL_MAPQ_CHAR = 1 << 11
COL_QPOS = 1 << 12
COL_QNAME = 1 << 13
COL_FLAG = 1 << 14
COL_RNAME = 1 << 15
COL_POS = 1 << 16
COL_MAPQ = 1 << 17
COL_CIGAR = 1 << 18
COL_RNEXT = 1 << 19
COL_PNEXT = 1 << 20
COL_TLEN = 1 << 21
COL_SEQ = 1 << 22
COL_QUAL = 1 << 23
COL_RLEN = 1 << 24
COL_MODS = 1 << 25
COL_QPOS5 = 1 << 26
COL_LAST = 1 << 27

# --output-extra names -> column (the subset samtools supports)
_NAMED_COLS = {
    "QNAME": COL_QNAME, "FLAG": COL_FLAG, "RNAME": COL_RNAME,
    "POS": COL_POS, "MAPQ": COL_MAPQ, "RNEXT": COL_RNEXT,
    "PNEXT": COL_PNEXT, "RLEN": COL_RLEN,
}

SEQ_LC = ",acmgrsvtwyhkdbn"
SEQ_UC = ".ACMGRSVTWYHKDBN"
NT16 = baqmod.NT16_LUT


def _kputd(v: float) -> str:
    """htslib kputd: the shortest %g-like rendering of a double."""
    return "%g" % v


def usage(fp):
    fp.write(
        "Usage: samtools mpileup [options] in1.bam [in2.bam [...]]\n"
        "\nInput options:\n"
        "  -6, --illumina1.3+      quality is in the Illumina-1.3+ encoding\n"
        "  -A, --count-orphans     do not discard anomalous read pairs\n"
        "  -b, --bam-list FILE     list of input BAM filenames, one per line\n"
        "  -B, --no-BAQ            disable BAQ (per-Base Alignment Quality)\n"
        "  -C, --adjust-MQ INT     adjust mapping quality [0]\n"
        "  -d, --max-depth INT     max per-file depth; avoids excessive memory usage [8000]\n"
        "  -E, --redo-BAQ          recalculate BAQ on the fly, ignore existing BQs\n"
        "  -f, --fasta-ref FILE    faidx indexed reference sequence file\n"
        "  -G, --exclude-RG FILE   exclude read groups listed in FILE\n"
        "  -l, --positions FILE    skip unlisted positions (chr pos) or regions (BED)\n"
        "  -q, --min-MQ INT        skip alignments with mapQ smaller than INT [0]\n"
        "  -Q, --min-BQ INT        skip bases with baseQ/BAQ smaller than INT [13]\n"
        "  -r, --region REG        region in which pileup is generated\n"
        "  -R, --ignore-RG         ignore RG tags (one BAM = one sample)\n"
        "  --rf, --incl-flags STR|INT\n"
        "                          required flags: include reads with any of the mask bits set []\n"
        "  --ff, --excl-flags STR|INT\n"
        "                          filter flags: skip reads with any of the mask bits set\n"
        "                          [UNMAP,SECONDARY,QCFAIL,DUP]\n"
        "  -x, --ignore-overlaps-removal, --disable-overlap-removal\n"
        "                          disable read-pair overlap detection and removal\n"
        "  -X, --customized-index  use customized index files\n"
        "\nOutput options:\n"
        "  -o, --output FILE       write output to FILE [standard output]\n"
        "  -O, --output-BP         output base positions on reads, current orientation\n"
        "  --output-BP-5           output base positions on reads, 5' to 3' orientation\n"
        "  -M, --output-mods       output base modifications\n"
        "  -s, --output-MQ         output mapping quality\n"
        "  --output-QNAME          output read names\n"
        "  --output-extra STR      output extra read fields and read tag values\n"
        "  --output-sep CHAR       set the separator character for tag lists [,]\n"
        "  --output-empty CHAR     set the no value character for tag lists [*]\n"
        "  --no-output-ins         skip insertion sequence output\n"
        "  --no-output-ins-mods    skip insertion base modifications\n"
        "  --no-output-del         skip deletion sequence output\n"
        "  --no-output-ends        remove the '^' and '$' markers\n"
        "  --reverse-del           use '#' character for deletions on the reverse strand\n"
        "  -a                      output all positions (including zero depth)\n"
        "  -a -a (or -aa)          output absolutely all positions, including unused ref. sequences\n")


class FileState:
    """One input file's pileup of one window: its prepared reads, the
    pileup table, each entry's rendered bytes (flat + offsets), qual char
    and min-BQ pass."""

    def __init__(self, sub, pileup, piece_flat, piece_off, qual_chars,
                 pass_q):
        self.sub = sub
        self.p = pileup
        self.piece_flat = piece_flat   # uint8 flat of per-entry strings
        self.piece_off = piece_off     # int64[n_entries+1]
        self.qual_chars = qual_chars
        self.pass_q = pass_q
        self._pos2col = None

    @property
    def pos2col(self):
        """position -> column index (the per-column writer's lookup)."""
        if self._pos2col is None:
            self._pos2col = {int(p): i
                             for i, p in enumerate(self.p.col_pos)}
        return self._pos2col

    def entry_bytes(self, i: int) -> str:
        return bytes(self.piece_flat[self.piece_off[i]:
                                     self.piece_off[i + 1]]) \
            .decode("latin-1")


def build_entry_pieces(sub, p, ref: bytes | None, ref_len: int, conf):
    """Each entry's seq-column piece (flat uint8 + offsets), qual char and
    min-BQ pass.  Plain entries (with ^q heads and $ tails) are array
    scatters; only entries with an indel anchor or a base modification
    take the Python string builder (pileup_seq's rare branches)."""
    n = p.n_entries
    rev = (sub.flag[p.rid] & F.FREVERSE) != 0
    lq = sub.l_qseq[p.rid]
    have_base = p.qpos < lq
    code = np.full(n, 15, np.int64)
    hv = np.nonzero(have_base)[0]
    code[hv] = sub.seq[sub.seq_off[p.rid[hv]] + p.qpos[hv]]
    if ref is not None:
        rb = np.full(n, 15, np.int64)
        inref = p.pos < ref_len
        refarr = np.frombuffer(ref, np.uint8)
        rb[inref] = NT16[refarr[p.pos[inref]]]
        code = np.where(code == rb, 0, code)
    uc = np.frombuffer(SEQ_UC.encode(), np.uint8)
    lc = np.frombuffer(SEQ_LC.encode(), np.uint8)
    base_ch = np.where(rev, lc[code], uc[code]).astype(np.uint8)
    # deletion / reference-skip chars
    del_ch = np.where(p.is_refskip,
                      np.where(rev, ord("<"), ord(">")),
                      np.where(rev & bool(conf["rev_del"]),
                               ord("#"), ord("*"))).astype(np.uint8)
    ch = np.where(p.is_del, del_ch, base_ch)

    # qual char and pass mask
    qv = np.zeros(n, np.int64)
    qv[hv] = sub.qual[sub.seq_off[p.rid[hv]] + p.qpos[hv]]
    pass_q = qv >= conf["min_baseQ"]
    qch = np.minimum(qv + 33, 126).astype(np.uint8)

    # mapq char of the ^ marker
    mq = np.minimum(sub.mapq[p.rid].astype(np.int64) + 33, 126).astype(
        np.uint8)

    # base modifications (-M): {rid: {qpos: [(strand, code, qual)]}};
    # entries with a mod annotation leave the plain path
    want_mods = bool(conf["flag_cols"] & COL_MODS)
    mods_by_rid: dict = {}
    has_mod = np.zeros(n, bool)
    if want_mods:
        mods_by_rid = basemods.batch_mods(sub, p.rid)
        if mods_by_rid:
            mod_rows = np.nonzero(np.isin(
                p.rid, np.fromiter(mods_by_rid, np.int64,
                                   len(mods_by_rid))))[0]
            for i in mod_rows:
                m = mods_by_rid.get(int(p.rid[i]))
                if m is not None and not p.is_del[i] \
                        and int(p.qpos[i]) in m:
                    has_mod[i] = True

    no_ends = conf["no_ends"]
    special = (p.indel != 0) | has_mod
    headv = p.is_head & (not no_ends)
    tailv = p.is_tail & (not no_ends)
    lens = (1 + 2 * (headv & ~special) + (tailv & ~special)) \
        .astype(np.int64)
    spec_idx = np.nonzero(special)[0]
    spec_strs: list[bytes] = []
    if spec_idx.size:
        chr_lut = [chr(i) for i in range(256)]
        no_ins = conf["no_ins"]
        no_del = conf["no_del"]
        no_ins_mods = conf["no_ins_mods"] or no_ins
        for i in spec_idx:
            rmods = mods_by_rid.get(int(p.rid[i])) if want_mods else None
            s = []
            if p.is_head[i] and not no_ends:
                s.append("^")
                s.append(chr_lut[mq[i]])
            s.append(chr_lut[ch[i]])
            if rmods is not None and not p.is_del[i]:
                lst = rmods.get(int(p.qpos[i]))
                if lst:
                    s.append(basemods.format_mods(lst))
            ind = int(p.indel[i])
            del_len = -ind
            if ind > 0:
                ins_str, del_after, ins_qpos = p.ins.get(int(i),
                                                         ("", 0, []))
                del_len = del_after
                if no_ins < 2:
                    s.append("+")
                    s.append(str(len(ins_str)))
                if not no_ins:
                    ins_mods = (rmods if (rmods is not None and
                                          not no_ins_mods) else None)
                    if rev[i]:
                        pad = "#" if conf["rev_del"] else "*"
                        for k, c in enumerate(ins_str):
                            s.append(pad if c == "*" else c.lower())
                            if ins_mods is not None and ins_qpos[k] >= 0:
                                lst = ins_mods.get(ins_qpos[k])
                                if lst:
                                    s.append(basemods.format_mods(lst))
                    else:
                        for k, c in enumerate(ins_str):
                            s.append(c.upper())
                            if ins_mods is not None and ins_qpos[k] >= 0:
                                lst = ins_mods.get(ins_qpos[k])
                                if lst:
                                    s.append(basemods.format_mods(lst))
            if del_len > 0:
                if no_del < 2:
                    s.append(str(-del_len))
                if not no_del:
                    refpart = []
                    for j in range(1, del_len + 1):
                        pj = int(p.pos[i]) + j
                        c = chr(ref[pj]) if (ref is not None
                                             and pj < ref_len) else "N"
                        refpart.append(c.lower() if rev[i] else c.upper())
                    s.append("".join(refpart))
            if p.is_tail[i] and not no_ends:
                s.append("$")
            sb = "".join(s).encode("latin-1")
            spec_strs.append(sb)
            lens[i] = len(sb)

    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    flat = np.empty(int(off[-1]), np.uint8)
    pl = ~special
    ph = pl & headv
    # the base char lands after the optional ^q prefix
    flat[off[:-1][pl] + 2 * ph[pl]] = ch[pl]
    if ph.any():
        hidx = off[:-1][ph]
        flat[hidx] = ord("^")
        flat[hidx + 1] = mq[ph]
    pt = pl & tailv
    if pt.any():
        flat[off[:-1][pt] + 2 * ph[pt] + 1] = ord("$")
    for k, i in enumerate(spec_idx):
        sb = spec_strs[k]
        flat[off[i]:off[i] + len(sb)] = np.frombuffer(sb, np.uint8)
    return flat, off, qch, pass_q


def _read_filter(b, conf, bedidx, header) -> np.ndarray:
    """mplp_func's record filter chain (BAQ and the mapq/orphan filters
    come later, per window)."""
    fl = b.flag.astype(np.int64)
    keep = (b.tid >= 0) & ((fl & F.FUNMAP) == 0)
    if conf["rflag_require"]:
        keep &= (fl & conf["rflag_require"]) != 0
    if conf["rflag_filter"]:
        keep &= (fl & conf["rflag_filter"]) == 0
    if bedidx is not None and conf["all"] == 0:
        end = b.end_pos()
        hit = np.zeros(b.n, bool)
        for t in np.unique(b.tid[b.tid >= 0]):
            m = np.nonzero(b.tid == t)[0]
            hit[m] = bedidx.overlap(header.ref_names[t], b.pos[m], end[m])
        keep &= hit
    if conf["rghash"] is not None:
        rg = auxmod.batch_tag_values(b, "RG")
        keep &= np.array([not (v is not None and v in conf["rghash"])
                          for v in rg], bool)
    return keep


def main_mpileup(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    conf = dict(
        min_mq=0, min_baseQ=13, capQ_thres=0, max_depth=8000,
        rflag_require=0, rflag_filter=DEFAULT_FF, no_orphan=True, realn=True,
        smart_overlaps=True, redo_baq=False, illumina13=False,
        ignore_rg=False, all=0, rev_del=0, sep=",", empty="*", no_ins=0,
        no_ins_mods=0, no_del=0, no_ends=0, flag_cols=0, auxtags=[],
        rghash=None, census_out=None, checkpoint=None)
    reg = None
    bedidx = None
    fai = None
    out_fname = None
    file_list = None
    has_index_file = False
    longopts = [
        "rf=", "ff=", "incl-flags=", "excl-flags=", "output=",
        "output-QNAME", "output-qname", "illumina1.3+", "count-orphans",
        "bam-list=", "no-BAQ", "no-baq", "adjust-MQ=", "adjust-mq=",
        "max-depth=", "redo-BAQ", "redo-baq", "fasta-ref=", "exclude-RG=",
        "exclude-rg=", "positions=", "region=", "ignore-RG", "ignore-rg",
        "min-MQ=", "min-mq=", "min-BQ=", "min-bq=",
        "ignore-overlaps-removal", "disable-overlap-removal", "output-mods",
        "output-BP", "output-bp", "output-BP-5", "output-bp-5", "output-MQ",
        "output-mq", "customized-index", "reverse-del", "output-extra=",
        "output-sep=", "output-empty=", "no-output-ins",
        "no-output-ins-mods", "no-output-del", "no-output-ends",
        "checkpoint=", "census-out=",
    ]
    try:
        opts, args = gnu_getopt(argv, "Af:r:l:q:Q:RC:Bd:b:o:EG:6OsxXaM",
                                longopts)
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-x", "--ignore-overlaps-removal",
                 "--disable-overlap-removal"):
            conf["smart_overlaps"] = False
        elif o in ("--rf", "--incl-flags"):
            conf["rflag_require"] = str2flag(v)
        elif o in ("--ff", "--excl-flags"):
            conf["rflag_filter"] = str2flag(v)
        elif o == "--checkpoint":
            conf["checkpoint"] = v
        elif o == "--census-out":
            # per-window BAQ-stage census checksums (the engine's
            # validation artifact)
            conf["census_out"] = v
        elif o in ("-o", "--output"):
            out_fname = v
        elif o in ("--output-QNAME", "--output-qname"):
            conf["flag_cols"] |= COL_QNAME
        elif o == "--reverse-del":
            conf["rev_del"] = 1
        elif o == "--output-extra":
            for tag in v.split(","):
                if tag in _NAMED_COLS:
                    conf["flag_cols"] |= _NAMED_COLS[tag]
                elif len(tag) == 2:
                    conf["auxtags"].append(tag)
                else:
                    sys.stderr.write(
                        f"[build_auxlist] tag '{tag}' has more than two "
                        "characters or not supported\n")
        elif o == "--output-sep":
            conf["sep"] = v[0]
        elif o == "--output-empty":
            conf["empty"] = v[0]
        elif o == "--no-output-ins":
            conf["no_ins"] += 1
        elif o == "--no-output-ins-mods":
            conf["no_ins_mods"] = 1
        elif o == "--no-output-del":
            conf["no_del"] += 1
        elif o == "--no-output-ends":
            conf["no_ends"] = 1
        elif o in ("-f", "--fasta-ref"):
            try:
                fai = fastamod.load_fasta(v)
            except OSError as e:
                print_error_errno("mpileup", 'Could not load fasta "%s"', v,
                                  exc=e)
                return 1
        elif o in ("-d", "--max-depth"):
            conf["max_depth"] = int(v)
        elif o in ("-r", "--region"):
            reg = v
        elif o in ("-l", "--positions"):
            try:
                bedidx = bedmod.read_bed(v)
            except OSError as e:
                print_error_errno("mpileup", 'Could not read file "%s"', v,
                                  exc=e)
                return 1
        elif o in ("-B", "--no-BAQ", "--no-baq"):
            conf["realn"] = False
        elif o == "-X":
            has_index_file = True
        elif o in ("-E", "--redo-BAQ", "--redo-baq"):
            conf["redo_baq"] = True
        elif o in ("-6", "--illumina1.3+"):
            conf["illumina13"] = True
        elif o in ("-R", "--ignore-RG", "--ignore-rg"):
            conf["ignore_rg"] = True
        elif o in ("-s", "--output-MQ", "--output-mq"):
            conf["flag_cols"] |= COL_MAPQ_CHAR
        elif o in ("-O", "--output-BP", "--output-bp"):
            conf["flag_cols"] |= COL_QPOS
        elif o in ("--output-BP-5", "--output-bp-5"):
            conf["flag_cols"] |= COL_QPOS5
        elif o in ("-M", "--output-mods"):
            conf["flag_cols"] |= COL_MODS
        elif o in ("-C", "--adjust-MQ", "--adjust-mq"):
            conf["capQ_thres"] = int(v)
        elif o in ("-q", "--min-MQ", "--min-mq"):
            conf["min_mq"] = int(v)
        elif o in ("-Q", "--min-BQ", "--min-bq"):
            conf["min_baseQ"] = int(v)
        elif o in ("-b", "--bam-list"):
            file_list = v
        elif o in ("-A", "--count-orphans"):
            conf["no_orphan"] = False
        elif o in ("-G", "--exclude-RG", "--exclude-rg"):
            conf["rghash"] = set()
            try:
                with open(v) as fh:
                    for line in fh:
                        conf["rghash"].update(line.split())
            except OSError:
                sys.stderr.write(
                    f"[bam_mpileup] Fail to open file {v}. Continue anyway.\n")
        elif o == "-a":
            conf["all"] += 1
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1

    if fai is None and ga.reference:
        try:
            fai = fastamod.load_fasta(ga.reference)
        except OSError:
            return 1
    if not conf["realn"] and conf["redo_baq"]:
        sys.stderr.write("Error: The -B option cannot be combined with -E\n")
        return 1
    if not argv:
        usage(sys.stderr)
        return 1
    if file_list:
        with open(file_list) as fh:
            args = [ln.strip() for ln in fh if ln.strip()]
    elif has_index_file:
        args = args[:len(args) // 2]
    if not args:
        sys.stderr.write("[mpileup] no input file/data given\n")
        return 1
    if os.environ.get("SAMTPU_MPILEUP_SHARD_WORKER") == "1":
        device = worker_device(device)
    try:
        dev = pick_device(device)
    except RuntimeError as e:     # no CUDA card
        return no_card("mpileup", e)

    files = []
    try:
        rc = _open_inputs(args, reg, ga.nthreads, files)
        if rc:
            return rc
        header = files[0].header
        sys.stderr.write(f"[mpileup] {_count_samples(files, args, conf)} "
                         f"samples in {len(files)} input files\n")
        region = None
        if reg:
            try:
                region = parse_region(reg, header.tid)
            except RegionError:
                sys.stderr.write(f"[E::mpileup] fail to parse region "
                                 f"'{reg}'\n")
                return 1
        if _would_shard(reg, conf, args, header):
            return _run_sharded(argv, header, n_shards(), out_fname, dev)
        ck_state = None
        if conf["checkpoint"]:
            if not out_fname:
                sys.stderr.write("[mpileup] --checkpoint requires -o FILE;"
                                 " ignoring\n")
                conf["checkpoint"] = None
            else:
                ck_state = _load_checkpoint(conf["checkpoint"], args)
        if ck_state and os.path.exists(out_fname):
            # resume: the output up to the last complete window stays
            out = open(out_fname, "r+")
            out.truncate(ck_state["out_off"])
            out.seek(ck_state["out_off"])
        else:
            ck_state = None
            out = open(out_fname, "w") if out_fname else sys.stdout
        try:
            return _run_pileup(files, args, header, conf, region, bedidx,
                               fai, dev, out, ck_state)
        finally:
            if out is not sys.stdout:
                out.close()
    finally:
        for f in files:
            if f.stream is not None:
                f.stream.close()


def _would_shard(reg, conf, paths, header) -> bool:
    """Whether the JAX tool runs this command as span workers
    (samtools_tpu/tools/mpileup_cmd.py:520-526 and ``_run_sharded``'s
    span list): SAMTPU_SHARDS > 1, no ``-r``, no ``--checkpoint``, one
    input that is not standard input, not inside a worker, and at least
    two spans.  Otherwise it runs serially, and so does the port."""
    shards = n_shards()
    return (shards > 1 and not reg and not conf["checkpoint"]
            and len(paths) == 1 and paths[0] != "-"
            and os.environ.get("SAMTPU_MPILEUP_SHARD_WORKER") != "1"
            and len(spans(header, shards)) > 1)


def _run_sharded(argv, header, shards: int, out_fname, dev) -> int:
    """Span-block parallel mpileup (samtools_tpu/tools/mpileup_cmd.py:
    558-632): the contigs cut into spans of max(ceil(len / shards), 1 Mi)
    positions, one worker process a span running this command over it
    (``-r``: a worker prints exactly its span's columns), ``shards`` at a
    time, on ``dev``; their outputs joined in span order.  Where the JAX
    tool sends the workers' standard error nowhere and stops at the first
    failed one, each worker's goes to a temporary file, and a failed
    worker's is copied to ours before the exit code 1."""
    span_list = spans(header, shards)
    # -o/--output stripped: workers write temporary files
    fwd = strip_args(argv, ("-o", "--output"))
    env = worker_env(dev, SAMTPU_MPILEUP_SHARD_WORKER="1")
    tmps = []
    try:
        for k in range(len(span_list)):
            fd, name = tempfile.mkstemp(prefix=f"mpileup.shard{k:03d}.",
                                        suffix=".txt")
            os.close(fd)
            tmps.append(name)
        workers = run_span_workers(
            [["mpileup", "-r", "%s:%d-%d" % (header.ref_names[tid],
                                             beg + 1, end), *fwd, "-o", tmp]
             for (tid, beg, end), tmp in zip(span_list, tmps)],
            [env] * len(span_list), shards, dev)
        if any(rc for rc, _ in workers):
            report_failed(workers)
            return 1
        out = open(out_fname, "wb") if out_fname else sys.stdout
        try:
            for name in tmps:
                with open(name, "rb") as fh:
                    while True:
                        chunk = fh.read(1 << 22)
                        if not chunk:
                            break
                        if out_fname:
                            out.write(chunk)
                        else:
                            _write_bytes(out, chunk)
        finally:
            if out_fname:
                out.close()
            else:
                out.flush()
        return 0
    finally:
        for name in tmps:
            os.remove(name)


def _open_inputs(paths, reg, nthreads, files) -> int:
    """Open each input into ``files``: with ``-r``, the reads the index
    gives for the region (``try_region_read``) or the whole file;
    without, a BamStream (``stream``) for a BGZF BAM, else the whole file
    in memory (``batch``: standard input, SAM).  The command's exit code
    on failure, else 0."""
    for path in paths:
        try:
            got = try_region_read(path, nthreads, reg) if reg else None
            st = (open_stream(path, nthreads or HOST_THREADS)
                  if not reg and path != "-" else None)
            if st is not None:
                files.append(types.SimpleNamespace(
                    header=st.header, batch=None, stream=st))
                continue
            got = got[0] if got else read_alignments(path, threads=nthreads)
            files.append(types.SimpleNamespace(
                header=got.header, batch=got.batch, stream=None))
        except RegionError:
            sys.stderr.write(f"[E::mpileup] fail to parse region '{reg}'\n")
            return 1
        except OSError as e:
            sys.stderr.write(f"[mpileup] failed to open {path}: "
                             f"{e.strerror}\n")
            return 1
    return 0


def _count_samples(files, paths, conf) -> int:
    """bam_smpl_add: one sample per distinct SM (the RG ID where SM is
    missing; the file name with no RG or with -R)."""
    samples = set()
    for f, path in zip(files, paths):
        if conf["ignore_rg"]:
            samples.add(path)
            continue
        rgs = f.header.rg_to_sample()
        if rgs:
            samples.update(rgs.values())
        else:
            samples.add(path)
    return len(samples)


def _extra_columns(conf):
    """The extra columns in output order, COL_MODS left out (it shapes
    the seq column)."""
    cols = []
    fv = COL_MAPQ_CHAR
    while fv < COL_LAST:
        if fv != COL_MODS and (conf["flag_cols"] & fv):
            cols.append(fv)
        fv <<= 1
    return cols


def _empty_row(name: str, pos: int, ref: bytes | None, ref_len: int,
               nf: int, conf) -> str:
    refc = chr(ref[pos]) if (ref is not None and pos < ref_len) else "N"
    n_extra = len(_extra_columns(conf)) + len(conf["auxtags"])
    percol = "\t0\t*\t*" + "\t*" * n_extra
    return f"{name}\t{pos + 1}\t{refc}" + percol * nf + "\n"


class _Refs:
    """Contig sequences from the FASTA, as the tool reads them: the last
    few contigs' bytes, the current contig's 0-4 codes and their copy on
    the device."""

    def __init__(self, fai, header):
        self.fai = fai
        self.header = header
        self.cache = {}
        self._ints = (None, None)
        self._dev = (None, None)

    def get(self, tid: int):
        """(sequence bytes, length), or (None, 0) without that contig."""
        if self.fai is None:
            return None, 0
        if tid not in self.cache:
            name = self.header.ref_names[tid]
            seq = self.fai.fetch(name) if self.fai.has(name) else None
            if len(self.cache) > 3:
                self.cache.clear()
            self.cache[tid] = (seq, len(seq) if seq is not None else 0)
        return self.cache[tid]

    def ints(self, tid: int) -> np.ndarray:
        if self._ints[0] != tid:
            self._ints = (tid, baqmod._ref_ints(self.get(tid)[0]))
        return self._ints[1]

    def on_device(self, tid: int, device) -> torch.Tensor | None:
        """The contig's codes on ``device``, uploaded once per contig (None
        for the host branch)."""
        if device is None:
            return None
        if self._dev[0] != (tid, device):
            self._dev = ((tid, device),
                         torch.from_numpy(self.ints(tid)).to(device))
        return self._dev[1]


def _write_bytes(out, data: bytes) -> None:
    outb = getattr(out, "buffer", None)
    if outb is not None:
        # rows written through the text layer go first
        out.flush()
        outb.write(data)
    else:
        out.write(data.decode("latin-1"))


def _checkpoint_sig(paths):
    """The inputs a checkpoint belongs to: each path with its size."""
    sig = []
    for p in paths:
        try:
            sig.append([p, os.path.getsize(p)])
        except OSError:
            sig.append([p, -1])
    return sig


def _load_checkpoint(path, paths):
    """The state a previous run over the same inputs saved, or None.
    Each window's output is independent of the others, so the output
    truncates to the last complete window and the streams re-enter at the
    saved record offsets."""
    try:
        with open(path) as fh:
            st = json.load(fh)
    except (OSError, ValueError):
        return None
    if st.get("sig") != _checkpoint_sig(paths):
        return None
    return st


def _save_checkpoint(ck_path, paths, tid, we, cursors, last_tid, last_pos,
                     out) -> None:
    out.flush()
    st = {"sig": _checkpoint_sig(paths), "tid": tid, "wb": we,
          "voffs": [c.checkpoint_voffset() for c in cursors],
          "last_tid": last_tid, "last_pos": last_pos,
          "out_off": out.tell()}
    with open(ck_path + ".tmp", "w") as fh:
        json.dump(st, fh)
    os.replace(ck_path + ".tmp", ck_path)


def _run_pileup(files, paths, header, conf, region, bedidx, fai, dev, out,
                ck_state=None) -> int:
    nf = len(files)
    refs = _Refs(fai, header)
    streaming = region is None and all(f.stream is not None for f in files)
    last_tid = last_pos = -1
    ck_path = conf["checkpoint"] if streaming else None
    if streaming:
        resume = None
        if ck_state:
            cursors = [_WindowCursor(f.stream, conf, bedidx, header,
                                     start_voffset=v,
                                     purge_before=(ck_state["tid"],
                                                   ck_state["wb"]))
                       for f, v in zip(files, ck_state["voffs"])]
            resume = (ck_state["tid"], ck_state["wb"])
            last_tid = ck_state["last_tid"]
            last_pos = ck_state["last_pos"]
        else:
            cursors = [_WindowCursor(f.stream, conf, bedidx, header)
                       for f in files]
        windows = _stream_windows(None, conf, bedidx, header, cursors,
                                  resume)
    else:
        windows = _slurped_windows(files, conf, region, bedidx, header)
    beg0 = region.beg if region else 0
    end0 = region.end if region else (1 << 62)
    # the native text writer: one file, default columns
    native_fast = nf == 1 and conf["flag_cols"] == 0 and not conf["auxtags"]
    # the card's engine (BAQ + census per window) on that path
    engine = None
    if (native_fast and conf["realn"] and conf["capQ_thres"] <= 10
            and fai is not None and dev is not None):
        engine = _DeviceBaqEngine(conf, dev)
    bulk_ok = not conf["auxtags"]
    caps = [types.SimpleNamespace(carry=None) for _ in files]
    one_seq = False
    w = out.write

    for tid, wb, we, subs in windows:
        name = header.ref_names[tid]
        if native_fast:
            nat_sub, _, _ = _prepare_sub(subs[0], conf, tid, refs, caps[0],
                                         wb, we, dev, engine)
            if nat_sub.n == 0:
                continue
            e_end = min(we if we is not None else 1 << 62, end0,
                        int(nat_sub.end_pos().max()))
            first_cov = max(int(nat_sub.pos.min()),
                            wb if wb is not None else 0, beg0)
            if first_cov >= e_end:
                continue
        else:
            states = [_prepare_file_state(sub, conf, tid, refs, cap, wb, we,
                                          dev)
                      for sub, cap in zip(subs, caps)]
            col_sets = [s.p.col_pos for s in states if s.p.n_entries]
            if not col_sets:
                continue
            allpos = np.unique(np.concatenate(col_sets))
            if wb is not None:
                # halo reads make entries outside [wb, we): those columns
                # belong to the neighbouring windows
                allpos = allpos[(allpos >= wb) & (allpos < we)]
            if region is not None:
                allpos = allpos[(allpos >= beg0) & (allpos < end0)]
            if allpos.size == 0:
                continue
        one_seq = True

        # -a: the empty rows of the contigs before this one
        if conf["all"]:
            while tid > last_tid:
                if last_tid >= 0 and region is None:
                    r, rl = refs.get(last_tid)
                    lname = header.ref_names[last_tid]
                    for pp in range(last_pos + 1, header.ref_lens[last_tid]):
                        if bedidx is not None and not bedidx.overlap_one(
                                lname, pp, pp + 1):
                            continue
                        w(_empty_row(lname, pp, r, rl, nf, conf))
                last_tid += 1
                last_pos = -1
                if conf["all"] < 2:
                    break
        ref, ref_len = refs.get(tid)
        last_tid = tid

        if native_fast:
            if conf["all"]:
                e_beg = min(max(last_pos + 1, beg0), first_cov)
                last_pos = e_end - 1
            else:
                e_beg = first_cov
            mask = None
            if bedidx is not None:
                rng = np.arange(e_beg, e_end, dtype=np.int64)
                mask = bedidx.overlap(name, rng, rng + 1)
            text = native.mpileup_text(
                nat_sub, ref, name, e_beg, e_end, conf["all"] > 0, mask,
                conf["min_baseQ"], conf["rev_del"], conf["no_ends"],
                conf["no_ins"], conf["no_del"])
            if text:
                _write_bytes(out, text)
        elif bulk_ok:
            if conf["all"]:
                start = last_pos + 1
                if region is not None:
                    start = max(start, beg0)
                start = min(start, int(allpos[0]))
                emitpos = np.arange(start, int(allpos[-1]) + 1,
                                    dtype=np.int64)
                last_pos = int(allpos[-1])
            else:
                emitpos = allpos
            if bedidx is not None and emitpos.size:
                emitpos = emitpos[bedidx.overlap(name, emitpos,
                                                 emitpos + 1)]
            if emitpos.size:
                _write_bytes(out, _render_rows(emitpos, states, name, ref,
                                               ref_len, conf, header)
                             .tobytes())
        else:
            for pos in allpos.tolist():
                if conf["all"]:
                    for pp in range(last_pos + 1, pos):
                        if region is not None and pp < beg0:
                            continue
                        if bedidx is not None and not bedidx.overlap_one(
                                name, pp, pp + 1):
                            continue
                        w(_empty_row(name, pp, ref, ref_len, nf, conf))
                    last_pos = pos
                if bedidx is not None and not bedidx.overlap_one(
                        name, pos, pos + 1):
                    continue
                refc = chr(ref[pos]) if (ref is not None
                                         and pos < ref_len) else "N"
                row = [name, "\t", str(pos + 1), "\t", refc]
                for s in states:
                    _append_file_column(row, s, pos, conf, header)
                row.append("\n")
                w("".join(row))
        if ck_path:
            _save_checkpoint(ck_path, paths, tid, we, cursors, last_tid,
                             last_pos, out)

    if engine is not None and conf["census_out"]:
        engine.write_census(conf["census_out"], header)

    # -a: the empty rows after the last covered column
    if conf["all"]:
        if last_tid < 0 and region is not None and conf["all"] > 1:
            last_tid = region.tid
            last_pos = beg0 - 1
        elif last_tid < 0 and not one_seq and conf["all"] > 1:
            last_tid = 0
        while 0 <= last_tid < header.n_refs:
            r, rl = refs.get(last_tid)
            lname = header.ref_names[last_tid]
            for pp in range(last_pos + 1, header.ref_lens[last_tid]):
                if pp >= end0:
                    break
                if bedidx is not None and not bedidx.overlap_one(
                        lname, pp, pp + 1):
                    continue
                w(_empty_row(lname, pp, r, rl, nf, conf))
            last_tid += 1
            last_pos = -1
            if conf["all"] < 2 or region is not None:
                break
    return 0


# ------------------------------------------------------------ the windows
class _WindowCursor:
    """Read cursor of one file's streamed windows.

    Pulls decoded batches on demand, applies the mplp_func record filter,
    and hands out each window's overlap set: the reads with pos < window
    end whose footprint can still touch the window, carried halo reads
    included (samtools re-queries its index with overlap; a sequential
    stream carries the boundary reads instead).  Each batch keeps the
    record offset it was read from, so ``checkpoint_voffset`` can name
    where a restarted run re-enters the stream; on such a run
    ``purge_before`` = (tid, wb) drops the reads that end before the
    resumed window."""

    def __init__(self, stream, conf, bedidx, header,
                 start_voffset: int | None = None, purge_before=None):
        self.stream = stream
        self.gen = stream.batches(start_voffset=start_voffset)
        self.conf = conf
        self.bedidx = bedidx
        self.header = header
        self.pending: list = []       # (filtered batch, origin voffset)
        self.carry = None             # (halo ReadBatch, tid)
        self.carry_voff = None
        self.done = False
        self.purge_before = purge_before

    def _origin(self) -> int:
        # before its first batch a stream has no next_record_voffset:
        # the header's end, as the JAX tool reads it
        return getattr(self.stream, "next_record_voffset",
                       self.stream._hdr_voffset)

    def _pull(self) -> bool:
        if self.done:
            return False
        origin = self._origin()
        nb = next(self.gen, None)
        if nb is None:
            self.done = True
            return False
        keep = _read_filter(nb, self.conf, self.bedidx, self.header)
        if self.purge_before is not None:
            rtid, rwb = self.purge_before
            keep &= (nb.tid > rtid) | ((nb.tid == rtid)
                                       & (nb.end_pos() > rwb))
            # sorted input: once a batch starts at or past the resumed
            # window, no later read can end before it
            if nb.n and (int(nb.tid[0]), int(nb.pos[0])) >= (rtid, rwb):
                self.purge_before = None
        if keep.all():
            self.pending.append((nb, origin))
        elif keep.any():
            self.pending.append((nb.take(np.nonzero(keep)[0]), origin))
        return True

    def front(self):
        """(tid, pos) of the next unconsumed read, or None at the end."""
        while not self.pending:
            if not self._pull():
                return None
        b = self.pending[0][0]
        return int(b.tid[0]), int(b.pos[0])

    def checkpoint_voffset(self) -> int:
        """A record offset from which re-streaming rebuilds every read
        this cursor still holds (pending and carried)."""
        cands = []
        if self.carry is not None and self.carry_voff is not None:
            cands.append(self.carry_voff)
        if self.pending:
            cands.append(self.pending[0][1])
        if not cands:
            cands.append(self._origin())
        return min(cands)

    def window(self, tid: int, wb: int, we: int) -> ReadBatch:
        """The overlap set of [wb, we) on tid: consumes the reads with
        pos < we and carries those that end past we into the next
        window.  Every read of the result is a copy its caller owns."""
        parts, voffs = [], []
        if self.carry is not None:
            cb, ctid = self.carry
            if ctid == tid:
                parts.append(cb.take(np.nonzero(cb.end_pos() > wb)[0]))
                if self.carry_voff is not None:
                    voffs.append(self.carry_voff)
            self.carry = None
            self.carry_voff = None
        while True:
            fr = self.front()
            if fr is None or fr[0] > tid or (fr[0] == tid and fr[1] >= we):
                break
            b, origin = self.pending.pop(0)
            voffs.append(origin)
            m = (b.tid == tid) & (b.pos < we)
            if m.all():
                parts.append(b)
                continue
            parts.append(b.take(np.nonzero(m)[0]))
            self.pending.insert(0, (b.take(np.nonzero(~m)[0]), origin))
            break
        sub = (ReadBatch.concat(parts) if len(parts) > 1 else
               parts[0] if parts else ReadBatch())
        if sub.n:
            hal = np.nonzero(sub.end_pos() > we)[0]
            if hal.size:
                self.carry = (sub.take(hal), tid)
                self.carry_voff = min(voffs) if voffs else None
        return sub

    def has_more_on(self, tid: int) -> bool:
        if self.carry is not None and self.carry[1] == tid:
            return True
        fr = self.front()
        return fr is not None and fr[0] == tid


def _stream_windows(streams, conf, bedidx, header, cursors=None,
                    resume=None):
    """(tid, wb, we, one overlap set per file) blocks of WINDOW_COLS
    columns in genomic order, merged over the files' streams (or the
    given ``cursors``), with bounded memory.  ``resume`` = (tid, wb)
    forces the first window there (a checkpoint restart: the cursors
    re-entered their streams at the saved offsets, so that window's
    overlap set rebuilds exactly)."""
    if cursors is None:
        cursors = [_WindowCursor(st, conf, bedidx, header) for st in streams]
    forced = resume
    while True:
        live = [f for f in (c.front() for c in cursors) if f is not None]
        if not live:
            return
        if forced is not None:
            (tid, wb), forced = forced, None
        else:
            tid = min(f[0] for f in live)
            wb = min(f[1] for f in live if f[0] == tid)
        while True:
            we = wb + WINDOW_COLS
            yield tid, wb, we, [c.window(tid, wb, we) for c in cursors]
            if not any(c.has_more_on(tid) for c in cursors):
                break
            wb = we


def _slurped_windows(files, conf, region, bedidx, header):
    """(tid, None, None, one batch per file): each contig of the reads
    kept (with -r, the region's contig and the reads overlapping the
    region) as one window, from whole files in memory."""
    selections = [_read_filter(f.batch, conf, bedidx, header)
                  for f in files]
    tids = set()
    for f, keep in zip(files, selections):
        tids.update(np.unique(f.batch.tid[keep & (f.batch.tid >= 0)])
                    .tolist())
    if region is not None:
        tids = {region.tid}
    for tid in sorted(tids):
        subs = []
        for f, keep in zip(files, selections):
            b = f.batch
            sel = np.nonzero(keep & (b.tid == tid))[0]
            if region is not None and sel.size:
                end = b.end_pos()
                sel = sel[(b.pos[sel] < region.end)
                          & (end[sel] > region.beg)]
            subs.append(b.take(sel))
        yield tid, None, None, subs


# ------------------------------------------------- per window and file
def _prepare_file_state(sub, conf, tid, refs, cap_state, wb, we,
                        dev) -> FileState:
    sub, ref, ref_len = _prepare_sub(sub, conf, tid, refs, cap_state, wb,
                                     we, dev)
    p = build_pileup(sub, dev)
    return FileState(sub, p, *build_entry_pieces(sub, p, ref, ref_len,
                                                 conf))


def _prepare_sub(sub, conf, tid, refs, cap_state, wb, we, dev,
                 engine=None):
    """mplp_func's per-read transforms and filters for one file's reads
    of one window: Illumina quals, BAQ, -C's cap, the min-mapQ/orphan
    filters, the depth cap, the overlap tweak.  Returns (sub, ref,
    ref_len).  ``wb`` None: the window is the whole contig.

    With ``engine`` BAQ runs after the mapq/orphan/depth-cap filters: the
    same output (those filters read no base qual, BAQ touches no mapq,
    and the engine is offered only at -C <= 10), BAQ skips the dropped
    reads, and the engine's census counts exactly the filtered reads."""
    if conf["illumina13"]:
        q = sub.qual.astype(np.int64)
        sub.qual = np.where(q > 31, q - 31, 0).astype(np.uint8)
    ref, ref_len = refs.get(tid)
    if engine is None and ref is not None:
        if conf["realn"]:
            baqmod.apply_baq_batch(sub, refs.ints(tid), conf["redo_baq"],
                                   dev, refs.on_device(tid, dev))
        if conf["capQ_thres"] > 10:
            newq = baqmod.cap_mapq_batch(sub, refs.ints(tid),
                                         conf["capQ_thres"])
            sub.mapq = np.where(newq >= 0, np.minimum(sub.mapq, newq),
                                sub.mapq).astype(np.uint8)
            if (newq < 0).any():
                sub = sub.take(np.nonzero(newq >= 0)[0])
    # the min-mapQ and orphan filters come after BAQ (mplp_func's order)
    keep = sub.mapq.astype(np.int64) >= conf["min_mq"]
    if conf["no_orphan"]:
        fl = sub.flag.astype(np.int64)
        keep &= ~(((fl & F.FPAIRED) != 0) & ((fl & F.FPROPER_PAIR) == 0))
    if not keep.all():
        sub = sub.take(np.nonzero(keep)[0])
    if conf["max_depth"]:
        if wb is None:
            if sub.n > conf["max_depth"]:
                sub = sub.take(_depth_cap_select(sub, conf["max_depth"]))
        else:
            # a read's cap decision is made once, in its first window, and
            # carried: it may depend on reads that ended before this window
            prev = None
            c = cap_state.carry
            if c is not None and c[0] == tid and c[1] == wb:
                prev = c[2]
            keepm, nxt = _depth_cap_stream(sub, conf["max_depth"], wb, we,
                                           prev)
            cap_state.carry = (tid, we, nxt)
            if not keepm.all():
                sub = sub.take(np.nonzero(keepm)[0])
    if engine is not None and ref is not None:
        engine.run_window(sub, tid, refs, wb, we)
    if conf["smart_overlaps"]:
        tweak_overlaps(sub)
    return sub, ref, ref_len


class _DeviceBaqEngine:
    """The tool's BAQ engine on the card: each window's BAQ and base
    census run through ``DeviceCensusPipeline.apply_window`` (device
    chunks, sparse qual deltas back to the host, risky and ineligible
    reads on the host's f64 HMM), and the census of the window's owned
    columns is kept as its two-lane checksum for ``--census-out`` (with
    the JAX tool's fields, ``reads_starting``: the window's reads that
    start in it, so the windows' sum counts every read once, and
    ``risky_reads``: those the f32 HMM sent to the host).  A window of
    the whole contig (``wb`` None) counts [0, contig length).  A window
    with no reference, stored BQ/ZQ tags, reads shorter than 8 bases or
    a contig past 64 Mi bases takes ``apply_baq_batch`` whole (K8 and
    the host HMM, or the tag conversions), with the same census recorded
    from its final quals."""

    def __init__(self, conf, device):
        self.device = device
        self.min_baseq = conf["min_baseQ"]
        self.redo = conf["redo_baq"]
        self.baq_flag = 7 if conf["redo_baq"] else 3
        self.want_census = bool(conf["census_out"])
        self.records: list = []
        self.n_reads = 0
        self.n_host = 0
        self.n_device_windows = 0

    def run_window(self, sub, tid, refs, wb, we):
        """BAQ one prepared window in place and record its census."""
        if sub.n == 0:
            return
        ref_len = refs.get(tid)[1]
        if wb is None:
            wb, we = 0, ref_len
        # the census window ends at the contig's end
        we = min(we, max(ref_len, wb + 1))
        wb = min(wb, we)
        ref_int = refs.ints(tid)
        ref_dev = refs.on_device(tid, self.device)
        lens = sub.seq_off[1:] - sub.seq_off[:-1]
        lq = int(np.bincount(np.minimum(lens, 1 << 14)).argmax())
        if lq >= 8 and ref_len <= (64 << 20) and not stored_baq_tags(sub):
            pipe = DeviceCensusPipeline(
                ref_int, wlen=we - wb, base=wb, min_baseq=self.min_baseq,
                baq_flag=self.baq_flag, l_query=lq, device=self.device,
                ref_dev=ref_dev)
            with metrics.stage("mpileup.device_window", sub.n, "reads"):
                nh = pipe.apply_window(sub, wb, we)
            self.n_reads += sub.n
            self.n_host += nh
            self.n_device_windows += 1
            if self.want_census:
                self.records.append(
                    {"tid": int(tid), "beg": int(wb), "end": int(we),
                     "reads": int(sub.n), "reads_starting":
                     int((sub.pos >= wb).sum()), "host_reads": int(nh),
                     "risky_reads": int(pipe.n_risky), "engine": "device",
                     "checksum": list(pipe.finish_checksum())})
            return
        baqmod.apply_baq_batch(sub, ref_int, self.redo, self.device, ref_dev)
        self.n_reads += sub.n
        self.n_host += sub.n
        if self.want_census:
            census = np.zeros((we - wb, 5), np.int64)
            qsum = np.zeros(we - wb, np.int64)
            _host_census(census, qsum, sub.pos.astype(np.int64), sub.cigar,
                         sub.cigar_off, NT16_TO4[sub.seq], sub.qual,
                         sub.seq_off, None, self.min_baseq, 0, base=wb,
                         gate_hi=we - wb, newq=sub.qual)
            self.records.append(
                {"tid": int(tid), "beg": int(wb), "end": int(we),
                 "reads": int(sub.n), "reads_starting":
                 int((sub.pos >= wb).sum()), "host_reads": int(sub.n),
                 "engine": "host",
                 "checksum": list(census_checksum(census, qsum))})

    def write_census(self, path: str, header) -> None:
        rec = {"min_baseq": self.min_baseq,
               "contigs": [str(n) for n in header.ref_names],
               "reads": int(self.n_reads),
               "host_reads": int(self.n_host),
               "device_windows": int(self.n_device_windows),
               "windows": self.records}
        with open(path, "w") as fh:
            json.dump(rec, fh)
            fh.write("\n")


def _depth_cap_stream(sub, maxcnt: int, wb: int, we: int, prev_keep):
    """The depth cap (bam_mplp_set_maxcnt: a read is dropped when the
    buffer already holds maxcnt reads overlapping its start) over one
    window's overlap set (coordinate-sorted; carried reads with pos < wb
    first).  Carried reads keep the decision of their first window
    (``prev_keep``, one bool per carried read); reads with pos >= wb are
    decided here, against the ends of the kept carried reads.  Returns
    (keep mask, the decisions of the reads carried into the next
    window)."""
    import heapq
    n = sub.n
    ends = sub.end_pos()
    pos = sub.pos
    keep = np.ones(n, bool)
    nc = int(np.searchsorted(pos, wb))
    if prev_keep is None or len(prev_keep) != nc:
        # first window of the contig: nothing carried
        nc = 0
    else:
        keep[:nc] = prev_keep
    # the largest span overlap bounds the active count from above: if it
    # never reaches maxcnt, nothing drops
    if n and _max_span_overlap(pos, ends) < maxcnt:
        return keep, keep[ends > we].copy()
    active: list = []
    for i in range(nc):
        if keep[i]:
            heapq.heappush(active, int(ends[i]))
    for i in range(nc, n):
        p = int(pos[i])
        while active and active[0] <= p:
            heapq.heappop(active)
        if len(active) >= maxcnt:
            keep[i] = False
            continue
        heapq.heappush(active, int(ends[i]))
    return keep, keep[ends > we].copy()


def _max_span_overlap(pos: np.ndarray, ends: np.ndarray) -> int:
    """The most read spans covering any one start position: an upper
    bound on the depth cap's active count (pos sorted)."""
    n = len(pos)
    if n == 0:
        return 0
    cnt = np.arange(1, n + 1) - np.searchsorted(np.sort(ends), pos,
                                                side="right")
    return int(cnt.max())


def _depth_cap_select(sub, maxcnt: int) -> np.ndarray:
    """The depth cap over a whole contig's reads (bam_mplp_set_maxcnt):
    the indices of the reads kept."""
    import heapq
    ends = sub.end_pos()
    if _max_span_overlap(sub.pos, ends) < maxcnt:
        return np.arange(sub.n, dtype=np.int64)
    keep = []
    active: list[int] = []
    for i in range(sub.n):
        p = int(sub.pos[i])
        while active and active[0] <= p:
            heapq.heappop(active)
        if len(active) >= maxcnt:
            continue
        keep.append(i)
        heapq.heappush(active, int(ends[i]))
    return np.array(keep, np.int64)


# ------------------------------------------------------------ the writers
def _itoa(vals: np.ndarray):
    """Vectorized non-negative decimal rendering: (flat uint8 digits,
    digit counts int64, offsets int64[n+1]).  Values below 65,536 are
    copied from a table of their renderings."""
    v = np.asarray(vals, np.int64)
    top = int(v.max()) if v.size else 0
    if top < 1 << 16:
        tab = [str(i).encode() for i in range(top + 1)]
        toff = np.zeros(top + 2, np.int64)
        np.cumsum([len(t) for t in tab], out=toff[1:])
        nd = np.diff(toff)[v]
        off = np.zeros(v.size + 1, np.int64)
        np.cumsum(nd, out=off[1:])
        flat = native.ragged_gather(np.frombuffer(b"".join(tab), np.uint8),
                                    toff, v, off, int(off[-1]),
                                    HOST_THREADS)
        return flat, nd, off
    nd = np.ones(v.size, np.int64)
    t = 10
    while t <= (int(v.max()) if v.size else 0):
        nd[v >= t] += 1
        t *= 10
    off = np.zeros(v.size + 1, np.int64)
    np.cumsum(nd, out=off[1:])
    flat = np.empty(int(off[-1]), np.uint8)
    end = off[1:] - 1
    rem = v.copy()
    for d in range(int(nd.max(initial=0))):
        act = nd > d
        flat[end[act] - d] = 48 + (rem[act] % 10)
        rem[act] //= 10
    return flat, nd, off


def _extra_tokens(fv: int, s: FileState, pidx: np.ndarray, header):
    """One extra column's value per passing entry ``pidx``, as (flat
    uint8, lengths int64, separator): what ``_append_file_column``
    writes for it."""
    sub, p = s.sub, s.p
    rid = p.rid[pidx].astype(np.int64)
    if fv == COL_MAPQ_CHAR:
        return (np.minimum(sub.mapq[rid].astype(np.int64) + 33, 126)
                .astype(np.uint8), np.ones(rid.size, np.int64), b"")
    if fv in (COL_QNAME, COL_RNAME, COL_RNEXT):
        if fv == COL_QNAME:
            flat, off = sub.qname, sub.qname_off
            row = rid
        else:
            names = ["*"] + list(header.ref_names)
            off = np.zeros(len(names) + 1, np.int64)
            np.cumsum([len(n.encode()) for n in names], out=off[1:])
            flat = np.frombuffer("".join(names).encode(), np.uint8)
            t = (sub.tid if fv == COL_RNAME else sub.mtid)[rid].astype(
                np.int64)
            row = np.where((t >= 0) & (t < header.n_refs), t + 1, 0)
        lens = off[row + 1] - off[row]
        return flat[ragged_gather_indices(off[row], lens)], lens, b","
    if fv == COL_QPOS:
        vals = p.qpos[pidx].astype(np.int64) + 1
    elif fv == COL_QPOS5:
        q = p.qpos[pidx].astype(np.int64)
        vals = np.where((sub.flag[rid] & F.FREVERSE) != 0,
                        sub.l_qseq[rid] - q + p.is_del[pidx], q + 1)
    elif fv == COL_FLAG:
        vals = sub.flag[rid]
    elif fv == COL_POS:
        vals = sub.pos[rid] + 1
    elif fv == COL_MAPQ:
        vals = sub.mapq[rid]
    elif fv == COL_PNEXT:
        vals = sub.mpos[rid] + 1
    else:   # COL_RLEN
        vals = sub.l_qseq[rid]
    flat, nd, _ = _itoa(vals)
    return flat, nd, b","


def _render_rows(emitpos: np.ndarray, states, name: str,
                 ref: bytes | None, ref_len: int, conf,
                 header) -> np.ndarray:
    """One window's pileup text as one byte buffer.

    In place of the per-column writer's loop, every field's bytes and
    offsets are computed over all the rows at once and scattered into one
    preallocated uint8 buffer.  A field is one file's count, seq column,
    qual column or one of its extra columns: the passing entries' pieces
    of a row are one contiguous run of the file's compacted pieces, and
    a column without passing entries prints ``*``."""
    nrow = emitpos.size
    name_b = np.frombuffer(name.encode(), np.uint8)
    if ref is not None:
        refarr = np.frombuffer(ref, np.uint8)
        refc = np.where(emitpos < ref_len,
                        refarr[np.minimum(emitpos, max(ref_len - 1, 0))],
                        ord("N")).astype(np.uint8)
    else:
        refc = np.full(nrow, ord("N"), np.uint8)
    pos_flat, pos_nd, pos_off = _itoa(emitpos + 1)
    extras = _extra_columns(conf)

    # (flat, start per row, length per row, rows with passing entries or
    # None for the count): a row's field is flat[start : start + length],
    # or "*" where it has no passing entry
    fields = []
    for s in states:
        p = s.p
        ncols = p.col_pos.size
        if ncols:
            ci = np.searchsorted(p.col_pos, emitpos)
            cic = np.minimum(ci, ncols - 1)
            pres = (ci < ncols) & (p.col_pos[cic] == emitpos)
            lo = np.where(pres, p.col_off[cic], 0)
            hi = np.where(pres, p.col_off[np.minimum(cic + 1, ncols)], 0)
        else:
            lo = hi = np.zeros(nrow, np.int64)
        # passing entries before each entry index: a row's passing
        # entries are [cq[lo], cq[hi]) of the compacted ones
        cq = np.zeros(p.n_entries + 1, np.int64)
        np.cumsum(s.pass_q, out=cq[1:])
        plo, phi = cq[lo], cq[hi]
        cnt = phi - plo
        nz = cnt > 0
        pidx = np.nonzero(s.pass_q)[0]
        cnt_flat, cnt_nd, cnt_off = _itoa(cnt)
        fields.append((cnt_flat, cnt_off[:-1], cnt_nd, None))
        plen = (s.piece_off[1:] - s.piece_off[:-1])[pidx]
        pc = np.zeros(pidx.size + 1, np.int64)
        np.cumsum(plen, out=pc[1:])
        pflat = native.ragged_gather(s.piece_flat, s.piece_off, pidx, pc,
                                     int(pc[-1]), HOST_THREADS)
        fields.append((pflat, pc[plo], pc[phi] - pc[plo], nz))
        fields.append((s.qual_chars[pidx], plo, cnt, nz))
        for fv in extras:
            tflat, tlen, sep = _extra_tokens(fv, s, pidx, header)
            # each token followed by the separator; a row drops its last
            k = len(sep)
            toff = np.zeros(pidx.size + 1, np.int64)
            np.cumsum(tlen + k, out=toff[1:])
            joined = np.empty(int(toff[-1]), np.uint8)
            src = np.zeros(pidx.size, np.int64)
            np.cumsum(tlen[:-1], out=src[1:])
            native.ragged_copy(joined, toff[:-1], tlen, tflat, src,
                               HOST_THREADS)
            if k:
                joined[toff[1:] - 1] = sep[0]
            fields.append((joined, toff[plo],
                           toff[phi] - toff[plo] - k * nz, nz))

    row_len = np.full(nrow, len(name_b) + 3 + 1, np.int64) + pos_nd
    for _, _, ln, nz in fields:
        row_len += 1 + (ln if nz is None else np.where(nz, ln, 1))
    row_off = np.zeros(nrow + 1, np.int64)
    np.cumsum(row_len, out=row_off[1:])
    buf = np.empty(int(row_off[-1]), np.uint8)
    cur = row_off[:-1].copy()
    if len(name_b):
        tgt = cur[:, None] + np.arange(len(name_b))[None, :]
        buf[tgt.reshape(-1)] = np.tile(name_b, nrow)
        cur += len(name_b)
    buf[cur] = 9
    cur += 1
    native.ragged_copy(buf, cur, pos_nd, pos_flat, pos_off[:-1],
                       HOST_THREADS)
    cur += pos_nd
    buf[cur] = 9
    buf[cur + 1] = refc
    cur += 2
    for flat, start, ln, nz in fields:
        buf[cur] = 9
        cur += 1
        if nz is None:
            native.ragged_copy(buf, cur, ln, flat, start, HOST_THREADS)
            cur += ln
            continue
        native.ragged_copy(buf, cur, np.where(nz, ln, 0), flat, start,
                           HOST_THREADS)
        buf[cur[~nz]] = ord("*")
        cur += np.where(nz, ln, 1)
    buf[cur] = 10
    return buf


def _append_file_column(row, s: FileState, pos: int, conf, header):
    """One file's columns of the row at ``pos``, per entry in Python (the
    writer for --output-extra aux tags)."""
    ci = s.pos2col.get(pos)
    if ci is None:
        row.append("\t0\t*\t*")
        row.extend("\t*" for _ in _extra_columns(conf))
        row.extend("\t*" for _ in conf["auxtags"])
        return
    lo, hi = s.p.col_off[ci], s.p.col_off[ci + 1]
    idx = np.arange(lo, hi)
    passing = idx[s.pass_q[lo:hi]]
    cnt = passing.size
    row.append("\t")
    row.append(str(cnt))
    row.append("\t")
    if cnt:
        row.append("".join(s.entry_bytes(i) for i in passing))
        row.append("\t")
        row.append(bytes(s.qual_chars[passing]).decode("latin-1"))
    else:
        row.append("*\t*")
    for fv in _extra_columns(conf):
        row.append("\t")
        vals = []
        for i in passing:
            rid = int(s.p.rid[i])
            if fv == COL_MAPQ_CHAR:
                vals.append(chr(min(int(s.sub.mapq[rid]) + 33, 126)))
            elif fv == COL_QPOS:
                vals.append(str(int(s.p.qpos[i]) + 1))
            elif fv == COL_QPOS5:
                if s.sub.flag[rid] & F.FREVERSE:
                    vals.append(str(int(s.sub.l_qseq[rid])
                                    - int(s.p.qpos[i])
                                    + int(s.p.is_del[i])))
                else:
                    vals.append(str(int(s.p.qpos[i]) + 1))
            elif fv == COL_QNAME:
                vals.append(s.sub.qname_str(rid))
            elif fv == COL_FLAG:
                vals.append(str(int(s.sub.flag[rid])))
            elif fv == COL_RNAME:
                t = int(s.sub.tid[rid])
                vals.append(header.ref_name(t) if t >= 0 else "*")
            elif fv == COL_POS:
                vals.append(str(int(s.sub.pos[rid]) + 1))
            elif fv == COL_MAPQ:
                vals.append(str(int(s.sub.mapq[rid])))
            elif fv == COL_RNEXT:
                t = int(s.sub.mtid[rid])
                vals.append(header.ref_name(t) if t >= 0 else "*")
            elif fv == COL_PNEXT:
                vals.append(str(int(s.sub.mpos[rid]) + 1))
            elif fv == COL_RLEN:
                vals.append(str(int(s.sub.l_qseq[rid])))
        if not vals:
            row.append("*")
        elif fv == COL_MAPQ_CHAR:
            row.append("".join(vals))
        else:
            row.append(",".join(vals))
    for tag in conf["auxtags"]:
        row.append("\t")
        vals = []
        for i in passing:
            got = auxmod.get_value(s.sub.aux_of(int(s.p.rid[i])), tag)
            if got is None:
                vals.append(conf["empty"])
                continue
            t, v = got
            if t in "ZHIiCcSsA":
                vals.append(str(v))
            elif t in "df":
                vals.append(_kputd(v))
            else:
                vals.append("*")
        row.append(conf["sep"].join(vals) if vals else "*")
