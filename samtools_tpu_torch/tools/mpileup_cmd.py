"""samtools mpileup on the port: one coordinate-sorted BAM, streamed in
windows of WINDOW_COLS columns, printed by the native text writer.

Counterpart of samtools_tpu/tools/mpileup_cmd.py's streamed single-BAM
path (``main_mpileup``, ``_run_pileup``'s native branch, the window
cursor, ``_prepare_sub`` and ``_DeviceBaqEngine``); its output is the JAX
tool's, byte for byte.  Per window: the mplp_func read filters, BAQ (on
the card through ``DeviceCensusPipeline``'s tool engine, K4 -> K5 -> K1's
census form, or with ``SAMTPU_DEVICE=0|host`` the host library's f64
HMM), the mapq/orphan filters, the depth cap, the overlap tweak, then the
text.

Options that need modules the port does not have yet exit 1 with one
line on stderr (``_not_ported``): -r, -b and several input files, SAM or
CRAM input, -O/--output-BP-5, -s, -M, --output-QNAME, --output-extra,
-C above 10, --checkpoint, SAMTPU_SHARDS and stored BQ/ZQ tags.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import torch

from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ReadBatch
from ..device import resolve
from ..io import bed as bedmod
from ..io import fasta as fastamod
from ..io import native
from ..io.bam import BamError
from ..io.bgzf import BgzfError
from ..io.stream import BamStream
from ..ops import baq as baqmod
from ..ops.mpileup_device import (HOST_THREADS, NT16_TO4,
                                  DeviceCensusPipeline, _host_census,
                                  census_checksum, stored_baq_tags)
from ..ops.overlaps import tweak_overlaps
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     n_shards, not_ported, print_error_errno)
from .flags_cmd import str2flag

DEFAULT_FF = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP

# streamed pileup window (columns per block)
WINDOW_COLS = 1 << 20

# options whose output needs the Python row renderer, the index or the
# checkpoint machinery of the JAX tool
_NOT_PORTED = {
    "-r": "-r/--region (index query)", "--region": "-r/--region (index query)",
    "-b": "-b/--bam-list (several input files)",
    "--bam-list": "-b/--bam-list (several input files)",
    "-O": "-O/--output-BP", "--output-BP": "-O/--output-BP",
    "--output-bp": "-O/--output-BP", "--output-BP-5": "--output-BP-5",
    "--output-bp-5": "--output-BP-5",
    "-s": "-s/--output-MQ", "--output-MQ": "-s/--output-MQ",
    "--output-mq": "-s/--output-MQ",
    "-M": "-M/--output-mods", "--output-mods": "-M/--output-mods",
    "--output-QNAME": "--output-QNAME", "--output-qname": "--output-QNAME",
    "--output-extra": "--output-extra", "--checkpoint": "--checkpoint",
}


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


def _not_ported(what: str) -> int:
    return not_ported("mpileup", what)


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
        ignore_rg=False, all=0, rev_del=0, no_ins=0, no_del=0, no_ends=0,
        rghash=None, census_out=None)
    bedidx = None
    fai = None
    out_fname = None
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
        if o in _NOT_PORTED:
            return _not_ported(_NOT_PORTED[o])
        if o in ("-x", "--ignore-overlaps-removal",
                 "--disable-overlap-removal"):
            conf["smart_overlaps"] = False
        elif o in ("--rf", "--incl-flags"):
            conf["rflag_require"] = str2flag(v)
        elif o in ("--ff", "--excl-flags"):
            conf["rflag_filter"] = str2flag(v)
        elif o == "--census-out":
            # per-window BAQ-stage census checksums (the engine's
            # validation artifact)
            conf["census_out"] = v
        elif o in ("-o", "--output"):
            out_fname = v
        elif o == "--reverse-del":
            conf["rev_del"] = 1
        elif o in ("--output-sep", "--output-empty", "--no-output-ins-mods"):
            pass   # they shape only the extra columns, not ported yet
        elif o == "--no-output-ins":
            conf["no_ins"] += 1
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
        elif o in ("-C", "--adjust-MQ", "--adjust-mq"):
            conf["capQ_thres"] = int(v)
        elif o in ("-q", "--min-MQ", "--min-mq"):
            conf["min_mq"] = int(v)
        elif o in ("-Q", "--min-BQ", "--min-bq"):
            conf["min_baseQ"] = int(v)
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
    if has_index_file:
        args = args[:len(args) // 2]
    if not args:
        sys.stderr.write("[mpileup] no input file/data given\n")
        return 1
    if conf["capQ_thres"] > 10:
        return _not_ported("-C above 10 (mapping-quality capping)")
    if len(args) > 1:
        return _not_ported("several input files")
    if n_shards() > 1:
        return _not_ported("SAMTPU_SHARDS (sharded runs)")
    path = args[0]
    if path == "-":
        return _not_ported("input from standard input")
    try:
        stream = BamStream(path, threads=ga.nthreads or HOST_THREADS)
    except OSError as e:
        sys.stderr.write(f"[mpileup] failed to open {path}: {e.strerror}\n")
        return 1
    except (BamError, BgzfError):
        return _not_ported("SAM or CRAM input")
    with stream:
        header = stream.header
        sys.stderr.write(f"[mpileup] {_count_samples(header, conf)} "
                         "samples in 1 input files\n")
        engine = None
        if (conf["realn"] and fai is not None
                and os.environ.get("SAMTPU_DEVICE") not in ("0", "host")):
            try:
                engine = _DeviceBaqEngine(conf, device)
            except RuntimeError as e:     # no CUDA card
                sys.stderr.write(f"[mpileup] {e} (SAMTPU_DEVICE=0 runs BAQ "
                                 "on the host)\n")
                return 1
        out = open(out_fname, "w") if out_fname else sys.stdout
        try:
            return _run_pileup(stream, header, conf, bedidx, fai, engine,
                               out)
        except NotImplementedError as e:
            sys.stderr.write(f"[mpileup] {e}\n")
            return 1
        finally:
            if out is not sys.stdout:
                out.close()


def _count_samples(header, conf) -> int:
    """bam_smpl_add: one sample per distinct SM (the RG ID where SM is
    missing; the file name with no RG or with -R)."""
    if conf["ignore_rg"]:
        return 1
    rgs = header.rg_to_sample()
    return len(set(rgs.values())) if rgs else 1


def _empty_row(name: str, pos: int, ref: bytes | None, ref_len: int) -> str:
    refc = chr(ref[pos]) if (ref is not None and pos < ref_len) else "N"
    return f"{name}\t{pos + 1}\t{refc}\t0\t*\t*\n"


class _Refs:
    """Contig sequences from the FASTA, as the tool reads them: the last
    few contigs' bytes, and the current contig's 0-4 codes."""

    def __init__(self, fai, header):
        self.fai = fai
        self.header = header
        self.cache = {}
        self._ints = (None, None)

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


def _run_pileup(stream, header, conf, bedidx, fai, engine, out) -> int:
    refs = _Refs(fai, header)
    last_tid = last_pos = -1
    one_seq = False
    w = out.write
    cap_state = types.SimpleNamespace(carry=None)

    for tid, wb, we, sub in _stream_windows(stream, conf, bedidx, header):
        name = header.ref_names[tid]
        sub, ref, ref_len = _prepare_sub(sub, conf, tid, refs, cap_state,
                                         wb, we, engine)
        if sub.n == 0:
            continue
        e_end = min(we, int(sub.end_pos().max()))
        first_cov = max(int(sub.pos.min()), wb)
        if first_cov >= e_end:
            continue
        one_seq = True
        # -a: the empty rows of the contigs before this one
        if conf["all"]:
            while tid > last_tid:
                if last_tid >= 0:
                    r, rl = refs.get(last_tid)
                    lname = header.ref_names[last_tid]
                    for pp in range(last_pos + 1, header.ref_lens[last_tid]):
                        if bedidx is not None and not bedidx.overlap_one(
                                lname, pp, pp + 1):
                            continue
                        w(_empty_row(lname, pp, r, rl))
                last_tid += 1
                last_pos = -1
                if conf["all"] < 2:
                    break
        last_tid = tid
        if conf["all"]:
            e_beg = min(max(last_pos + 1, 0), first_cov)
            last_pos = e_end - 1
        else:
            e_beg = first_cov
        mask = None
        if bedidx is not None:
            rng = np.arange(e_beg, e_end, dtype=np.int64)
            mask = bedidx.overlap(name, rng, rng + 1)
        text = native.mpileup_text(
            sub, ref, name, e_beg, e_end, conf["all"] > 0, mask,
            conf["min_baseQ"], conf["rev_del"], conf["no_ends"],
            conf["no_ins"], conf["no_del"])
        if text:
            outb = getattr(out, "buffer", None)
            if outb is not None:
                # the -a rows above went through the text layer: flush
                # them before these bytes
                out.flush()
                outb.write(text)
            else:
                out.write(text.decode("latin-1"))

    if engine is not None and conf["census_out"]:
        engine.write_census(conf["census_out"], header)

    # -a: the empty rows after the last covered column
    if conf["all"]:
        if last_tid < 0 and not one_seq and conf["all"] > 1:
            last_tid = 0
        while 0 <= last_tid < header.n_refs:
            r, rl = refs.get(last_tid)
            lname = header.ref_names[last_tid]
            for pp in range(last_pos + 1, header.ref_lens[last_tid]):
                if bedidx is not None and not bedidx.overlap_one(
                        lname, pp, pp + 1):
                    continue
                w(_empty_row(lname, pp, r, rl))
            last_tid += 1
            last_pos = -1
            if conf["all"] < 2:
                break
    return 0


class _WindowCursor:
    """Read cursor of the streamed windows.

    Pulls decoded batches on demand, applies the mplp_func record filter,
    and hands out each window's overlap set: the reads with pos < window
    end whose footprint can still touch the window, carried halo reads
    included (samtools re-queries its index with overlap; a sequential
    stream carries the boundary reads instead)."""

    def __init__(self, stream, conf, bedidx, header):
        self.gen = stream.batches()
        self.conf = conf
        self.bedidx = bedidx
        self.header = header
        self.pending: list = []       # filtered batches not yet consumed
        self.carry = None             # (halo ReadBatch, tid)
        self.done = False

    def _pull(self) -> bool:
        if self.done:
            return False
        nb = next(self.gen, None)
        if nb is None:
            self.done = True
            return False
        keep = _read_filter(nb, self.conf, self.bedidx, self.header)
        if keep.all():
            self.pending.append(nb)
        elif keep.any():
            self.pending.append(nb.take(np.nonzero(keep)[0]))
        return True

    def front(self):
        """(tid, pos) of the next unconsumed read, or None at the end."""
        while not self.pending:
            if not self._pull():
                return None
        b = self.pending[0]
        return int(b.tid[0]), int(b.pos[0])

    def window(self, tid: int, wb: int, we: int) -> ReadBatch:
        """The overlap set of [wb, we) on tid: consumes the reads with
        pos < we and carries those that end past we into the next
        window.  Every read of the result is a copy its caller owns."""
        parts = []
        if self.carry is not None:
            cb, ctid = self.carry
            if ctid == tid:
                parts.append(cb.take(np.nonzero(cb.end_pos() > wb)[0]))
            self.carry = None
        while True:
            fr = self.front()
            if fr is None or fr[0] > tid or (fr[0] == tid and fr[1] >= we):
                break
            b = self.pending.pop(0)
            m = (b.tid == tid) & (b.pos < we)
            if m.all():
                parts.append(b)
                continue
            parts.append(b.take(np.nonzero(m)[0]))
            self.pending.insert(0, b.take(np.nonzero(~m)[0]))
            break
        sub = (ReadBatch.concat(parts) if len(parts) > 1 else
               parts[0] if parts else ReadBatch())
        if sub.n:
            hal = np.nonzero(sub.end_pos() > we)[0]
            if hal.size:
                self.carry = (sub.take(hal), tid)
        return sub

    def has_more_on(self, tid: int) -> bool:
        if self.carry is not None and self.carry[1] == tid:
            return True
        fr = self.front()
        return fr is not None and fr[0] == tid


def _stream_windows(stream, conf, bedidx, header):
    """(tid, wb, we, reads) blocks of WINDOW_COLS columns in genomic
    order, with bounded memory."""
    cur = _WindowCursor(stream, conf, bedidx, header)
    while True:
        fr = cur.front()
        if fr is None:
            return
        tid, wb = fr
        while True:
            we = wb + WINDOW_COLS
            yield tid, wb, we, cur.window(tid, wb, we)
            if not cur.has_more_on(tid):
                break
            wb = we


def _prepare_sub(sub, conf, tid, refs, cap_state, wb, we, engine=None):
    """mplp_func's per-read transforms and filters for one window's reads:
    Illumina quals, BAQ, the min-mapQ/orphan filters, the depth cap, the
    overlap tweak.  Returns (sub, ref, ref_len).

    With ``engine`` BAQ runs after the mapq/orphan/depth-cap filters:
    the same output (those filters read no base qual, BAQ touches no
    mapq), BAQ skips the dropped reads, and the engine's census counts
    exactly the filtered reads."""
    if conf["illumina13"]:
        q = sub.qual.astype(np.int64)
        sub.qual = np.where(q > 31, q - 31, 0).astype(np.uint8)
    ref, ref_len = refs.get(tid)
    if engine is None and ref is not None and conf["realn"]:
        baqmod.apply_baq_batch(sub, refs.ints(tid))
    # the min-mapQ and orphan filters come after BAQ (mplp_func's order)
    keep = sub.mapq.astype(np.int64) >= conf["min_mq"]
    if conf["no_orphan"]:
        fl = sub.flag.astype(np.int64)
        keep &= ~(((fl & F.FPAIRED) != 0) & ((fl & F.FPROPER_PAIR) == 0))
    if not keep.all():
        sub = sub.take(np.nonzero(keep)[0])
    if conf["max_depth"]:
        # a read's cap decision is made once, in its first window, and
        # carried: it may depend on reads that ended before this window
        prev = None
        c = cap_state.carry
        if c is not None and c[0] == tid and c[1] == wb:
            prev = c[2]
        keepm, nxt = _depth_cap_stream(sub, conf["max_depth"], wb, we, prev)
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
    ``risky_reads``: those the f32 HMM sent to the host).  A
    window with no reference, stored BQ/ZQ tags, reads shorter than 8
    bases or a contig past 64 Mi bases takes the host HMM whole, with the
    same census recorded from its final quals."""

    def __init__(self, conf, device=None):
        self.device = resolve(device)
        self.min_baseq = conf["min_baseQ"]
        self.baq_flag = 7 if conf["redo_baq"] else 3
        self.want_census = bool(conf["census_out"])
        self.records: list = []
        self.n_reads = 0
        self.n_host = 0
        self.n_device_windows = 0
        self._ref_dev = (None, None)   # (tid, contig codes on the device)

    def _contig_on_device(self, tid: int, ref_int: np.ndarray):
        if self._ref_dev[0] != tid:
            self._ref_dev = (tid, torch.from_numpy(ref_int).to(self.device))
        return self._ref_dev[1]

    def run_window(self, sub, tid, refs, wb, we):
        """BAQ one prepared window in place and record its census."""
        if sub.n == 0:
            return
        ref_len = refs.get(tid)[1]
        # the census window ends at the contig's end
        we = min(we, max(ref_len, wb + 1))
        wb = min(wb, we)
        ref_int = refs.ints(tid)
        lens = sub.seq_off[1:] - sub.seq_off[:-1]
        lq = int(np.bincount(np.minimum(lens, 1 << 14)).argmax())
        if lq >= 8 and ref_len <= (64 << 20) and not stored_baq_tags(sub):
            pipe = DeviceCensusPipeline(
                ref_int, wlen=we - wb, base=wb, min_baseq=self.min_baseq,
                baq_flag=self.baq_flag, l_query=lq, device=self.device,
                ref_dev=self._contig_on_device(tid, ref_int))
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
        baqmod.apply_baq_batch(sub, ref_int)
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
