"""samtools calmd (and fillmd): recompute the MD and NM tags against the
reference.

Counterpart of samtools_tpu/tools/calmd_cmd.py (samtools' bam_md.c,
bam_fillmd1_core :64-224): the MD string, NM (mismatches, insertions and
deletions), ``-e``'s '=' bases, ``-n``'s masking above an NM, ``-d``'s
tag drop, ``-q``'s quality bins, ``-r``'s BAQ (``-A``, ``-E``) and
``-C``'s MAPQ cap.  Each run of records on one contig takes the
vectorised ``fillmd_batch`` (the host library's ``aux_find_batch`` finds
the old tags); ``SAMTPU_CALMD_SCALAR=1`` takes the per-record
``fillmd_one``.  ``-r`` and ``-C`` run the f64 HMM one read at a time on
the host (``ops/baq.sam_prob_realn_single``, ``_cap_mapq_single``), as the
JAX package does.  A host command: no device work.
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..io import fasta as fastamod
from ..io import native
from ..io.files import StreamingWriter, read_alignments, write_alignments
from ..io.sam_text import NT16_LUT
from ..io.stream import BamStream
from ..ops import baq as baqmod
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)

USE_EQUAL = 1
DROP_TAG = 2
BIN_QUAL = 4
UPDATE_NM = 8
UPDATE_MD = 16

NT16_TABLE = np.full(256, 15, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    NT16_TABLE[ord(_c)] = _i
    NT16_TABLE[ord(_c.lower())] = _i
NT16_TABLE[ord("u")] = 8
NT16_TABLE[ord("U")] = 8


def usage(fp):
    fp.write(
        "Usage: samtools calmd [-eubrAESQ] <aln.bam> <ref.fasta>\n"
        "Options:\n"
        "  -e       change identical bases to '='\n"
        "  -u       uncompressed BAM output (for piping)\n"
        "  -b       compressed BAM output\n"
        "  -S       ignored (input format is auto-detected)\n"
        "  -A       modify the quality string\n"
        "  -Q       use quiet mode to output less debug info to stdout\n"
        "  -r       compute the BQ tag (without -A) or cap baseQ by BAQ "
        "(with -A)\n"
        "  -E       extended BAQ for better sensitivity but lower "
        "specificity\n"
        "  --no-PG  do not add a PG line\n")


def fillmd_one(b, i, ref: bytes, ref_len: int, flag: int, max_nm: int,
               quiet: bool, ref_name: str, aux_out: list) -> int:
    """Returns NM; mutates seq/qual in place; appends new aux to
    aux_out[i]."""
    seq = b.seq[b.seq_off[i]:b.seq_off[i + 1]]
    qual = b.qual[b.seq_off[i]:b.seq_off[i + 1]]
    cig = b.cigar_of(i)
    lq = seq.size
    if lq == 0:
        if not quiet:
            sys.stderr.write(
                "[bam_fillmd1] no sequence in alignment record for '%s' "
                "at %s:%d, skipped\n"
                % (b.qname_str(i), ref_name, int(b.pos[i]) + 1))
        return -2
    md = []
    matched = 0
    nm = 0
    qpos = 0
    rpos = int(b.pos[i])
    mismatch_sites = []
    out_of_bounds = False
    for c in cig:
        op = int(c) & 0xF
        oplen = int(c) >> 4
        if op in (F.CMATCH, F.CEQUAL, F.CDIFF):
            j = 0
            while j < oplen:
                z = qpos + j
                if rpos + j >= ref_len or z >= lq or ref[rpos + j] == 0:
                    out_of_bounds = True
                    break
                c1 = int(seq[z])
                c2 = int(NT16_TABLE[ref[rpos + j]])
                if (c1 == c2 and c1 != 15 and c2 != 15) or c1 == 0:
                    if flag & USE_EQUAL:
                        seq[z] = 0
                    matched += 1
                    mismatch_sites.append((z, True))
                else:
                    md.append(str(matched))
                    md.append(chr(ref[rpos + j]).upper())
                    matched = 0
                    nm += 1
                    mismatch_sites.append((z, False))
                j += 1
            if out_of_bounds:
                break
            rpos += oplen
            qpos += oplen
        elif op == F.CDEL:
            md.append(str(matched))
            md.append("^")
            j = 0
            while j < oplen:
                if rpos + j >= ref_len or ref[rpos + j] == 0:
                    break
                md.append(chr(ref[rpos + j]).upper())
                j += 1
            matched = 0
            rpos += j
            nm += j
            if j < oplen:
                break
        elif op in (F.CINS, F.CSOFT_CLIP):
            qpos += oplen
            if op == F.CINS:
                nm += oplen
        elif op == F.CREF_SKIP:
            rpos += oplen
    md.append(str(matched))
    md_str = "".join(md)

    if max_nm > 0 and nm >= max_nm:
        # mask matches back to ref base (uppercase=15? htslib sets code 15)
        for z, is_match in mismatch_sites:
            if is_match:
                seq[z] = 15
                qual[z] = 0

    a = aux_out[i]
    fl = int(b.flag[i])
    if (flag & UPDATE_NM) and not (fl & F.FUNMAP):
        got = auxmod.get_value(a, "NM")
        if got is None:
            a = np.concatenate([a, np.frombuffer(
                b"NMi" + struct.pack("<i", nm), np.uint8)])
        elif got[1] != nm:
            if not quiet:
                sys.stderr.write(
                    "[bam_fillmd1] different NM for read '%s': %d -> %d\n"
                    % (b.qname_str(i), got[1], nm))
            a = auxmod.delete_tags(a, {"NM"})
            a = np.concatenate([a, np.frombuffer(
                b"NMi" + struct.pack("<i", nm), np.uint8)])
    if (flag & UPDATE_MD) and not (fl & F.FUNMAP):
        got = auxmod.get_value(a, "MD")
        if got is None:
            a = np.concatenate([a, np.frombuffer(
                b"MDZ" + md_str.encode("latin-1") + b"\0", np.uint8)])
        elif str(got[1]).upper() != md_str.upper():
            if not quiet:
                sys.stderr.write(
                    "[bam_fillmd1] different MD for read '%s': '%s' -> "
                    "'%s'\n" % (b.qname_str(i), got[1], md_str))
            a = auxmod.delete_tags(a, {"MD"})
            a = np.concatenate([a, np.frombuffer(
                b"MDZ" + md_str.encode("latin-1") + b"\0", np.uint8)])
    if flag & DROP_TAG:
        a = auxmod.keep_tags(a, {"RG"})
    if flag & BIN_QUAL:
        q = qual.astype(np.int64)
        qual[:] = np.where(q >= 3, q // 10 * 10 + 7, q).astype(np.uint8)
    aux_out[i] = a
    return 0


def fillmd_batch(b, run, ref: bytes, ref_len: int, flag: int,
                 max_nm: int, quiet: bool, ref_name: str,
                 aux_out: list, aux_native_ok: bool) -> int:
    """Vectorized bam_fillmd1_core over one same-tid run of records.

    The per-base CIGAR walk of fillmd_one becomes flat segment arrays
    over the run's M/=/X bases (one ref gather + compare for the whole
    run); per-read work shrinks to the MD event list (mismatches +
    deletions, ~1% of bases).  Reads overhanging the contig end (the
    truncation paths) fall back to the scalar oracle; messages keep
    record order.  Returns the skip count."""
    n = run.size
    if n == 0:
        return 0
    lq = (b.seq_off[run + 1] - b.seq_off[run]).astype(np.int64)
    # flat cigar ops of the run
    clens = (b.cigar_off[run + 1] - b.cigar_off[run]).astype(np.int64)
    ccum = np.concatenate([[0], np.cumsum(clens)])
    cseg = np.repeat(np.arange(n, dtype=np.int64), clens)
    fi = b.cigar_off[run].astype(np.int64)[cseg] + (
        np.arange(int(ccum[-1]), dtype=np.int64) - ccum[cseg])
    ops = (b.cigar[fi] & 0xF).astype(np.int64)
    lens = (b.cigar[fi] >> 4).astype(np.int64)
    matchy = (ops == F.CMATCH) | (ops == F.CEQUAL) | (ops == F.CDIFF)
    refadv = np.where(matchy | (ops == F.CDEL) | (ops == F.CREF_SKIP),
                      lens, 0)
    qadv = np.where(matchy | (ops == F.CINS) | (ops == F.CSOFT_CLIP),
                    lens, 0)

    def prefix(adv):
        cs = np.cumsum(adv)
        return cs - adv - np.concatenate([[0], cs[ccum[1:-1] - 1]])[cseg]

    ref_off = prefix(refadv)
    q_off = prefix(qadv)
    refspan = _segsum(refadv, ccum)
    pos_r = b.pos[run].astype(np.int64)

    eligible = (lq > 0) & (pos_r + refspan <= ref_len)
    ok_op = eligible[cseg]

    ref_arr = np.frombuffer(ref, np.uint8)
    nm_vec = np.zeros(n, np.int64)
    md_strs: dict[int, str] = {}
    el = np.flatnonzero(eligible)
    if el.size:
        # per-base expansion of M/=/X ops of eligible reads
        mids = np.flatnonzero(matchy & ok_op & (lens > 0))
        mlens = lens[mids]
        bcum = np.concatenate([[0], np.cumsum(mlens)])
        total = int(bcum[-1])
        bseg = np.repeat(np.arange(mids.size, dtype=np.int64), mlens)
        blocal = np.arange(total, dtype=np.int64) - bcum[bseg]
        oseg = cseg[mids][bseg]                 # run-row of each base
        abs_ref = pos_r[oseg] + ref_off[mids][bseg] + blocal
        qidx = b.seq_off[run].astype(np.int64)[oseg] \
            + q_off[mids][bseg] + blocal
        c1 = b.seq[qidx].astype(np.int64)
        c2 = NT16_TABLE[ref_arr[abs_ref]].astype(np.int64)
        is_match = ((c1 == c2) & (c1 != 15)) | (c1 == 0)
        if flag & USE_EQUAL:
            b.seq[qidx[is_match]] = 0
        # NM: M mismatches + full INS/DEL lengths
        mm = ~is_match
        np.add.at(nm_vec, oseg[mm], 1)
        indel = (ops == F.CINS) | (ops == F.CDEL)
        np.add.at(nm_vec, cseg[indel & ok_op],
                  lens[indel & ok_op])
        if max_nm > 0:
            over = nm_vec >= max_nm
            sel_m = is_match & over[oseg]
            b.seq[qidx[sel_m]] = 15
            b.qual[qidx[sel_m]] = 0

        # ---- MD strings from the event lists --------------------------
        # per-read count of M bases before each op
        m_pref = prefix(np.where(matchy, lens, 0))
        mb_ord = m_pref[mids][bseg] + blocal
        mm_idx = np.flatnonzero(mm)
        mm_read = oseg[mm_idx]
        mm_ord = mb_ord[mm_idx]
        mm_ref = ref_arr[abs_ref[mm_idx]]
        # deletions as events at their op position
        dmask = (ops == F.CDEL) & ok_op & (lens > 0)
        didx = np.flatnonzero(dmask)
        d_read = cseg[didx]
        d_ord = m_pref[didx]
        d_beg = pos_r[d_read] + ref_off[didx]
        d_len = lens[didx]
        # group events per read (dels sort before a tied mismatch, op
        # order kept by the stable sort)
        ev_mm: dict[int, list] = {}
        for k in range(mm_idx.size):
            ev_mm.setdefault(int(mm_read[k]), []).append(
                (int(mm_ord[k]), 0, chr(mm_ref[k]).upper()))
        for k in range(didx.size):
            txt = ref[int(d_beg[k]): int(d_beg[k] + d_len[k])] \
                .decode("latin-1").upper()
            ev_mm.setdefault(int(d_read[k]), []).append(
                (int(d_ord[k]), 1, "^" + txt))
        m_total = _segsum(np.where(matchy, lens, 0), ccum)
        for r in el:
            r = int(r)
            evs = ev_mm.get(r)
            if not evs:
                md_strs[r] = str(int(m_total[r]))
                continue
            evs.sort(key=lambda e: (e[0], 0 if e[1] else 1))
            out = []
            consumed = 0
            for ordn, is_del, txt in evs:
                out.append(str(ordn - consumed))
                out.append(txt)
                consumed = ordn + (0 if is_del else 1)
            out.append(str(int(m_total[r]) - consumed))
            md_strs[r] = "".join(out)

    # aux tag offsets via one native scan when aux_out is untouched
    nm_off = md_off = None
    if aux_native_ok and native.has_stats_native():
        nm_off, nm_t = native.aux_find_batch(b.aux, b.aux_off, run, "NM")
        md_off, md_t = native.aux_find_batch(b.aux, b.aux_off, run, "MD")

    skip = 0
    fl_unmap = (b.flag[run].astype(np.int64) & F.FUNMAP) != 0
    if (flag & BIN_QUAL) and el.size:
        # vectorized qual binning for the whole eligible set (fallback
        # reads get it inside fillmd_one)
        fi2, seg2, _l2, _n2, _c2 = _flat_q(b, run[el])
        q = b.qual[fi2].astype(np.int64)
        b.qual[fi2] = np.where(q >= 3, q // 10 * 10 + 7, q).astype(
            np.uint8)

    if nm_off is not None:
        old_nm = np.full(n, -1, np.int64)
        int_t = np.isin(nm_t, list(_AUX_INT_TYPES))
        got_i = (nm_off >= 0) & int_t
        if got_i.any():
            old_nm[got_i] = _decode_int_aux_arr(b.aux, nm_off[got_i],
                                                nm_t[got_i])
        nm_have = (nm_off >= 0)
        weird_nm = nm_have & ~int_t
        md_have = md_off >= 0
        md_isz = md_have & (md_t == ord("Z"))
        # records needing ANY aux/emit work in the lean loop
        upd_nm_mask = np.zeros(n, bool)
        upd_md_mask = np.zeros(n, bool)
        if flag & UPDATE_NM:
            upd_nm_mask = eligible & ~fl_unmap & (
                ~nm_have | weird_nm | (old_nm != nm_vec))
        if flag & UPDATE_MD:
            upd_md_mask = eligible & ~fl_unmap & md_have  # compare below
            upd_md_append = eligible & ~fl_unmap & ~md_have
        else:
            upd_md_append = np.zeros(n, bool)
        need = (upd_nm_mask | upd_md_mask | upd_md_append
                | ~eligible | (lq == 0))
        if flag & DROP_TAG:
            need |= eligible
        kl = np.flatnonzero(need).tolist()
        nm_off_l = nm_off.tolist()
        md_off_l = md_off.tolist()
        md_isz_l = md_isz.tolist()
        lq_l = lq.tolist()
        elig_l = eligible.tolist()
        nm_l = nm_vec.tolist()
        old_nm_l = old_nm.tolist()
        nm_have_l = nm_have.tolist()
        weird_l = weird_nm.tolist()
        upd_nm_l = upd_nm_mask.tolist()
        upd_mda_l = upd_md_append.tolist()
        upd_mdc_l = upd_md_mask.tolist()
        aux_mem = b.aux.tobytes() if kl else b""
        for k in kl:
            i = int(run[k])
            if lq_l[k] == 0:
                if not quiet:
                    sys.stderr.write(
                        "[bam_fillmd1] no sequence in alignment record "
                        "for '%s' at %s:%d, skipped\n"
                        % (b.qname_str(i), ref_name, int(b.pos[i]) + 1))
                skip += 1
                continue
            if not elig_l[k]:
                r = fillmd_one(b, i, ref, ref_len, flag, max_nm, quiet,
                               ref_name, aux_out)
                if r == -2:
                    skip += 1
                continue
            a = aux_out[i]
            suffix = b""
            nm = nm_l[k]
            md_str = md_strs[k]
            if upd_nm_l[k]:
                if weird_l[k]:
                    got = auxmod.get_value(a, "NM")
                    old = int(got[1])
                    if old != nm:
                        if not quiet:
                            sys.stderr.write(
                                "[bam_fillmd1] different NM for read "
                                "'%s': %d -> %d\n"
                                % (b.qname_str(i), old, nm))
                        a = auxmod.delete_tags(a, {"NM"})
                        suffix += b"NMi" + struct.pack("<i", nm)
                elif not nm_have_l[k]:
                    suffix += b"NMi" + struct.pack("<i", nm)
                else:
                    if not quiet:
                        sys.stderr.write(
                            "[bam_fillmd1] different NM for read '%s': "
                            "%d -> %d\n"
                            % (b.qname_str(i), old_nm_l[k], nm))
                    a = auxmod.delete_tags(a, {"NM"})
                    suffix += b"NMi" + struct.pack("<i", nm)
            if upd_mda_l[k]:
                suffix += b"MDZ" + md_str.encode("latin-1") + b"\0"
            elif upd_mdc_l[k]:
                if md_isz_l[k]:
                    o = md_off_l[k]
                    e = aux_mem.index(b"\0", o)
                    old_md = aux_mem[o:e].decode("latin-1")
                else:
                    got = auxmod.get_value(a, "MD")
                    old_md = str(got[1])
                if old_md.upper() != md_str.upper():
                    if not quiet:
                        sys.stderr.write(
                            "[bam_fillmd1] different MD for read '%s': "
                            "'%s' -> '%s'\n"
                            % (b.qname_str(i), old_md, md_str))
                    a = auxmod.delete_tags(a, {"MD"})
                    suffix += b"MDZ" + md_str.encode("latin-1") + b"\0"
            if suffix:
                a = np.concatenate([np.asarray(a, np.uint8),
                                    np.frombuffer(suffix, np.uint8)])
            if flag & DROP_TAG:
                a = auxmod.keep_tags(a, {"RG"})
            aux_out[i] = a
        return skip

    # aux_out already diverged (BAQ path): per-record oracle semantics
    for k in range(n):
        i = int(run[k])
        if lq[k] == 0:
            if not quiet:
                sys.stderr.write(
                    "[bam_fillmd1] no sequence in alignment record for "
                    "'%s' at %s:%d, skipped\n"
                    % (b.qname_str(i), ref_name, int(b.pos[i]) + 1))
            skip += 1
            continue
        if not eligible[k]:
            r = fillmd_one(b, i, ref, ref_len, flag, max_nm, quiet,
                           ref_name, aux_out)
            if r == -2:
                skip += 1
            continue
        fl = int(b.flag[i])
        a = aux_out[i]
        nm = int(nm_vec[k])
        md_str = md_strs[k]
        if (flag & UPDATE_NM) and not (fl & F.FUNMAP):
            got = auxmod.get_value(a, "NM")
            if got is None:
                a = np.concatenate([a, np.frombuffer(
                    b"NMi" + struct.pack("<i", nm), np.uint8)])
            elif int(got[1]) != nm:
                if not quiet:
                    sys.stderr.write(
                        "[bam_fillmd1] different NM for read '%s': "
                        "%d -> %d\n" % (b.qname_str(i), int(got[1]), nm))
                a = auxmod.delete_tags(a, {"NM"})
                a = np.concatenate([a, np.frombuffer(
                    b"NMi" + struct.pack("<i", nm), np.uint8)])
        if (flag & UPDATE_MD) and not (fl & F.FUNMAP):
            got = auxmod.get_value(a, "MD")
            if got is None:
                a = np.concatenate([a, np.frombuffer(
                    b"MDZ" + md_str.encode("latin-1") + b"\0",
                    np.uint8)])
            elif str(got[1]).upper() != md_str.upper():
                if not quiet:
                    sys.stderr.write(
                        "[bam_fillmd1] different MD for read '%s': "
                        "'%s' -> '%s'\n"
                        % (b.qname_str(i), str(got[1]), md_str))
                a = auxmod.delete_tags(a, {"MD"})
                a = np.concatenate([a, np.frombuffer(
                    b"MDZ" + md_str.encode("latin-1") + b"\0",
                    np.uint8)])
        if flag & DROP_TAG:
            a = auxmod.keep_tags(a, {"RG"})
        if flag & BIN_QUAL:
            qv = b.qual[b.seq_off[i]:b.seq_off[i + 1]]
            q = qv.astype(np.int64)
            qv[:] = np.where(q >= 3, q // 10 * 10 + 7, q).astype(np.uint8)
        aux_out[i] = a
    return skip


_AUX_INT_TYPES = frozenset(ord(c) for c in "cCsSiI")


def _flat_q(b, idx):
    lens = (b.seq_off[idx + 1] - b.seq_off[idx]).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    seg = np.repeat(np.arange(idx.size, dtype=np.int64), lens)
    local = np.arange(int(cum[-1]), dtype=np.int64) - cum[seg]
    fi = b.seq_off[idx].astype(np.int64)[seg] + local
    return fi, seg, local, lens, cum


def _decode_int_aux_arr(aux, offs, types):
    out = np.zeros(offs.size, np.int64)
    a = aux.astype(np.int64)
    for tc, width, signed in (("c", 1, True), ("C", 1, False),
                              ("s", 2, True), ("S", 2, False),
                              ("i", 4, True), ("I", 4, False)):
        m = types == ord(tc)
        if not m.any():
            continue
        o = offs[m]
        v = np.zeros(o.size, np.int64)
        for bb in range(width):
            v |= a[o + bb] << (8 * bb)
        if signed:
            bits = 8 * width
            v = np.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
        out[m] = v
    return out


def _segsum(values: np.ndarray, cum: np.ndarray) -> np.ndarray:
    tot = np.concatenate([[0], np.cumsum(values.astype(np.int64))])
    return tot[cum[1:]] - tot[cum[:-1]]


def main_calmd(argv: list[str]) -> int:
    ga = GlobalArgs()
    flt_flag = UPDATE_NM | UPDATE_MD
    is_bam_out = False
    level = 6
    is_realn = False
    max_nm = 0
    capq = 0
    baq_flag = 0
    quiet = False
    no_pg = False
    try:
        opts, args = gnu_getopt(argv, "EqQreuNhbSC:n:Ad@:",
                                ["no-PG"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-r":
            is_realn = True
        elif o == "-e":
            flt_flag |= USE_EQUAL
        elif o == "-d":
            flt_flag |= DROP_TAG
        elif o == "-q":
            flt_flag |= BIN_QUAL
        elif o == "-N":
            flt_flag &= ~(UPDATE_MD | UPDATE_NM)
        elif o == "-b":
            is_bam_out = True
        elif o == "-u":
            level = 0
            is_bam_out = True
        elif o == "-S":
            pass
        elif o == "-n":
            max_nm = int(v)
        elif o == "-C":
            capq = int(v)
        elif o == "-A":
            baq_flag |= 1
        elif o == "-E":
            baq_flag |= 2
        elif o == "-Q":
            quiet = True
        elif o == "-h":
            pass  # HASH_QNM legacy, ignored
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v, short_outfmt=None):
            pass
        else:
            usage(sys.stderr)
            return 1
    if not args or (len(args) < 2 and not ga.reference):
        usage(sys.stderr)
        return 1
    fn_in = args[0]
    ref_file = args[1] if len(args) > 1 else ga.reference

    try:
        fai = fastamod.load_fasta(ref_file)
    except OSError as e:
        print_error_errno("calmd",
                          "Failed to open reference file '%s'", ref_file,
                          exc=e)
        return 1
    stream = None
    if fn_in != "-":
        try:
            stream = BamStream(fn_in, threads=ga.nthreads or 2)
            header = stream.header
        except OSError as e:
            print_error_errno("calmd", "Failed to open input file '%s'",
                              fn_in, exc=e)
            return 1
        except RuntimeError:    # not a BGZF BAM: read whole
            stream = None
    if stream is None:
        try:
            f = read_alignments(fn_in, threads=ga.nthreads)
        except OSError as e:
            print_error_errno("calmd", "Failed to open input file '%s'",
                              fn_in, exc=e)
            return 1
        header = f.header

    skipped = 0
    ref_cache: dict = {}
    missing: set = set()

    def process(b) -> int | None:
        """BAQ/capQ/MD-fill one decoded batch in place; returns skipped
        count or None on a fatal missing-reference error."""
        nonlocal ref_cache
        aux_out = [b.aux_of(i) for i in range(b.n)]
        skip = 0
        batch_tids = {int(t) for t in np.unique(b.tid[b.tid >= 0])}
        if len(ref_cache) > 4:
            # drop contigs this batch doesn't touch (ref LRU analog,
            # bam_md.c:54 keeps a small cache)
            ref_cache = {t: s for t, s in ref_cache.items()
                         if t in batch_tids}
        for t in sorted(batch_tids):
            if t in ref_cache or t in missing:
                continue
            name = header.ref_name(t)
            if fai.has(name):
                ref_cache[t] = fai.fetch(name)
            else:
                sys.stderr.write("[bam_fillmd] fail to find sequence "
                                 "'%s' in the reference.\n" % name)
                if is_realn or capq > 10:
                    return None
                missing.add(t)
        if is_realn or capq > 10:
            for t, seq in ref_cache.items():
                sel = np.nonzero(b.tid == t)[0]
                ref_int = baqmod.NT16_INT[
                    NT16_LUT[np.frombuffer(seq, np.uint8)]]
                for i in sel:
                    i = int(i)
                    qual = b.qual[b.seq_off[i]:b.seq_off[i + 1]]
                    if is_realn:
                        got = baqmod.sam_prob_realn_single(
                            int(b.pos[i]), b.cigar_of(i), b.seq_of(i),
                            qual, aux_out[i], ref_int, len(seq),
                            baq_flag)
                        if got is not None:
                            newq, new_aux = got
                            b.qual[b.seq_off[i]:b.seq_off[i + 1]] = newq
                            aux_out[i] = np.asarray(new_aux, np.uint8)
                    if capq > 10:
                        q = baqmod._cap_mapq_single(
                            int(b.pos[i]), b.cigar_of(i), b.seq_of(i),
                            b.qual[b.seq_off[i]:b.seq_off[i + 1]],
                            ref_int, len(seq), capq)
                        if b.mapq[i] > q:
                            b.mapq[i] = max(q, 0)
        scalar = os.environ.get("SAMTPU_CALMD_SCALAR") == "1"
        # contiguous same-tid runs keep per-record stderr order exact
        i = 0
        while i < b.n:
            t = int(b.tid[i])
            j = i
            while j < b.n and int(b.tid[j]) == t:
                j += 1
            if t >= 0 and t in ref_cache:
                ref = ref_cache[t]
                if scalar:
                    for k in range(i, j):
                        r = fillmd_one(b, k, ref, len(ref), flt_flag,
                                       max_nm, quiet, header.ref_name(t),
                                       aux_out)
                        if r == -2:
                            skip += 1
                else:
                    # bounded sub-chunks: no cross-record state, keeps
                    # the flat scratch arrays cache-sized
                    for c0 in range(i, j, 1 << 16):
                        skip += fillmd_batch(
                            b, np.arange(c0, min(c0 + (1 << 16), j),
                                         dtype=np.int64), ref,
                            len(ref), flt_flag, max_nm, quiet,
                            header.ref_name(t), aux_out,
                            aux_native_ok=not (is_realn or capq > 10))
            i = j
        off = np.zeros(b.n + 1, np.int64)
        for i, a in enumerate(aux_out):
            off[i + 1] = off[i] + len(a)
        b.aux = (np.concatenate(aux_out).astype(np.uint8)
                 if aux_out else np.empty(0, np.uint8))
        b.aux_off = off
        return skip

    if not no_pg:
        cl = "samtools calmd " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)
    fmt = "bam" if is_bam_out else (ga.out_fmt or "sam")

    if stream is not None and fmt in ("bam", "sam", "sam.gz"):
        # bounded-memory pipeline: window in, window out (the
        # samtools' one-record loop, bam_md.c:389)
        writer = StreamingWriter(None, header, fmt,
                                 threads=ga.nthreads, level=level)
        try:
            for wb in stream.batches():
                got = process(wb)
                if got is None:
                    return 1
                skipped += got
                writer.write_batch(wb)
        finally:
            writer.close()
            stream.close()
    else:
        if stream is not None:
            stream.close()
            f = read_alignments(fn_in, threads=ga.nthreads)
        b = f.batch
        got = process(b)
        if got is None:
            return 1
        skipped += got
        write_alignments(None, header, b, fmt=fmt, threads=ga.nthreads,
                         level=level, include_header=True)

    if skipped and not quiet:
        sys.stderr.write("[bam_fillmd] %u reads skipped\n" % skipped)
    return 0
