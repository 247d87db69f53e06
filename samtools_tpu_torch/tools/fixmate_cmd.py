"""samtools fixmate: fill in mate information on name-grouped input.

Counterpart of samtools_tpu/tools/fixmate_cmd.py (samtools'
bam_mating_core, bam_mate.c:1007-1190): sanitize (``-z``), copy each
mate's position, strand and unmapped flag, the MQ and MC tags, TLEN from
the 5' ends, the proper-pair check, ``-m``'s ms scores, ``-c``'s ct
template cigar and ``-r``'s removals.  Templates of two primary records
take one vectorised pass; the rest loop a template at a time.  A BGZF
BAM path streams a batch at a time, each batch cut after its last whole
template (name-grouped templates are adjacent); other inputs are read
whole.  A host command: no device work.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ReadBatch, ragged_gather_indices
from ..core.sanitize import FIX_ALL, parse_sanitize_options, sanitize_batch
from ..core.textutil import cigar_strs, ragged_scatter
from ..io.files import (StreamingWriter, infer_output_format,
                        read_alignments, write_alignments)
from ..io.sam_text import cigar_to_str
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     open_stream, print_error_errno)

MD_MIN_QUALITY = 15


def usage(fp):
    fp.write(
        "Usage: samtools fixmate <in.nameSrt.bam> <out.nameSrt.bam>\n"
        "Options:\n"
        "  -r           Remove unmapped reads and secondary alignments\n"
        "  -p           Disable FR proper pair check\n"
        "  -c           Add template cigar ct tag\n"
        "  -m           Add mate score tag\n"
        "  -u           Uncompressed output\n"
        "  -z, --sanitize FLAG[,FLAG]\n"
        "               Sanitize alignment fields [defaults to all types]\n"
        "  --no-PG      do not add a PG line\n")


def main_fixmate(argv: list[str]) -> int:
    ga = GlobalArgs()
    remove_reads = False
    pp_check = True
    add_ct = False
    mate_score = False
    no_pg = False
    level = 6
    sanitize_flags = FIX_ALL
    try:
        opts, args = gnu_getopt(argv, "rpcmO:@:uz:",
                                ["no-PG", "sanitize="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-r":
            remove_reads = True
        elif o == "-p":
            pp_check = False
        elif o == "-c":
            add_ct = True
        elif o == "-m":
            mate_score = True
        elif o == "-u":
            level = 0
        elif o in ("-z", "--sanitize"):
            sanitize_flags = parse_sanitize_options(v)
            if sanitize_flags < 0:
                return 1
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1
    if len(args) < 1 or (len(args) < 2 and sys.stdout.isatty()):
        usage(sys.stderr if args else sys.stdout)
        return 1
    fn_in = args[0]
    fn_out = args[1] if len(args) > 1 else "-"

    # streamed input (bounded memory; queryname-grouped templates are
    # adjacent, so chunks carry only the trailing partial template)
    stream = None
    if fn_in != "-":
        try:
            stream = open_stream(fn_in, ga.nthreads)
        except OSError as e:
            print_error_errno("fixmate", 'cannot open input file "%s"',
                              fn_in, exc=e)
            return 1
    if stream is not None:
        header = stream.header
        chunks = stream.batches()
    else:
        try:
            f = read_alignments(fn_in, threads=ga.nthreads)
        except OSError as e:
            print_error_errno("fixmate", 'cannot open input file "%s"',
                              fn_in, exc=e)
            return 1
        header = f.header
        chunks = iter([f.batch])
    if header.sort_order() == "coordinate":
        sys.stderr.write("[bam_mating_core] ERROR: Coordinate sorted, "
                         "require grouped/sorted by queryname.\n")
        if stream is not None:
            stream.close()
        return 1

    out_header = header
    if not no_pg:
        cl = "samtools fixmate " + " ".join(argv)
        out_header = header.add_pg_line("samtools", "samtools", cl,
                                        SAMTOOLS_PARITY_VERSION)
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    if fmt in ("bam", "sam", "sam.gz"):
        writer = StreamingWriter(fn_out if fn_out != "-" else None,
                                 out_header, fmt, threads=ga.nthreads,
                                 level=level)
        sink = None
    else:  # cram etc: accumulate (rare path)
        writer = None
        sink = []
    carry = None
    try:
        it = iter(chunks)
        nxt = next(it, None)
        while nxt is not None:
            b = nxt
            nxt = next(it, None)
            if carry is not None and carry.n:
                b = ReadBatch.concat([carry, b])
                carry = None
            if b.n == 0:
                continue
            if nxt is not None:
                # split off the trailing template run (may continue)
                runs = _qname_runs(b)
                cut = int(runs[-2])
                if cut == 0:
                    carry = b
                    continue
                carry = b.take(np.arange(cut, b.n, dtype=np.int64))
                b = b.take(np.arange(cut, dtype=np.int64))
            out = _fixmate_chunk(b, header, sanitize_flags, remove_reads,
                                 pp_check, add_ct, mate_score)
            if writer is not None:
                writer.write_batch(out)
            else:
                sink.append(out)
        if carry is not None and carry.n:
            out = _fixmate_chunk(carry, header, sanitize_flags,
                                 remove_reads, pp_check, add_ct,
                                 mate_score)
            if writer is not None:
                writer.write_batch(out)
            else:
                sink.append(out)
    finally:
        if writer is not None:
            writer.close()
        if stream is not None:
            stream.close()
    if sink is not None:
        allb = (ReadBatch.concat(sink) if len(sink) > 1
                else sink[0] if sink else ReadBatch())
        write_alignments(fn_out, out_header, allb, fmt=fmt,
                         threads=ga.nthreads, level=level,
                         include_header=True)
    return 0


def _qname_runs(b) -> np.ndarray:
    """Template run boundaries (offsets array) over adjacent equal
    qnames, fully vectorized."""
    n = b.n
    if n == 0:
        return np.zeros(1, np.int64)
    ln = np.diff(b.qname_off)
    same = ln[1:] == ln[:-1]
    idx = np.nonzero(same)[0]
    if idx.size:
        la = ln[idx]
        ga = ragged_gather_indices(b.qname_off[idx], la)
        gb = ragged_gather_indices(b.qname_off[idx + 1], la)
        eqb = b.qname[ga] == b.qname[gb]
        starts = np.zeros(idx.size, np.int64)
        np.cumsum(la[:-1], out=starts[1:])
        ok = la > 0
        alleq = np.ones(idx.size, bool)
        if eqb.size:
            red = np.logical_and.reduceat(eqb, starts[ok])
            alleq[ok] = red
        same[idx] = alleq
    bounds = np.nonzero(~same)[0] + 1
    return np.concatenate([[0], bounds, [n]]).astype(np.int64)


def _fixmate_chunk(b, header, sanitize_flags, remove_reads, pp_check,
                   add_ct, mate_score):
    """bam_mating_core over one chunk of whole templates: vectorized
    fast path for clean primary pairs, scalar loop for the rest."""
    b = sanitize_batch(b, header, sanitize_flags)
    fl = b.flag.astype(np.int64)
    end = b.end_pos()
    runs = _qname_runs(b)
    rl = np.diff(runs)
    starts = runs[:-1]
    sec = (fl & (F.FSECONDARY | F.FSUPPLEMENTARY)) != 0
    # fast runs: exactly two records, both primary, no ct tagging
    fast = np.zeros(rl.size, bool)
    two = rl == 2
    if two.any() and not add_ct:
        s2 = starts[two]
        fast[two] = (~sec[s2]) & (~sec[s2 + 1])
    aux_extra: dict[int, bytes] = {}
    aux_del: dict[int, set] = {}

    def aux_append(i, tag, blob):
        aux_del.setdefault(i, set()).add(tag)
        aux_extra[i] = aux_extra.get(i, b"") + blob

    vec_extra = [None]
    if fast.any():
        pre = starts[fast]
        cur = pre + 1
        _fast_pairs(b, fl, end, pre, cur, pp_check, mate_score,
                    remove_reads, vec_extra)
    # scalar path for the rest
    slow = np.nonzero(~fast)[0]
    if slow.size:
        _slow_templates(b, fl, end, starts, rl, slow, remove_reads,
                        pp_check, add_ct, mate_score, aux_append)

    b.flag = fl.astype(np.uint16)
    if aux_extra or aux_del or vec_extra[0] is not None:
        _apply_aux(b, aux_extra, aux_del, vec_extra[0], mate_score)
    if remove_reads:
        keep = (b.flag.astype(np.int64)
                & (F.FSECONDARY | F.FUNMAP)) == 0
        if not keep.all():
            b = b.take(np.nonzero(keep)[0])
    return b


def _fast_pairs(b, fl, end, pre, cur, pp_check, mate_score, remove_reads,
                vec_extra):
    """Vectorized bam_mating_core inner ops for clean primary pairs,
    mirroring the scalar sequence exactly (sync pre->cur, cur->pre,
    MQ/MC both ways, TLEN, proper-pair check, ms, -r fixes)."""
    pre_end = np.where(fl[pre] & F.FUNMAP, 0, end[pre])
    cur_end = np.where(fl[cur] & F.FUNMAP, 0, end[cur])
    fl[pre] |= F.FPAIRED
    fl[cur] |= F.FPAIRED

    def sync(src, dst):
        s_unm = (fl[src] & F.FUNMAP) != 0
        d_unm = (fl[dst] & F.FUNMAP) != 0
        mvs = d_unm & ~s_unm
        b.tid[dst[mvs]] = b.tid[src[mvs]]
        b.pos[dst[mvs]] = b.pos[src[mvs]]
        b.mtid[dst] = b.tid[src]
        b.mpos[dst] = b.pos[src]
        rev = (fl[src] & F.FREVERSE) != 0
        fl[dst] = np.where(rev, fl[dst] | F.FMREVERSE,
                           fl[dst] & ~F.FMREVERSE)
        fl[dst[s_unm]] |= F.FMUNMAP

    sync(pre, cur)
    sync(cur, pre)

    # MQ / MC / ms blobs (per destination, scalar append order
    # MQ,MC,ms), built fully vectorized: dests = [cur..., pre...] with
    # srcs = [pre..., cur...]
    pre_unm = (fl[pre] & F.FUNMAP) != 0
    cur_unm = (fl[cur] & F.FUNMAP) != 0
    dests = np.concatenate([cur, pre])
    srcs = np.concatenate([pre, cur])
    s_unm = np.concatenate([pre_unm, cur_unm])
    d_unm = np.concatenate([cur_unm, pre_unm])
    has_mq = ~s_unm
    has_mc = (~s_unm) | (~d_unm)
    mcflat, mcoff = cigar_strs(b.cigar, b.cigar_off, srcs)
    mclen = np.diff(mcoff)
    if mate_score:
        q = b.qual.astype(np.int64)
        contrib = np.where(q >= MD_MIN_QUALITY, q, 0)
        csum = np.zeros(q.size + 1, np.int64)
        np.cumsum(contrib, out=csum[1:])
        ms_val = csum[b.seq_off[srcs + 1]] - csum[b.seq_off[srcs]]
    blob_len = (7 * has_mq + (4 + mclen) * has_mc
                + (7 if mate_score else 0))
    boff = np.zeros(dests.size + 1, np.int64)
    np.cumsum(blob_len, out=boff[1:])
    blob = np.zeros(int(boff[-1]), np.uint8)
    curp = boff[:-1].copy()
    im = np.nonzero(has_mq)[0]
    if im.size:
        mq_le = b.mapq[srcs[im]].astype("<i4").view(np.uint8) \
            .reshape(-1, 4)
        blob[curp[im]] = ord("M")
        blob[curp[im] + 1] = ord("Q")
        blob[curp[im] + 2] = ord("i")
        blob[(curp[im][:, None] + 3 + np.arange(4)[None, :])
             .reshape(-1)] = mq_le.reshape(-1)
    curp += 7 * has_mq
    ic = np.nonzero(has_mc)[0]
    if ic.size:
        blob[curp[ic]] = ord("M")
        blob[curp[ic] + 1] = ord("C")
        blob[curp[ic] + 2] = ord("Z")
        ragged_scatter(blob, curp[ic] + 3, mclen[ic], mcflat,
                       mcoff[:-1][ic])
        blob[curp[ic] + 3 + mclen[ic]] = 0
    curp += (4 + mclen) * has_mc
    if mate_score:
        ms_le = ms_val.astype("<i4").view(np.uint8).reshape(-1, 4)
        blob[curp] = ord("m")
        blob[curp + 1] = ord("s")
        blob[curp + 2] = ord("i")
        blob[(curp[:, None] + 3 + np.arange(4)[None, :])
             .reshape(-1)] = ms_le.reshape(-1)
    vec_extra[0] = (dests, blob, boff)

    # TLEN
    both_mapped = ~(((fl[pre] | fl[cur]) & (F.FUNMAP | F.FMUNMAP)) != 0) \
        & (b.tid[pre] == b.tid[cur])
    cur5 = np.where(fl[cur] & F.FREVERSE, cur_end, b.pos[cur])
    pre5 = np.where(fl[pre] & F.FREVERSE, pre_end, b.pos[pre])
    b.tlen[cur] = np.where(both_mapped, pre5 - cur5, 0)
    b.tlen[pre] = np.where(both_mapped, cur5 - pre5, 0)

    if pp_check:
        a_pos = np.where(fl[pre] & F.FREVERSE, pre_end, b.pos[pre])
        b_pos = np.where(fl[cur] & F.FREVERSE, cur_end, b.pos[cur])
        swap = a_pos > b_pos
        first_rev = np.where(swap, fl[cur] & F.FREVERSE,
                             fl[pre] & F.FREVERSE) != 0
        second_rev = np.where(swap, fl[pre] & F.FREVERSE,
                              fl[cur] & F.FREVERSE) != 0
        plaus = (~pre_unm) & (~cur_unm) \
            & (b.tid[pre] == b.tid[cur]) \
            & (~first_rev) & second_rev
        bad = ~plaus
        fl[pre[bad]] &= ~F.FPROPER_PAIR
        fl[cur[bad]] &= ~F.FPROPER_PAIR

    if remove_reads:
        fl[cur[pre_unm]] &= ~(F.FMREVERSE | F.FPROPER_PAIR)
        fl[pre[cur_unm]] &= ~(F.FMREVERSE | F.FPROPER_PAIR)


def _slow_templates(b, fl, end, starts, rl, slow_runs, remove_reads,
                    pp_check, add_ct, mate_score, aux_append):
    """The original per-template loop, over selected runs only."""
    for r in slow_runs:
        i = int(starts[r])
        j = i + int(rl[r])
        prims = [k for k in range(i, j)
                 if not (fl[k] & (F.FSECONDARY | F.FSUPPLEMENTARY))]
        if not prims:
            continue
        pre = prims[0]
        cur = None
        pre_end = int(end[pre]) if not (fl[pre] & F.FUNMAP) else 0
        for k in prims[1:]:
            cur = k
            cur_end = int(end[cur]) if not (fl[cur] & F.FUNMAP) else 0
            fl[pre] |= F.FPAIRED
            fl[cur] |= F.FPAIRED
            _sync_mate(b, fl, pre, cur)
            _sync_mate(b, fl, cur, pre)
            _sync_mq_mc(b, fl, pre, cur, aux_append)
            _sync_mq_mc(b, fl, cur, pre, aux_append)
            if (b.tid[pre] == b.tid[cur]
                    and not (fl[cur] & (F.FUNMAP | F.FMUNMAP))
                    and not (fl[pre] & (F.FUNMAP | F.FMUNMAP))):
                cur5 = cur_end if fl[cur] & F.FREVERSE else int(b.pos[cur])
                pre5 = pre_end if fl[pre] & F.FREVERSE else int(b.pos[pre])
                b.tlen[cur] = pre5 - cur5
                b.tlen[pre] = cur5 - pre5
            else:
                b.tlen[cur] = b.tlen[pre] = 0
            if add_ct:
                _template_cigar(b, fl, end, pre, cur, aux_append)
            if pp_check and not _plausibly_pp(b, fl, pre, cur,
                                              pre_end, cur_end):
                fl[pre] &= ~F.FPROPER_PAIR
                fl[cur] &= ~F.FPROPER_PAIR
            if mate_score:
                _add_ms(b, pre, cur, aux_append)
                _add_ms(b, cur, pre, aux_append)
            if remove_reads:
                if fl[pre] & F.FUNMAP:
                    fl[cur] &= ~(F.FMREVERSE | F.FPROPER_PAIR)
                if fl[cur] & F.FUNMAP:
                    fl[pre] &= ~(F.FMREVERSE | F.FPROPER_PAIR)
        if cur is None and pre is not None:
            b.mtid[pre] = -1
            b.mpos[pre] = -1
            b.tlen[pre] = 0
            fl[pre] &= ~(F.FMREVERSE | F.FPROPER_PAIR)


def _apply_aux(b, aux_extra: dict, aux_del: dict, vec, mate_score):
    """Rebuild the aux flat as [old | extra] per row in one vectorized
    pass.  Rows whose existing aux may already hold a replaced tag
    (2-byte id scan; false positives just take the slow path) get a
    scalar delete_tags treatment first."""
    n = b.n
    vrows = np.empty(0, np.int64)
    vflat = np.empty(0, np.uint8)
    voff = np.zeros(1, np.int64)
    if vec is not None:
        vrows, vflat, voff = vec
    # suspect rows: aux may contain one of the replaced tag ids
    tags = {"MQ", "MC"} | ({"ms"} if mate_score else set())
    for s in aux_del.values():
        tags |= s
    suspect = np.zeros(n, bool)
    flat = b.aux
    if flat.size >= 2 and tags:
        for t in tags:
            tb = t.encode()
            h = np.flatnonzero((flat[:-1] == tb[0]) & (flat[1:] == tb[1]))
            if h.size:
                rows = np.searchsorted(b.aux_off, h, side="right") - 1
                rows = rows[(rows >= 0) & (rows < n)]
                suspect[rows] = True
    # scalar rows: either flagged suspect with a pending change, or in
    # the dict path
    vec_extra_len = np.zeros(n, np.int64)
    if vrows.size:
        vec_extra_len[vrows] = np.diff(voff)
    py_rows = {}
    touched = set(aux_extra) | set(aux_del)
    for i in touched:
        a = b.aux[b.aux_off[i]:b.aux_off[i + 1]]
        dels = aux_del.get(i)
        if dels and suspect[i]:
            a = auxmod.delete_tags(a, dels)
        py_rows[i] = bytes(a) + aux_extra.get(i, b"")
    if vrows.size:
        vdel = {"MQ", "MC"} | ({"ms"} if mate_score else set())
        for i in vrows[suspect[vrows]]:
            i = int(i)
            if i in py_rows:
                continue
            a = auxmod.delete_tags(
                b.aux[b.aux_off[i]:b.aux_off[i + 1]], vdel)
            py_rows[i] = bytes(a)  # vec extra appended via vec path

    old_len = np.diff(b.aux_off)
    base_len = old_len.copy()
    for i, blob in py_rows.items():
        base_len[i] = len(blob)
    row_len = base_len + vec_extra_len
    new_off = np.zeros(n + 1, np.int64)
    np.cumsum(row_len, out=new_off[1:])
    new_flat = np.empty(int(new_off[-1]), np.uint8)
    # bulk old-aux copy for untouched rows
    if py_rows:
        keep = np.ones(n, bool)
        keep[np.fromiter(py_rows, np.int64, len(py_rows))] = False
        keep_rows = np.nonzero(keep)[0]
    else:
        keep_rows = np.arange(n)
    ragged_scatter(new_flat, new_off[keep_rows], old_len[keep_rows],
                   b.aux, b.aux_off[:-1][keep_rows])
    for i, blob in py_rows.items():
        if blob:
            new_flat[new_off[i]:new_off[i] + len(blob)] = \
                np.frombuffer(blob, np.uint8)
    # vectorized extras appended after each row's base
    if vrows.size:
        ragged_scatter(new_flat, new_off[vrows] + base_len[vrows],
                       np.diff(voff), vflat, voff[:-1])
    b.aux = new_flat
    b.aux_off = new_off


def _sync_mate(b, fl, src, dest):
    """sync_unmapped_pos_inner + sync_mate_inner (one direction)."""
    if (fl[dest] & F.FUNMAP) and not (fl[src] & F.FUNMAP):
        b.tid[dest] = b.tid[src]
        b.pos[dest] = b.pos[src]
    b.mtid[dest] = b.tid[src]
    b.mpos[dest] = b.pos[src]
    if fl[src] & F.FREVERSE:
        fl[dest] |= F.FMREVERSE
    else:
        fl[dest] &= ~F.FMREVERSE
    if fl[src] & F.FUNMAP:
        fl[dest] |= F.FMUNMAP


def _sync_mq_mc(b, fl, src, dest, aux_append):
    if not (fl[src] & F.FUNMAP):
        aux_append(dest, "MQ",
                   b"MQi" + struct.pack("<i", int(b.mapq[src])))
    if not (fl[src] & F.FUNMAP) or not (fl[dest] & F.FUNMAP):
        mc = cigar_to_str(b.cigar_of(src))
        aux_append(dest, "MC", b"MCZ" + mc.encode("latin-1") + b"\0")


def _plausibly_pp(b, fl, pre, cur, pre_end, cur_end) -> bool:
    if (fl[pre] & F.FUNMAP) or (fl[cur] & F.FUNMAP):
        return False
    if b.tid[pre] != b.tid[cur]:
        return False
    a_pos = pre_end if fl[pre] & F.FREVERSE else int(b.pos[pre])
    b_pos = cur_end if fl[cur] & F.FREVERSE else int(b.pos[cur])
    if a_pos > b_pos:
        first, second = cur, pre
    else:
        first, second = pre, cur
    return (not (fl[first] & F.FREVERSE)) and bool(fl[second] & F.FREVERSE)


def _add_ms(b, src, dest, aux_append):
    qual = b.qual[b.seq_off[src]:b.seq_off[src + 1]].astype(np.int64)
    score = int(qual[qual >= MD_MIN_QUALITY].sum())
    aux_append(dest, "ms", b"msi" + struct.pack("<i", score))


def _template_cigar(b, fl, end, pre, cur, aux_append):
    """bam_template_cigar (bam_mate.c:48): ct:Z on the leftmost read."""
    if (b.tid[pre] != b.tid[cur] or b.tid[pre] < 0 or b.pos[pre] < 0
            or b.pos[cur] < 0 or (fl[pre] & F.FUNMAP)
            or (fl[cur] & F.FUNMAP)):
        # samtools returns here, before it drops any old ct tag
        return
    b1, b2 = (pre, cur) if b.pos[pre] <= b.pos[cur] else (cur, pre)
    s = []
    s.append("1" if fl[b1] & F.FREAD1 else "2")
    s.append("R" if fl[b1] & F.FREVERSE else "F")
    s.append(cigar_to_str(b.cigar_of(b1)).replace("*", ""))
    s.append(str(int(b.pos[b2]) - int(end[b1])))
    s.append("T")
    s.append("1" if fl[b2] & F.FREAD1 else "2")
    s.append("R" if fl[b2] & F.FREVERSE else "F")
    s.append(cigar_to_str(b.cigar_of(b2)).replace("*", ""))
    ct = "".join(s)
    aux_append(b1, "ct", b"ctZ" + ct.encode("latin-1") + b"\0")
    # ensure any stale ct on the other read is dropped
    aux_append(b2, "ct", b"")