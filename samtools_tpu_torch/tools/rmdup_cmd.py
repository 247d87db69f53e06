"""samtools rmdup: the legacy duplicate removal (markdup supersedes it).

Counterpart of samtools_tpu/tools/rmdup_cmd.py (samtools' bam_rmdup.c,
bam_rmdup_core :130-254: paired reads keyed by (pos, isize), the best sum
of qualities kept; and bam_rmdupse.c :129-230: single-end reads through a
queue with a best-read hash a strand).  The output order follows
samtools' stack and queue, a beaten duplicate's slot taken over in place.
A host command: no device work.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F
from ..io.files import infer_output_format, read_alignments, write_alignments
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error_errno)

BUFFER_SIZE = 0x40000
QUEUE_CLEAR_SIZE = 0x100000
MAX_POS = 0x7FFFFFFF


def get_library_map(header) -> dict:
    """@RG ID -> LB (samtools' bam_get_library, bam.c)."""
    lib = {}
    for line in header.text.split("\n"):
        if not line.startswith("@RG"):
            continue
        fields = dict(x.split(":", 1) for x in line.split("\t")[1:]
                      if ":" in x)
        if "ID" in fields and "LB" in fields:
            lib[fields["ID"]] = fields["LB"]
    return lib


def rmdup_pe(b, header, out_order: list) -> dict:
    """bam_rmdup_core (bam_rmdup.c:130-254).  Appends output slots
    (mutable single-element lists of record index) to out_order."""
    rg2lib = get_library_map(header)
    sum_quals = np.zeros(b.n, np.int64)
    for i in range(b.n):
        sum_quals[i] = int(b.qual[b.seq_off[i]:b.seq_off[i + 1]]
                           .astype(np.int64).sum())
    qnames = [b.qname_str(i) for i in range(b.n)]

    stats: dict[str, list] = {}   # lib -> [checked, removed]
    best: dict[str, dict] = {}    # lib -> {key: slot}
    slot_of: dict = {}            # key id -> (slot list, qname)
    del_set: set = set()
    stack: list = []
    last_tid = -1
    last_pos = -1

    def lib_of(i: int) -> str:
        rg = auxmod.get_value(b.aux_of(i), "RG")
        lb = rg2lib.get(rg[1]) if rg is not None else None
        return lb if lb is not None else "\t"

    i = 0
    n = b.n
    while i < n:
        tid = int(b.tid[i])
        pos = int(b.pos[i])
        flag = int(b.flag[i])
        if tid != last_tid or last_pos != pos:
            out_order.extend(stack)
            stack = []
            for lb in best:
                if len(best[lb]) >= BUFFER_SIZE:
                    best[lb].clear()
            if tid != last_tid:
                for lb in best:
                    best[lb].clear()
                if del_set:
                    sys.stderr.write("[bam_rmdup_core] %d unmatched"
                                     " pairs\n" % len(del_set))
                    del_set.clear()
                if tid == -1:
                    # append remaining (unmapped) reads verbatim
                    for j in range(i, n):
                        out_order.append([j])
                    i = n
                    break
                last_tid = tid
                sys.stderr.write("[bam_rmdup_core] processing reference"
                                 " %s...\n" % header.ref_name(tid))
        if not (flag & F.FPAIRED) or (flag & (F.FUNMAP | F.FMUNMAP)) or \
                (int(b.mtid[i]) >= 0 and tid != int(b.mtid[i])):
            out_order.append([i])
        elif int(b.tlen[i]) > 0:   # paired, head
            key = (pos << 32) | (int(b.tlen[i]) & 0xFFFFFFFF)
            lb = lib_of(i)
            st = stats.setdefault(lb, [0, 0])
            bh = best.setdefault(lb, {})
            st[0] += 1
            prev = bh.get(key)
            if prev is not None:
                st[1] += 1
                slot, prev_qname = prev
                if sum_quals[slot[0]] < sum_quals[i]:
                    del_set.add(prev_qname)
                    slot[0] = i                     # replace in place
                    bh[key] = (slot, qnames[i])
                else:
                    del_set.add(qnames[i])
            else:
                slot = [i]
                bh[key] = (slot, qnames[i])
                stack.append(slot)
        else:                      # paired, tail
            if qnames[i] in del_set:
                del_set.discard(qnames[i])
            else:
                out_order.append([i])
        last_pos = pos
        i += 1
    out_order.extend(stack)
    for lb, st in stats.items():
        sys.stderr.write("[bam_rmdup_core] %d / %d = %.4f in library"
                         " '%s'\n" % (st[1], st[0],
                                      st[1] / st[0] if st[0] else 0.0,
                                      lb))
    return stats


def rmdup_se(b, header, out_order: list, force_se: bool) -> dict:
    """bam_rmdupse_core (bam_rmdupse.c:129-230)."""
    rg2lib = get_library_map(header)
    spans = b.ref_span()
    has_cig = b.n_cigar > 0
    mapped = (b.flag & F.FUNMAP) == 0
    endpos = b.pos + np.where(mapped & has_cig, spans, 1)

    stats: dict[str, list] = {}
    # lib -> {key: element}; element = [rec_idx, endpos, score, discarded]
    left: dict[str, dict] = {}
    rght: dict[str, dict] = {}
    queue: list = []
    last_tid = -2

    def lib_of(i: int) -> str:
        rg = auxmod.get_value(b.aux_of(i), "RG")
        lb = rg2lib.get(rg[1]) if rg is not None else None
        return lb if lb is not None else "\t"

    def dump(pos: int):
        if len(queue) > QUEUE_CLEAR_SIZE or pos == MAX_POS:
            while queue:
                el = queue[0]
                if el[3]:
                    queue.pop(0)
                    continue
                if (int(b.flag[el[0]]) & F.FREVERSE) and el[1] > pos:
                    break
                out_order.append([el[0]])
                queue.pop(0)
            for h in (left, rght):
                for lb in h:
                    h[lb] = {k: v for k, v in h[lb].items()
                             if v[1] > pos}

    for i in range(b.n):
        tid = int(b.tid[i])
        pos = int(b.pos[i])
        flag = int(b.flag[i])
        score = int(b.qual[b.seq_off[i]:b.seq_off[i + 1]]
                    .astype(np.int64).sum())
        ep = int(endpos[i])
        if last_tid != tid:
            if last_tid >= 0:
                dump(MAX_POS)
            last_tid = tid
        else:
            dump(pos)
        if (flag & F.FUNMAP) or ((flag & F.FPAIRED) and not force_se):
            queue.append([i, ep, score, 0])
        else:
            lb = lib_of(i)
            st = stats.setdefault(lb, [0, 0])
            st[0] += 1
            h = rght.setdefault(lb, {}) if flag & F.FREVERSE \
                else left.setdefault(lb, {})
            key = ep if flag & F.FREVERSE else pos
            el = h.get(key)
            if el is not None:
                st[1] += 1
                if el[2] < score:
                    if flag & F.FREVERSE:
                        el[3] = 1
                        new = [i, ep, score, 0]
                        queue.append(new)
                        h[key] = new
                    else:
                        el[2] = score
                        el[1] = ep
                        el[0] = i        # replace in place
                # else discard current
            else:
                new = [i, ep, score, 0]
                queue.append(new)
                h[key] = new
    dump(MAX_POS)
    for lb, st in stats.items():
        sys.stderr.write("[bam_rmdupse_core] %d / %d = %.4f in library"
                         " '%s'\n" % (st[1], st[0],
                                      st[1] / st[0] if st[0] else 0.0,
                                      lb))
    return stats


def usage(fp):
    fp.write("\nUsage:  samtools rmdup [-sS] <input.srt.bam>"
             " <output.bam>\n\n"
             "Option: -s    rmdup for SE reads\n"
             "        -S    treat PE reads as SE in rmdup (force -s)\n")


def main_rmdup(argv: list[str]) -> int:
    ga = GlobalArgs()
    is_se = force_se = False
    try:
        opts, args = gnu_getopt(argv, "sS", [])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-s":
            is_se = True
        elif o == "-S":
            force_se = is_se = True
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    if len(args) < 2:
        usage(sys.stderr)
        return 1
    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e:
        print_error_errno("rmdup", 'failed to open "%s" for input',
                          args[0], exc=e)
        return 1
    if f.header.n_refs == 0:
        sys.stderr.write("[bam_rmdup] input SAM does not have header."
                         " Abort!\n")
        return 1

    out_order: list = []
    if is_se:
        rmdup_se(f.batch, f.header, out_order, force_se)
    else:
        rmdup_pe(f.batch, f.header, out_order)
    idx = np.array([slot[0] for slot in out_order], np.int64)
    sub = f.batch.take(idx)
    fmt = infer_output_format(args[1], ga.out_fmt, default="bam")
    write_alignments(args[1], f.header, sub, fmt=fmt,
                     threads=ga.nthreads)
    return 0
