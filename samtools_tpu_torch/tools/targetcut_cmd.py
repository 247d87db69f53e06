"""samtools targetcut on the port: cut fosmid-pool target regions.

Counterpart of samtools_tpu/tools/targetcut_cmd.py (``gencns`` :25,
``process_cns`` :50, ``main_targetcut`` :101), samtools' cut_target.c: a
per-column consensus from the MAQ error model (``gencns``, cut_target.c
:59-93), then a two-state segmentation (``process_cns``, :95-147) that
prints each target region as a SAM-like line.  Output is the JAX tool's,
byte for byte.

Device work: each contig's pileup table is ordered by K13 on the card
(``ops.pileup.build_pileup``), and with ``-f`` its reads are BAQ'd first
(``ops.baq.apply_baq_batch``: K8 on the card for uniform all-M groups of
at least ``DEVICE_GROUP_MIN`` reads, the host library's HMM for the
rest).  ``SAMTPU_DEVICE=0|host`` runs both on the host.  The JAX tool
wraps its BAQ in ``except Exception: pass``; the port does not, so a
failure of K8 raises.  Where that call changes nothing in the JAX tool (a
FASTA without the contig: ``fetch`` gives no bases), the port skips it.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import flags as F
from ..io.fasta import load_fasta
from ..io.files import read_alignments
from ..ops.baq import _ref_ints, apply_baq_batch
from ..ops.errmod import ErrMod, _SEQ_NT16_INT
from ..ops.pileup import build_pileup
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, pick_device, print_error_errno)

ERR_DEP = 0.83


def gencns(em: ErrMod, entries) -> int:
    """cut_target.c:59-93: per-column consensus (base, qual, depth)
    packed as ret<<8 | k."""
    bases = []
    for qual, mapq, rev, b16 in entries:
        b = int(_SEQ_NT16_INT[b16])
        if b > 3:
            continue
        q = qual if qual < mapq else mapq
        if q < 4:
            q = 4
        if q > 63:
            q = 63
        bases.append((q << 5) | (rev << 4) | b)
    k = len(bases)
    if k == 0:
        return 0
    q = em.cal(np.array(bases, np.uint16), 4)
    s = sorted((int(q[i * 4 + i] + 0.499) << 2 | i for i in range(4)))
    qual = (s[1] >> 2) - (s[0] >> 2)
    k = k if k < 256 else 255
    ret = (qual if qual < 63 else 63) << 2 | (s[0] & 3)
    return ret << 8 | k


def process_cns(ref_name: str, l: int, cns: np.ndarray, param) -> None:
    """2-state HMM segmentation + SAM-like consensus output
    (cut_target.c:95-147)."""
    e, p = param
    b = np.zeros(l, np.uint8)
    prev = [0, 0]
    curr = [0, 0]
    for i in range(l):
        c = 0 if cns[i] == 0 else (1 if (cns[i] >> 8) == 0 else 2)
        tmp0 = prev[0] + e[0][c] + p[0][0]
        tmp1 = prev[1] + e[0][c] + p[1][0]
        if tmp0 > tmp1:
            curr[0] = tmp0
            b[i] = 0
        else:
            curr[0] = tmp1
            b[i] = 1
        tmp0 = prev[0] + e[1][c] + p[0][1]
        tmp1 = prev[1] + e[1][c] + p[1][1]
        if tmp0 > tmp1:
            curr[1] = tmp0
        else:
            curr[1] = tmp1
            b[i] |= 1 << 1
        prev, curr = curr, prev
    s = 0 if prev[0] > prev[1] else 1
    for i in range(l - 1, 0, -1):
        b[i] |= s << 2
        s = (int(b[i]) >> s) & 1
    out = sys.stdout
    s = -1
    for i in range(l + 1):
        if i == l or (((int(b[i]) >> 2) & 3) == 0 and s >= 0):
            if s >= 0:
                out.write("%s:%d-%d\t0\t%s\t%d\t60\t%dM\t*\t0\t0\t"
                          % (ref_name, s + 1, i, ref_name, s + 1, i - s))
                chars = []
                quals = []
                for j in range(s, i):
                    c = int(cns[j]) >> 8
                    chars.append("N" if c == 0 else "ACGT"[c & 3])
                    quals.append(chr(33 + (c >> 2)))
                out.write("".join(chars))
                out.write("\t")
                out.write("".join(quals))
                out.write("\n")
            s = -1
        elif ((int(b[i]) >> 2) & 3) and s < 0:
            s = i


def main_targetcut(argv: list[str], device=None) -> int:
    """``samtools targetcut``; ``device``: where K8 and K13 run (None: the
    CUDA card; ``SAMTPU_DEVICE=0|host``: the host)."""
    ga = GlobalArgs()
    min_baseQ = 13
    e = [[0, 0, 0], [-4, 1, 6]]
    p = [[0, -14000], [0, 0]]
    try:
        opts, args = gnu_getopt(argv, "f:Q:i:o:0:1:2:", ["reference="])
    except UsageError:
        sys.stderr.write("Usage: samtools targetcut [-Q minQ] [-i inPen]"
                         " [-0 em0] [-1 em1] [-2 em2] <in.bam>\n")
        return 1
    for o, v in opts:
        if o == "-Q":
            min_baseQ = int(v)
        elif o == "-i":
            p[0][1] = -int(v)
        elif o == "-0":
            e[1][0] = int(v)
        elif o == "-1":
            e[1][1] = int(v)
        elif o == "-2":
            e[1][2] = int(v)
        elif o in ("-f", "--reference"):
            ga.reference = v
        elif handle_global_opt(ga, o, v):
            pass
        else:
            sys.stderr.write("Usage: samtools targetcut [-Q minQ]"
                             " [-i inPen] [-0 em0] [-1 em1] [-2 em2]"
                             " <in.bam>\n")
            return 1
    if not args:
        sys.stderr.write("Usage: samtools targetcut [-Q minQ] [-i inPen]"
                         " [-0 em0] [-1 em1] [-2 em2] <in.bam>\n")
        return 1

    try:
        dev = pick_device(device)
    except RuntimeError as e2:
        return no_card("targetcut", e2)

    fai = None
    if ga.reference:
        try:
            fai = load_fasta(ga.reference)
        except Exception:
            sys.stderr.write("[main_cut_target] fail to load the fasta"
                             " index.\n")
            fai = None

    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e2:
        print_error_errno("targetcut", 'can\'t open "%s"', args[0],
                          exc=e2)
        return 1
    header = f.header
    b = f.batch
    em = ErrMod(1.0 - ERR_DEP)

    skip = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
    keep = np.nonzero(((b.flag & skip) == 0) & (b.tid >= 0))[0]
    sub_all = b.take(keep)

    for tid in np.unique(sub_all.tid):
        tid = int(tid)
        rn = header.ref_name(tid)
        sel = np.nonzero(sub_all.tid == tid)[0]
        sub = sub_all.take(sel)
        if fai is not None:
            # BAQ adjust (cut_target.c:158-165, flag 1<<1|1); a contig the
            # FASTA lacks has no bases, and no read changes
            ref = fai.fetch(rn)
            if ref:
                apply_baq_batch(sub, _ref_ints(ref), redo=False, device=dev)
        pile = build_pileup(sub, dev)
        l = header.ref_lens[tid]
        cns = np.zeros(l, np.uint32)
        ncols = len(pile.col_pos)
        for ci in range(ncols):
            pos = int(pile.col_pos[ci])
            if pos >= l:
                continue
            s0 = int(pile.col_off[ci])
            e0 = int(pile.col_off[ci + 1])
            entries = []
            for idx in range(s0, e0):
                if pile.is_del[idx] or pile.is_refskip[idx]:
                    continue
                rid = int(pile.rid[idx])
                qpos = int(pile.qpos[idx])
                qual = int(sub.qual[sub.seq_off[rid] + qpos])
                if qual < min_baseQ:
                    continue
                entries.append((qual, int(sub.mapq[rid]),
                                int(bool(sub.flag[rid] & F.FREVERSE)),
                                int(sub.seq[sub.seq_off[rid] + qpos])))
            cns[pos] = gencns(em, entries)
        process_cns(rn, l, cns, (e, p))
    return 0
