"""samtools phase on the port: het-SNP calls and read-backed phasing.

Counterpart of samtools_tpu/tools/phase_cmd.py (the whole module), after
samtools' phase.c: het calls through the MAQ error model (``gl2cns``,
phase.c:561), a dynamic program over windows of variants (``dynaprog``,
:163), fragment phasing (``fragphase``, :211), masked regions
(``genmask``, :302) and the PS/FL/M?/EV report (:704-716).  Unphased
reads are routed by glibc's drand48 from its default seed, so ``-b``
writes the same reads to the same files.  Output is the JAX tool's, byte
for byte; the ``-b`` BAMs hold the same records and header (the port's
BGZF is ``zlib``'s, so the compressed bytes may differ).

Device work: each contig's pileup table is ordered by K13 on the card
(``ops.pileup.build_pileup``); ``SAMTPU_DEVICE=0|host`` orders it on the
host.  The JAX tool's quirks are kept: contigs in order of first
appearance, reads queued at a contig's end flushed only by a block that
holds variants, and ``-b`` writing BAM whatever ``--output-fmt`` names
(it only sets the extension).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import flags as F
from ..io.files import read_alignments, write_alignments
from ..ops.errmod import ErrMod, _SEQ_NT16_INT
from ..ops.pileup import build_pileup
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, pick_device, print_error_errno)

MAX_VARS = 256
FLIP_PENALTY = 2
FLIP_THRES = 4
MASK_THRES = 3

FLAG_FIX_CHIMERA = 0x1
FLAG_LIST_EXCL = 0x4
FLAG_DROP_AMBI = 0x8


class Drand48:
    """glibc drand48 with the default (unseeded) state."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self):
        self.x = 0x1234ABCD330E

    def next(self) -> float:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x / float(1 << 48)


def x31_hash(s: bytes) -> int:
    h = s[0] if s else 0
    if h:
        for ch in s[1:]:
            h = ((h << 5) - h + ch) & 0xFFFFFFFFFFFFFFFF
    return h


class Frag:
    __slots__ = ("seq", "vpos", "beg", "end", "vlen", "single", "flip",
                 "phase", "phased", "ambig", "in_", "out")

    def __init__(self):
        self.seq = [0] * MAX_VARS
        self.vpos = 0
        self.beg = 0
        self.end = 0
        self.vlen = 0
        self.single = 0
        self.flip = 0
        self.phase = 0
        self.phased = 0
        self.ambig = 0
        self.in_ = 0
        self.out = 0


def count1(l: int, seq: list, cnt: np.ndarray) -> None:
    if seq[l - 1] == 0:
        return
    n_ambi = sum(1 for i in range(l) if seq[i] == 0)
    if l - n_ambi <= 1:
        return
    for x in range(1 << n_ambi):
        z = 0
        j = 0
        for i in range(l):
            if seq[i]:
                c = seq[i] - 1
            else:
                c = (x >> j) & 1
                j += 1
            z = (z << 1) | c
        cnt[z] += 1


def count_all(l: int, vpos: int, frags: dict) -> list:
    cnt = [np.zeros(1 << l, np.int64) for _ in range(vpos)]
    seq = [0] * l
    for f in frags.values():
        if f.vpos >= vpos or f.single:
            continue
        if f.vlen == 1:
            f.single = 1
            continue
        for j in range(1, f.vlen):
            for i in range(l):
                seq[i] = 0 if j < l - 1 - i else f.seq[j - (l - 1 - i)]
            count1(l, seq, cnt[f.vpos + j])
    return cnt


def dynaprog(l: int, vpos: int, w: list) -> np.ndarray:
    """phase.c:163-208."""
    z = 1 << (l - 1)
    mask = (1 << l) - 1
    prev = np.zeros(z, np.int64)
    curr = np.zeros(z, np.int64)
    b = np.zeros((vpos, z), np.int8)
    xs = np.arange(z)
    xcs = (~xs) & mask
    y0 = xs >> 1
    y1 = xcs >> 1
    for i in range(vpos):
        wi = w[i]
        wx = wi[xs] + wi[xcs]
        c0 = prev[y0] + wx
        c1 = prev[y1] + wx
        take1 = c1 >= c0
        b[i] = take1.astype(np.int8)
        curr = np.where(take1, c1, c0)
        prev, curr = curr, prev
    h = np.zeros(vpos, np.int8)
    # replicate the C scan: strictly-greater keeps the first maximum
    max_v = 0
    max_x = 0
    for x in range(z):
        if prev[x] > max_v:
            max_v = int(prev[x])
            max_x = x
    which = 0
    x = max_x
    for i in range(vpos - 1, -1, -1):
        h[i] = (~x & 1) if which else (x & 1)
        if b[i][x]:
            which = not which
            x = ((~x) & mask) >> 1
        else:
            x = x >> 1
    return h


def fragphase(vpos: int, path: np.ndarray, frags: dict,
              flip: bool) -> np.ndarray:
    """phase.c:211-300."""
    pcnt = np.zeros(vpos, np.uint64)
    for f in frags.values():
        if f.vpos >= vpos:
            continue
        c = [0, 0]
        for i in range(f.vlen):
            if f.seq[i] == 0:
                continue
            c[0 if f.seq[i] == path[f.vpos + i] + 1 else 1] += 1
        f.phase = 0 if c[0] > c[1] else 1
        f.in_ = c[f.phase]
        f.out = c[1 - f.phase]
        f.phased = 0 if f.in_ == f.out else 1
        f.ambig = 1 if (f.in_ and f.out and f.out < 3
                        and f.in_ <= f.out + 1) else 0
        f.flip = 0
        if flip and c[0] >= 3 and c[1] >= 3:
            left = [0] * f.vlen
            rght = [0] * f.vlen
            sum_ = [0, 0]
            for i in range(f.vlen):
                if f.seq[i]:
                    cc = 2 - f.seq[i] if f.phase else f.seq[i] - 1
                    sum_[0 if cc == path[f.vpos + i] else 1] += 1
                left[i] = (sum_[1] << 16) | sum_[0]
            sum_ = [0, 0]
            for i in range(f.vlen - 1, -1, -1):
                if f.seq[i]:
                    cc = 2 - f.seq[i] if f.phase else f.seq[i] - 1
                    sum_[0 if cc == path[f.vpos + i] else 1] += 1
                rght[i] = (sum_[1] << 16) | sum_[0]
            m = 0
            mi = -1
            md = -1
            for i in range(f.vlen - 1):
                a0 = (left[i] & 0xFFFF) + ((rght[i + 1] >> 16) & 0xFFFF) \
                    - (rght[i + 1] & 0xFFFF) * FLIP_PENALTY
                a1 = ((left[i] >> 16) & 0xFFFF) + (rght[i + 1] & 0xFFFF) \
                    - ((rght[i + 1] >> 16) & 0xFFFF) * FLIP_PENALTY
                if a0 > a1:
                    if a0 > m:
                        m, md, mi = a0, 0, i
                else:
                    if a1 > m:
                        m, md, mi = a1, 1, i
            if m - c[0] >= FLIP_THRES and m - c[1] >= FLIP_THRES:
                f.flip = 1
                rng = range(mi + 1, f.vlen) if md == 0 else \
                    range(0, mi + 1)
                for i in rng:
                    if f.seq[i] == 1:
                        f.seq[i] = 2
                    elif f.seq[i] == 2:
                        f.seq[i] = 1
        if not f.single:
            for i in range(f.vlen):
                if f.seq[i] == 0:
                    continue
                cc = 2 - f.seq[i] if f.phase else f.seq[i] - 1
                if cc == path[f.vpos + i]:
                    pcnt[f.vpos + i] += np.uint64(1) if f.phase == 0 \
                        else np.uint64(1 << 32)
                else:
                    pcnt[f.vpos + i] += np.uint64(1 << 16) \
                        if f.phase == 0 else np.uint64(1 << 48)
    return pcnt


def genmask(vpos: int, pcnt: np.ndarray):
    """phase.c:302-329."""
    out = []
    max_ = 0
    max_i = -1
    beg = 0
    score = 0
    i = 0
    while i < vpos:
        x = int(pcnt[i])
        c = [x & 0xFFFF, (x >> 16) & 0xFFFF, (x >> 32) & 0xFFFF,
             (x >> 48) & 0xFFFF]
        pre = score
        s = -(c[0] + c[2]) if (c[1] + c[3]) == 0 else (c[1] + c[3] - 1)
        if c[3] > c[2]:
            s += c[3] - c[2]
        if c[1] > c[0]:
            s += c[1] - c[0]
        score += s
        if score < 0:
            score = 0
        if pre == 0 and score > 0:
            beg = i
        if (i == vpos - 1 or score == 0) and max_ >= MASK_THRES:
            out.append((beg << 32) | max_i)
            i = max_i
            score = 0
        elif score > max_:
            max_ = score
            max_i = i
        if score == 0:
            max_ = 0
        i += 1
    return out


def clean_seqs(vpos: int, frags: dict) -> int:
    ret = 0
    for key in list(frags.keys()):
        f = frags[key]
        if f.vpos >= vpos:
            ret = 1
            continue
        beg = next((i for i in range(f.vlen) if f.seq[i] != 0), f.vlen)
        end = next((i + 1 for i in range(f.vlen - 1, -1, -1)
                    if f.seq[i] != 0), 0)
        if end - beg <= 0:
            del frags[key]
        else:
            if beg != 0:
                f.seq[:end - beg] = f.seq[beg:end]
            f.vpos += beg
            f.vlen = end - beg
            f.single = 1 if f.vlen == 1 else 0
    return ret


class PhaseState:
    def __init__(self):
        self.flag = FLAG_FIX_CHIMERA
        self.k = 13
        self.min_baseQ = 13
        self.min_varLOD = 37
        self.max_depth = 256
        self.vpos_shift = 0
        self.pre = None
        self.no_pg = False
        self.queue = []   # pending read indices (file order)
        self.routed = [[], [], []]
        self.rand = Drand48()
        self.batch = None
        self.ends = None


def dump_aln(g: PhaseState, min_pos: int, frags: dict) -> None:
    """phase.c:361-399."""
    drop_ambi = g.flag & FLAG_DROP_AMBI
    is_flip = g.rand.next() < 0.5
    consumed = 0
    for ri in g.queue:
        end = int(g.ends[ri])
        if end > min_pos:
            break
        key = x31_hash(bytes(
            g.batch.qname[g.batch.qname_off[ri]:g.batch.qname_off[ri + 1]]))
        f = frags.get(key)
        tag = False
        if f is None:
            which = 3
        else:
            if f.ambig:
                which = 2 if drop_ambi else 3
            elif f.phased and f.flip:
                which = 2
            elif f.phased == 0:
                which = 3
            else:
                which = f.phase
                tag = True
            if which < 2 and is_flip:
                which = 1 - which
        if which == 3:
            which = 1 if g.rand.next() < 0.5 else 0
        g.routed[which].append((ri, tag))
        consumed += 1
    del g.queue[:consumed]


def gl2cns(q: np.ndarray) -> int:
    """phase.c:561-573."""
    min_v = min2 = 1e30
    min_ij = -1
    for i in range(4):
        for j in range(i, 4):
            v = q[(i << 2) | j]
            if v < min_v:
                min_ij = (i << 2) | j
                min2 = min_v
                min_v = v
            elif v < min2:
                min2 = v
    if ((min_ij >> 2) & 3) == (min_ij & 3):
        return 0
    return (1 << 18 | ((min_ij >> 2) & 3) << 16 | (min_ij & 3)
            | int(min2 - min_v + 0.499) << 2)


def phase_block(g: PhaseState, out, chrom: str, vpos: int, cns: list,
                frags: dict) -> int:
    """phase.c:401-486."""
    if vpos == 0:
        return 0
    has_tail = clean_seqs(vpos, frags)
    min_pos = (cns[vpos] >> 32) if has_tail else 0x7FFFFFFF
    if vpos == 1:
        out.write("PS\t%s\t%d\t%d\n"
                  % (chrom, (cns[0] >> 32) + 1, (cns[0] >> 32) + 1))
        out.write("M0\t%s\t%d\t%d\t%c\t%c\t%d\t0\t0\t0\t0\n//\n"
                  % (chrom, (cns[0] >> 32) + 1, (cns[0] >> 32) + 1,
                     "ACGTX"[cns[0] & 3], "ACGTX"[(cns[0] >> 16) & 3],
                     g.vpos_shift + 1))
        for f in frags.values():
            if f.vpos:
                continue
            f.flip = 0
            if f.seq[0] == 0:
                f.phased = 0
            else:
                f.phased = 1
                f.phase = f.seq[0] - 1
        dump_aln(g, min_pos, frags)
        g.vpos_shift += 1
        return 1
    out.write("PS\t%s\t%d\t%d\n"
              % (chrom, (cns[0] >> 32) + 1, (cns[vpos - 1] >> 32) + 1))
    sitemask = np.zeros(vpos, np.int8)
    cnt = count_all(g.k, vpos, frags)
    path = dynaprog(g.k, vpos, cnt)
    pcnt = fragphase(vpos, path, frags, False)
    mask = genmask(vpos, pcnt)
    regmask = []
    for mv in mask:
        b_i = mv >> 32
        e_i = mv & 0xFFFFFFFF
        regmask.append(((cns[b_i] >> 32) << 32) | (cns[e_i] >> 32))
        for j in range(b_i, e_i + 1):
            sitemask[j] = 1
    if g.flag & FLAG_FIX_CHIMERA:
        pcnt = fragphase(vpos, path, frags, True)
    for rv in regmask:
        out.write("FL\t%s\t%d\t%d\n"
                  % (chrom, (rv >> 32) + 1, (rv & 0xFFFFFFFF) + 1))
    for i in range(vpos):
        x = int(pcnt[i])
        c0 = 4 if (cns[i] & 0xFFFF) >> 2 == 0 else (cns[i] & 3)
        c1 = 4 if ((cns[i] >> 16) & 0xFFFF) >> 2 == 0 \
            else ((cns[i] >> 16) & 3)
        cpair = [c0, c1]
        out.write("M%d\t%s\t%d\t%d\t%c\t%c\t%d\t%d\t%d\t%d\t%d\n"
                  % (sitemask[i] + 1, chrom, (cns[0] >> 32) + 1,
                     (cns[i] >> 32) + 1, "ACGTX"[cpair[path[i]]],
                     "ACGTX"[cpair[1 - path[i]]], i + g.vpos_shift + 1,
                     x & 0xFFFF, (x >> 16) & 0xFFFF, (x >> 32) & 0xFFFF,
                     (x >> 48) & 0xFFFF))
    seqs = [f for f in frags.values() if f.vpos < vpos and not f.single]
    seqs.sort(key=lambda f: f.vpos)
    for f in seqs:
        out.write("EV\t0\t%s\t%d\t40\t%dM\t*\t0\t0\t"
                  % (chrom, f.vpos + 1 + g.vpos_shift, f.vlen))
        chars = []
        for j in range(f.vlen):
            c = cns[f.vpos + j]
            if f.seq[j] == 0:
                chars.append("N")
            else:
                chars.append("ACGT"[(c & 3) if f.seq[j] == 1
                                    else ((c >> 16) & 3)])
        out.write("".join(chars))
        out.write("\t*\tYP:i:%d\tYF:i:%d\tYI:i:%d\tYO:i:%d\tYS:i:%d\n"
                  % (f.phase, f.flip, f.in_, f.out, f.beg + 1))
    out.write("//\n")
    g.vpos_shift += vpos
    dump_aln(g, min_pos, frags)
    return vpos


def update_vpos(vpos: int, frags: dict) -> None:
    for key in list(frags.keys()):
        f = frags[key]
        if f.vpos < vpos:
            del frags[key]
        else:
            f.vpos -= vpos


USAGE = """
Usage:   samtools phase [options] <in.bam>

Options: -k INT    block length [13]
         -b STR    prefix of BAMs to output [null]
         -q INT    min het phred-LOD [37]
         -Q, --min-BQ INT
                   min base quality in het calling [13]
         -D INT    max read depth [256]
         -F        do not attempt to fix chimeras
         -A        drop reads with ambiguous phase
         --no-PG   do not add a PG line

"""


def main_phase(argv: list[str], device=None) -> int:
    """``samtools phase``; ``device``: where K13 runs (None: the CUDA
    card; ``SAMTPU_DEVICE=0|host``: the host)."""
    from .. import SAMTOOLS_PARITY_VERSION
    ga = GlobalArgs()
    g = PhaseState()
    try:
        opts, args = gnu_getopt(argv, "Q:eFq:k:b:l:D:A",
                                ["min-BQ=", "min-bq=", "no-PG"])
    except UsageError:
        sys.stderr.write(USAGE)
        return 1
    for o, v in opts:
        if o == "-D":
            g.max_depth = int(v)
        elif o == "-q":
            g.min_varLOD = int(v)
        elif o in ("-Q", "--min-BQ", "--min-bq"):
            g.min_baseQ = int(v)
        elif o == "-k":
            g.k = int(v)
        elif o == "-F":
            g.flag &= ~FLAG_FIX_CHIMERA
        elif o == "-e":
            g.flag |= FLAG_LIST_EXCL
        elif o == "-A":
            g.flag |= FLAG_DROP_AMBI
        elif o == "-b":
            g.pre = v
        elif o == "-l":
            pass  # undocumented site list; not supported
        elif o == "--no-PG":
            g.no_pg = True
        elif handle_global_opt(ga, o, v):
            pass
        else:
            sys.stderr.write(USAGE)
            return 1
    if not args:
        sys.stderr.write(USAGE)
        return 1
    try:
        dev = pick_device(device)
    except RuntimeError as e:
        return no_card("phase", e)

    try:
        f = read_alignments(args[0], threads=ga.nthreads)
    except OSError as e:
        print_error_errno("phase", "Couldn't open '%s'", args[0], exc=e)
        return 1
    header = f.header
    b = f.batch

    skip = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
    keep = np.nonzero((b.flag & skip) == 0)[0]
    sub_all = b.take(keep)
    spans = sub_all.ref_span()
    has_cig = sub_all.n_cigar > 0
    g.batch = sub_all
    g.ends = sub_all.pos + np.where(has_cig, spans, 1)

    em = ErrMod(1.0 - 0.83)
    out = sys.stdout
    out.write("CC\n")
    out.write("CC\tDescriptions:\nCC\n")
    out.write("CC\t  CC      comments\n")
    out.write("CC\t  PS      start of a phase set\n")
    out.write("CC\t  FL      filtered region\n")
    out.write("CC\t  M[012]  markers; 0 for singletons, 1 for phased and"
              " 2 for filtered\n")
    out.write("CC\t  EV      supporting reads; SAM format\n")
    out.write("CC\t  //      end of a phase set\nCC\n")
    out.write("CC\tFormats of PS, FL and M[012] lines (1-based"
              " coordinates):\nCC\n")
    out.write("CC\t  PS  chr  phaseSetStart  phaseSetEnd\n")
    out.write("CC\t  FL  chr  filterStart    filterEnd\n")
    out.write("CC\t  M?  chr  PS  pos  allele0  allele1  hetIndex "
              " #supports0  #errors0  #supp1  #err1\n")
    out.write("CC\nCC\n")

    frags: dict[int, Frag] = {}
    cns: list[int] = []
    vpos = 0

    # contigs in order of first appearance
    seen = []
    for t in sub_all.tid:
        t = int(t)
        if t >= 0 and t not in seen:
            seen.append(t)
    for tid in seen:
        chrom = header.ref_name(tid)
        sel = np.nonzero(sub_all.tid == tid)[0]
        g.queue = [int(i) for i in sel]
        sub = sub_all.take(sel)
        sub_spans = sub.ref_span()
        sub_ends = sub.pos + np.where(sub_spans > 0, sub_spans, 1)
        pile = build_pileup(sub, dev)
        g.vpos_shift = 0
        frags.clear()
        cns = []
        vpos = 0
        ncols = len(pile.col_pos)
        for ci in range(ncols):
            pos = int(pile.col_pos[ci])
            s0 = int(pile.col_off[ci])
            e0 = int(pile.col_off[ci + 1])
            n = e0 - s0
            if n > g.max_depth:
                continue
            bases = []
            col = []
            for idx in range(s0, e0):
                if pile.is_del[idx] or pile.is_refskip[idx]:
                    continue
                rid = int(pile.rid[idx])
                qpos = int(pile.qpos[idx])
                baseQ = int(sub.qual[sub.seq_off[rid] + qpos])
                bb = int(_SEQ_NT16_INT[
                    int(sub.seq[sub.seq_off[rid] + qpos])])
                col.append((idx, rid, qpos, bb))
                if baseQ < g.min_baseQ or bb > 3:
                    continue
                mq = int(sub.mapq[rid])
                q = baseQ if baseQ < mq else mq
                q = max(4, min(q, 63))
                bases.append((q << 5)
                             | (int(bool(sub.flag[rid] & F.FREVERSE))
                                << 4) | bb)
            if not bases:
                continue
            q16 = em.cal(np.array(bases, np.uint16), 4)
            c = gl2cns(q16)
            if ((c & 0xFFFF) >> 2) < g.min_varLOD:
                continue
            if vpos >= len(cns):
                cns.extend([0] * 128)
            cns[vpos] = (pos << 32) | c
            dophase = True
            for idx, rid, qpos, bb in col:
                if pile.is_del[idx] or pile.is_refskip[idx]:
                    continue
                if int(sub.mapq[rid]) == 0:
                    continue
                cc = 1 if bb == (cns[vpos] & 3) else \
                    (2 if bb == ((cns[vpos] >> 16) & 3) else 0)
                key = x31_hash(bytes(
                    sub.qname[sub.qname_off[rid]:sub.qname_off[rid + 1]]))
                fobj = frags.get(key)
                if fobj is not None:
                    if vpos - fobj.vpos + 1 < MAX_VARS:
                        fobj.vlen = vpos - fobj.vpos + 1
                        fobj.seq[fobj.vlen - 1] = cc
                        fobj.end = int(sub_ends[rid])
                    dophase = False
                else:
                    fobj = frags[key] = Frag()
                    fobj.beg = int(sub.pos[rid])
                    fobj.end = int(sub_ends[rid])
                    fobj.vpos = vpos
                    fobj.vlen = 1
                    fobj.seq[0] = cc
            if dophase:
                if phase_block(g, out, chrom, vpos, cns, frags) < 0:
                    return 1
                update_vpos(vpos, frags)
                cns[0] = cns[vpos]
                vpos = 0
            vpos += 1
        # end of chromosome (phase.c:807-811; when vpos==0 queued reads
        # are not flushed — reference quirk preserved)
        phase_block(g, out, chrom, vpos, cns + [0], frags)
        g.queue = []
        frags.clear()
        out.flush()

    if g.pre:
        ext = "bam" if (ga.out_fmt or "bam") == "bam" else ga.out_fmt
        hdr = header
        if not g.no_pg:
            hdr = hdr.add_pg_line("samtools", "samtools",
                                  "samtools phase " + " ".join(argv),
                                  SAMTOOLS_PARITY_VERSION)
        for c, middle in ((0, "0"), (1, "1"), (2, "chimera")):
            name = "%s.%s.%s" % (g.pre, middle, ext)
            idxs = [ri for ri, _tag in g.routed[c]]
            outb = sub_all.take(np.array(idxs, np.int64)) if idxs \
                else sub_all.take(np.empty(0, np.int64))
            # append ZP:A:Y to phased reads
            tags = {ri for ri, tag in g.routed[c] if tag}
            if tags:
                parts = []
                for k2, ri in enumerate(idxs):
                    a = outb.aux_of(k2)
                    if ri in tags:
                        a = np.concatenate([
                            np.asarray(a, np.uint8),
                            np.frombuffer(b"ZPAY", np.uint8)])
                    parts.append(np.asarray(a, np.uint8))
                offs = np.zeros(len(parts) + 1, np.int64)
                for k2, p2 in enumerate(parts):
                    offs[k2 + 1] = offs[k2] + len(p2)
                outb.aux = (np.concatenate(parts) if parts
                            else np.empty(0, np.uint8))
                outb.aux_off = offs
            write_alignments(name, hdr, outb, fmt="bam")
    return 0
