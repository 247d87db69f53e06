"""Sort-order keys for the columnar batch.

Counterpart of samtools_tpu/ops/sort_keys.py (:1-318); samtools'
bam_sort.c orders: coordinate (tid, pos, strand; unmapped last, :2402),
queryname (the natural-number compare ``strnum_cmp``, :172, then
READ1 < READ2 < PRIMARY < SUPPLEMENTARY < SECONDARY), by tag value
(:2073) and template-coordinate (:2193).  Every order is a stable
``np.lexsort`` over integer key columns (stability is samtools'
tie-break by input index); names are ranked once per distinct value.
"""

from __future__ import annotations

import functools
import re

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F


def is_digit(c: int) -> bool:
    return 0x30 <= c <= 0x39


def strnum_cmp(a: bytes, b: bytes) -> int:
    """bam_sort.c strnum_cmp natural-number comparator."""
    ia = ib = 0
    la, lb = len(a), len(b)
    while ia < la and ib < lb:
        ca, cb = a[ia], b[ib]
        if not (is_digit(ca) and is_digit(cb)):
            if ca != cb:
                return ca - cb
            ia += 1
            ib += 1
        else:
            while ia < la and a[ia] == 0x30:
                ia += 1
            while ib < lb and b[ib] == 0x30:
                ib += 1
            while (ia < la and ib < lb and is_digit(a[ia])
                   and is_digit(b[ib]) and a[ia] == b[ib]):
                ia += 1
                ib += 1
            diff = (a[ia] if ia < la else 0) - (b[ib] if ib < lb else 0)
            adig = ia < la and is_digit(a[ia])
            bdig = ib < lb and is_digit(b[ib])
            if adig and bdig:
                # scan to end of both numbers
                while ia < la and ib < lb and is_digit(a[ia]) \
                        and is_digit(b[ib]):
                    ia += 1
                    ib += 1
                adig = ia < la and is_digit(a[ia])
                bdig = ib < lb and is_digit(b[ib])
            if adig:
                return 1
            if bdig:
                return -1
            if diff:
                return diff
    ca = a[ia] if ia < la else 0
    cb = b[ib] if ib < lb else 0
    return 1 if ca else (-1 if cb else 0)


def name_ranks(batch, natural: bool = True) -> np.ndarray:
    """Rank of each record's qname under the chosen name order."""
    names = np.empty(batch.n, object)
    qf = batch.qname.tobytes()
    off = batch.qname_off
    for i in range(batch.n):
        names[i] = qf[off[i]:off[i + 1]]
    uniq = sorted(set(names.tolist()),
                  key=functools.cmp_to_key(strnum_cmp) if natural else None)
    rank = {n: i for i, n in enumerate(uniq)}
    return np.array([rank[n] for n in names], np.int64)


def qname_flag_key(batch) -> np.ndarray:
    """READ1 < READ2 < PRIMARY < SUPPLEMENTARY < SECONDARY flag key."""
    f = batch.flag.astype(np.int64)
    return ((f & 0xC0) << 8) | ((f & 0x100) << 3) | ((f & 0x800) >> 3)


def coordinate_keys(batch) -> tuple:
    """Lexsort key columns (least->most significant) for SO:coordinate:
    (rev, pos, tid with -1 last)."""
    tid = batch.tid.astype(np.int64)
    tid = np.where(tid < 0, np.iinfo(np.int64).max, tid)
    rev = (batch.flag.astype(np.int64) & F.FREVERSE) != 0
    return (rev, batch.pos, tid)


def coordinate_order(batch) -> np.ndarray:
    """Stable order for SO:coordinate: (tid with -1 last, pos, rev)."""
    return np.lexsort(coordinate_keys(batch))


def coordinate_pack(batch) -> np.ndarray | None:
    """Single radix-sortable uint64 per record for SO:coordinate —
    the bam_sort.c:2436 packed-key formulation: tid(30) | pos+1(32) |
    rev(1), unmapped (tid<0) in the all-ones tid field so it sorts
    last.  None when the ranges don't fit (>2^30 contigs or >2^32-2
    positions, where samtools itself spills through SAM)."""
    tid = batch.tid.astype(np.int64)
    pos = batch.pos.astype(np.int64)
    if batch.n and (tid.max(initial=0) >= (1 << 30) - 1
                    or pos.max(initial=0) >= (1 << 32) - 1
                    or pos.min(initial=0) < -1):
        return None
    tidf = np.where(tid < 0, (1 << 30) - 1, tid).astype(np.uint64)
    rev = ((batch.flag.astype(np.uint64) & F.FREVERSE) != 0)
    return (tidf << np.uint64(33)) \
        | ((pos + 1).astype(np.uint64) << np.uint64(1)) \
        | rev.astype(np.uint64)


def queryname_keys(batch, natural: bool = True) -> tuple:
    return (qname_flag_key(batch), name_ranks(batch, natural))


def queryname_order(batch, natural: bool = True) -> np.ndarray:
    return np.lexsort(queryname_keys(batch, natural))


def _core_key(batch, queryname: bool, natural: bool):
    """bam1_cmp_core fallback keys."""
    if queryname:
        return (qname_flag_key(batch), name_ranks(batch, natural))
    tid = batch.tid.astype(np.uint64)  # -1 wraps to max (C cast semantics)
    pos = (batch.pos + 1).astype(np.uint64)
    rev = ((batch.flag.astype(np.int64) & F.FREVERSE) != 0)
    # C compares tid, then pos, then rev
    return (rev, pos, tid)


def tag_order(batch, tag: str, queryname: bool,
              natural: bool = True) -> np.ndarray:
    return np.lexsort(tag_keys(batch, tag, queryname, natural))


def tag_keys(batch, tag: str, queryname: bool, natural: bool = True) -> tuple:
    """Key columns for ordering by aux tag value (bam1_cmp_by_tag):
    records without the tag first, then grouped by normalized type, then
    value, falling back to cmp_core."""
    vals = [auxmod.get_value(batch.aux_of(i), tag) for i in range(batch.n)]
    has = np.array([v is not None for v in vals])

    def norm(v):
        t, x = v
        if t in "cCsSiI":
            return ("c", float(x), "")
        if t in "fd":
            return ("f", float(x), "")
        if t == "A":
            return ("A", float(ord(x)), "")
        if t in "ZH":
            return ("Z", 0.0, x)
        return ("~", 0.0, "")

    type_key = np.zeros(batch.n, np.int64)
    num_key = np.zeros(batch.n, np.float64)
    str_vals = np.empty(batch.n, object)
    str_vals[:] = ""
    for i, v in enumerate(vals):
        if v is None:
            continue
        t, x, s = norm(v)
        # mismatched normalized types compare by their ASCII char
        # (normalize_type: ints->'c', floats->'f', strings->'H', char 'A');
        # int-vs-float pairs compare by value, so merge their ranks
        type_key[i] = {"c": ord("c"), "f": ord("c"), "A": ord("A"),
                       "Z": ord("H"), "~": 126}[t]
        num_key[i] = x
        str_vals[i] = s
    str_rank_map = {s: r for r, s in enumerate(sorted(set(str_vals.tolist())))}
    str_key = np.array([str_rank_map[s] for s in str_vals], np.int64)
    core = _core_key(batch, queryname, natural)
    # primary: records without the tag first (bam1_cmp_by_tag NULL rule)
    return core + (str_key, num_key, type_key, has)


# ------------------------------------------------------- unclipped coords

def unclipped_start(batch, hard: bool = False) -> np.ndarray:
    """bam.c:163 unclipped_start: pos - leading soft clips (+hard if
    ``hard``) + 1.  Leading H ops are skipped without terminating."""
    out = batch.pos.astype(np.int64) + 1
    for i in range(batch.n):
        for c in batch.cigar_of(i):
            op = c & 0xF
            if op == F.CSOFT_CLIP or (hard and op == F.CHARD_CLIP):
                out[i] -= c >> 4
            elif op != F.CHARD_CLIP:
                break
    return out


def unclipped_end(batch, hard: bool = False) -> np.ndarray:
    """bam.c:211 unclipped_end: bam_endpos + trailing soft clips (+hard
    if ``hard``)."""
    out = batch.end_pos().astype(np.int64).copy()
    for i in range(batch.n):
        for c in batch.cigar_of(i)[::-1]:
            op = c & 0xF
            if op == F.CSOFT_CLIP or (hard and op == F.CHARD_CLIP):
                out[i] += c >> 4
            elif op != F.CHARD_CLIP:
                break
    return out


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=XB])")


def _parse_text_cigar(cigar: str):
    return [(int(n), c) for n, c in _CIG_RE.findall(cigar)]


def unclipped_other_start(op_pos: int, cigar: str, hard: bool = False) -> int:
    """bam.c:184: mate unclipped start from MC cigar (1-based-ish:
    op - clips + 1)."""
    clipped = 0
    for n, c in _parse_text_cigar(cigar):
        if c == "S" or (hard and c == "H"):
            clipped += n
        elif c != "H":
            break
    return op_pos - clipped + 1


def unclipped_other_end(op_pos: int, cigar: str, hard: bool = False) -> int:
    """bam.c:240: mate unclipped end = op + ref span + non-leading clips."""
    refpos = 0
    skip = True
    for n, c in _parse_text_cigar(cigar):
        if c in "MDN=X":
            refpos += n
            skip = False
        elif c == "S":
            if not skip:
                refpos += n
        elif c == "H":
            if not skip and hard:
                refpos += n
    return op_pos + refpos


def template_coordinate_order(batch, header) -> np.ndarray:
    keys = template_coordinate_keys(batch, header)
    order = sorted(range(batch.n), key=lambda i: keys[i])
    return np.array(order, np.int64) if order else np.empty(0, np.int64)


def template_coordinate_keys(batch, header) -> list:
    """TemplateCoordinate python-tuple keys (bam_sort.c:2193
    template_coordinate_key + :2285 comparator); ties resolved by the
    caller's stable sort."""
    lib_map = {}
    for line in header.lines():
        if line.startswith("@RG"):
            rid = lb = None
            for fseg in line.split("\t")[1:]:
                if fseg.startswith("ID:"):
                    rid = fseg[3:]
                elif fseg.startswith("LB:"):
                    lb = fseg[3:]
            if rid is not None and lb is not None:
                lib_map[rid] = lb
    ustart = unclipped_start(batch)
    uend = unclipped_end(batch)
    fl = batch.flag.astype(np.int64)
    INT32MAX = np.iinfo(np.int32).max
    POSMAX = (1 << 62)
    keys = []
    for i in range(batch.n):
        tid1 = tid2 = INT32MAX
        pos1 = pos2 = POSMAX
        neg1 = neg2 = False
        if not (fl[i] & F.FUNMAP):
            tid1 = int(batch.tid[i])
            neg1 = bool(fl[i] & F.FREVERSE)
            pos1 = int(uend[i]) if neg1 else int(ustart[i])
        if (fl[i] & F.FPAIRED) and not (fl[i] & F.FMUNMAP):
            got = auxmod.get_value(batch.aux_of(i), "MC")
            if got is None or got[0] != "Z":
                raise ValueError(
                    "no MC tag. Please run samtools fixmate on file first.")
            tid2 = int(batch.mtid[i])
            neg2 = bool(fl[i] & F.FMREVERSE)
            mp = int(batch.mpos[i])
            pos2 = (unclipped_other_end(mp, got[1]) if neg2
                    else unclipped_other_start(mp, got[1]))
        rg = auxmod.get_value(batch.aux_of(i), "RG")
        lib = lib_map.get(rg[1], "") if rg is not None and rg[0] == "Z" \
            else ""
        cb = auxmod.get_value(batch.aux_of(i), "CB")
        cid = cb[1] if cb is not None and cb[0] == "Z" else ""
        mi = auxmod.get_value(batch.aux_of(i), "MI")
        mid = mi[1] if mi is not None and mi[0] == "Z" else ""
        if len(mid) >= 2 and mid[-2] == "/":
            mid = mid[:-2]
        name = batch.qname_str(i)
        upper = not (tid1 < tid2
                     or (tid1 == tid2 and pos1 < pos2)
                     or (tid1 == tid2 and pos1 == pos2 and not neg1))
        if upper:
            tid1, tid2 = tid2, tid1
            pos1, pos2 = pos2, pos1
            neg1, neg2 = neg2, neg1
        keys.append((tid1, tid2, pos1, pos2,
                     0 if neg1 else 1, 0 if neg2 else 1,
                     lib, cid, mid, name, 1 if upper else 0))
    return keys
