"""Base-modification (MM/ML tag) decoding for mpileup's ``-M``.

Counterpart of samtools_tpu/ops/basemods.py: htslib's base-mods API as
mpileup consumes it (bam_plcmd.c's ``[{+-}{code}{qual}]`` annotations
after a base, and the annotated insertion strings).

MM grammar (SAM tags spec 1.7):
    MM:Z:([ACGTUN][-+]([a-z]+|[0-9]+)[.?]?(,[0-9]+)*;)*
Deltas count skipped bases of the fundamental type in the original
(pre-alignment) read orientation, so a reverse-strand record walks the
stored sequence from its 3' end with complemented bases.  ML holds one
uint8 per (position, code) pair, position-major in MM order.
"""

from __future__ import annotations

import numpy as np

from ..core import aux as auxmod
from ..core import flags as F

_COMP = str.maketrans("ACGTUMRWSYKVHDBN", "TGCAAKYWSRMBDHVN")


def parse_mm(seq_letters: str, is_rev: bool, mm: str, ml) -> dict:
    """One read's MM/ML as {qpos: [(strand, code, qual), ...]}.

    ``code`` is a 1-char str for standard codes or an int for ChEBI ids;
    ``qual`` is the raw ML byte, or -1 when ML is absent or short.  The
    list order per qpos is MM order (items, then codes within an item),
    as hts_base_mods iterates."""
    mods: dict[int, list] = {}
    if not mm:
        return mods
    L = len(seq_letters)
    orig = (seq_letters[::-1].translate(_COMP) if is_rev else seq_letters)
    orig = orig.upper()
    mli = 0
    nml = 0 if ml is None else len(ml)
    for item in mm.split(";"):
        if len(item) < 2:
            continue
        base = item[0].upper()
        if base == "U":
            base = "T"
        strand = item[1]
        if strand not in "+-":
            continue
        k = 2
        codes: list = []
        if k < len(item) and item[k].isdigit():
            j = k
            while j < len(item) and item[j].isdigit():
                j += 1
            codes = [int(item[k:j])]
            k = j
        else:
            while k < len(item) and item[k].isalpha():
                codes.append(item[k])
                k += 1
        if k < len(item) and item[k] in ".?":
            k += 1
        deltas = ([int(x) for x in item[k + 1:].split(",")]
                  if k < len(item) and item[k] == "," else [])
        idx = -1
        for d in deltas:
            skipped = 0
            while True:
                idx += 1
                if idx >= L:
                    break
                b = orig[idx]
                if base == "N" or b == base:
                    if skipped == d:
                        break
                    skipped += 1
            if idx >= L:
                mli += len(codes)
                continue
            qpos = L - 1 - idx if is_rev else idx
            lst = mods.setdefault(qpos, [])
            for c in codes:
                qual = int(ml[mli]) if mli < nml else -1
                mli += 1
                lst.append((strand, c, qual))
    return mods


def format_mods(lst) -> str:
    """One position's mods as ``[+m128-h6...]`` (pileup_seq's grammar)."""
    parts = ["["]
    for strand, code, qual in lst:
        q = str(qual) if qual >= 0 else ""
        if isinstance(code, int):
            parts.append("%s(%d)%s" % (strand, code, q))
        else:
            parts.append("%s%s%s" % (strand, code, q))
    parts.append("]")
    return "".join(parts)


def batch_mods(sub, rids) -> dict:
    """{rid: {qpos: mods}} for the given read ids (a read without MM, or
    with an empty or invalid one, has no entry)."""
    out: dict[int, dict] = {}
    seq_chars = F.SEQ_NT16_STR
    for r in np.unique(np.asarray(rids, np.int64)):
        r = int(r)
        buf = sub.aux_of(r)
        mm = auxmod.get_value(buf, "MM")
        if mm is None:
            mm = auxmod.get_value(buf, "Mm")
        if isinstance(mm, tuple):  # (type char, value)
            mm = mm[1] if mm[0] == "Z" else None
        if not isinstance(mm, str) or not mm:
            continue
        ml = auxmod.get_value(buf, "ML")
        if ml is None:
            ml = auxmod.get_value(buf, "Ml")
        if isinstance(ml, tuple):
            ml = ml[1] if ml[0] == "B" else None
        if isinstance(ml, tuple) and len(ml) == 2:
            ml = ml[1]  # a B array decodes to (subtype, values)
        if ml is not None and not hasattr(ml, "__len__"):
            ml = None
        codes = sub.seq[sub.seq_off[r]:sub.seq_off[r] + int(sub.l_qseq[r])]
        letters = "".join(seq_chars[c] for c in codes)
        is_rev = bool(sub.flag[r] & F.FREVERSE)
        m = parse_mm(letters, is_rev, mm, ml)
        if m:
            out[r] = m
    return out
