"""SOLiD color-space aux accessors (samtools' bam_color.c) for tview's
color-space view (the ``c`` key of its curses display): a base's color
from the CS tag, and the corrected-color mismatch view.  Counterpart of
samtools_tpu/core/colorspace.py less ``get_cqi``, which tview does not
call.  Operates on a ReadBatch row."""

from __future__ import annotations

from . import aux as auxmod
from . import flags as F

_SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"


def _tag_z(batch, i: int, tag: str):
    v = auxmod.get_value(batch.aux_of(i), tag)
    if v is None or v[0] != "Z":
        return None
    return v[1]


def _adjust(batch, i: int, k: int, s: str) -> int:
    """Strand/hard-clip index adjustment (bam_aux_getCSi semantics)."""
    if batch.flag[i] & F.FREVERSE:
        k = len(s) - 1 - k
        cig = batch.cigar_of(i)
        if cig.size and (int(cig[0]) & 0xF) == F.CHARD_CLIP:
            k -= int(cig[0]) >> 4
    else:
        k += 1
    return k


def get_csi(batch, i: int, k: int) -> str:
    """Color encoding the previous and current base ('' if no CS)."""
    cs = _tag_z(batch, i, "CS")
    if cs is None:
        return ""
    j = _adjust(batch, i, k, cs)
    return cs[j] if 0 <= j < len(cs) else ""


def nt2int(a: str) -> int:
    return {"A": 0, "C": 1, "G": 2, "T": 3}.get(a.upper(), 4)


def ntnt2cs(a: str, b: str) -> str:
    ia, ib = nt2int(a), nt2int(b)
    if ia == 4 or ib == 4:
        return "4"
    return "0123"[ia ^ ib]


def get_cei(batch, i: int, k: int) -> str:
    """Corrected-color view: '-' when the stored color matches the
    color implied by the called bases, the stored color otherwise."""
    cs = _tag_z(batch, i, "CS")
    if cs is None:
        return ""

    def base_at(q: int) -> str:
        code = int(batch.seq[batch.seq_off[i] + q])
        return _SEQ_NT16_STR[code]

    if batch.flag[i] & F.FREVERSE:
        cs_i = len(cs) - 1 - k
        cig = batch.cigar_of(i)
        if cig.size and (int(cig[0]) & 0xF) == F.CHARD_CLIP:
            cs_i -= int(cig[0]) >> 4
        if not (0 <= cs_i < len(cs)):
            return ""
        cur_color = cs[cs_i]
        lq = int(batch.seq_off[i + 1] - batch.seq_off[i])
        if cs_i == 1:
            prev_b = "TGCAN"[nt2int(cs[0])]
        elif k + 1 < lq:
            prev_b = base_at(k + 1)
        else:
            return ""
        cur_b = base_at(k)
    else:
        cs_i = k + 1
        if not (0 <= cs_i < len(cs)):
            return ""
        cur_color = cs[cs_i]
        prev_b = cs[0] if k == 0 else base_at(k - 1)
        cur_b = base_at(k)
    cor = ntnt2cs(prev_b, cur_b)
    return "-" if cur_color == cor else cur_color
