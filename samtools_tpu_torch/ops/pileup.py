"""Columnar pileup builder and its stable order on the card (K13).

Counterpart of samtools_tpu/ops/pileup.py (``Pileup``, ``build_pileup``
:66, ``_device_stable_order`` :167, ``_finish`` :199-232).  In place of
htslib's per-read pileup cursors, one vectorized pass expands the
sub-batch's CIGARs into a flat entry table (one row per read per covered
reference position), which is then put in (position, arrival) order.
mpileup's rows and ``coverage -m/-D`` walk columns as slices of it.

Entry semantics are bam_pileup1_t's: qpos (the query index of the base,
or of the next base inside a deletion), is_del / is_refskip, is_head /
is_tail, and indel (+len insertion / -len deletion, anchored at the
column before the event).

K13, the order, is a stable argsort of int32 window-relative positions:
``torch.sort(stable=True)`` on the card (``stable_order``), whose plain
version is ``np.argsort(kind="stable")``.  Where a window's span passes
int32, the host's stable sort of the int64 positions takes over, as in
the JAX package.  The JAX package keeps this sort on the host unless its
device is forced (a rule made for a slow TPU link); here it runs on the
card whenever the command does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..core import flags as F
from ..core import metrics
from ..core.batch import ragged_gather_indices
from ..device import h2d
from .cigar import expand_ops

# ref-consuming ops that make pileup entries
_ENTRY_OPS = (F.CMATCH, F.CDEL, F.CREF_SKIP, F.CEQUAL, F.CDIFF)


@dataclass
class Pileup:
    """Flat entry table in (pos, read arrival) order."""
    n_entries: int
    pos: np.ndarray        # int64 reference position
    rid: np.ndarray        # int32 read index within the sub-batch
    qpos: np.ndarray       # int32 query offset
    is_del: np.ndarray     # bool
    is_refskip: np.ndarray
    is_head: np.ndarray
    is_tail: np.ndarray
    indel: np.ndarray      # int32, + insertion len / - deletion len
    # per anchor entry (indel > 0 only): (insertion string, upper case with
    # '*' pads, the deletion that follows it, the query offset of each
    # character with -1 for pads), for mpileup's -M insertion mods
    ins: dict = field(default_factory=dict)
    # column boundaries: sorted unique positions and each one's first entry
    col_pos: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    col_off: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    # the (pos, arrival) permutation ``_finish`` applied
    order: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))


_ENTRY_LUT = np.zeros(16, bool)
for _o in _ENTRY_OPS:
    _ENTRY_LUT[_o] = True
_M_LUT = np.zeros(16, bool)
for _o in (F.CMATCH, F.CEQUAL, F.CDIFF):
    _M_LUT[_o] = True


def build_pileup(sub, device=None) -> Pileup:
    """The pileup table of one contig's reads (in file order).  ``device``
    is where K13 orders the entries: a torch device (the CPU takes its
    plain version), or None for the host branch's numpy sort."""
    t = expand_ops(sub)
    emit = _ENTRY_LUT[t.op]
    lens = np.where(emit, t.oplen, 0)
    total = int(lens.sum())
    if total == 0:
        return Pileup(0, *(np.empty(0, np.int64) for _ in range(3)),
                      *(np.empty(0, bool) for _ in range(4)),
                      np.empty(0, np.int64))

    # entry start per op (op order == read order == file order)
    entry_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    e_ops = np.nonzero(emit)[0]
    e_len = t.oplen[e_ops]
    pos = ragged_gather_indices(t.rpos[e_ops], e_len)
    rid = np.repeat(t.rid[e_ops].astype(np.int32), e_len)
    is_m_e = np.repeat(_M_LUT[t.op[e_ops]], e_len)
    # query pos: advancing within M ops, frozen at the op start in D/N
    qpos_adv = ragged_gather_indices(t.qpos[e_ops], e_len)
    qpos_frozen = np.repeat(t.qpos[e_ops], e_len)
    qpos = np.where(is_m_e, qpos_adv, qpos_frozen).astype(np.int32)
    is_del = ~is_m_e
    is_refskip = np.repeat(t.op[e_ops] == F.CREF_SKIP, e_len)

    end = sub.end_pos()
    is_head = pos == sub.pos[rid]
    is_tail = pos == end[rid] - 1

    indel = np.zeros(total, np.int32)
    ins: dict = {}
    last_entry_of_op = entry_start + lens - 1  # valid where emit
    seq_chars = np.frombuffer(F.SEQ_NT16_STR.encode(), np.uint8)

    # indel events: between two consecutive emitting ops of a read, the
    # run of non-emitting ops anchors at the last entry of the first.  A
    # run holding I is an insertion whose string covers the whole run (I
    # bases, '*' per pad: the padded-reference grammar of pileup_seq and
    # bam_plp_insertion), with a following D as its del_after; an empty or
    # pad-only run before a D is a plain deletion (-dlen).  N never makes
    # an indel.
    indel_reads = np.unique(t.rid[np.isin(t.op, (F.CINS, F.CDEL))])
    for r in indel_reads:
        k0 = int(t.op_off[r])
        k1 = int(t.op_off[r + 1])
        emit_ks = [k for k in range(k0, k1) if emit[k]]
        for ei, p in enumerate(emit_ks):
            q = emit_ks[ei + 1] if ei + 1 < len(emit_ks) else None
            run = range(p + 1, q if q is not None else k1)
            if not len(run):
                # adjacent emitting ops: a direct deletion
                if q is not None and t.op[q] == F.CDEL:
                    indel[int(last_entry_of_op[p])] = -int(t.oplen[q])
                continue
            parts = []
            qlist: list[int] = []
            has_ins = False
            for j in run:
                o = int(t.op[j])
                if o == F.CINS:
                    has_ins = True
                    q0 = int(t.qpos[j])
                    bases = sub.seq[sub.seq_off[r] + q0:
                                    sub.seq_off[r] + q0 + int(t.oplen[j])]
                    if bases.size:
                        parts.append(bytes(seq_chars[bases]).decode("latin-1"))
                    else:
                        parts.append("N" * int(t.oplen[j]))
                    qlist.extend(range(q0, q0 + int(t.oplen[j])))
                elif o == F.CPAD:
                    parts.append("*" * int(t.oplen[j]))
                    qlist.extend([-1] * int(t.oplen[j]))
                else:  # S/H end the event scan
                    break
            anchor = int(last_entry_of_op[p])
            if has_ins:
                del_after = (int(t.oplen[q])
                             if q is not None and t.op[q] == F.CDEL else 0)
                sstr = "".join(parts)
                indel[anchor] = len(sstr)
                ins[anchor] = (sstr, del_after, qlist)
            elif q is not None and t.op[q] == F.CDEL:
                indel[anchor] = -int(t.oplen[q])
    return _finish(Pileup(total, pos, rid, qpos, is_del, is_refskip, is_head,
                          is_tail, indel, ins), device)


def stable_order_plain(keys: np.ndarray) -> np.ndarray:
    """K13's plain version: the stable argsort of int32 keys (int64)."""
    return np.argsort(keys, kind="stable")


def stable_order(keys: torch.Tensor) -> torch.Tensor:
    """K13: the stable argsort of int32 keys int32[n] -> int64[n] (equal
    keys keep their input order).  A CPU tensor takes the plain version;
    a CUDA tensor runs ``torch.sort(stable=True)`` on the card."""
    kernels.check(keys, "keys", torch.int32, (None,))
    if not kernels.on_card(keys):
        return torch.from_numpy(stable_order_plain(keys.numpy()))
    order = torch.sort(keys, stable=True).indices
    kernels.launches["stable_order"] += 1
    return order


def entry_order(pos: np.ndarray, device=None) -> np.ndarray:
    """The (pos, arrival) order of entry positions ``pos`` (int64):
    window-relative int32 keys through K13 on ``device``, or the host's
    numpy sort of them where ``device`` is None.  Where the span or the
    count passes int32, the host's stable sort of the int64 positions."""
    n = pos.size
    base = int(pos.min())
    if int(pos.max()) - base >= (1 << 31) - 1 or n >= 1 << 31:
        return np.argsort(pos, kind="stable")
    keys = (pos - base).astype(np.int32)
    if device is None:
        return stable_order_plain(keys)
    # int32 indices cross the link, half of torch.sort's int64
    order = stable_order(h2d(keys, torch.device(device))).to(torch.int32)
    return order.cpu().numpy().astype(np.int64)


def _finish(p: Pileup, device) -> Pileup:
    if p.n_entries == 0:
        return p
    if device is None:
        order = entry_order(p.pos, device)
    else:
        with metrics.stage("device.pileup_sort", p.n_entries, "entries"):
            order = entry_order(p.pos, device)
    for f in ("pos", "rid", "qpos", "is_del", "is_refskip", "is_head",
              "is_tail", "indel"):
        setattr(p, f, getattr(p, f)[order])
    p.order = order
    if p.ins:
        inv = np.empty(p.n_entries, np.int64)
        inv[order] = np.arange(p.n_entries)
        p.ins = {int(inv[k]): v for k, v in p.ins.items()}
    # column boundaries from the sorted key run ends
    bnd = np.flatnonzero(np.diff(p.pos)) + 1
    p.col_pos = p.pos[np.concatenate(([0], bnd))]
    p.col_off = np.concatenate(([0], bnd, [p.n_entries]))
    return p
