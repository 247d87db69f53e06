"""Record sanitizing (samtools' bam_sanitize, bam_mate.c:372-527), as
``fixmate -z`` applies it.

Counterpart of samtools_tpu/core/sanitize.py (:1-275).  A vectorised
screen picks the records that bam_sanitize could change (a superset,
usually empty); only those take the per-record path, and the ragged
cigar and aux columns are rebuilt around them.  The flag bits are
samtools.h:35-45's.
"""

from __future__ import annotations

import numpy as np

from . import aux as auxmod
from . import flags as F
from .textutil import ragged_scatter

FIX_POS = 2
FIX_MQUAL = 4
FIX_UNMAP = 8
FIX_CIGAR = 16
FIX_AUX = 32
FIX_CIGDUP = 64
FIX_CIGARX = 128
FIX_ALL = 127


def parse_sanitize_options(s: str) -> int:
    opt = 0
    for word in s.split(","):
        w = word.strip()
        if not w:
            continue
        if w.startswith("all") or w.startswith("*"):
            opt = FIX_ALL
        elif w.startswith("none") or w.startswith("off"):
            opt = 0
        elif w.startswith("on"):
            opt = FIX_MQUAL | FIX_UNMAP | FIX_CIGAR | FIX_AUX
        elif w.startswith("pos"):
            opt |= FIX_POS
        elif w.startswith("mqual"):
            opt |= FIX_MQUAL
        elif w.startswith("unmap"):
            opt |= FIX_UNMAP
        elif w.startswith("cigdup"):
            opt |= FIX_CIGDUP
        elif w.startswith("cigarx"):
            opt |= FIX_CIGARX | FIX_CIGDUP
        elif w.startswith("cigar"):
            opt |= FIX_CIGAR
        elif w.startswith("aux"):
            opt |= FIX_AUX
        else:
            return -1
    return opt


def _trim_cigar(cigar: np.ndarray, pos: int, end: int):
    """bam_trim (bam_mate.c:266): clip ops past reference `end`.  The
    partial op is split into op + soft clip; non-H trailing ops (even D/N)
    merge their lengths into the soft clip; H ops pass through.  Returns
    (new_cigar, set_unmap)."""
    x = pos
    i = 0
    n = cigar.size
    op = oplen = 0
    while i < n:
        op = int(cigar[i]) & 0xF
        oplen = int(cigar[i]) >> 4
        if F.CIGAR_CONSUMES_REF[op]:
            x += oplen
            if x > end:
                break
        i += 1
    if i == n:
        return cigar, False
    out = [int(c) for c in cigar[:i]]
    tail = []
    if x - oplen < end:
        out.append(((end - (x - oplen)) << 4) | op)
        tail.append(((x - end) << 4) | F.CSOFT_CLIP)
    elif x > end:
        return cigar, True  # entirely off the chromosome -> unmapped
    else:
        tail.append((oplen << 4) | F.CSOFT_CLIP)
    for j in range(i + 1, n):
        o = int(cigar[j]) & 0xF
        ln = int(cigar[j]) >> 4
        if o == F.CHARD_CLIP:
            tail.append(int(cigar[j]))
        else:
            tail[-1] = (((tail[-1] >> 4) + ln) << 4) | F.CSOFT_CLIP
    return np.array(out + tail, np.uint32), False


def sanitize_record(flags_opt: int, flag: int, tid: int, pos: int,
                    cigar: np.ndarray, mapq: int, aux: np.ndarray,
                    ref_len: int):
    """Returns (flag, tid, pos, cigar, mapq, aux) sanitized."""
    if (flags_opt & FIX_POS) and tid < 0:
        pos = -1
        if flags_opt & FIX_UNMAP:
            flag |= F.FUNMAP

    if (flags_opt & FIX_CIGAR) and not (flag & F.FUNMAP):
        if pos < 0 and (flags_opt & FIX_UNMAP):
            flag |= F.FUNMAP
        else:
            if pos >= ref_len and (flags_opt & FIX_UNMAP):
                flag |= F.FUNMAP
                if flags_opt & FIX_POS:
                    tid = -1
                    pos = -1
            else:
                span = int(sum((int(c) >> 4) for c in cigar
                               if F.CIGAR_CONSUMES_REF[int(c) & 0xF]))
                if pos + max(span, 0) > ref_len:
                    cigar, unmap = _trim_cigar(cigar, pos, ref_len)
                    if unmap:
                        flag |= F.FUNMAP
                        flag &= ~F.FPROPER_PAIR

    if flag & F.FUNMAP:
        if (flags_opt & FIX_CIGAR) and cigar.size > 0:
            cigar = np.empty(0, np.uint32)
        if flags_opt & FIX_MQUAL:
            mapq = 0
        if flags_opt & FIX_AUX:
            aux = auxmod.delete_tags(aux, {"NM", "MD", "CG", "SM"})

    if (flags_opt & FIX_CIGARX) and not (flag & F.FUNMAP) and cigar.size:
        ops = cigar & 0xF
        cigar = np.where((ops == F.CEQUAL) | (ops == F.CDIFF),
                         (cigar & ~np.uint32(0xF)) | np.uint32(F.CMATCH),
                         cigar).astype(np.uint32)

    if (flags_opt & FIX_CIGDUP) and not (flag & F.FUNMAP) and cigar.size:
        out = []
        for c in cigar:
            c = int(c)
            ln = c >> 4
            if ln == 0:
                continue
            if out and (out[-1] & 0xF) == (c & 0xF) \
                    and ((out[-1] >> 4) + ln) < (1 << 28):
                out[-1] = (((out[-1] >> 4) + ln) << 4) | (c & 0xF)
            else:
                out.append(c)
        cigar = np.array(out, np.uint32)

    return flag, tid, pos, cigar, mapq, aux


def _sanitize_screen(batch, flags_opt: int,
                     ref_lens: np.ndarray) -> np.ndarray:
    """Vectorized superset mask of records bam_sanitize could alter —
    clean records (the overwhelming majority) skip the scalar path."""
    n = batch.n
    fl = batch.flag.astype(np.int64)
    tid = batch.tid.astype(np.int64)
    pos = batch.pos
    unm = (fl & F.FUNMAP) != 0
    rl = ref_lens[np.clip(tid, 0, ref_lens.size - 1)]
    rl = np.where(tid < 0, 0, rl)
    need = np.zeros(n, bool)
    if flags_opt & FIX_POS:
        need |= (tid < 0) & ((pos != -1)
                             | (bool(flags_opt & FIX_UNMAP) & ~unm))
    if flags_opt & FIX_CIGAR:
        span = batch.ref_span()
        need |= (~unm) & ((pos < 0) | (pos >= rl)
                          | (pos + np.maximum(span, 0) > rl))
    ncig = batch.cigar_off[1:] - batch.cigar_off[:-1]
    aux_sus = np.zeros(n, bool)
    if (flags_opt & FIX_AUX) and batch.aux.size >= 2:
        a = batch.aux
        for t in (b"NM", b"MD", b"CG", b"SM"):
            h = np.flatnonzero((a[:-1] == t[0]) & (a[1:] == t[1]))
            if h.size:
                rows = np.searchsorted(batch.aux_off, h,
                                       side="right") - 1
                aux_sus[rows[(rows >= 0) & (rows < n)]] = True
    need |= unm & (
        (bool(flags_opt & FIX_CIGAR) & (ncig > 0))
        | (bool(flags_opt & FIX_MQUAL) & (batch.mapq != 0))
        | (bool(flags_opt & FIX_AUX) & aux_sus))
    if (flags_opt & (FIX_CIGARX | FIX_CIGDUP)) and batch.cigar.size:
        ops = batch.cigar & np.uint32(0xF)
        hit = np.zeros(batch.cigar.size, bool)
        if flags_opt & FIX_CIGARX:
            hit |= (ops == F.CEQUAL) | (ops == F.CDIFF)
        if flags_opt & FIX_CIGDUP:
            hit |= (batch.cigar >> 4) == 0
            adj = ops[1:] == ops[:-1]
            # exclude cross-row adjacency
            row_end = np.zeros(batch.cigar.size - 1, bool) \
                if batch.cigar.size > 1 else np.empty(0, bool)
            if batch.cigar.size > 1:
                ends = batch.cigar_off[1:-1] - 1
                ends = ends[(ends >= 0) & (ends < row_end.size)]
                row_end[ends] = True
                hit[1:] |= adj & ~row_end
        hrows = np.searchsorted(batch.cigar_off,
                                np.flatnonzero(hit), side="right") - 1
        m = np.zeros(n, bool)
        m[hrows[(hrows >= 0) & (hrows < n)]] = True
        need |= (~unm) & m
    return need


def sanitize_batch(batch, header, flags_opt: int):
    """Apply bam_sanitize to every record, rebuilding ragged columns.

    A vectorized screen routes only potentially-affected records (a
    superset, usually empty) through the per-record scalar path."""
    if flags_opt == 0 or batch.n == 0:
        return batch
    ref_lens = np.array(header.ref_lens + [0], np.int64)
    rows = np.nonzero(_sanitize_screen(batch, flags_opt, ref_lens))[0]
    if rows.size == 0:
        return batch
    new_cig = {}
    new_aux = {}
    for i in rows:
        i = int(i)
        tid = int(batch.tid[i])
        rl = int(ref_lens[tid]) if tid >= 0 else 0
        flag, tid2, pos, cig, mapq, aux = sanitize_record(
            flags_opt, int(batch.flag[i]), tid, int(batch.pos[i]),
            batch.cigar_of(i), int(batch.mapq[i]), batch.aux_of(i), rl)
        batch.flag[i] = flag
        batch.tid[i] = tid2
        batch.pos[i] = pos
        batch.mapq[i] = mapq
        if cig.size != batch.n_cigar[i] \
                or not np.array_equal(cig, batch.cigar_of(i)):
            new_cig[i] = cig
        if aux.size != batch.aux_of(i).size:
            new_aux[i] = aux
    if new_cig:
        _splice_rows(batch, "cigar", "cigar_off", new_cig, np.uint32)
    if new_aux:
        _splice_rows(batch, "aux", "aux_off", new_aux, np.uint8)
    return batch


def _splice_rows(batch, flat_name, off_name, repl: dict, dtype):
    """Replace the ragged payloads of selected rows, keeping the rest."""
    n = batch.n
    off = getattr(batch, off_name)
    flat = getattr(batch, flat_name)
    row_len = off[1:] - off[:-1]
    new_len = row_len.copy()
    for i, p in repl.items():
        new_len[i] = len(p)
    noff = np.zeros(n + 1, np.int64)
    np.cumsum(new_len, out=noff[1:])
    nflat = np.empty(int(noff[-1]), dtype)
    keep = np.ones(n, bool)
    keep[np.fromiter(repl, np.int64, len(repl))] = False
    kr = np.nonzero(keep)[0]
    ragged_scatter(nflat, noff[kr], row_len[kr], flat, off[:-1][kr])
    for i, p in repl.items():
        nflat[noff[i]:noff[i] + len(p)] = p
    setattr(batch, flat_name, nflat)
    setattr(batch, off_name, noff)
