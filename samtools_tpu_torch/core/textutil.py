"""Bulk text primitives: decimal rendering, ragged scatters and CIGAR
strings for a whole batch, with no loop a row.

Counterpart of samtools_tpu/core/textutil.py (:1-89); ``fixmate`` builds
its MC tags with ``cigar_strs`` and splices aux payloads with
``ragged_scatter``.
"""

from __future__ import annotations

import numpy as np

from .batch import ragged_gather_indices


def itoa(vals: np.ndarray):
    """Vectorized non-negative decimal rendering.

    Returns (flat uint8 digits, digit counts int64, offsets int64[n+1])."""
    v = np.asarray(vals, np.int64)
    nd = np.ones(v.size, np.int64)
    t = 10
    while t <= (int(v.max()) if v.size else 0):
        nd[v >= t] += 1
        t *= 10
    off = np.zeros(v.size + 1, np.int64)
    np.cumsum(nd, out=off[1:])
    flat = np.empty(int(off[-1]), np.uint8)
    end = off[1:] - 1
    rem = v.copy()
    for d in range(int(nd.max(initial=0))):
        act = nd > d
        flat[end[act] - d] = 48 + (rem[act] % 10)
        rem[act] //= 10
    return flat, nd, off


def ragged_scatter(buf, cur, lens, src_flat, src_off):
    """buf[cur[i] : cur[i]+lens[i]] = src_flat[src_off[i] : +lens[i]],
    vectorized over all i (rows with lens 0 contribute nothing)."""
    total = int(np.sum(lens))
    if total == 0:
        return
    tgt = ragged_gather_indices(cur, lens)
    src = ragged_gather_indices(src_off, lens)
    buf[tgt] = src_flat[src]


_CIGAR_OPCH = np.frombuffer(b"MIDNSHP=XB??????", np.uint8).copy()


def cigar_strs(cigar: np.ndarray, cigar_off: np.ndarray,
               rows: np.ndarray):
    """CIGAR text for the selected rows, vectorized.

    Returns (flat uint8, off int64[len(rows)+1]); rows with no cigar
    ops render as "*"."""
    rows = np.asarray(rows, np.int64)
    cl = cigar_off[rows + 1] - cigar_off[rows]
    opidx = ragged_gather_indices(cigar_off[rows], cl)
    cig = cigar[opidx] if opidx.size else np.empty(0, np.uint32)
    lens32 = (cig >> 4).astype(np.int64)
    opch = _CIGAR_OPCH[cig & 0xF]
    dflat, dnd, _doff = itoa(lens32)
    piece = dnd + 1                       # digits + op char per op
    # per-row byte lengths (empty -> "*")
    cpl = np.zeros(opidx.size + 1, np.int64)
    np.cumsum(piece, out=cpl[1:])
    row_op_off = np.zeros(rows.size + 1, np.int64)
    np.cumsum(cl, out=row_op_off[1:])
    row_len = cpl[row_op_off[1:]] - cpl[row_op_off[:-1]]
    row_len = np.where(cl == 0, 1, row_len)
    off = np.zeros(rows.size + 1, np.int64)
    np.cumsum(row_len, out=off[1:])
    flat = np.empty(int(off[-1]), np.uint8)
    # op piece start positions within the output
    op_out = cpl[:-1].copy()
    # shift pieces of each row to the row's output start (accounts for
    # "*" rows occupying 1 byte instead of 0)
    shift = off[:-1] - cpl[row_op_off[:-1]]
    op_out += np.repeat(shift, cl)
    doff2 = np.zeros(opidx.size + 1, np.int64)
    np.cumsum(dnd, out=doff2[1:])
    ragged_scatter(flat, op_out, dnd, dflat, doff2[:-1])
    if opidx.size:
        flat[op_out + dnd] = opch
    star = np.nonzero(cl == 0)[0]
    if star.size:
        flat[off[:-1][star]] = ord("*")
    return flat, off
