"""Vectorized CIGAR expansion, the foundation of the pileup family.

Counterpart of samtools_tpu/ops/cigar.py (:25-64): every CIGAR op of
every read becomes a row of one flat op table carrying its absolute
reference and query start, computed with segment-offset cumsums instead
of a cursor walk per read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import flags as F

CONSUMES_REF = np.array(F.CIGAR_CONSUMES_REF + [0] * 6, np.int64)
CONSUMES_QRY = np.array(F.CIGAR_CONSUMES_QUERY + [0] * 6, np.int64)


@dataclass
class OpTable:
    """One row per CIGAR op across the whole batch."""
    rid: np.ndarray    # record index
    op: np.ndarray     # 0..9
    oplen: np.ndarray
    rpos: np.ndarray   # absolute 0-based reference position at op start
    qpos: np.ndarray   # query offset at op start
    op_off: np.ndarray  # per-read boundaries into this table

    @property
    def n(self) -> int:
        return self.rid.size


def expand_ops(batch, idx: np.ndarray | None = None) -> OpTable:
    """The op table of all (or the selected) records."""
    b = batch if idx is None else batch.take(np.asarray(idx, np.int64))
    rid = np.repeat(np.arange(b.n, dtype=np.int64), b.n_cigar)
    ops = (b.cigar & 0xF).astype(np.int64)
    lens = (b.cigar >> 4).astype(np.int64)
    # exclusive prefix sums, reset per read by the segment-offset trick
    cr = np.concatenate([[0], np.cumsum(lens * CONSUMES_REF[ops])[:-1]])
    cq = np.concatenate([[0], np.cumsum(lens * CONSUMES_QRY[ops])[:-1]])
    rpos = cr - cr[b.cigar_off[:-1]][rid] + b.pos[rid]
    qpos = cq - cq[b.cigar_off[:-1]][rid]
    return OpTable(rid=rid, op=ops, oplen=lens, rpos=rpos, qpos=qpos,
                   op_off=b.cigar_off.copy())
