"""view's record predicates over a whole batch, and the qname hashes of
its subsampling (counterpart of samtools_tpu/ops/filters.py).

samtools' process_aln (sam_view.c:151-230) tests one record at a time;
here each predicate is a boolean column over the batch, ANDed once.  The
hashes are khash's X31, Wang and FNV-1a with their uint32 wrap-around
(view keeps a read when Wang(X31(qname) ^ seed) falls under the
fraction, sam_view.c:178), and glibc's first ``rand()`` after
``srand(seed)``, through which view scrambles the seed.  numpy on the
host: no device work.
"""

from __future__ import annotations

import numpy as np

from ..core import flags as F


def x31_hash_ragged(flat: np.ndarray, off: np.ndarray) -> np.ndarray:
    """khash's __ac_X31_hash_string (h = h * 31 + c, uint32) of each
    ragged string, one character position at a time over every string."""
    n = off.size - 1
    lens = off[1:] - off[:-1]
    maxlen = int(lens.max()) if n else 0
    h = np.zeros(n, np.uint32)
    starts = off[:-1]
    for j in range(maxlen):
        live = lens > j
        c = flat[starts[live] + j].astype(np.uint32)
        h[live] = (h[live] << np.uint32(5)) - h[live] + c
    return h


def wang_hash(key: np.ndarray) -> np.ndarray:
    """khash's __ac_Wang_hash (32-bit)."""
    k = key.astype(np.uint32)
    k = k + ~(k << np.uint32(15))
    k = k ^ (k >> np.uint32(10))
    k = k + (k << np.uint32(3))
    k = k ^ (k >> np.uint32(6))
    k = k + ~(k << np.uint32(11))
    k = k ^ (k >> np.uint32(16))
    return k


def fnv1a_hash_bytes(data: bytes) -> int:
    """khash's __ac_FNV1a_hash_string (uint32)."""
    h = 0x811C9DC5
    for c in data:
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


def glibc_rand_first(seed: int) -> int:
    """The first ``rand()`` after glibc's ``srand(seed)`` (its TYPE_3
    additive generator; sam_view.c:1390-1394)."""
    seed &= 0xFFFFFFFF
    if seed == 0:
        seed = 1
    r = [0] * 345
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * r[i - 1]) % 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    for i in range(34, 345):
        r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
    return r[344] >> 1


def subsample_keep(batch, frac: float, seed: int) -> np.ndarray:
    """The reads view's subsampling keeps (sam_view.c:178-181)."""
    h = x31_hash_ragged(batch.qname, batch.qname_off)
    k = wang_hash(h ^ np.uint32(seed))
    return (k & np.uint32(0xFFFFFF)).astype(np.float64) / 0x1000000 < frac


def qlen_from_cigar(batch) -> np.ndarray:
    """Query length of each record with its hard clips (view ``-m``,
    sam_view.c:162-168)."""
    if batch.n == 0:
        return np.zeros(0, np.int64)
    ops = (batch.cigar & 0xF).astype(np.int64)
    lens = (batch.cigar >> 4).astype(np.int64)
    counts_q = np.array(F.CIGAR_CONSUMES_QUERY, np.int64)
    counts_q[F.CHARD_CLIP] = 1
    csum = np.concatenate([[0], np.cumsum(lens * counts_q[ops])])
    return csum[batch.cigar_off[1:]] - csum[batch.cigar_off[:-1]]


def flag_mask(batch, flag_on: int = 0, flag_off: int = 0,
              flag_anyon: int = 0, flag_alloff: int = 0) -> np.ndarray:
    """view's four flag tests: ``-f``, ``-F``, ``--rf`` and ``-G``
    (sam_view.c:63-66, 168-175)."""
    f = batch.flag.astype(np.int64)
    keep = np.ones(batch.n, bool)
    if flag_on:
        keep &= (f & flag_on) == flag_on
    if flag_off:
        keep &= (f & flag_off) == 0
    if flag_alloff:
        keep &= (f & flag_alloff) != flag_alloff
    if flag_anyon:
        keep &= (f & flag_anyon) != 0
    return keep


def qnames_array(batch) -> np.ndarray:
    """Each record's qname as bytes, in an object array (for set
    lookups)."""
    out = np.empty(batch.n, object)
    qf = batch.qname.tobytes()
    off = batch.qname_off
    for i in range(batch.n):
        out[i] = qf[off[i]:off[i + 1]]
    return out
