"""Order-free checksum reduction in GF(2^31 - 1).

Counterpart of samtools_tpu/ops/checksum.py (samtools' bam_checksum.c
``update_hash`` / ``sums_update_row``).  Each record's CRC32 is mapped
into the multiplicative group modulo the Mersenne prime 2^31 - 1 and the
values are multiplied, so the result depends on neither the order of the
records nor how they are split: the products of parts combine with one
more multiply.  A product of two values below 2^31 fits in ``uint64``,
so no step wraps.
"""

from __future__ import annotations

import numpy as np

PRIME = np.uint64((1 << 31) - 1)


def map_crc(crcs: np.ndarray) -> np.ndarray:
    """Raw uint32 CRCs into the group: ``crc & PRIME``, with 0 taken to 1
    (bam_checksum.c:196-199).  A value of PRIME itself stays PRIME, as in
    the JAX module (whose docstring says it becomes 1 too)."""
    v = np.asarray(crcs).astype(np.uint64) & PRIME
    return np.where(v == 0, np.uint64(1), v)


def gf31_mul(a, b) -> int:
    """(a * b) mod (2^31 - 1) of two values already in [1, PRIME)."""
    return int((np.uint64(a) * np.uint64(b)) % PRIME)
