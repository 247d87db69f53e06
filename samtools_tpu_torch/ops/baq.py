"""Host BAQ for the mpileup tool: the contig's 0-4 codes and the f64 BAQ
of the windows no device engine takes.

Counterpart of samtools_tpu/ops/baq.py's ``_ref_ints`` (:345) and the
host-library branch of ``apply_baq_batch`` (:377-452).  Stored BQ/ZQ tags
change BAQ into a tag conversion (htslib sam_prob_realn's apply/convert
paths), which the port does not have yet: a read that carries one makes
``apply_baq_batch`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..io import native
from .mpileup_device import HOST_THREADS, NT16_TO4, stored_baq_tags

# ASCII base -> nt16 code (htslib seq_nt16_table; U reads as T)
NT16_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    NT16_LUT[ord(_c)] = _i
    NT16_LUT[ord(_c.lower())] = _i
NT16_LUT[ord("u")] = NT16_LUT[ord("U")] = 8


def _ref_ints(ref: bytes) -> np.ndarray:
    """A contig's 0-4 codes (A, C, G, T, other) from its ASCII bases."""
    return np.ascontiguousarray(
        NT16_TO4[NT16_LUT[np.frombuffer(ref, np.uint8)]], np.uint8)


def apply_baq_batch(sub, ref_int: np.ndarray) -> None:
    """BAQ every read of ``sub`` (one contig) in place with the host
    library's f64 HMM (sam_prob_realn with flag 3; without stored tags
    ``-E``'s flag 7 computes the same)."""
    if sub.n == 0:
        return
    if stored_baq_tags(sub):
        raise NotImplementedError("BAQ tag conversion (stored BQ/ZQ "
                                  "tags) is not ported yet")
    out, _ = native.baq_batch(sub.pos, sub.cigar, sub.cigar_off, sub.seq,
                              sub.qual, sub.seq_off, ref_int, flag=3,
                              threads=HOST_THREADS)
    sub.qual[:] = out
