"""Whole-file alignment reading, BAM only.

Counterpart of samtools_tpu/io/files.py (:54-107): a path, or ``-`` for
standard input, read whole into one columnar batch.  BGZF-compressed BAM
and raw (uncompressed) BAM decode; SAM text and CRAM raise
``FormatNotPorted``, which the tools report as not ported yet.
"""

from __future__ import annotations

import sys
import zlib
from dataclasses import dataclass

import numpy as np

from ..core.batch import ReadBatch
from . import bgzf, native
from .bam import decode_header, decode_records
from .header import SamHeader


class FormatNotPorted(RuntimeError):
    """The input is SAM text or CRAM, which the port does not read yet."""


@dataclass
class AlignmentFile:
    header: SamHeader
    batch: ReadBatch
    format: str = "bam"


def read_alignments(path: str, threads: int = 0) -> AlignmentFile:
    """Read a whole BAM file (``-``: standard input) into one batch."""
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    threads = max(1, threads or 2)
    if bgzf.is_bgzf(data):
        arr = bgzf.decompress(data, threads)
    elif data[:2] == b"\x1f\x8b":
        arr = np.frombuffer(zlib.decompress(data, 47), np.uint8)
    else:
        arr = np.frombuffer(data, np.uint8)
    if arr[:4].tobytes() != b"BAM\1":
        raise FormatNotPorted("SAM and CRAM input")
    header, off = decode_header(arr)
    offs = native.bam_record_offsets(arr, off)
    return AlignmentFile(header=header,
                         batch=decode_records(arr, offs, threads))
