"""Whole-file alignment reading with format detection.

Counterpart of samtools_tpu/io/files.py (:27-107): a path, or ``-`` for
standard input, read whole into one columnar batch.  BGZF-compressed and
raw BAM decode in the host library; SAM text, gzip'd SAM and BGZF'd SAM
parse through ``io/sam_text.py``.  CRAM raises ``FormatNotPorted``,
which the tools report as not ported yet.
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
from .sam_text import parse_sam


class FormatNotPorted(RuntimeError):
    """The input is CRAM, which the port does not read yet."""


@dataclass
class AlignmentFile:
    header: SamHeader
    batch: ReadBatch
    format: str = "sam"


def detect_format(path: str) -> str:
    """The container format from the file's head (htslib's
    hts_detect_format): cram, bam, sam.gz, bam_raw or sam."""
    with open(path, "rb") as f:
        head = f.read(65536)
    if head[:4] == b"CRAM":
        return "cram"
    if head[:4] == b"BAM\1":
        return "bam_raw"
    if head[:2] != b"\x1f\x8b":
        return "sam"
    try:
        if bgzf.is_bgzf(head):
            xlen = int.from_bytes(head[10:12], "little")
            first = zlib.decompressobj(-15).decompress(head[12 + xlen:], 16)
        else:
            first = zlib.decompressobj(47).decompress(head, 16)
    except zlib.error:
        first = b""
    return "bam" if first[:4] == b"BAM\1" else "sam.gz"


def read_alignments(path: str, threads: int = 0) -> AlignmentFile:
    """Read a whole SAM or BAM file (``-``: standard input) into one
    batch."""
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    return _read_from_bytes(data, max(1, threads or 2))


def _read_from_bytes(data: bytes, threads: int) -> AlignmentFile:
    if data[:4] == b"CRAM":
        raise FormatNotPorted("CRAM input")
    if bgzf.is_bgzf(data):
        arr = bgzf.decompress(data, threads)
    elif data[:2] == b"\x1f\x8b":
        arr = np.frombuffer(zlib.decompress(data, 47), np.uint8)
    else:
        arr = np.frombuffer(data, np.uint8)
    if arr[:4].tobytes() == b"BAM\1":
        header, off = decode_header(arr)
        offs = native.bam_record_offsets(arr, off)
        return AlignmentFile(header=header,
                             batch=decode_records(arr, offs, threads),
                             format="bam")
    header, batch = parse_sam(arr.tobytes())
    return AlignmentFile(header=header, batch=batch)
