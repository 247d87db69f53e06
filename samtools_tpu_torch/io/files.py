"""Whole-file alignment reading and writing with format detection.

Counterpart of samtools_tpu/io/files.py: a path, a URL (``io/hfile.py``)
or ``-`` for standard input, read whole into one columnar batch.
BGZF-compressed and raw BAM decode in the host library; SAM text, gzip'd
SAM and BGZF'd SAM parse through ``io/sam_text.py``; CRAM 2.1/3.0/3.1
decodes on the host through ``io/cram_decode.py``, its reference taken
from an explicit FASTA or the ``@SQ`` M5 store (``REF_PATH`` /
``REF_CACHE``).  ``write_alignments`` writes BAM or CRAM.
"""

from __future__ import annotations

import sys
import zlib
from dataclasses import dataclass

import numpy as np

from ..core.batch import ReadBatch
from . import bgzf, hfile, native
from . import fasta as fastamod
from .bam import decode_header, decode_records, write_bam
from .header import SamHeader
from .sam_text import parse_sam


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


def read_alignments(path: str, threads: int = 0,
                    reference: str | None = None) -> AlignmentFile:
    """Read a whole SAM, BAM or CRAM file (``-``: standard input; a URL
    is fetched once, ``io/hfile.py``) into one batch.  ``reference``
    names a FASTA for CRAM decode."""
    if path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(hfile.resolve(path), "rb") as f:
            data = f.read()
    return _read_from_bytes(data, max(1, threads or 2), reference)


def _read_from_bytes(data: bytes, threads: int,
                     reference: str | None = None) -> AlignmentFile:
    if data[:4] == b"CRAM":
        from .cram_decode import read_cram
        fai = fastamod.load_fasta(reference) if reference else None
        header, batch = read_cram(data, fai=fai)
        return AlignmentFile(header=header, batch=batch, format="cram")
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


def cram_ref_lookup(header: SamHeader, reference: str | None):
    """tid -> uppercase reference bytes, through an explicit FASTA or the
    REF_PATH/REF_CACHE M5 store (htslib's cram_ref), for the encoder."""
    from .cram_decode import _ref_path_lookup
    fai = fastamod.load_fasta(reference) if reference else None
    cache: dict[int, bytes | None] = {}

    def lookup(tid: int):
        if tid in cache:
            return cache[tid]
        seq = None
        if fai is not None:
            try:
                seq = fai.fetch(header.ref_names[tid])
            except (IndexError, OSError):
                seq = None
        if seq is None:
            seq = _ref_path_lookup(header, tid)
        if seq is not None:
            seq = bytes(seq).upper()
        cache[tid] = seq
        return seq

    return lookup


def write_alignments(path: str, header: SamHeader, batch: ReadBatch,
                     fmt: str = "bam", write_index: bool = False) -> None:
    """Write a batch as BAM or as CRAM 3.0 (its reference from the
    REF_PATH/REF_CACHE M5 store; a ``.crai`` beside it with
    ``write_index``), as the JAX package's write_alignments does for
    those formats."""
    if fmt == "bam":
        write_bam(path, header, batch)
        return
    if fmt != "cram":
        raise ValueError(f"the port writes bam or cram, not {fmt}")
    from .cram_encode import encode_cram, write_crai
    payload, crai = encode_cram(header, batch, cram_ref_lookup(header, None))
    if write_index:
        write_crai(path + ".crai", crai)
    with open(path, "wb") as f:
        f.write(payload)
