"""Whole-file alignment reading and writing with format detection.

Counterpart of samtools_tpu/io/files.py: a path, a URL (``io/hfile.py``)
or ``-`` for standard input, read whole into one columnar batch.
BGZF-compressed and raw BAM decode in the host library; SAM text, gzip'd
SAM and BGZF'd SAM parse through ``io/sam_text.py``; CRAM 2.1/3.0/3.1
decodes on the host through ``io/cram_decode.py``, its reference taken
from an explicit FASTA or the ``@SQ`` M5 store (``REF_PATH`` /
``REF_CACHE``).  ``write_alignments`` writes SAM, gzip'd SAM, BAM or
CRAM to a path or to standard output; ``StreamingWriter`` writes SAM,
gzip'd SAM or BAM a batch at a time, in the same bytes.
"""

from __future__ import annotations

import sys
import zlib
from dataclasses import dataclass

import numpy as np

from ..core import metrics
from ..core.batch import ReadBatch
from . import bgzf, hfile, native
from . import fasta as fastamod
from .bam import decode_header, decode_records, encode_header, encode_records
from .header import SamHeader
from .sam_text import format_records, parse_sam


class FormatError(RuntimeError):
    pass


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
    with metrics.stage("read+decode", len(data), "bytes"):
        af = _read_from_bytes(data, max(1, threads or 2), reference)
    metrics.add("decode.records", 0.0, af.batch.n, "reads")
    return af


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


def infer_output_format(path: str | None, explicit: str | None = None,
                        default: str = "sam") -> str:
    """The output format: ``explicit`` if given, else the path's
    extension (.bam, .cram, .sam.gz, .sam), else ``default``."""
    if explicit:
        return explicit.lower()
    if path:
        p = path.lower()
        for ext, fmt in ((".bam", "bam"), (".cram", "cram"),
                         (".sam.gz", "sam.gz"), (".sam", "sam")):
            if p.endswith(ext):
                return fmt
    return default


def _open_out(path: str | None):
    """(file, whether the caller closes it): ``None`` or ``-`` is
    standard output."""
    if path is None or path == "-":
        return sys.stdout.buffer, False
    return open(path, "wb"), True


class StreamingWriter:
    """Incremental alignment writer (bam / sam / sam.gz): the header once,
    then record batches as they come (the external sort's and view's
    streamed output path)."""

    def __init__(self, path: str | None, header: SamHeader, fmt: str,
                 threads: int = 0, level: int = 6,
                 include_header: bool = True):
        if fmt not in ("bam", "sam", "sam.gz"):
            raise FormatError(f"streaming output not supported for {fmt}")
        self.fmt = fmt
        self.header = header
        self._f, self._own = _open_out(path)
        self._w = (bgzf.BgzfWriter(self._f, level=level, threads=threads)
                   if fmt in ("bam", "sam.gz") else self._f)
        self._w.write(encode_header(header) if fmt == "bam"
                      else header.text.encode("latin-1") if include_header
                      else b"")

    def write_batch(self, batch: ReadBatch) -> None:
        if batch.n == 0:
            return
        self._w.write(encode_records(batch) if self.fmt == "bam"
                      else format_records(self.header, batch)
                      .encode("latin-1"))

    def close(self) -> None:
        if self._w is not self._f:
            self._w.close(write_eof=True)
        if self._own:
            self._f.close()
        else:
            self._f.flush()


def _cram_version(fmt_opts: dict | None) -> tuple[int, int]:
    """The CRAM version of ``version=`` among the format options (3.0 by
    default; 2.1 is written as 3.0, the writer's floor)."""
    version = (3, 0)
    v = (fmt_opts or {}).get("version")
    if v:
        try:
            major, minor = str(v).split(".")
            version = (int(major), int(minor))
        except ValueError:
            pass
        if version not in ((2, 1), (3, 0), (3, 1)):
            raise FormatError("unsupported CRAM version %s" % (v,))
        if version == (2, 1):
            version = (3, 0)
    return version


def write_alignments(path: str | None, header: SamHeader, batch: ReadBatch,
                     fmt: str = "sam", threads: int = 0, level: int = 6,
                     include_header: bool = True,
                     header_only: bool = False,
                     reference: str | None = None,
                     write_index: bool = False,
                     fmt_opts: dict | None = None) -> None:
    """Write records as SAM, gzip'd SAM, BAM or CRAM; ``path`` None or
    ``-`` writes to standard output.  CRAM takes its reference from the
    FASTA ``reference`` or the REF_PATH/REF_CACHE M5 store, its version
    from ``fmt_opts``, and writes a ``.crai`` beside a path with
    ``write_index``."""
    with metrics.stage("encode+write", batch.n, "reads"):
        _write_alignments(path, header, batch, fmt, threads, level,
                          include_header, header_only, reference,
                          write_index, fmt_opts)


def _write_alignments(path, header, batch, fmt, threads, level,
                      include_header, header_only, reference, write_index,
                      fmt_opts) -> None:
    if fmt == "cram":
        from .cram_encode import encode_cram, write_crai
        payload, crai = encode_cram(header, batch,
                                    cram_ref_lookup(header, reference),
                                    version=_cram_version(fmt_opts))
        if path and path != "-" and write_index:
            write_crai(path + ".crai", crai)
    elif fmt == "bam":
        raw = encode_header(header)
        if not header_only:
            raw += encode_records(batch)
        payload = bgzf.compress(raw, level=level, threads=threads)
    else:
        text = header.text if include_header else ""
        if not header_only:
            text += format_records(header, batch)
        payload = text.encode("latin-1")
        if fmt == "sam.gz":
            payload = bgzf.compress(payload, level=level, threads=threads)
    f, own = _open_out(path)
    f.write(payload)
    if own:
        f.close()
    else:
        f.flush()
