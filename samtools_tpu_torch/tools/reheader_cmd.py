"""samtools reheader: replace the header of a BAM or CRAM.

Counterpart of samtools_tpu/tools/reheader_cmd.py (samtools'
bam_reheader.c): the new header comes from a SAM file or from ``-c``'s
shell command run on the old header, with a samtools @PG line unless
``-P``.  A BAM is spliced without decoding its records: the new header
is deflated into new blocks, the tail of the block the old header ends
inside is deflated again, and every later compressed block is copied
byte for byte.  A CRAM gets a new header container followed by a copy
of every later container; ``-i`` rewrites a CRAM's header block in
place when the new text fits (a BAM in place is refused).  A file that
is neither is decoded and written again as BAM.  A host command: no
device work.
"""

from __future__ import annotations

import struct
import subprocess
import sys
import zlib

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..io import bgzf
from ..io.bam import encode_header
from ..io.cram import (itf8, parse_block, parse_container,
                       parse_file_definition)
from ..io.cram_encode import _container_header, encode_block
from ..io.files import read_alignments, write_alignments
from ..io.header import SamHeader
from ..io.stream import BamStream
from .common import (UsageError, gnu_getopt, print_error,
                     print_error_errno)

# bytes read from a CRAM's head to find its header container
_CRAM_HEAD = 1 << 22


def _cram_header_site(data: bytes):
    """Where the SAM-header block of the first container lies: (payload
    offset, compressed size, method, CRC offset or -1, block offset)."""
    major, _minor, pos = parse_file_definition(data)
    _cont, blk_off = parse_container(data, pos, major)
    method = data[blk_off]
    off = blk_off + 2  # method, content type
    _cid, off = itf8(data, off)
    comp, off = itf8(data, off)
    _usize, off = itf8(data, off)
    crc_off = off + comp if major >= 3 else -1
    return off, comp, method, crc_off, blk_off


def _reheader_cram_inplace(path: str, new_header) -> int:
    """cram_reheader_inplace (bam_reheader.c:193): the header block
    rewritten, padded to its old size, when it is raw and the new text
    fits."""
    with open(path, "r+b") as f:
        head = f.read(_CRAM_HEAD)
        try:
            poff, comp, method, crc_off, blk_off = _cram_header_site(head)
        except Exception:
            print_error("reheader", "unable to parse CRAM '%s'", path)
            return 1
        text = new_header.text.encode("latin-1")
        payload = struct.pack("<i", len(text)) + text
        if method != 0 or len(payload) > comp:
            print_error(
                "reheader",
                "unable to fit new header into '%s' in place "
                "(need %d bytes raw, block holds %d)",
                path, len(payload), comp if method == 0 else 0)
            return 1
        padded = payload + b"\x00" * (comp - len(payload))
        f.seek(poff)
        f.write(padded)
        if crc_off > 0:
            f.seek(crc_off)
            f.write(struct.pack(
                "<I", zlib.crc32(head[blk_off:poff] + padded) & 0xFFFFFFFF))
    return 0


def _splice_cram(path: str, new_header, out) -> bool:
    """cram_reheader (bam_reheader.c:124): the file definition, a new
    header container, then every later container copied; False when the
    file is not a CRAM that parses."""
    with open(path, "rb") as f:
        head = f.read(_CRAM_HEAD)
        if head[:4] != b"CRAM":
            return False
        try:
            major, _minor, p0 = parse_file_definition(head)
            cont, i = parse_container(head, p0, major)
            _cram_header_site(head)
        except Exception:
            return False
        out.write(head[:p0])
        htext = new_header.text.encode("latin-1")
        pad = max(1024, len(htext) // 2)
        hblock = encode_block(0, 0, 0, struct.pack("<i", len(htext)) + htext
                              + b"\x00" * pad)
        out.write(_container_header(len(hblock), 0, 0, 0, 0, 0, 0, 1, [0]))
        out.write(hblock)
        f.seek(i + cont.length)
        while chunk := f.read(1 << 24):
            out.write(chunk)
    return True


class _LazyFile:
    """The header of a BAM or CRAM whose records are copied raw:
    ``kind`` is "bam" or "cram"."""

    def __init__(self, path: str, header, kind: str):
        self.path = path
        self.header = header
        self.kind = kind


def _cram_header(path: str) -> SamHeader | None:
    """A CRAM's header text, or None when the file is not a CRAM."""
    with open(path, "rb") as f:
        if f.read(4) != b"CRAM":
            return None
        f.seek(0)
        head = f.read(_CRAM_HEAD)
    blk, _ = parse_block(head, _cram_header_site(head)[4],
                         parse_file_definition(head)[0])
    hd = blk.data()
    tlen = struct.unpack_from("<i", hd, 0)[0]
    return SamHeader.from_text(hd[4:4 + tlen].rstrip(b"\x00")
                               .decode("latin-1"))


def _open_lazy(path: str):
    """A BAM or CRAM as a _LazyFile (its header only); anything else read
    whole, through the generic reader, whose OSError is the caller's."""
    try:
        header = _cram_header(path)
        if header is not None:
            return _LazyFile(path, header, "cram")
    except Exception:
        pass
    try:
        with BamStream(path) as st:
            return _LazyFile(path, st.header, "bam")
    except Exception:
        return read_alignments(path)


def _splice_bam(bam_path: str, new_header, out) -> bool:
    """The new header, then the records' compressed blocks copied raw;
    False when the input is not a BGZF BAM."""
    try:
        st = BamStream(bam_path, threads=2)
    except Exception:
        return False
    try:
        voff = st._hdr_voffset
        cpos, uoff = voff >> 16, voff & 0xFFFF
        out.write(bgzf.compress(encode_header(new_header), level=6,
                                append_eof=False))
        if uoff:
            # the first record shares a block with the old header: that
            # block is deflated again from the record on
            data, uoffs, coffs, cend = st._inflate_span(cpos, 1 << 16)
            end0 = int(uoffs[1]) if uoffs.size > 1 else data.size
            blk = data[uoff:end0]
            if blk.size:
                out.write(bgzf.compress(np.asarray(blk).tobytes(), level=6,
                                        append_eof=False))
            cpos = int(coffs[1]) if coffs.size > 1 else cend
        with open(bam_path, "rb") as f:
            f.seek(cpos)
            while chunk := f.read(1 << 24):
                out.write(chunk)
    finally:
        st.close()
    return True


def usage(fp):
    fp.write(
        "Usage: samtools reheader [-P] in.header.sam in.bam > out.bam\n"
        "   or  samtools reheader [-P] -i in.header.sam file.bam\n"
        "   or  samtools reheader [-P] -c CMD in.bam > out.bam\n"
        "\n"
        "Options:\n"
        "    -P, --no-PG      Do not generate a @PG header line\n"
        "    -i, --in-place   Modify the file in-place (CRAM only)\n"
        "    -c, --command    Use CMD to modify the header\n")


def main_reheader(argv: list[str]) -> int:
    no_pg = False
    inplace = False
    external = None
    try:
        opts, args = gnu_getopt(argv, "hiPc:",
                                ["help", "in-place", "no-PG", "command="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-P", "--no-PG"):
            no_pg = True
        elif o in ("-i", "--in-place"):
            inplace = True
        elif o in ("-c", "--command"):
            external = v
        elif o in ("-h", "--help"):
            usage(sys.stdout)
            return 0
        else:
            usage(sys.stderr)
            return 1

    if (len(args) != 2 or external) and (len(args) != 1 or not external):
        usage(sys.stderr)
        return 1

    bam_path = args[-1]
    if not external:
        try:
            new_header = read_alignments(args[0]).header
        except OSError as e:
            print_error_errno("reheader",
                              "fail to read the header from '%s'",
                              args[0], exc=e)
            return 1
    try:
        f = _open_lazy(bam_path)
    except OSError as e:
        print_error_errno("reheader", "fail to open file '%s'", bam_path,
                          exc=e)
        return 1
    if external:
        p = subprocess.run(external, shell=True,
                           input=f.header.text.encode("latin-1"),
                           capture_output=True)
        if p.returncode != 0:
            sys.stderr.write(
                "[main_reheader] failed to read the header from '%s'.\n"
                % external)
            return 1
        new_header = SamHeader.from_text(p.stdout.decode("latin-1"))

    kind = getattr(f, "kind", None)
    if inplace and kind != "cram":
        print_error("reheader", "cannot reheader BAM '%s' in-place",
                    bam_path)
        return 1

    if not no_pg:
        new_header = new_header.add_pg_line(
            "samtools", "samtools", "samtools reheader " + " ".join(argv),
            SAMTOOLS_PARITY_VERSION)
    # records keep their tids: the new header's @SQ lines are taken as
    # they are (no checks, as in samtools), or the old ones when it has
    # none
    if not new_header.ref_names:
        new_header.ref_names = f.header.ref_names
        new_header.ref_lens = f.header.ref_lens

    if kind == "cram":
        if inplace:
            return _reheader_cram_inplace(f.path, new_header)
        if _splice_cram(f.path, new_header, sys.stdout.buffer):
            return 0
        print_error("reheader", "failed to reheader CRAM '%s'", bam_path)
        return 1
    if kind == "bam":
        if _splice_bam(f.path, new_header, sys.stdout.buffer):
            return 0
        f = read_alignments(f.path)
    write_alignments(None, new_header, f.batch, fmt="bam",
                     include_header=True)
    return 0
