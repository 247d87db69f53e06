"""samtools quickcheck: a quick sniff of each file's integrity.

Counterpart of samtools_tpu/tools/quickcheck_cmd.py (samtools'
bam_quickcheck.c): the file opens, is sequence data, has targets in its
header (unless ``-u``) and ends in an EOF block (BGZF's or CRAM's); the
exit status is the OR of the files' state bits.  A host command: no
device work.
"""

from __future__ import annotations

import getopt
import struct
import sys

import numpy as np

from ..io import bgzf
from ..io.bam import decode_header
from ..io.cram import CramReader, parse_block
from ..io.files import detect_format

# CRAM's EOF container: v3's 38 bytes, v2.1's 30
_CRAM_EOF_V3 = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606"
    "010001000100ee63014b")
_CRAM_EOF_V21 = bytes.fromhex(
    "0b000000ffffffff0fe0454f4600000000010000010006060100"
    "01000100")

QC_FAIL_OPEN = 2
QC_NOT_SEQUENCE = 4
QC_BAD_HEADER = 8
QC_NO_EOF_BLOCK = 16


def usage(fp):
    fp.write(
        "Usage: samtools quickcheck [options] <input> [...]\n"
        "Options:\n"
        "  -v              verbose output (repeat for more verbosity)\n"
        "  -q              suppress warning messages\n"
        "  -u              unmapped input (do not require targets in header)\n")


def _check_one(fn: str, unmapped: bool, verbose: int, quiet: bool) -> int:
    state = 0

    def err(bit, msg):
        nonlocal state
        state |= bit
        if not quiet or verbose >= 2:
            sys.stderr.write(msg)

    try:
        with open(fn, "rb") as f:
            head = f.read(65536)
    except OSError:
        err(QC_FAIL_OPEN, f"{fn} could not be opened for reading.\n")
        return state
    if not head:
        err(QC_NOT_SEQUENCE, f"{fn} was not identified as sequence data.\n")
        return state
    try:
        fmt = detect_format(fn)
    except Exception:
        fmt = "unknown"
    n_targets = -1
    if fmt in ("bam", "bam_raw"):
        try:
            if fmt == "bam":
                data = np.frombuffer(bgzf.read_file(fn), np.uint8)
            else:
                with open(fn, "rb") as f:
                    data = np.frombuffer(f.read(), np.uint8)
            hdr, _ = decode_header(data)
            n_targets = hdr.n_refs
        except Exception:
            err(QC_BAD_HEADER, f"{fn} caused an error whilst reading its header.\n")
            return state
    elif fmt in ("sam", "sam.gz"):
        # text: count @SQ lines in the leading header
        try:
            data = bgzf.read_file(fn)
            n_targets = 0
            for line in data.split(b"\n"):
                if not line.startswith(b"@"):
                    break
                if line.startswith(b"@SQ"):
                    n_targets += 1
        except Exception:
            err(QC_BAD_HEADER, f"{fn} caused an error whilst reading its header.\n")
            return state
    elif fmt == "cram":
        # header readability + EOF container presence
        # (bam_quickcheck.c CRAM branch; EOF marker per CRAM spec)
        try:
            with open(fn, "rb") as f:
                data = f.read()
            rd = CramReader(data)
            gen = rd.containers()
            cont0, i0 = next(gen)
            blk, _ = parse_block(data, i0, rd.major)
            hd = blk.data()
            tlen = struct.unpack_from("<i", hd, 0)[0]
            text = hd[4:4 + tlen].decode("latin-1")
            n_targets = sum(1 for l in text.split("\n")
                            if l.startswith("@SQ"))
        except Exception:
            err(QC_BAD_HEADER,
                f"{fn} caused an error whilst reading its header.\n")
            return state
        tail = data[-38:]
        if not (tail == _CRAM_EOF_V3 or tail[-30:] == _CRAM_EOF_V21):
            err(QC_NO_EOF_BLOCK,
                f"{fn} was missing EOF block when one should be"
                " present.\n")
        if not unmapped and n_targets <= 0:
            err(QC_BAD_HEADER, f"{fn} had no targets in header.\n")
        return state
    else:
        err(QC_NOT_SEQUENCE, f"{fn} was not identified as sequence data.\n")
        return state

    if not unmapped and n_targets <= 0:
        err(QC_BAD_HEADER, f"{fn} had no targets in header.\n")

    # EOF block applies to BGZF containers only (bam / sam.gz via bgzf)
    if fmt == "bam" or (fmt == "sam.gz" and bgzf.is_bgzf(head)):
        if not bgzf.has_eof_block(fn):
            err(QC_NO_EOF_BLOCK,
                f"{fn} was missing EOF block when one should be present.\n")
    return state


def main_quickcheck(argv: list[str]) -> int:
    verbose = 0
    quiet = False
    unmapped = False
    try:
        opts, args = getopt.getopt(argv, "vqu")
    except getopt.GetoptError:
        usage(sys.stderr)
        return 1
    for o, _ in opts:
        if o == "-v":
            verbose += 1
        elif o == "-q":
            quiet = True
        elif o == "-u":
            unmapped = True
    if not args:
        usage(sys.stdout)
        return 1
    if verbose >= 2:
        sys.stderr.write(f"verbosity set to {verbose}\n")
    ret = 0
    for fn in args:
        if verbose >= 3:
            sys.stderr.write(f"checking {fn}\n")
        state = _check_one(fn, unmapped, verbose, quiet)
        if state > 0 and verbose >= 1:
            sys.stdout.write(fn + "\n")
        ret |= state
    return ret
