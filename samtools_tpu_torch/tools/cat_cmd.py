"""samtools cat: concatenate alignment files.

Counterpart of samtools_tpu/tools/cat_cmd.py (samtools' bam_cat.c).  CRAM
inputs splice their containers after one new header container
(bam_cat.c:385); BGZF BAM inputs splice their compressed blocks
(bam_cat.c:700): only the header blocks and the EOF markers are dropped,
and records that share the header's last block are recompressed once; no
record is decoded.  Other inputs (SAM, or a mix) are decoded and written
again, the same records in the same order.  A host command: no device
work.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core.batch import ReadBatch
from ..io import bgzf
from ..io.bam import encode_header
from ..io.cram import parse_block, parse_container, parse_file_definition
from ..io.cram_encode import CRAM_EOF, _container_header, encode_block
from ..io.files import infer_output_format, read_alignments, write_alignments
from ..io.header import SamHeader
from ..io.stream import BamStream
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)


def usage(fp):
    fp.write(
        "Usage: samtools cat [options] <in1.bam>  [... <inN.bam>]\n"
        "       samtools cat [options] <in1.cram> [... <inN.cram>]\n"
        "\n"
        "Concatenate BAM or CRAM files, first those in <bamlist.fofn>, then those\n"
        "on the command line.\n"
        "\n"
        "Options: -b FILE  list of input BAM/CRAM file names, one per line\n"
        "         -h FILE  copy the header from FILE [default is 1st input file]\n"
        "         -o FILE  output BAM/CRAM\n"
        "         --no-PG  do not add a PG line\n")


def main_cat(argv: list[str]) -> int:
    ga = GlobalArgs()
    fn_list = None
    header_file = None
    fn_out = None
    no_pg = False
    fast = False
    try:
        opts, args = gnu_getopt(argv, "b:h:o:q@:", ["no-PG", "fast"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-b":
            fn_list = v
        elif o == "-h":
            header_file = v
        elif o == "-o":
            fn_out = v
        elif o in ("-q", "--fast"):
            fast = True
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    paths = []
    if fn_list:
        try:
            paths.extend(l.strip() for l in open(fn_list) if l.strip())
        except OSError as e:
            print_error_errno("cat", 'Cannot open "%s"', fn_list, exc=e)
            return 1
    paths.extend(args)
    if not paths:
        usage(sys.stderr)
        return 1

    rc = _try_splice_cram(paths, header_file, fn_out, ga, no_pg, argv)
    if rc is not None:
        return rc
    rc = _try_splice(paths, header_file, fn_out, ga, no_pg, fast, argv)
    if rc is not None:
        return rc

    header = None
    batches = []
    for path in paths:
        try:
            f = read_alignments(path, threads=ga.nthreads)
        except OSError as e:
            print_error_errno("cat", 'fail to open file "%s"', path, exc=e)
            return 1
        if header is None:
            header = f.header
        else:
            if f.header.ref_names != header.ref_names:
                print_error("cat",
                            "different sequence dictionaries in \"%s\"",
                            path)
                return 1
        batches.append(f.batch)
    if header_file:
        try:
            hf = read_alignments(header_file)
            header = hf.header
        except OSError as e:
            print_error_errno("cat", 'fail to open file "%s"', header_file,
                              exc=e)
            return 1
    out = ReadBatch.concat(batches)
    if not no_pg:
        cl = "samtools cat " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    level = 1 if fast else 6
    write_alignments(fn_out, header, out, fmt=fmt, threads=ga.nthreads,
                     level=level, include_header=True)
    return 0


def _try_splice_cram(paths, header_file, fn_out, ga, no_pg, argv):
    """CRAM container splice (bam_cat.c:385 cram_cat): every input's
    containers are copied byte-for-byte after one new header container;
    per-file header and EOF containers are dropped.  Returns an exit
    code when handled, or None when any input is not CRAM (or the
    output format says otherwise)."""
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    for path in paths:
        try:
            with open(path, "rb") as f:
                if f.read(4) != b"CRAM":
                    return None
        except OSError as e:
            print_error_errno("cat", 'fail to open file "%s"', path,
                              exc=e)
            return 1
    # all inputs are CRAM: splice unless the user explicitly asked for
    # a different output container
    if (ga.out_fmt or "").lower().startswith("bam") \
            or (fn_out or "").endswith(".bam") or fmt == "sam":
        return None

    def read_header(path):
        head = open(path, "rb").read(1 << 22)
        major, _m, p0 = parse_file_definition(head)
        cont, i2 = parse_container(head, p0, major)
        blk, _ = parse_block(head, i2, major)
        hd = blk.data()
        tlen = struct.unpack_from("<i", hd, 0)[0]
        text = hd[4:4 + tlen].rstrip(b"\x00").decode("latin-1")
        return SamHeader.from_text(text), i2 + cont.length, head[:p0]

    def rg_ids(h):
        return [ln.split("\tID:", 1)[1].split("\t")[0]
                for ln in h.text.split("\n")
                if ln.startswith("@RG") and "\tID:" in ln]

    header, _end0, filedef = read_header(paths[0])
    for path in paths[1:]:
        h2, _, _ = read_header(path)
        if h2.ref_names != header.ref_names:
            print_error("cat",
                        "different sequence dictionaries in \"%s\"", path)
            return 1
        if rg_ids(h2) != rg_ids(header):
            # CRAM records store @RG (and tag dictionaries) by header
            # index; mismatched lists cannot splice — decode instead
            return None
    if header_file:
        try:
            hf = read_alignments(header_file)
            header = hf.header
        except OSError as e:
            print_error_errno("cat", 'fail to open file "%s"',
                              header_file, exc=e)
            return 1
    if not no_pg:
        cl = "samtools cat " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)

    out = open(fn_out, "wb") if fn_out else sys.stdout.buffer
    try:
        out.write(filedef)
        htext = header.text.encode("latin-1")
        pad = max(1024, len(htext) // 2)
        hpayload = (struct.pack("<i", len(htext)) + htext
                    + b"\x00" * pad)
        hblock = encode_block(0, 0, 0, hpayload)
        out.write(_container_header(len(hblock), 0, 0, 0, 0, 0, 0, 1,
                                    [0]))
        out.write(hblock)
        for path in paths:
            data = open(path, "rb").read()
            major, _m, pos = parse_file_definition(data)
            cont, i = parse_container(data, pos, major)
            start = i + cont.length  # skip the header container
            # walk containers to drop the EOF container(s)
            end = len(data)
            p = start
            last_eof = None
            while p < len(data):
                c2, j2 = parse_container(data, p, major)
                if c2.ref_seq_id == -1 and c2.ref_start == 4542278:
                    last_eof = p
                p = j2 + c2.length
            if last_eof is not None:
                end = last_eof
            out.write(data[start:end])
        out.write(CRAM_EOF)
    finally:
        if fn_out:
            out.close()
    return 0


def _try_splice(paths, header_file, fn_out, ga, no_pg, fast, argv):
    """Zero-decode BGZF block splice (bam_cat.c:700).  Returns an exit
    code when handled, or None to fall back to decode+re-encode (non-BAM
    inputs, or explicit non-BAM output format)."""
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    if fmt != "bam":
        return None
    streams = []
    try:
        header = None
        for path in paths:
            try:
                st = BamStream(path, threads=ga.nthreads)
            except OSError as e:
                print_error_errno("cat", 'fail to open file "%s"', path,
                                  exc=e)
                return 1
            except Exception:
                for s, _ in streams:
                    s.close()
                return None  # not a BGZF BAM — fall back
            streams.append((st, path))
            if header is None:
                header = st.header
            elif st.header.ref_names != header.ref_names:
                print_error("cat",
                            "different sequence dictionaries in \"%s\"",
                            path)
                return 1
        if header_file:
            try:
                hf = read_alignments(header_file)
                header = hf.header
            except OSError as e:
                print_error_errno("cat", 'fail to open file "%s"',
                                  header_file, exc=e)
                return 1
        if not no_pg:
            cl = "samtools cat " + " ".join(argv)
            header = header.add_pg_line("samtools", "samtools", cl,
                                        SAMTOOLS_PARITY_VERSION)
        level = 1 if fast else 6
        out = (open(fn_out, "wb") if fn_out else sys.stdout.buffer)
        try:
            out.write(bgzf.compress(encode_header(header), level=level,
                                    threads=ga.nthreads, append_eof=False))
            for st, path in streams:
                raw = open(path, "rb").read()
                coffs, bsizes = bgzf.scan_blocks(raw)
                isizes = np.array(
                    [int.from_bytes(raw[int(o + b - 4):int(o + b)],
                                    "little")
                     for o, b in zip(coffs, bsizes)], np.int64)
                # drop trailing empty (EOF-marker) blocks
                last = len(coffs)
                while last > 0 and isizes[last - 1] == 0:
                    last -= 1
                cpos = st._hdr_voffset >> 16
                upos = st._hdr_voffset & 0xFFFF
                blk = int(np.searchsorted(coffs, cpos))
                if upos:
                    # records share the header's last block: recompress
                    # the tail of that block, then raw-copy the rest
                    data = bgzf._inflate_block(raw, int(coffs[blk]),
                                               int(bsizes[blk]))
                    if len(data) > upos:
                        out.write(bgzf.compress(data[upos:], level=level,
                                                append_eof=False))
                    blk += 1
                if blk < last:
                    out.write(raw[int(coffs[blk]):
                                  int(coffs[last - 1] + bsizes[last - 1])])
            out.write(bgzf.BGZF_EOF)
        finally:
            if fn_out:
                out.close()
        return 0
    finally:
        for st, _ in streams:
            st.close()
