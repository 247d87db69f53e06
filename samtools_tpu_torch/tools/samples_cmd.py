"""samtools samples: list the samples of alignment files.

Counterpart of samtools_tpu/tools/samples_cmd.py (samtools'
bam_samples.c): one row per sample (the SM values of the @RG lines, or
``-T``'s tag; ``.`` when no @RG carries it) and file, with ``-i`` a
column saying whether the file has an index (or the paired index file
of ``-X`` exists) and with ``-f``/``-F`` the first FASTA whose contigs
match the header's names and lengths.  With no file argument the names
come from standard input.  Only the header is read: a BAM's record
blocks are not inflated, where the JAX tool inflates the whole file.  A
host command: no device work.
"""

from __future__ import annotations

import gzip
import os
import sys

import numpy as np

from ..io import bgzf
from ..io.bam import decode_header
from ..io.fasta import load_fasta
from ..io.files import detect_format
from ..io.header import SamHeader
from ..io.index import find_index_file
from ..io.stream import BamStream
from .common import UsageError, gnu_getopt, print_error, print_error_errno


def _read_header(path: str) -> SamHeader:
    """The header of a BAM (its records are not inflated), or of the @
    lines at the head of a SAM (plain or BGZF)."""
    fmt = detect_format(path)
    if fmt == "bam":
        with BamStream(path) as st:
            return st.header
    if fmt == "bam_raw":
        header, _ = decode_header(np.frombuffer(bgzf.read_file(path),
                                                np.uint8))
        return header
    text_lines = []
    with (gzip.open if fmt == "sam.gz" else open)(path, "rb") as f:
        for line in f:
            if not line.startswith(b"@"):
                break
            text_lines.append(line.rstrip(b"\n").decode("latin-1"))
    return SamHeader.from_text("\n".join(text_lines) + "\n"
                               if text_lines else "")


def _matching_fasta(fa_indexes, header) -> str | None:
    """The first FASTA whose contigs are the header's, in its order and
    with its lengths."""
    for fa, fidx in fa_indexes:
        if (fidx.nseq() == header.n_refs
                and all(fidx.order[i] == header.ref_names[i]
                        and fidx.length(fidx.order[i]) == header.ref_lens[i]
                        for i in range(header.n_refs))):
            return fa
    return None


def main_samples(argv: list[str]) -> int:
    tag = "SM"
    header_row = False
    test_index = False
    out_path = None
    fastas: list = []
    use_index_files = False
    try:
        opts, args = gnu_getopt(argv, "?hiT:o:f:F:X", [])
    except UsageError:
        return 1
    for o, v in opts:
        if o == "-h":
            header_row = True
        elif o == "-i":
            test_index = True
        elif o == "-T":
            if len(v) != 2:
                print_error("samples", 'Length of tag "%s" is not 2.', v)
                return 1
            tag = v
        elif o == "-o":
            out_path = v
        elif o == "-f":
            fastas.append(v)
        elif o == "-F":
            try:
                with open(v) as f:
                    fastas.extend(ln.strip() for ln in f if ln.strip())
            except OSError as e:
                print_error_errno("samples", 'Cannot open "%s"', v, exc=e)
                return 1
        elif o == "-X":
            use_index_files = True
        elif o == "-?":
            return 0

    out = open(out_path, "w") if out_path else sys.stdout
    if header_row:
        out.write(f"#{tag}\tPATH")
        if test_index:
            out.write("\tINDEX")
        if fastas:
            out.write("\tREFERENCE")
        out.write("\n")

    fa_indexes = []
    for fa in fastas:
        try:
            fa_indexes.append((fa, load_fasta(fa)))
        except OSError as e:
            print_error_errno("samples", 'Cannot load index from "%s"', fa,
                              exc=e)
            return 1

    if not args:
        args = [ln.strip() for ln in sys.stdin if ln.strip()]

    files = args
    idx_files = [None] * len(files)
    if use_index_files:
        if "\t" in (files[0] if files else ""):
            pairs = [f.split("\t") for f in files]
            files = [p[0] for p in pairs]
            idx_files = [p[1] if len(p) > 1 else None for p in pairs]
        else:
            n = len(files) // 2
            idx_files = files[n:] + [None] * (len(files) - 2 * n)
            files = files[:n]

    rc = 0
    for path, idxf in zip(files, idx_files):
        try:
            header = _read_header(path)
        except OSError as e:
            print_error_errno("samples", 'Cannot open "%s"', path, exc=e)
            rc = 1
            continue
        has_index = False
        if test_index:
            has_index = (os.path.exists(idxf) if idxf
                         else find_index_file(path) is not None)
        samples = list(dict.fromkeys(header.find_tag_values("RG", tag)))
        ref = _matching_fasta(fa_indexes, header) if fa_indexes else None
        for s in samples or ["."]:
            out.write(f"{s}\t{path}")
            if test_index:
                out.write("\tY" if has_index else "\tN")
            if fa_indexes:
                out.write("\t" + (ref if ref else "."))
            out.write("\n")
    if out_path:
        out.close()
    return rc
