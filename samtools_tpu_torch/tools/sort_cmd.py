"""samtools sort: order alignments by coordinate, name, tag, template
coordinate or minimiser.

Counterpart of samtools_tpu/tools/sort_cmd.py (samtools' bam_sort.c).
Every order is one stable sort over the columnar batch; samtools'
tie-break by input index is that stability.  A BAM path sorted into BAM,
SAM or gzip'd SAM goes through the spill sorter (``io/extsort.py``):
batches fill a ``-m`` arena (times the ``-@`` threads), full arenas spill
as sorted runs under ``-T``'s prefix, and the runs merge into a streamed
writer; an input that fits is written whole.  Standard input, SAM or
CRAM input, CRAM output, ``-M`` and a stream that fails before any
output read the whole file instead.  Both paths write the same bytes.  A
host command: no device work.
"""

from __future__ import annotations

import os
import sys

from .. import SAMTOOLS_PARITY_VERSION
from ..io.extsort import SpillSorter
from ..io.files import (StreamingWriter, infer_output_format,
                        read_alignments, write_alignments)
from ..ops import sort_keys as sk
from ..ops.minhash import minhash_order
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     open_stream, print_error, print_error_errno)
from .index_cmd import build_index_for


def usage(fp):
    fp.write(
        "Usage: samtools sort [options...] [in.bam]\n"
        "Options:\n"
        "  -l INT     Set compression level, from 0 (uncompressed) to 9 (best)\n"
        "  -u         Output uncompressed data (equivalent to -l 0)\n"
        "  -m INT     Set maximum memory per thread; suffix K/M/G recognized [768M]\n"
        "  -M         Use minimiser for clustering unaligned/unplaced reads\n"
        "  -R         Do not use reverse strand (only compatible with -M)\n"
        "  -K INT     Kmer size to use for minimiser [20]\n"
        "  -I FILE    Order minimisers by their position in FILE fasta\n"
        "  -w INT     Window size for minimiser indexing via -I ref.fa [100]\n"
        "  -H         Squash homopolymers when computing minimiser\n"
        "  -n         Sort by read name (natural): cannot be used with samtools index\n"
        "  -N         Sort by read name (ASCII): cannot be used with samtools index\n"
        "  -t TAG     Sort by value of TAG. Uses position as secondary index (or read name if -n is set)\n"
        "  -o FILE    Write final output to FILE rather than standard output\n"
        "  -T PREFIX  Write temporary files to PREFIX.nnnn.bam\n"
        "  --no-PG\n"
        "               Do not add a PG line\n"
        "      --template-coordinate\n"
        "               Sort by template-coordinate\n")


def sort_header(header, order: str, natural: bool, tag: str | None,
                mapped: bool, tag_by_name: bool = False):
    """set_sort_order (bam_sort.c:3270): stamp @HD SO/SS/GO.
    ``tag_by_name``: the header names the read name, not the position,
    as a tag order's secondary key (``-t`` when the last order option
    was ``-n`` or ``-N``)."""
    if order == "coordinate":
        return header.ensure_hd_so("coordinate")
    if order == "queryname":
        ss = "queryname:natural" if natural else "queryname:lexicographical"
        return header.ensure_hd_so("queryname", subsort=ss)
    if order == "tag":
        sec = (("queryname:natural" if natural else
                "queryname:lexicographical") if tag_by_name
               else "coordinate")
        return header.ensure_hd_so("unsorted", subsort=f"unsorted:{tag}:{sec}")
    if order == "template-coordinate":
        h = header.ensure_hd_so("unsorted",
                                subsort="unsorted:template-coordinate")
        return _set_go(h, "query")
    if order == "minhash":
        if mapped:
            return header.ensure_hd_so("coordinate",
                                       subsort="coordinate:minhash")
        return header.ensure_hd_so("unsorted", subsort="unsorted:minhash")
    return header


def _set_go(header, go: str):
    """The @HD line with GO:``go`` after its SO field (htslib's tag
    order: VN SO GO SS), any SS moved last."""
    lines = header.text.split("\n")
    for i, line in enumerate(lines):
        if line.startswith("@HD"):
            out = []
            inserted = False
            for f in line.split("\t"):
                if f.startswith("GO:"):
                    continue
                out.append(f)
                if f.startswith("SO:"):
                    out.append("GO:" + go)
                    inserted = True
            if not inserted:
                out.append("GO:" + go)
            out = ([f for f in out if not f.startswith("SS:")]
                   + [f for f in out if f.startswith("SS:")])
            lines[i] = "\t".join(out)
            break
    return header.with_text("\n".join(lines))


def _order_key_fn(order, natural, by_tag, name_seen):
    """(header -> batch -> key columns, kind) for the orders the spill
    sorter can merge; (None, None) for ``minhash``, which rewrites
    records."""
    if order == "coordinate":
        return (lambda hdr: sk.coordinate_keys), "lex"
    if order == "queryname":
        return (lambda hdr: (lambda b: sk.queryname_keys(b, natural))), \
            "lex"
    if order == "tag":
        return (lambda hdr: (lambda b: sk.tag_keys(b, by_tag, name_seen,
                                                   natural))), "lex"
    if order == "template-coordinate":
        return (lambda hdr: (
            lambda b: sk.template_coordinate_keys(b, hdr))), "py"
    return None, None


def _pg_header(header, argv, no_pg):
    if no_pg:
        return header
    cl = "samtools sort " + " ".join(argv) if argv else "samtools sort"
    return header.add_pg_line("samtools", "samtools", cl,
                              SAMTOOLS_PARITY_VERSION)


def _try_external_sort(fn_in, fn_out, order, natural, by_tag, tag_by_name,
                       key_fn_maker, key_kind, max_mem, tmpprefix, level,
                       no_pg, argv, ga) -> int | None:
    """Sort ``fn_in`` through the spill sorter.  Returns the exit code, or
    None when the whole-file path must take over (not a BGZF BAM, CRAM
    output, or the file cannot be opened: that path reports it)."""
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    if fmt not in ("bam", "sam", "sam.gz"):
        return None
    try:
        stream = open_stream(fn_in, ga.nthreads)
    except OSError:
        return None
    if stream is None:
        return None

    mem = max_mem * max(1, ga.nthreads)
    prefix = tmpprefix or ((fn_out or "samtools") + f".tmp.{os.getpid()}")
    pack_fn = None
    if order == "coordinate" and stream.header.n_refs < (1 << 30) - 1:
        # BAM positions are int32, so the packed key always fits: the
        # merge runs on one uint64 key a record
        pack_fn = sk.coordinate_pack
    sorter = SpillSorter(key_fn_maker(stream.header), key_kind, mem,
                         prefix, pack_fn=pack_fn)
    try:
        mapped = False
        for b in stream.batches():
            mapped = mapped or bool((b.tid >= 0).any())
            sorter.add(b)
        mode, result = sorter.finish()
    except Exception as e:
        print_error("sort", "error while sorting: %s", e)
        return 1
    finally:
        stream.close()

    header = _pg_header(sort_header(stream.header, order, natural, by_tag,
                                    mapped, tag_by_name), argv, no_pg)
    try:
        if mode == "mem":
            write_alignments(fn_out, header, result, fmt=fmt,
                             threads=ga.nthreads, level=level,
                             include_header=True)
        else:
            w = StreamingWriter(fn_out, header, fmt,
                                threads=ga.nthreads, level=level)
            try:
                for chunk in result:
                    w.write_batch(chunk)
            finally:
                result.close()      # removes the spill runs
                w.close()
    except OSError as e:
        print_error_errno("sort", 'failed writing to "%s"',
                          fn_out or "-", exc=e)
        return 1
    if ga.write_index and fn_out and fmt == "bam":
        build_index_for(fn_out, None, False, 14, ga.nthreads)
    return 0


def main_sort(argv: list[str]) -> int:
    ga = GlobalArgs()
    order = "coordinate"
    natural = True
    by_tag = None
    fn_out = None
    level = 6
    no_pg = False
    max_mem = 768 << 20  # bam_sort.c SORT_DEFAULT_MEGS_PER_THREAD
    tmpprefix = None
    minimiser_kmer = 20
    minimiser_ref = None
    minimiser_window = 100
    try_rev = True
    no_squash = True
    try:
        opts, args = gnu_getopt(argv, "l:m:no:O:T:@:t:MNK:I:Rw:Hu",
                                ["no-PG", "template-coordinate"])
    except UsageError:
        usage(sys.stderr)
        return 1
    name_seen = False
    tag_by_name = False
    for o, v in opts:
        if o == "-o":
            fn_out = v
        elif o == "-N":
            natural = False
            order = "queryname"
            name_seen = True
        elif o == "-n":
            order = "queryname"
            name_seen = True
        elif o == "-t":
            by_tag = v
        elif o == "-m":
            mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(
                v[-1:].upper())
            try:
                max_mem = (int(float(v[:-1]) * mult) if mult
                           else int(float(v)))
            except ValueError:
                print_error("sort", "invalid memory limit \"%s\"", v)
                return 1
        elif o == "-T":
            tmpprefix = v
        elif o == "-l":
            level = int(v)
        elif o == "-u":
            level = 0
        elif o == "-M":
            order = "minhash"
        elif o == "-K":
            minimiser_kmer = int(v)
        elif o == "-I":
            order = "minhash"  # implied (bam_sort.c:3813)
            minimiser_ref = v
        elif o == "-R":
            try_rev = False
        elif o == "-w":
            minimiser_window = int(v)
        elif o == "-H":
            no_squash = False
        elif o == "--template-coordinate":
            order = "template-coordinate"
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1
    if by_tag is not None:
        tag_by_name = order == "queryname"
        order = "tag"
    if len(args) > 1:
        # the obsolete "sort in.bam out.prefix" form fails
        print_error("sort", "too many arguments. The output name should be "
                    "given via -o instead")
        return 1
    fn_in = args[0] if args else "-"

    key_fn, key_kind = _order_key_fn(order, natural, by_tag, name_seen)
    if key_fn is not None and fn_in != "-":
        rc = _try_external_sort(fn_in, fn_out, order, natural, by_tag,
                                tag_by_name, key_fn, key_kind, max_mem,
                                tmpprefix, level, no_pg, argv, ga)
        if rc is not None:
            return rc

    try:
        f = read_alignments(fn_in, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("sort", 'can\'t open "%s"', fn_in, exc=e)
        return 1
    b = f.batch

    if order == "coordinate":
        idx = sk.coordinate_order(b)
    elif order == "queryname":
        idx = sk.queryname_order(b, natural)
    elif order == "tag":
        idx = sk.tag_order(b, by_tag, name_seen, natural)
    elif order == "template-coordinate":
        try:
            idx = sk.template_coordinate_order(b, f.header)
        except ValueError as e:
            sys.stderr.write(f"[bam_sort] error: {e}\n")
            return 1
    else:
        idx = minhash_order(b, kmer=minimiser_kmer, try_rev=try_rev,
                            no_squash=no_squash, ref_fa=minimiser_ref,
                            ref_window=minimiser_window)
        # final_out (bam_sort.c:1959) clears the unmapped records' key
        # fields on output
        unm = b.tid < 0
        b.pos[unm] = -1
        b.mpos[unm] = -1
        b.tlen[unm] = 0

    out = b.take(idx)
    mapped = bool((b.tid >= 0).any())
    header = _pg_header(sort_header(f.header, order, natural, by_tag,
                                    mapped, tag_by_name), argv, no_pg)
    fmt = infer_output_format(fn_out, ga.out_fmt, "bam")
    write_alignments(fn_out, header, out, fmt=fmt, threads=ga.nthreads,
                     level=level, include_header=True)
    if ga.write_index and fn_out and fmt == "bam":
        build_index_for(fn_out, None, False, 14, ga.nthreads)
    return 0
