"""samtools view: convert and filter SAM, BAM and CRAM.

Counterpart of samtools_tpu/tools/view_cmd.py (samtools' sam_view.c).
The per-record filter chain process_aln (sam_view.c:151-230) is one
boolean mask over the columnar batch; subsampling is khash's
Wang(X31(qname) ^ seed) with glibc's ``rand()`` seed scramble.  Two paths
print the same bytes: with no region, no ``-U``/``-p``/``-P``, no
``--write-index``, a path (not ``-``) and a BAM input, ``_stream_view``
filters the file a window at a time into a ``StreamingWriter``; anything
else (and CRAM output) reads the whole file.  A host command: no device
work.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core.flags import FPROPER_PAIR, FUNMAP
from ..core.regions import Region, RegionError, parse_region
from ..io import bed as bedmod
from ..io.files import (StreamingWriter, infer_output_format,
                        read_alignments, write_alignments)
from ..io.stream import BamStream
from ..ops import filters as fops
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno, try_region_read)
from .flags_cmd import str2flag


def usage(fp, long_help: bool = False):
    fp.write(
        "Usage: samtools view [options] <in.bam>|<in.sam>|<in.cram> [region ...]\n"
        "\n"
        "Output options:\n"
        "  -b, --bam                  Output BAM\n"
        "  -C, --cram                 Output CRAM (requires -T)\n"
        "  -1, --fast                 Use fast BAM compression (and default to --bam)\n"
        "  -u, --uncompressed         Uncompressed BAM output (and default to --bam)\n"
        "  -h, --with-header          Include header in SAM output\n"
        "  -H, --header-only          Print SAM header only (no alignments)\n"
        "      --no-header            Print SAM alignment records only\n"
        "  -c, --count                Print only the count of matching records\n"
        "  -o, --output FILE          Write output to FILE [standard output]\n"
        "  -U, --unoutput FILE, --output-unselected FILE\n"
        "                             Output reads not selected by filters to FILE\n"
        "  -p, --unmap                Set flag to UNMAP on reads not selected\n"
        "                             then write to output file.\n"
        "Input options:\n"
        "  -t, --fai-reference FILE   FILE listing reference names and lengths\n"
        "  -M, --use-index            Use index and multi-region iterator for regions\n"
        "      --region[s]-file FILE  Use index to include only reads overlapping FILE\n"
        "  -X, --customized-index     Expect extra index file argument after <in.bam>\n"
        "\n"
        "Filtering options (Only include in output reads that...):\n"
        "  -L, --target[s]-file FILE  ...overlap (BED) regions in FILE\n"
        "  -r, --read-group STR       ...are in read group STR\n"
        "  -R, --read-group-file FILE ...are in a read group listed in FILE\n"
        "  -N, --qname-file FILE      ...whose read name is listed in FILE\n"
        "  -d, --tag STR1[:STR2]      ...have a tag STR1 (with associated value STR2)\n"
        "  -D, --tag-file STR:FILE    ...have a tag STR whose value is listed in FILE\n"
        "  -q, --min-MQ INT           ...have mapping quality >= INT\n"
        "  -l, --library STR          ...are in library STR\n"
        "  -m, --min-qlen INT         ...cover >= INT query bases (as measured via CIGAR)\n"
        "  -e, --expr STR             ...match the filter expression STR\n"
        "  -f, --require-flags FLAG   ...have all of the FLAGs present\n"
        "  -F, --excl[ude]-flags FLAG ...have none of the FLAGs present\n"
        "      --rf, --incl[ude]-flags FLAG  ...have some of the FLAGs present\n"
        "  -G FLAG                    EXCLUDE reads with all of the FLAGs present\n"
        "      --subsample FLOAT      Keep only FLOAT fraction of templates/read pairs\n"
        "      --subsample-seed INT   Influence WHICH reads are kept in subsampling [0]\n"
        "  -s INT.FRAC                Same as --subsample 0.FRAC --subsample-seed INT\n"
        "\n"
        "Processing options:\n"
        "      --add-flags FLAG       Add FLAGs to reads\n"
        "      --remove-flags FLAG    Remove FLAGs from reads\n"
        "  -x, --remove-tag STR\n"
        "               Comma-separated read tags to strip (repeatable) [null]\n"
        "      --keep-tag STR\n"
        "               Comma-separated read tags to preserve (repeatable) [null].\n"
        "               Equivalent to \"-x ^STR\"\n"
        "  -B, --remove-B             Collapse the backward CIGAR operation\n"
        "  -z, --sanitize FLAG[,FLAG] Perform sanity checks and fixes on records.\n"
        "      --no-PG                Do not add a PG line\n"
        "\n"
        "General options:\n"
        "  -?, --help   Print long help, including note about region specification\n"
        "  -S           Ignored (input format is auto-detected)\n"
        "      --input-fmt-option OPT[=VAL]\n"
        "               Specify a single input file format option in the form\n"
        "               of OPTION or OPTION=VALUE\n"
        "  -O, --output-fmt FORMAT[,OPT[=VAL]]...\n"
        "               Specify output format (SAM, BAM, CRAM)\n"
        "      --output-fmt-option OPT[=VAL]\n"
        "               Specify a single output file format option in the form\n"
        "               of OPTION or OPTION=VALUE\n"
        "  -T, --reference FILE\n"
        "               Reference sequence FASTA FILE [null]\n"
        "  -@, --threads INT\n"
        "               Number of additional threads to use [0]\n"
        "      --write-index  Automatically index the output files [off]\n"
        "      --verbosity INT\n"
        "               Set level of verbosity\n")


def _load_lines_set(path: str) -> set:
    with open(path, "rt") as f:
        return {line.rstrip("\r\n") for line in f if line.rstrip("\r\n")}


def _stream_view(stream, f, header, args, ga, fn_out, fn_counts,
                 is_count, is_header, is_header_only, out_fmt_flag,
                 compress_level, add_flag, remove_flag, keep_tags,
                 remove_tags) -> int:
    """Bounded-memory filter pipeline: decode window -> keep mask ->
    transforms -> incremental writer (sam_view.c:772 stream_view)."""

    out_fmt = infer_output_format(fn_out, ga.out_fmt or out_fmt_flag,
                                  "sam")
    level = compress_level if compress_level >= 0 else \
        int(ga.out_opts.get("level", 6))
    include_header = is_header if out_fmt in ("sam", "sam.gz") else True

    writer = None
    total = 0
    try:
        if not is_count:
            if out_fmt not in ("bam", "sam", "sam.gz"):
                # CRAM output needs the whole batch today
                raise _StreamFallback()
            writer = StreamingWriter(fn_out, header, out_fmt,
                                     threads=ga.nthreads, level=level,
                                     include_header=include_header)
            if is_header_only:
                writer.close()
                return 0
        elif is_header_only:
            pass
        for wb in stream.batches():
            fw = types.SimpleNamespace(batch=wb, header=header)
            keep = build_keep_mask(fw, args, ga)
            total += int(keep.sum())
            if writer is not None:
                ob = wb.take(np.nonzero(keep)[0])
                _apply_transforms(ob, args, add_flag, remove_flag,
                                  keep_tags, remove_tags)
                writer.write_batch(ob)
    except _StreamFallback:
        # reload in memory through the generic path
        g = read_alignments(stream.path, threads=ga.nthreads,
                            reference=ga.reference)
        keep = build_keep_mask(g, args, ga)
        ob = g.batch.take(np.nonzero(keep)[0])
        _apply_transforms(ob, args, add_flag, remove_flag, keep_tags,
                          remove_tags)
        write_alignments(fn_out, header, ob, fmt=out_fmt,
                         threads=ga.nthreads, level=level,
                         include_header=include_header,
                         reference=ga.reference, fmt_opts=ga.out_opts)
        total = ob.n
    finally:
        if writer is not None:
            writer.close()
        stream.close()
    if is_count:
        line = str(total) + "\n"
        if fn_out:
            with open(fn_out, "wt") as fh:
                fh.write(line)
        else:
            sys.stdout.write(line)
    if fn_counts:
        with open(fn_counts, "wt") as fh:
            fh.write(str(total) + "\n")
    return 0


class _StreamFallback(Exception):
    pass


def build_keep_mask(f, args, ga) -> np.ndarray:
    """Vectorized process_aln over the whole batch."""
    b = f.batch
    keep = np.ones(b.n, bool)
    if args["min_qlen"] > 0:
        keep &= fops.qlen_from_cigar(b) >= args["min_qlen"]
    if args["min_mapq"] > 0:
        keep &= b.mapq.astype(np.int64) >= args["min_mapq"]
    keep &= fops.flag_mask(b, args["flag_on"], args["flag_off"],
                           args["flag_anyon"], args["flag_alloff"])
    bidx = args["bed"]
    if bidx is not None and not args["multi_region"]:
        end = b.end_pos()
        hit = np.zeros(b.n, bool)
        for t in range(f.header.n_refs):
            sel = np.nonzero(b.tid == t)[0]
            if sel.size:
                hit[sel] = bidx.overlap(f.header.ref_names[t],
                                        b.pos[sel], end[sel])
        keep &= hit
    if args["subsam_frac"] > 0.0:
        keep &= fops.subsample_keep(b, args["subsam_frac"],
                                    args["subsam_seed"])
    if args["rghash"] is not None or args["exclude_no_rg"]:
        rg = auxmod.batch_tag_values(b, "RG")
        have = np.array([v is not None for v in rg], bool)
        if args["rghash"] is not None:
            inset = np.array([v in args["rghash"] if v is not None else False
                              for v in rg], bool)
            # absent RG records pass the rghash check (reference behavior)
            keep &= inset | ~have
        if args["exclude_no_rg"]:
            keep &= have
    if args["tag"] is not None:
        vals = auxmod.batch_tag_str_values(b, args["tag"])
        if args["tvhash"] is not None:
            keep &= np.array([v in args["tvhash"] if v is not None else False
                              for v in vals], bool)
        else:
            raw = auxmod.batch_tag_values(b, args["tag"])
            keep &= np.array([v is not None for v in raw], bool)
    if args["rnhash"] is not None:
        names = fops.qnames_array(b)
        keep &= np.array(
            [n.decode("latin-1") in args["rnhash"] for n in names], bool)
    if args["library"] is not None:
        lbmap = _rg_to_library(f.header)
        rg = auxmod.batch_tag_values(b, "RG")
        keep &= np.array(
            [rg[i] is not None and lbmap.get(rg[i]) == args["library"]
             for i in range(b.n)], bool)
    if args["expr"] is not None:
        from ..core.sam_expr import compile_filter
        keep &= compile_filter(args["expr"])(f.header, b)
    return keep


def _rg_to_library(header) -> dict:
    out = {}
    for line in header.lines():
        if line.startswith("@RG"):
            rid = lb = None
            for fld in line.split("\t")[1:]:
                if fld.startswith("ID:"):
                    rid = fld[3:]
                elif fld.startswith("LB:"):
                    lb = fld[3:]
            if rid is not None:
                out[rid] = lb
    return out


def region_mask(f, regions: list[Region]) -> np.ndarray:
    """Reads overlapping any region (index-iterator emulation over the
    in-memory batch; multi-region semantics = dedup)."""
    b = f.batch
    keep = np.zeros(b.n, bool)
    end = None
    for reg in regions:
        if reg.tid == -2:
            keep[:] = True
        elif reg.tid == -1:
            keep |= b.tid == -1
        else:
            if end is None:
                end = b.end_pos()
            keep |= ((b.tid == reg.tid) & (b.pos < reg.end)
                     & (end > reg.beg))
    return keep


def main_view(argv: list[str]) -> int:
    ga = GlobalArgs()
    args = dict(
        flag_on=0, flag_off=0, flag_anyon=0, flag_alloff=0,
        min_mapq=0, min_qlen=0, library=None, bed=None, tag=None,
        tvhash=None, rghash=None, rnhash=None, exclude_no_rg=False,
        subsam_frac=-1.0, subsam_seed=0, subsam_seed_auto=True,
        multi_region=False, expr=None, remove_B=False,
    )
    out_fmt_flag = None
    is_header = False
    is_header_only = False
    no_header = False
    is_count = False
    fn_out = None
    fn_un_out = None
    fn_counts = None
    fn_fai = None
    compress_level = -1
    no_pg = False
    unmap = False
    has_index_file = False
    keep_tags: set | None = None
    remove_tags: set = set()
    add_flag = 0
    remove_flag = 0
    region_file_regs = None
    sanitize = None

    longopts = [
        "add-flags=", "bam", "count", "cram", "customised-index",
        "customized-index", "excl-flags=", "exclude-flags=",
        "excl-no-read-group", "excl-no-readgroup", "exclude-no-read-group",
        "exclude-no-readgroup", "expr=", "expression=", "fai-reference=",
        "fast", "fetch-pairs", "header-only", "help", "incl-flags=",
        "include-flags=", "rf=", "keep-tag=", "library=", "min-mapq=",
        "min-MQ=", "min-mq=", "min-qlen=", "no-header", "no-PG", "output=",
        "output-unselected=", "QNAME-file=", "qname-file=", "read-group=",
        "read-group-file=", "readgroup=", "readgroup-file=", "region-file=",
        "regions-file=", "remove-B", "remove-flags=", "remove-tag=",
        "require-flags=", "save-counts=", "subsample=", "subsample-seed=",
        "tag=", "tag-file=", "target-file=", "targets-file=", "uncompressed",
        "unmap", "unoutput=", "use-index", "with-header", "sanitize=",
    ]
    try:
        opts, pos_args = gnu_getopt(
            argv, "SbBcCt:h1Ho:O:q:f:F:G:ul:r:T:R:N:d:D:L:s:@:m:x:U:MXe:pPz:n?",
            longopts)
    except UsageError as e:
        print_error("view", "%s", e)
        return 1

    fetch_pairs = False
    for o, v in opts:
        if o in ("-b", "--bam"):
            out_fmt_flag = "bam"
        elif o in ("-C", "--cram"):
            out_fmt_flag = "cram"
        elif o == "-S":
            pass
        elif o in ("-1", "--fast"):
            compress_level = 1
            if out_fmt_flag is None:
                out_fmt_flag = "bam"
        elif o in ("-u", "--uncompressed"):
            compress_level = 0
            if out_fmt_flag is None:
                out_fmt_flag = "bam"
        elif o in ("-h", "--with-header"):
            is_header = True
        elif o in ("-H", "--header-only"):
            is_header_only = True
        elif o == "--no-header":
            is_header = is_header_only = False
            no_header = True
        elif o in ("-c", "--count"):
            is_count = True
        elif o == "--save-counts":
            fn_counts = v
        elif o in ("-o", "--output"):
            fn_out = v
        elif o in ("-U", "--unoutput", "--output-unselected"):
            fn_un_out = v
        elif o in ("-t", "--fai-reference"):
            fn_fai = v
        elif o in ("-X", "--customised-index", "--customized-index"):
            has_index_file = True
        elif o in ("-f", "--require-flags"):
            args["flag_on"] |= str2flag(v)
        elif o in ("-F", "--excl-flags", "--exclude-flags"):
            args["flag_off"] |= str2flag(v)
        elif o in ("--rf", "--incl-flags", "--include-flags"):
            args["flag_anyon"] |= str2flag(v)
        elif o == "-G":
            args["flag_alloff"] |= str2flag(v)
        elif o in ("-q", "--min-mapq", "--min-MQ", "--min-mq"):
            args["min_mapq"] = int(v)
        elif o in ("-m", "--min-qlen"):
            args["min_qlen"] = int(v)
        elif o in ("-l", "--library"):
            args["library"] = v
        elif o in ("-r", "--read-group", "--readgroup"):
            args["rghash"] = (args["rghash"] or set()) | {v}
        elif o in ("-R", "--read-group-file", "--readgroup-file"):
            args["rghash"] = (args["rghash"] or set()) | _load_lines_set(v)
        elif o in ("-N", "--qname-file", "--QNAME-file"):
            args["rnhash"] = (args["rnhash"] or set()) | _load_lines_set(v)
        elif o == "-n" or o.startswith("--excl-no") or o.startswith("--exclude-no"):
            args["exclude_no_rg"] = True
        elif o in ("-d", "--tag"):
            if ":" in v:
                t, val = v.split(":", 1)
                args["tag"] = t
                args["tvhash"] = (args["tvhash"] or set()) | {val}
            else:
                args["tag"] = v
        elif o in ("-D", "--tag-file"):
            t, _, path = v.partition(":")
            args["tag"] = t
            args["tvhash"] = (args["tvhash"] or set()) | _load_lines_set(path)
        elif o in ("-L", "--target-file", "--targets-file"):
            args["bed"] = bedmod.read_bed(v)
        elif o in ("--region-file", "--regions-file"):
            region_file_regs = bedmod.read_bed(v)
            args["multi_region"] = True
        elif o == "-s":
            if v.lower().startswith("auto."):
                args["subsam_seed_auto"] = True
                args["subsam_frac"] = float(v[4:])
            else:
                seed_s, dot, frac_s = v.partition(".")
                if not dot:
                    print_error("view",
                                'Incorrect sampling argument "%s"', v)
                    return 1
                args["subsam_seed"] = int(seed_s or 0)
                args["subsam_frac"] = float("0." + frac_s)
                args["subsam_seed_auto"] = False
        elif o == "--subsample":
            args["subsam_frac"] = float(v)
            if not (0.0 <= args["subsam_frac"] <= 1.0):
                print_error("view", 'Incorrect sampling argument "%s"', v)
                return 1
        elif o == "--subsample-seed":
            args["subsam_seed"] = int(v)
            args["subsam_seed_auto"] = False
        elif o in ("-x", "--remove-tag"):
            if v.startswith("^"):
                keep_tags = (keep_tags or set()) | set(v[1:].split(","))
            else:
                remove_tags |= set(v.split(","))
        elif o == "--keep-tag":
            keep_tags = (keep_tags or set()) | set(v.split(","))
        elif o == "--add-flags":
            add_flag |= str2flag(v)
        elif o == "--remove-flags":
            remove_flag |= str2flag(v)
        elif o in ("-B", "--remove-B"):
            args["remove_B"] = True
        elif o in ("-p", "--unmap"):
            unmap = True
        elif o in ("-P", "--fetch-pairs"):
            fetch_pairs = True
            args["multi_region"] = True
        elif o in ("-z", "--sanitize"):
            sanitize = v
        elif o in ("-M", "--use-index"):
            args["multi_region"] = True
        elif o == "--no-PG":
            no_pg = True
        elif o in ("-e", "--expr", "--expression"):
            args["expr"] = v
        elif o in ("-?", "--help"):
            usage(sys.stdout, True)
            return 0
        elif handle_global_opt(ga, o, v, short_outfmt="-O",
                               short_reference="-T"):
            pass
        else:
            usage(sys.stderr)
            return 1

    if unmap and fn_un_out:
        print_error("view",
                    "Options --unoutput and --unmap are mutually exclusive.")
        return 1
    if not argv and sys.stdin.isatty():
        usage(sys.stdout)
        return 0

    fn_in = pos_args[0] if pos_args else "-"
    region_args = pos_args[1:]
    if has_index_file and region_args:
        region_args = region_args[1:]  # skip the explicit index argument

    try:
        f = None
        # single-region + no unselected-output: index-driven byte-range
        # read (multi_region_view path, sam_view.c:791); everything
        # downstream re-applies the region mask so output is unchanged
        if (len(region_args) == 1 and not fn_un_out and not fetch_pairs
                and not unmap):
            got = try_region_read(fn_in, ga.nthreads, region_args[0])
            if got is not None:
                f, _ = got
        stream = None
        if (f is None and not region_args and region_file_regs is None
                and not fetch_pairs and not unmap and not fn_un_out
                and not (args["bed"] is not None and args["multi_region"])
                and not ga.write_index and fn_in != "-"):
            # default filter pipeline: stream in bounded windows
            # (stream_view, sam_view.c:772) when nothing needs the
            # whole file at once
            try:
                st = BamStream(fn_in, threads=ga.nthreads or 2)
                stream = st
                f = types.SimpleNamespace(header=st.header, batch=None)
            except OSError as e:
                print_error_errno("view",
                                  'failed to open "%s" for reading',
                                  fn_in, exc=e)
                return 1
            except Exception:
                stream = None
                f = None
        if f is None:
            f = read_alignments(fn_in, threads=ga.nthreads,
                                reference=ga.reference)
    except RegionError as e:
        print_error("view", "%s", e)
        return 1
    except OSError as e:
        print_error_errno("view", 'failed to open "%s" for reading', fn_in,
                          exc=e)
        return 1
    header = f.header

    # subsample seed derivation + @CO line (sam_view.c:1367-1395)
    if args["subsam_frac"] > 0.0:
        if args["subsam_seed_auto"]:
            args["subsam_seed"] = fops.fnv1a_hash_bytes(
                header.text.encode("latin-1"))
        co = "Sub-sampled fraction=%g seed=%d" % (args["subsam_frac"],
                                                  args["subsam_seed"])
        text = header.text
        if text and not text.endswith("\n"):
            text += "\n"
        header = header.with_text(text + "@CO\t" + co + "\n")
        if args["subsam_seed"] != 0:
            args["subsam_seed"] = fops.glibc_rand_first(args["subsam_seed"])

    if not no_pg and not is_count:
        cl = "samtools view " + " ".join(argv) if argv else "samtools view"
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)

    if stream is not None:
        return _stream_view(stream, f, header, args, ga, fn_out,
                            fn_counts, is_count, is_header,
                            is_header_only, out_fmt_flag, compress_level,
                            add_flag, remove_flag, keep_tags, remove_tags)

    b = f.batch
    sel = np.ones(b.n, bool)
    if region_args:
        try:
            regions = [parse_region(r, header.tid) for r in region_args]
        except RegionError as e:
            print_error("view", "%s", e)
            return 1
        sel &= region_mask(f, regions)
    if region_file_regs is not None:
        end = b.end_pos()
        hit = np.zeros(b.n, bool)
        for t in range(header.n_refs):
            m = np.nonzero(b.tid == t)[0]
            if m.size:
                hit[m] = region_file_regs.overlap(header.ref_names[t],
                                                  b.pos[m], end[m])
        sel &= hit
    if args["bed"] is not None and args["multi_region"]:
        end = b.end_pos()
        hit = np.zeros(b.n, bool)
        for t in range(header.n_refs):
            m = np.nonzero(b.tid == t)[0]
            if m.size:
                hit[m] = args["bed"].overlap(header.ref_names[t],
                                             b.pos[m], end[m])
        sel &= hit
    if fetch_pairs:
        # second pass: also keep mates of selected reads (by qname)
        names = fops.qnames_array(b)
        wanted = set(names[sel])
        sel = sel | np.array([n in wanted for n in names], bool)

    keep = sel & build_keep_mask(f, args, ga)

    if is_count:
        out_line = str(int(keep.sum()))
        if fn_out:
            with open(fn_out, "wt") as fh:
                fh.write(out_line + "\n")
        else:
            print(out_line)
        if fn_counts:
            with open(fn_counts, "wt") as fh:
                fh.write(out_line + "\n")
        return 0

    out_fmt = infer_output_format(fn_out, ga.out_fmt or out_fmt_flag, "sam")
    level = compress_level if compress_level >= 0 else \
        int(ga.out_opts.get("level", 6))

    if is_header_only:
        write_alignments(fn_out, header, b.take(np.empty(0, np.int64)),
                         fmt=out_fmt, threads=ga.nthreads, level=level,
                         header_only=True, fmt_opts=ga.out_opts)
        return 0

    if unmap:
        # keep everything; unselected records get unmapped in place
        drop = ~keep
        if drop.any():
            _unmap_records(b, drop)
        out_batch = b.take(np.nonzero(sel)[0])
    else:
        out_batch = b.take(np.nonzero(keep)[0])

    _apply_transforms(out_batch, args, add_flag, remove_flag,
                      keep_tags, remove_tags)

    # header in text output only with -h (sam_view.c writes it for binary
    # formats unconditionally)
    include_header = is_header if out_fmt in ("sam", "sam.gz") else True
    write_alignments(fn_out, header, out_batch, fmt=out_fmt,
                     threads=ga.nthreads, level=level,
                     include_header=include_header,
                     reference=ga.reference,
                     write_index=ga.write_index, fmt_opts=ga.out_opts)
    if ga.write_index and fn_out and out_fmt == "bam":
        from .index_cmd import build_index_for
        build_index_for(fn_out, None, False, 14, ga.nthreads)

    if fn_un_out:
        un_batch = b.take(np.nonzero(sel & ~keep)[0])
        _apply_transforms(un_batch, args, add_flag, remove_flag,
                          keep_tags, remove_tags)
        un_fmt = infer_output_format(fn_un_out, ga.out_fmt or out_fmt_flag,
                                     "sam")
        write_alignments(fn_un_out, header, un_batch, fmt=un_fmt,
                         threads=ga.nthreads, level=level,
                         include_header=(is_header if un_fmt in
                                         ("sam", "sam.gz") else True),
                         reference=ga.reference, fmt_opts=ga.out_opts)
    if fn_counts:
        with open(fn_counts, "wt") as fh:
            fh.write(str(out_batch.n) + "\n")
    return 0


def _unmap_records(b, mask: np.ndarray):
    """view -p: unmap unselected records in place (flag only; keeps
    position for sort stability, as bam_sanitize/unmap does minimal)."""
    f = b.flag.astype(np.int64)
    f[mask] |= FUNMAP
    f[mask] &= ~(FPROPER_PAIR)
    b.flag = f.astype(np.uint16)


def _apply_transforms(batch, args, add_flag, remove_flag,
                      keep_tags, remove_tags):
    if args["remove_B"]:
        _remove_B(batch)
    if add_flag:
        batch.flag = (batch.flag.astype(np.int64) | add_flag).astype(np.uint16)
    if remove_flag:
        batch.flag = (batch.flag.astype(np.int64)
                      & ~remove_flag).astype(np.uint16)
    if keep_tags is not None or remove_tags:
        auxmod.batch_adjust_tags(batch, keep=keep_tags,
                                 remove=remove_tags or None)


def _remove_B(batch):
    """bam_remove_B analog (legacy B CIGAR op removal, bam.c:163).  B ops
    are vanishingly rare; per-record handling only when present."""
    has_b = np.nonzero([(batch.cigar_of(i) & 0xF == 9).any()
                        for i in range(batch.n)])[0]
    # full B-op rewind logic is legacy (colorspace); drop the op and keep
    # the record otherwise intact for records that carry it.
    for i in has_b:
        cig = batch.cigar_of(int(i))
        batch.cigar[batch.cigar_off[i]:batch.cigar_off[i + 1]] = np.where(
            (cig & 0xF) == 9, (0 << 4) | 0, cig)
