"""samtools merge: merge sorted alignment files, translating headers.

Counterpart of samtools_tpu/tools/merge_cmd.py (samtools' bam_sort.c
bam_merge, :1618, and bam_merge_core2, :1115): the merged @SQ
dictionary, @RG/@PG ID collisions renamed with hts_lrand48 suffixes
(gen_unique_id, :393) unless ``-c``/``-p`` combine them, PP/PG
cross-references fixed, each record's tid, RG and PG translated
(bam_translate, :948), an ordered merge with the file index breaking
ties, ``-r``'s RG from each file name, and ``-R``/``-L`` filters.  A
coordinate merge of BGZF BAMs into BAM, SAM or gzip'd SAM (no ``-t``,
``-R``, ``-L`` or ``--write-index``) streams: each file's batches are
translated as they come and merged on packed keys
(``io/extsort.merge_packed_iters``) into a streamed writer; any other
merge reads every file whole.  A host command: no device work.
"""

from __future__ import annotations

import os
import sys
import time
import types

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import aux as auxmod
from ..core import flags as F
from ..core.batch import ReadBatch
from ..core.regions import RegionError, parse_region
from ..io import bed as bedmod
from ..io.extsort import merge_packed_iters
from ..io.files import (StreamingWriter, infer_output_format,
                        read_alignments, write_alignments)
from ..io.header import SamHeader
from ..ops import sort_keys as sk
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     open_stream, print_error, print_error_errno)
from .index_cmd import build_index_for


class Drand48:
    """hts_srand48/lrand48 (POSIX drand48 semantics)."""

    A = 0x5DEECE66D
    C = 0xB
    M = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16 | 0x330E) & self.M

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.M
        return self.x >> 17


def usage(fp):
    fp.write(
        "Usage: samtools merge [options] -o <out.bam> [options] "
        "<in1.bam> ... <inN.bam>\n"
        "   or: samtools merge [options] <out.bam> <in1.bam> ... "
        "<inN.bam>\n"
        "\n"
        "Options:\n"
        "  -n         Input files are sorted by read name (natural)\n"
        "  -N         Input files are sorted by read name (ASCII)\n"
        "  -t TAG     Input files are sorted by TAG value\n"
        "  -r         Attach RG tag (inferred from file names)\n"
        "  -u         Uncompressed BAM output\n"
        "  -f         Overwrite the output BAM if exist\n"
        "  -1         Compress level 1\n"
        "  -l INT     Compression level, from 0 to 9 [-1]\n"
        "  -R STR     Merge file in the specified region STR [all]\n"
        "  -L FILE    Use the supplied bed file as a list of regions\n"
        "  -h FILE    Copy the header in FILE to <out.bam> [in1.bam]\n"
        "  -c         Combine @RG headers with colliding IDs [alter IDs to "
        "be distinct]\n"
        "  -p         Combine @PG headers with colliding IDs [alter IDs to "
        "be distinct]\n"
        "  -s VALUE   Override random seed\n"
        "  -b FILE    List of input BAM filenames, one per line [null]\n"
        "  -X         Use customized index files\n"
        "  --no-PG    do not add a PG line\n")


class MergedHeader:
    def __init__(self, rng: Drand48):
        self.hd = None
        self.sq_lines: list[str] = []
        self.sq_tids: dict[str, int] = {}
        self.sq_lens: list[int] = []
        self.rg_ids: set[str] = set()
        self.pg_ids: set[str] = set()
        self.out_rg: list[str] = []
        self.out_pg: list[str] = []
        self.out_co: list[str] = []
        self.rng = rng

    def gen_unique_id(self, prefix: str, ids: set, always: bool) -> str:
        if not always and prefix not in ids:
            return prefix
        while True:
            cand = "%s-%08X" % (prefix, self.rng.lrand48())
            if cand not in ids:
                return cand

    def add_file(self, header: SamHeader, merge_rg: bool, merge_pg: bool,
                 copy_co: bool, rg_override: str | None):
        """trans_tbl_init: returns (tid_trans, rg_map, pg_map)."""
        lines = header.lines()
        if self.hd is None:
            for line in lines:
                if line.startswith("@HD"):
                    self.hd = line
                    break
        # @SQ
        tid_trans = []
        for i, name in enumerate(header.ref_names):
            if name in self.sq_tids:
                tid_trans.append(self.sq_tids[name])
            else:
                tid = len(self.sq_lines)
                self.sq_tids[name] = tid
                sq_line = None
                for line in lines:
                    if line.startswith("@SQ") and f"\tSN:{name}" in line \
                            or (line.startswith("@SQ")
                                and line.split("\t")[1:]
                                and any(fld == f"SN:{name}"
                                        for fld in line.split("\t")[1:])):
                        sq_line = line
                        break
                if sq_line is None:
                    sq_line = f"@SQ\tSN:{name}\tLN:{header.ref_lens[i]}"
                self.sq_lines.append(sq_line)
                self.sq_lens.append(header.ref_lens[i])
                tid_trans.append(tid)
        # @RG then @PG
        rg_map, rg_new = self._trans_ids(lines, "RG", merge_rg, self.rg_ids,
                                         rg_override)
        pg_map, pg_new = self._trans_ids(lines, "PG", merge_pg, self.pg_ids,
                                         None)
        # fix PG: refs in new RG lines, PP: refs in new PG lines
        for line in rg_new:
            self.out_rg.append(self._fix_ref(line, "\tPG:", pg_map))
        for line in pg_new:
            self.out_pg.append(self._fix_ref(line, "\tPP:", pg_map))
        if copy_co:
            for line in lines:
                if line.startswith("@CO"):
                    self.out_co.append(line)
        return tid_trans, rg_map, pg_map

    def _trans_ids(self, lines, rec_type, merge, known_ids, override):
        id_map: dict[str, str] = {}
        new_lines: list[str] = []
        rec_lines = [l for l in lines if l.startswith("@" + rec_type)]
        for line in rec_lines:
            orig_id = None
            for fld in line.split("\t")[1:]:
                if fld.startswith("ID:"):
                    orig_id = fld[3:]
                    break
            if orig_id is None:
                continue
            not_found = orig_id not in known_ids
            if override:
                transformed = override
                not_found = transformed not in known_ids
                changed = True
            elif not_found or merge:
                transformed = orig_id
                changed = False
            else:
                transformed = self.gen_unique_id(orig_id, known_ids, True)
                changed = True
                not_found = True
            if not_found:
                out_line = line
                if changed:
                    out_line = self._replace_id(line, transformed)
                new_lines.append(out_line)
                known_ids.add(transformed)
            id_map[orig_id] = transformed
        if rec_type == "RG" and override and not rec_lines:
            new_id = self.gen_unique_id(override, known_ids, False)
            new_lines.append(f"@RG\tID:{new_id}")
            known_ids.add(new_id)
            id_map[""] = new_id
        return id_map, new_lines

    @staticmethod
    def _replace_id(line: str, new_id: str) -> str:
        fields = line.split("\t")
        out = []
        for fld in fields:
            if fld.startswith("ID:"):
                out.append("ID:" + new_id)
            else:
                out.append(fld)
        return "\t".join(out)

    @staticmethod
    def _fix_ref(line: str, search: str, pg_map: dict) -> str:
        pos = line.find(search)
        if pos < 0:
            return line
        start = pos + len(search)
        end = line.find("\t", start)
        if end < 0:
            end = len(line)
        old = line[start:end]
        new = pg_map.get(old)
        if new is None:
            sys.stderr.write(f"[W::finish_rg_pg] Tag {search[1:]}{old} not "
                             "found in @PG records\n")
            return line
        return line[:start] + new + line[end:]

    def finish(self) -> SamHeader:
        parts = []
        if self.hd:
            parts.append(self.hd)
        parts.extend(self.sq_lines)
        parts.extend(self.out_rg)
        parts.extend(self.out_pg)
        parts.extend(self.out_co)
        text = "\n".join(parts) + ("\n" if parts else "")
        names = [None] * len(self.sq_tids)
        for name, tid in self.sq_tids.items():
            names[tid] = name
        return SamHeader.from_text(text, names, self.sq_lens)


def translate_batch(b: ReadBatch, tid_trans, rg_map, pg_map):
    """bam_translate over the whole batch."""
    tt = np.array(tid_trans + [0], np.int64)
    tid = b.tid.astype(np.int64)
    b.tid = np.where(tid >= 0, tt[np.where(tid >= 0, tid, 0)],
                     tid).astype(np.int32)
    mtid = b.mtid.astype(np.int64)
    b.mtid = np.where(mtid >= 0, tt[np.where(mtid >= 0, mtid, 0)],
                      mtid).astype(np.int32)
    # RG/PG tag remap (delete + append, as htslib does)
    warned_rg: set = set()
    warned_pg: set = set()
    parts = []
    off = np.zeros(b.n + 1, np.int64)
    for i in range(b.n):
        a = b.aux_of(i)
        for tag, tmap, warned in (("RG", rg_map, warned_rg),
                                  ("PG", pg_map, warned_pg)):
            got = auxmod.get_value(a, tag)
            if got is None or got[0] != "Z":
                continue
            val = got[1]
            new = tmap.get(val)
            if new is not None:
                a = auxmod.delete_tags(a, {tag})
                blob = tag.encode() + b"Z" + new.encode("latin-1") + b"\0"
                a = np.concatenate([np.asarray(a, np.uint8),
                                    np.frombuffer(blob, np.uint8)])
            else:
                if val not in warned:
                    sys.stderr.write(
                        f'[bam_translate] {tag} tag "{val}" on read '
                        f'"{b.qname_str(i)}" encountered with no '
                        "corresponding entry in header, tag lost. "
                        "Unknown tags are only reported once per input "
                        "file for each tag ID.\n")
                    warned.add(val)
                a = auxmod.delete_tags(a, {tag})
        parts.append(a)
        off[i + 1] = off[i] + len(a)
    b.aux = (np.concatenate(parts).astype(np.uint8)
             if parts else np.empty(0, np.uint8))
    b.aux_off = off


def rg_from_filename(path: str) -> str:
    base = path
    for ext in (".bam", ".sam", ".cram"):
        if base.endswith(ext):
            base = base[:-len(ext)]
            break
    return os.path.basename(base)


def _merge_streamed(streams, tables, paths, header, attach_rg, no_pg,
                    argv, fnout, ga, level) -> int:
    """Bounded-memory coordinate merge: each file's batches are
    translated (and given ``-r``'s RG) as they come, and a k-way merge on
    packed keys writes ordered batches to a streamed writer
    (bam_merge_core2's heap loop, bam_sort.c:1956, a batch at a time)."""
    def make_iter(fi, st):
        tid_trans, rg_map, pg_map = tables[fi]
        for b in st.batches():
            translate_batch(b, tid_trans, rg_map, pg_map)
            if attach_rg:
                _attach_rg(b, rg_from_filename(paths[fi]))
            yield b

    if not no_pg:
        cl = "samtools merge " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)
    fmt = infer_output_format(fnout, ga.out_fmt, "bam")
    writer = StreamingWriter(fnout if fnout != "-" else None, header,
                             fmt, threads=ga.nthreads, level=level)
    try:
        iters = [make_iter(fi, st) for fi, st in enumerate(streams)]
        try:
            for ob in merge_packed_iters(iters, sk.coordinate_pack):
                writer.write_batch(ob)
        except ValueError as e:
            print_error("merge", "%s", e)
            return 1
    finally:
        writer.close()
    return 0


def _attach_rg(b: ReadBatch, rg: str) -> None:
    """Replace each record's RG tag by RG:Z:``rg``, appended last."""
    blob = np.frombuffer(b"RGZ" + rg.encode("latin-1") + b"\0", np.uint8)
    parts = [np.concatenate([np.asarray(auxmod.delete_tags(b.aux_of(i),
                                                           {"RG"}),
                                        np.uint8), blob])
             for i in range(b.n)]
    b.aux_off = np.zeros(b.n + 1, np.int64)
    np.cumsum([len(a) for a in parts], out=b.aux_off[1:])
    b.aux = (np.concatenate(parts).astype(np.uint8)
             if parts else np.empty(0, np.uint8))


def _close_all(streams) -> None:
    for st in streams:
        st.close()


def main_merge(argv: list[str]) -> int:
    ga = GlobalArgs()
    order = "coordinate"
    natural = True
    sort_tag = None
    attach_rg = False
    force = False
    fn_headers = None
    fnout = None
    level = 6
    reg = None
    fn_bed = None
    combine_rg = False
    combine_pg = False
    seed = int(time.time())
    fn_list = None
    has_index_file = False
    no_pg = False
    try:
        opts, args = gnu_getopt(argv, "h:nNru1R:o:f@:l:cps:b:O:t:XL:",
                                ["no-PG", "template-coordinate",
                                 "threads="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-r":
            attach_rg = True
        elif o == "-f":
            force = True
        elif o == "-h":
            fn_headers = v
        elif o == "-N":
            natural = False
            order = "queryname"
        elif o == "-n":
            order = "queryname"
        elif o == "-o":
            fnout = v
        elif o == "-t":
            sort_tag = v
        elif o == "-1":
            level = 1
        elif o == "-u":
            level = 0
        elif o == "-R":
            reg = v
        elif o == "-l":
            level = int(v)
        elif o == "-c":
            combine_rg = True
        elif o == "-p":
            combine_pg = True
        elif o == "-s":
            seed = int(v)
        elif o == "-X":
            has_index_file = True
        elif o == "-L":
            fn_bed = v
        elif o == "-b":
            fn_list = v
        elif o == "--template-coordinate":
            order = "template-coordinate"
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v, short_outfmt="-O"):
            pass
        else:
            usage(sys.stderr)
            return 1

    paths = []
    if fn_list:
        try:
            with open(fn_list) as fl:
                paths.extend(ln.strip() for ln in fl if ln.strip())
        except OSError as e:
            print_error_errno("merge", 'Cannot open "%s"', fn_list, exc=e)
            return 1
    rest = list(args)
    if fnout is None:
        if not rest:
            usage(sys.stderr)
            return 1
        fnout = rest[0]
        rest = rest[1:]
    if has_index_file:
        n_in = len(rest) // 2
        paths.extend(rest[:n_in])
    else:
        paths.extend(rest)
    if not paths:
        usage(sys.stderr)
        return 1
    if (fnout not in ("-", "/dev/stdout") and os.path.exists(fnout)
            and not force):
        print_error("merge",
                    'File "%s" exists. Please apply \'-f\' to overwrite. '
                    "Abort.", fnout)
        return 1

    rng = Drand48(seed)
    merged = MergedHeader(rng)

    if fn_headers:
        try:
            hf = read_alignments(fn_headers)
        except OSError as e:
            print_error_errno("merge", 'Cannot open "%s"', fn_headers,
                              exc=e)
            return 1
        merged.add_file(hf.header, combine_rg, combine_pg, True, None)

    # coordinate merges over BGZF BAMs stream (k-way packed-key merge,
    # the bam_merge_core2 heap's batched equivalent) — header-only
    # opens here, record windows during the merge
    want_stream = (order == "coordinate" and sort_tag is None
                   and not reg and not fn_bed
                   and infer_output_format(fnout, ga.out_fmt, "bam")
                   in ("bam", "sam", "sam.gz")
                   and not ga.write_index)
    files = []
    tables = []
    streams = []
    for path in paths:
        try:
            st = (open_stream(path, ga.nthreads)
                  if want_stream and path != "-" else None)
            if st is not None:
                f = types.SimpleNamespace(header=st.header, stream=st)
                streams.append(st)
            else:
                f = read_alignments(path, threads=ga.nthreads)
        except OSError as e:
            print_error_errno("merge", 'fail to open "%s"', path, exc=e)
            _close_all(streams)
            return 1
        override = rg_from_filename(path) if attach_rg else None
        tbl = merged.add_file(f.header, combine_rg, combine_pg, True,
                              override)
        files.append(f)
        tables.append(tbl)

    header = merged.finish()
    if (want_stream and len(streams) == len(files)
            and header.n_refs < (1 << 30) - 1):
        try:
            return _merge_streamed(streams, tables, paths, header,
                                   attach_rg, no_pg, argv, fnout, ga, level)
        finally:
            _close_all(streams)
    # a file that is not a BGZF BAM: every file is read whole
    _close_all(streams)
    for i, f in enumerate(files):
        if getattr(f, "stream", None) is not None:
            files[i] = read_alignments(paths[i], threads=ga.nthreads)

    bedidx = bedmod.read_bed(fn_bed) if fn_bed else None
    region = None
    if reg:
        try:
            region = parse_region(reg, header.tid)
        except RegionError:
            print_error("merge", 'Badly formatted region or unknown '
                        'reference name: "%s"', reg)
            return 1

    batches = []
    file_of = []
    for fi, (f, (tid_trans, rg_map, pg_map)) in enumerate(
            zip(files, tables)):
        b = f.batch
        translate_batch(b, tid_trans, rg_map, pg_map)
        sel = np.arange(b.n)
        if region is not None:
            end = b.end_pos()
            sel = sel[(b.tid == region.tid) & (b.pos < region.end)
                      & (end > region.beg)]
        if bedidx is not None:
            end = b.end_pos()
            hit = np.zeros(b.n, bool)
            # resolve BED chrom names through the header (incl AN aliases)
            tid2chroms: dict[int, list] = {}
            for chrom in bedidx.chroms:
                t = header.tid(chrom)
                if t >= 0:
                    tid2chroms.setdefault(t, []).append(chrom)
            for t, chroms in tid2chroms.items():
                m = np.nonzero(b.tid == t)[0]
                if m.size:
                    got = np.zeros(m.size, bool)
                    for chrom in chroms:
                        got |= bedidx.overlap(chrom, b.pos[m], end[m])
                    hit[m] |= got
            sel = sel[hit[sel]]
        sub = b.take(sel)
        if attach_rg:
            _attach_rg(sub, rg_from_filename(paths[fi]))
        batches.append(sub)
        file_of.append(np.full(sub.n, fi, np.int64))

    allb = ReadBatch.concat(batches)
    fidx = (np.concatenate(file_of) if file_of
            else np.empty(0, np.int64))

    if order == "coordinate":
        tid = allb.tid.astype(np.int64)
        tid = np.where(tid < 0, np.iinfo(np.int64).max, tid)
        rev = (allb.flag.astype(np.int64) & F.FREVERSE) != 0
        idx = np.lexsort((fidx, rev, allb.pos, tid))
    elif order == "queryname":
        idx = np.lexsort((fidx, sk.qname_flag_key(allb),
                          sk.name_ranks(allb, natural)))
    elif order == "template-coordinate":
        idx = sk.template_coordinate_order(allb, header)
    else:
        idx = np.arange(allb.n)
    if sort_tag is not None:
        idx = sk.tag_order(allb, sort_tag, order == "queryname", natural)
    out = allb.take(idx)

    if not no_pg:
        cl = "samtools merge " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)
    fmt = infer_output_format(fnout, ga.out_fmt, "bam")
    write_alignments(fnout if fnout != "-" else None, header, out, fmt=fmt,
                     threads=ga.nthreads, level=level, include_header=True)
    if ga.write_index and fnout not in ("-", None) and fmt == "bam":
        build_index_for(fnout, None, False, 14, ga.nthreads)
    return 0
