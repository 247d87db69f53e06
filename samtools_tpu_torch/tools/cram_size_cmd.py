"""samtools cram-size: what each CRAM content ID and data series costs.

Counterpart of samtools_tpu/tools/cram_size_cmd.py (samtools'
cram_size.c): a walk over every block of every container, summing
compressed and uncompressed sizes by content ID and by compression
method (expanded to its options: gzip level, rANS order, stripe ...),
with the data series and tags each content ID carries; ``-v`` one line
per method, ``-e`` each container's encodings as htslib's
cram_describe_encodings prints them (tags in khash bucket order,
``core/khash_sim.py``).  A host command: no device work.
"""

from __future__ import annotations

import sys

from ..core.khash_sim import khash_order
from ..io import cram_codecs as cc
from ..io.cram import (CramReader, CramError, parse_block,
                       parse_compression_header, parse_slice_header,
                       Encoding)
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     print_error, print_error_errno)

# expanded method enumeration (cram_size.c:56-134)
(COMP_RAW, COMP_GZIP, COMP_BZIP2, COMP_LZMA, COMP_RANS8, COMP_RANS16,
 COMP_ARITH, COMP_FQZ, COMP_TOK3, COMP_GZIP_1, COMP_GZIP_9,
 COMP_BZIP2_1, COMP_BZIP2_2, COMP_BZIP2_3, COMP_BZIP2_4, COMP_BZIP2_5,
 COMP_BZIP2_6, COMP_BZIP2_7, COMP_BZIP2_8, COMP_BZIP2_9,
 COMP_RANS4x8_O0, COMP_RANS4x8_O1,
 COMP_RANS4x16_O0, COMP_RANS4x16_O1, COMP_RANS4x16_O0R,
 COMP_RANS4x16_O1R, COMP_RANS4x16_O0P, COMP_RANS4x16_O1P,
 COMP_RANS4x16_O0PR, COMP_RANS4x16_O1PR,
 COMP_RANS32x16_O0, COMP_RANS32x16_O1, COMP_RANS32x16_O0R,
 COMP_RANS32x16_O1R, COMP_RANS32x16_O0P, COMP_RANS32x16_O1P,
 COMP_RANS32x16_O0PR, COMP_RANS32x16_O1PR,
 COMP_RANSNx16_STRIPE, COMP_RANSNx16_CAT,
 COMP_ARITH_O0, COMP_ARITH_O1, COMP_ARITH_O0R, COMP_ARITH_O1R,
 COMP_ARITH_O0P, COMP_ARITH_O1P, COMP_ARITH_O0PR, COMP_ARITH_O1PR,
 COMP_ARITH_STRIPE, COMP_ARITH_CAT, COMP_ARITH_EXT,
 COMP_TOK3_RANS, COMP_TOK3_ARITH, COMP_MAX) = range(54)

METHOD_CHAR = (".gblr0afn" "_G" "bbbbbbbbB" "rR"
               "010101014545454582" "aAaAaAaAaaa" "nN")

METHOD_STR = [
    "raw", "gzip", "bzip2", "lzma", "r4x8", "rNx16",
    "arith", "fqzcomp", "tok3",
    "gzip-min", "gzip-max",
    "bzip2-1", "bzip2-2", "bzip2-3", "bzip2-4", "bzip2-5",
    "bzip2-6", "bzip2-7", "bzip2-8", "bzip2-9",
    "r4x8-o0", "r4x8-o1",
    "r4x16-o0", "r4x16-o1", "r4x16-o0R", "r4x16-o1R",
    "r4x16-o0P", "r4x16-o1P", "r4x16-o0PR", "r4x16-o1PR",
    "r32x16-o0", "r32x16-o1", "r32x16-o0R", "r32x16-o1R",
    "r32x16-o0P", "r32x16-o1P", "r32x16-o0PR", "r32x16-o1PR",
    "rNx16-xo0", "rNx16-cat",
    "arith-o0", "arith-o1", "arith-o0R", "arith-o1R",
    "arith-o0P", "arith-o1P", "arith-o0PR", "arith-o1PR",
    "arith-stripe", "arith-cat", "arith-ext",
    "tok3-rans", "tok3-arith",
]


def method2expanded(method: int, data: bytes) -> int:
    d = cc.expand_method(method, data)
    if method == cc.GZIP:
        return {1: COMP_GZIP_1, 9: COMP_GZIP_9}.get(d["level"], COMP_GZIP)
    if method == cc.BZIP2:
        if 1 <= d["level"] <= 9:
            return COMP_BZIP2_1 + d["level"] - 1
        return COMP_BZIP2
    if method == cc.RANS4x8:
        return COMP_RANS4x8_O1 if d["order"] else COMP_RANS4x8_O0
    if method == cc.RANSNx16:
        if d["stripe"]:
            return COMP_RANSNx16_STRIPE
        if d["cat"]:
            return COMP_RANSNx16_CAT
        return (COMP_RANS4x16_O0 + d["order"] + 2 * d["rle"]
                + 4 * d["pack"] + 8 * (d["nway"] == 32))
    if method == cc.ARITH:
        if d["stripe"]:
            return COMP_ARITH_STRIPE
        if d["cat"]:
            return COMP_ARITH_CAT
        if d["ext"]:
            return COMP_ARITH_EXT
        return (COMP_ARITH_O0 + d["order"] + 2 * d["rle"]
                + 4 * d["pack"])
    if method == cc.TOK3:
        return COMP_TOK3_RANS if d["level"] < 10 else COMP_TOK3_ARITH
    return method


def enc_cids(e: Encoding) -> list:
    out = []
    if e.codec in (1, 5) and e.content_id >= 0:
        out.append(e.content_id)
    if e.codec == 4:
        out.extend(enc_cids(e.sub_len))
        out.extend(enc_cids(e.sub_val))
    return out


def describe_encoding(e: Encoding) -> str:
    """htslib cram_describe_encodings text (note the missing close-paren
    on BYTE_ARRAY_LEN is replicated)."""
    if e.codec == 0:
        return "NULL"
    if e.codec == 1:
        return "EXTERNAL(id=%d)" % e.content_id
    if e.codec == 3:
        return "HUFFMAN(codes={%s},lengths={%s})" % (
            ",".join(str(v) for v in e.alphabet),
            ",".join(str(v) for v in e.bitlens))
    if e.codec == 4:
        return "BYTE_ARRAY_LEN(len_codec={%s},val_codec={%s}" % (
            describe_encoding(e.sub_len), describe_encoding(e.sub_val))
    if e.codec == 5:
        return "BYTE_ARRAY_STOP(stop=%d,id=%d)" % (e.stop_byte,
                                                   e.content_id)
    if e.codec == 6:
        return "BETA(offset=%d,nbits=%d)" % (e.offset, e.nbits)
    if e.codec == 9:
        return "GAMMA(offset=%d)" % e.offset
    return "codec#%d" % e.codec


def run_cram_size(data: bytes, out, verbose: bool, encodings: bool) -> int:
    rd = CramReader(data)
    # cid -> {expanded_method: [csize, usize]}
    cu: dict[int, dict] = {}
    cid2ds: dict[int, set] = {}
    ref_seq_blk_used = -1
    nseqs = nbases = ncont = nslice = 0

    raw = data
    first = True
    for cont, i in rd.containers():
        if first:
            first = False     # SAM header container (read by sam_hdr_read)
            continue
        if cont.n_records == 0 and cont.n_bases == 0:
            continue  # empty marker / EOF container
        nseqs += cont.n_records
        nbases += cont.n_bases
        blk, i = parse_block(raw, i, rd.major)
        ch = parse_compression_header(blk.data())
        if encodings:
            out.write("Container encodings\n")
            # htslib iterates its DS enum order, not wire order
            order = ["RN", "QS", "IN", "SC", "BF", "CF", "AP", "RG",
                     "MQ", "NS", "MF", "TS", "NP", "NF", "RL", "FN",
                     "FC", "FP", "DL", "BA", "BS", "PD", "HC", "QQ",
                     "TL", "RI", "TC", "TN", "BB", "QT"]
            for key in order + [k for k in ch.data_series
                                if k not in order]:
                enc = ch.data_series.get(key)
                if enc is None:
                    continue
                out.write("\t%s\t%s\n" % (key, describe_encoding(enc)))
            for key in khash_order(list(ch.tag_encodings)):
                name = "%c%c%c" % ((key >> 16) & 0xFF, (key >> 8) & 0xFF,
                                   key & 0xFF)
                out.write("\t%s\t%s\n"
                          % (name, describe_encoding(ch.tag_encodings[key])))
            out.write("\n")
        for key, enc in ch.data_series.items():
            d = (ord(key[0]) << 8) | ord(key[1])
            for cid in enc_cids(enc):
                cid2ds.setdefault(cid, set()).add(d)
        for key, enc in ch.tag_encodings.items():
            for cid in enc_cids(enc):
                cid2ds.setdefault(cid, set()).add(key)

        ncont += 1
        nslice += len(cont.landmarks)
        for _s in range(len(cont.landmarks)):
            blk, i = parse_block(raw, i, rd.major)
            sh = parse_slice_header(blk.data(), rd.major)
            if sh.embedded_ref_id >= 0:
                if ref_seq_blk_used == -1:
                    ref_seq_blk_used = sh.embedded_ref_id
            for _b in range(sh.n_blocks):
                blk, i = parse_block(raw, i, rd.major)
                cid = blk.content_id if blk.content_type != 5 else -1
                comp = method2expanded(blk.method, blk.raw)
                slot = cu.setdefault(cid, {})
                cs = slot.setdefault(comp, [0, 0])
                cs[0] += blk.comp_size
                cs[1] += blk.usize

    # report (cram_size.c:299-409)
    out.write("#   Content_ID  Uncomp.size    Comp.size   Ratio Method"
              "%s  Data_series\n" % ("    " if verbose else ""))
    tot_size = 0
    for cid in sorted(cu):
        comps = sorted(cu[cid].items(),
                       key=lambda kv: (-kv[1][0], kv[0]))
        ds = sorted(cid2ds.get(cid, ()))

        def ds_str():
            s = ""
            for d in ds:
                if d > 65535:
                    s += " %c%c%c" % ((d >> 16) & 0xFF, (d >> 8) & 0xFF,
                                      d & 0xFF)
                else:
                    s += " %c%c" % ((d >> 8) & 0xFF, d & 0xFF)
            return s

        if verbose:
            for ci, (comp, (csize, usize)) in enumerate(comps):
                if ci:
                    out.write("\n")
                if cid < 0:
                    out.write("BLOCK %8s" % "CORE")
                else:
                    out.write("BLOCK %8d" % cid)
                out.write(" %12d %12d" % (usize, csize))
                f = (100.0 * (csize + .0001)) / (usize + .0001)
                if f > 999:
                    out.write("   >999%% %-11s" % METHOD_STR[comp])
                else:
                    out.write(" %6.2f%% %-11s" % (f, METHOD_STR[comp]))
                out.write(ds_str())
                tot_size += csize
            # embedded_ref marker attaches to the group's last line
            # (cram_size.c:397-401)
            if cid >= 0 and cid == ref_seq_blk_used:
                out.write(" embedded_ref")
            out.write("\n")
        else:
            csize = sum(v[0] for v in cu[cid].values())
            usize = sum(v[1] for v in cu[cid].values())
            cstr = "".join(METHOD_CHAR[c] for c, v in comps if v[0])
            if not cstr:
                cstr = "."
            if cid < 0:
                out.write("BLOCK %8s" % "CORE")
            else:
                out.write("BLOCK %8d" % cid)
            out.write(" %12d %12d" % (usize, csize))
            f = 100 * (csize + .0001) / (usize + .0001)
            if f > 999:
                out.write("   >999%% %-7s" % cstr)
            else:
                out.write(" %6.2f%% %-7s" % (f, cstr))
            out.write(ds_str())
            if cid >= 0 and cid == ref_seq_blk_used:
                out.write(" embedded_ref")
            out.write("\n")
            tot_size += csize

    end = len(data)
    out.write("\n")
    out.write("Number of containers  %18d\n" % ncont)
    out.write("Number of slices      %18d\n" % nslice)
    out.write("Number of sequences   %18d\n" % nseqs)
    out.write("Number of bases       %18d\n" % nbases)
    out.write("Total file size       %18d\n" % end)
    out.write("Format overhead size  %18d\n" % (end - tot_size))
    return 0


def main_cram_size(argv: list[str]) -> int:
    ga = GlobalArgs()
    verbose = 0
    encodings = 0
    out = sys.stdout
    try:
        opts, args = gnu_getopt(argv, "vo:e",
                                ["output=", "verbose", "encodings"])
    except UsageError:
        print("Usage: samtools cram_size [-ve] [-o out.size] [in.cram]")
        return 0
    for o, v in opts:
        if o in ("-o", "--output"):
            try:
                out = open(v, "w")
            except OSError as e:
                sys.stderr.write("%s: %s\n" % (v, e.strerror))
                return 1
        elif o in ("-v", "--verbose"):
            verbose += 1
        elif o in ("-e", "--encodings"):
            encodings += 1
        elif handle_global_opt(ga, o, v):
            pass
        else:
            print("Usage: samtools cram_size [-ve] [-o out.size]"
                  " [in.cram]")
            return 0
    if not args and sys.stdin.isatty():
        print("Usage: samtools cram_size [-ve] [-o out.size] [in.cram]")
        return 0
    fn = args[0] if args else "-"
    try:
        if fn == "-":
            data = sys.stdin.buffer.read()
        else:
            data = open(fn, "rb").read()
    except OSError as e:
        print_error_errno("cram_size", "failed to open file '%s'", fn,
                          exc=e)
        return 1
    if data[:4] != b"CRAM":
        print_error("cram_size", "Input is not a CRAM file")
        return 1
    try:
        ret = run_cram_size(data, out, verbose > 0, encodings > 0)
    except (CramError, cc.CramCodecError, NotImplementedError):
        print_error("cram_size", "Failed in decoding CRAM file")
        ret = -1
    if out is not sys.stdout:
        out.close()
    return 1 if ret else 0
