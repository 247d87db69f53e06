"""samtools collate: group the records of each template, without a full
sort.

Counterpart of samtools_tpu/tools/collate_cmd.py (samtools' bamshuf.c):
each record goes to bucket hash(qname) % n (the X31 hash mixed by Wang's
integer hash), each bucket is ordered by (hash, qname, READ1/READ2) with
ties in input order, and the buckets are written in turn; ``-f`` pairs
primary reads on the fly through a ring of ``-r`` slots and writes each
pair at once, its evictions going to the buckets.  A BGZF BAM path
written as BAM, SAM or gzip'd SAM streams: its buckets are temporary
BAMs beside the output (``<prefix>.<pid>.NNNN.tmp.bam``), removed after;
other inputs and CRAM output are read whole and bucketed in memory.  A
host command: no device work.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import SAMTOOLS_PARITY_VERSION
from ..core import flags as F
from ..core.batch import ReadBatch
from ..io.files import (StreamingWriter, infer_output_format,
                        read_alignments, write_alignments)
from ..ops.filters import wang_hash, x31_hash_ragged
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     open_stream, print_error_errno)

DEF_CLEVEL = 1


def usage(fp):
    fp.write(
        "Usage: samtools collate [options] <in.bam> [<prefix>]\n"
        "Options:\n"
        "      -O       output to stdout\n"
        "      -o       output file name (use prefix if not set)\n"
        "      -u       uncompressed BAM output\n"
        "      -f       fast (only primary alignments)\n"
        "      -r       working reads stored (with -f) [10000]\n"
        "      -l INT   compression level [1]\n"
        "      -n INT   number of temporary files [64]\n"
        "      --no-PG  do not add a PG line\n")


def main_collate(argv: list[str]) -> int:
    ga = GlobalArgs()
    is_stdout = False
    output_file = None
    clevel = DEF_CLEVEL
    n_files = 64
    fast = False
    store_max = 10000
    no_pg = False
    try:
        opts, args = gnu_getopt(argv, "Oo:ul:n:fr:@:", ["no-PG"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-O":
            is_stdout = True
        elif o == "-o":
            output_file = v
        elif o == "-u":
            clevel = 0
        elif o == "-l":
            clevel = int(v)
        elif o == "-n":
            n_files = int(v)
        elif o == "-f":
            fast = True
        elif o == "-r":
            store_max = int(v)
        elif o == "--no-PG":
            no_pg = True
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    if not args:
        usage(sys.stderr)
        return 1
    fn_in = args[0]
    prefix = args[1] if len(args) > 1 else None
    if output_file is None and not is_stdout and prefix is None:
        # samtools requires a prefix (or -o/-O)
        usage(sys.stderr)
        return 1

    # resolve output target first (shared by both paths)
    if output_file is not None:
        path = output_file
        fmt = infer_output_format(path, ga.out_fmt, "bam")
    elif is_stdout:
        path = None
        fmt = ga.out_fmt or "bam"
    else:
        ext = {"sam": "sam", "bam": "bam", "cram": "cram",
               None: "bam"}.get(ga.out_fmt, "bam")
        path = f"{prefix}.{ext}"
        fmt = ga.out_fmt or "bam"

    # bounded-memory scatter path (bamshuf.c:167: hash qnames into n
    # temp files, sort each, concatenate); non-BGZF inputs and CRAM
    # output take the in-memory path below
    if fn_in != "-" and fmt in ("bam", "sam", "sam.gz"):
        try:
            stream = open_stream(fn_in, ga.nthreads)
        except OSError as e:
            print_error_errno("collate", 'Cannot open input file "%s"',
                              fn_in, exc=e)
            return 1
        if stream is not None:
            try:
                return _collate_streamed(
                    stream, argv, ga, n_files, fast, store_max, clevel,
                    no_pg, path, fmt, prefix)
            finally:
                stream.close()

    try:
        f = read_alignments(fn_in, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("collate", 'Cannot open input file "%s"', fn_in,
                          exc=e)
        return 1
    b = f.batch
    header = f.header.ensure_hd_so("unsorted")
    header = _set_go_query(header)
    if not no_pg:
        cl = "samtools collate " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)

    keys = wang_hash(x31_hash_ragged(b.qname, b.qname_off))
    # zero-length names hash to 0 (hash_X31_Wang returns 0 for "")
    buckets = (keys % np.uint32(n_files)).astype(np.int64)
    qnames = [b.qname_str(i) for i in range(b.n)]

    out_order: list[int] = []
    if fast:
        fl = b.flag.astype(np.int64)
        if store_max < 2:
            store_max = 2
        ring = [None] * store_max  # record index or None(written)
        ring_idx = 0
        stored: dict[str, int] = {}  # qname -> ring slot
        spill: list[int] = []  # records scattered to bin files
        for i in range(b.n):
            readflag = fl[i] & (F.FREAD1 | F.FREAD2)
            if (fl[i] & (F.FSECONDARY | F.FSUPPLEMENTARY)) \
                    or readflag not in (F.FREAD1, F.FREAD2):
                continue
            slot = stored.get(qnames[i])
            if slot is None:
                # store in current ring slot, flushing its occupant
                cur = ring[ring_idx]
                ring[ring_idx] = i
                stored[qnames[i]] = ring_idx
                ring_idx = (ring_idx + 1) % store_max
                if ring[ring_idx] is not None:
                    j = ring[ring_idx]
                    spill.append(j)
                    ring[ring_idx] = None
                    stored.pop(qnames[j], None)
                del cur
            else:
                j = ring[slot]
                if fl[i] & F.FREAD1:
                    out_order.extend([i, j])
                else:
                    out_order.extend([j, i])
                ring[slot] = None
                stored.pop(qnames[i], None)
        for idx in range(store_max):
            if ring[idx] is not None:
                spill.append(ring[idx])
        scatter_src = spill
    else:
        scatter_src = list(range(b.n))

    # bucket scatter + per-bucket stable sort by (key, qname, pairflag)
    fl = b.flag.astype(np.int64)
    bucket_lists: list[list[int]] = [[] for _ in range(n_files)]
    for i in scatter_src:
        bucket_lists[buckets[i]].append(i)
    for bl in bucket_lists:
        bl.sort(key=lambda i: (int(keys[i]), qnames[i],
                               int(fl[i] >> 6) & 3))
        out_order.extend(bl)

    out = b.take(np.array(out_order, np.int64)) if out_order \
        else b.take(np.empty(0, np.int64))

    write_alignments(path, header, out, fmt=fmt, threads=ga.nthreads,
                     level=clevel, include_header=True)
    return 0


def _collate_streamed(stream, argv, ga, n_files, fast, store_max, clevel,
                      no_pg, path, fmt, prefix) -> int:
    """Scatter-to-buckets collate over a streamed input.

    bamshuf.c architecture: each record lands in temp file
    hash(qname) % n; afterwards every bucket is loaded (1/n of the
    input), stably sorted by (hash, qname, read1/read2) and appended.
    Fast mode (-f) pairs primaries through the bounded ring first and
    writes pairs straight to the output; ring evictions spill to the
    buckets."""
    header = stream.header.ensure_hd_so("unsorted")
    header = _set_go_query(header)
    if not no_pg:
        cl = "samtools collate " + " ".join(argv)
        header = header.add_pg_line("samtools", "samtools", cl,
                                    SAMTOOLS_PARITY_VERSION)

    tmp_prefix = (prefix if prefix is not None
                  else (path or "collate_tmp")) + ".%d" % os.getpid()
    bucket_w = [StreamingWriter(f"{tmp_prefix}.{k:04d}.tmp.bam", header,
                                "bam", threads=0, level=1)
                for k in range(n_files)]
    out_w = StreamingWriter(path, header, fmt, threads=ga.nthreads,
                            level=clevel)

    # fast-mode ring state: entries are (batch, row, qname, is_read1)
    if store_max < 2:
        store_max = 2
    ring = [None] * store_max
    ring_idx = 0
    stored: dict = {}

    pair_refs: list = []   # (batch, row) in output order

    def flush_pairs(force=False):
        if not pair_refs or (not force and len(pair_refs) < 4096):
            return
        # group consecutive refs by source batch for bulk takes
        parts = []
        k0 = 0
        for k in range(1, len(pair_refs) + 1):
            if k == len(pair_refs) or pair_refs[k][0] is not \
                    pair_refs[k0][0]:
                bb = pair_refs[k0][0]
                rows = np.array([r for _, r in pair_refs[k0:k]], np.int64)
                parts.append(bb.take(rows))
                k0 = k
        out_w.write_batch(ReadBatch.concat(parts) if len(parts) > 1
                          else parts[0])
        pair_refs.clear()

    def spill_one(bb, row, bucket):
        bucket_w[bucket].write_batch(bb.take(np.array([row], np.int64)))

    try:
        for b in stream.batches():
            if b.n == 0:
                continue
            keys = wang_hash(x31_hash_ragged(b.qname, b.qname_off))
            buckets = (keys % np.uint32(n_files)).astype(np.int64)
            if not fast:
                # vectorized scatter: whole batch grouped per bucket,
                # order within a bucket = file order
                order = np.argsort(buckets, kind="stable")
                bounds = np.flatnonzero(np.diff(buckets[order])) + 1
                for grp in np.split(order, bounds):
                    if grp.size:
                        bucket_w[int(buckets[grp[0]])].write_batch(
                            b.take(grp))
                continue
            fl = b.flag.astype(np.int64)
            for i in range(b.n):
                readflag = fl[i] & (F.FREAD1 | F.FREAD2)
                if (fl[i] & (F.FSECONDARY | F.FSUPPLEMENTARY)) \
                        or readflag not in (F.FREAD1, F.FREAD2):
                    continue
                qn = b.qname_str(i)
                slot = stored.get(qn)
                if slot is None:
                    ring[ring_idx] = (b, i, qn, int(buckets[i]))
                    stored[qn] = ring_idx
                    ring_idx = (ring_idx + 1) % store_max
                    nxt = ring[ring_idx]
                    if nxt is not None:
                        jb, jr, jq, jbk = nxt
                        spill_one(jb, jr, jbk)
                        ring[ring_idx] = None
                        stored.pop(jq, None)
                else:
                    jb, jr, jq, _ = ring[slot]
                    if fl[i] & F.FREAD1:
                        pair_refs.append((b, i))
                        pair_refs.append((jb, jr))
                    else:
                        pair_refs.append((jb, jr))
                        pair_refs.append((b, i))
                    ring[slot] = None
                    stored.pop(qn, None)
                    flush_pairs()
        if fast:
            for idx in range(store_max):
                ent = ring[idx]
                if ent is not None:
                    jb, jr, jq, jbk = ent
                    spill_one(jb, jr, jbk)
            flush_pairs(force=True)
        for w in bucket_w:
            w.close()
        # per-bucket load + stable sort + append (1/n of input each)
        for k in range(n_files):
            fn = f"{tmp_prefix}.{k:04d}.tmp.bam"
            fb = read_alignments(fn).batch
            if fb.n:
                bkeys = wang_hash(x31_hash_ragged(fb.qname, fb.qname_off))
                qn = [fb.qname_str(i) for i in range(fb.n)]
                ffl = fb.flag.astype(np.int64)
                order = sorted(range(fb.n),
                               key=lambda i: (int(bkeys[i]), qn[i],
                                              int(ffl[i] >> 6) & 3))
                out_w.write_batch(fb.take(np.array(order, np.int64)))
            os.remove(fn)
    finally:
        out_w.close()
        for k in range(n_files):
            fn = f"{tmp_prefix}.{k:04d}.tmp.bam"
            if os.path.exists(fn):
                try:
                    os.remove(fn)
                except OSError:
                    pass
    return 0


def _set_go_query(header):
    lines = header.text.split("\n")
    for i, line in enumerate(lines):
        if line.startswith("@HD"):
            fields = [x for x in line.split("\t") if not x.startswith("GO:")]
            out = []
            for x in fields:
                out.append(x)
                if x.startswith("SO:"):
                    out.append("GO:query")
            if "GO:query" not in out:
                out.append("GO:query")
            lines[i] = "\t".join(out)
            return header.with_text("\n".join(lines))
    text = "@HD\tVN:1.6\tSO:unsorted\tGO:query\n" + header.text
    return header.with_text(text)
