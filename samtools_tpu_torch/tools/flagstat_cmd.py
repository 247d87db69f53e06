"""samtools flagstat on the port: the flag census.

Counterpart of samtools_tpu/tools/flagstat_cmd.py (``percent``, the
default / JSON / TSV writers, ``main_flagstat``); its output is the JAX
tool's, byte for byte.  A BGZF BAM streams in batches that decode only
the fixed-width fields; standard input, other BAMs and SAM are read
whole.  Each batch's counts come from K11
(``ops.flagstat.flagstat_counts``, on the card), or with
``SAMTPU_DEVICE=0|host`` from numpy.  A CRAM is decoded whole on the
host (``io/cram_decode.py``); a decode error is reported as the JAX tool
reports it.  ``SAMTPU_SHARDS`` above 1 on several cards (capped at their
count, as the JAX tool caps it) runs each batch on the mesh
(``parallel/mesh.flagstat_counts_sharded``: K11 on every shard, the
partials summed), with the same counts.  Percentages reproduce
the reference's single-precision ``(float)n / total * 100.0`` exactly.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.files import read_alignments
from ..ops import flagstat as fsops
from ..parallel.mesh import flagstat_counts_sharded, make_mesh
from . import common
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     device_shards, no_card, open_stream,
                     pick_device, print_error, print_error_errno)


def usage(fp):
    fp.write("Usage: samtools flagstat [options] <in.bam>\n"
             "  -O, --output-fmt FORMAT[,OPT[=VAL]]...\n"
             "               Specify output format (json, tsv)\n")


def percent(n: int, total: int) -> str:
    if total == 0:
        return "N/A"
    v = float(np.float32(np.float32(n) / np.float32(total))) * 100.0
    return "%.2f%%" % v


def percent_json(n: int, total: int) -> str:
    if total == 0:
        return "null"
    v = float(np.float32(np.float32(n) / np.float32(total))) * 100.0
    return "%.2f" % v


def out_default(s, w=None):
    w = w if w is not None else sys.stdout

    def p(line):
        w.write(line + "\n")
    p("%d + %d in total (QC-passed reads + QC-failed reads)" % s["n_reads"])
    p("%d + %d primary" % s["n_primary"])
    p("%d + %d secondary" % s["n_secondary"])
    p("%d + %d supplementary" % s["n_supp"])
    p("%d + %d duplicates" % s["n_dup"])
    p("%d + %d primary duplicates" % s["n_pdup"])
    p("%d + %d mapped (%s : %s)" % (
        s["n_mapped"][0], s["n_mapped"][1],
        percent(s["n_mapped"][0], s["n_reads"][0]),
        percent(s["n_mapped"][1], s["n_reads"][1])))
    p("%d + %d primary mapped (%s : %s)" % (
        s["n_pmapped"][0], s["n_pmapped"][1],
        percent(s["n_pmapped"][0], s["n_primary"][0]),
        percent(s["n_pmapped"][1], s["n_primary"][1])))
    p("%d + %d paired in sequencing" % s["n_pair_all"])
    p("%d + %d read1" % s["n_read1"])
    p("%d + %d read2" % s["n_read2"])
    p("%d + %d properly paired (%s : %s)" % (
        s["n_pair_good"][0], s["n_pair_good"][1],
        percent(s["n_pair_good"][0], s["n_pair_all"][0]),
        percent(s["n_pair_good"][1], s["n_pair_all"][1])))
    p("%d + %d with itself and mate mapped" % s["n_pair_map"])
    p("%d + %d singletons (%s : %s)" % (
        s["n_sgltn"][0], s["n_sgltn"][1],
        percent(s["n_sgltn"][0], s["n_pair_all"][0]),
        percent(s["n_sgltn"][1], s["n_pair_all"][1])))
    p("%d + %d with mate mapped to a different chr" % s["n_diffchr"])
    p("%d + %d with mate mapped to a different chr (mapQ>=5)"
      % s["n_diffhigh"])


def _json_group(s, w: int) -> str:
    return (
        "  \"total\": %d, \n"
        "  \"primary\": %d, \n"
        "  \"secondary\": %d, \n"
        "  \"supplementary\": %d, \n"
        "  \"duplicates\": %d, \n"
        "  \"primary duplicates\": %d, \n"
        "  \"mapped\": %d, \n"
        "  \"mapped %%\": %s, \n"
        "  \"primary mapped\": %d, \n"
        "  \"primary mapped %%\": %s, \n"
        "  \"paired in sequencing\": %d, \n"
        "  \"read1\": %d, \n"
        "  \"read2\": %d, \n"
        "  \"properly paired\": %d, \n"
        "  \"properly paired %%\": %s, \n"
        "  \"with itself and mate mapped\": %d, \n"
        "  \"singletons\": %d, \n"
        "  \"singletons %%\": %s, \n"
        "  \"with mate mapped to a different chr\": %d, \n"
        "  \"with mate mapped to a different chr (mapQ >= 5)\": %d \n"
    ) % (
        s["n_reads"][w], s["n_primary"][w], s["n_secondary"][w],
        s["n_supp"][w], s["n_dup"][w], s["n_pdup"][w], s["n_mapped"][w],
        percent_json(s["n_mapped"][w], s["n_reads"][w]),
        s["n_pmapped"][w],
        percent_json(s["n_pmapped"][w], s["n_primary"][w]),
        s["n_pair_all"][w], s["n_read1"][w], s["n_read2"][w],
        s["n_pair_good"][w],
        percent_json(s["n_pair_good"][w], s["n_pair_all"][w]),
        s["n_pair_map"][w], s["n_sgltn"][w],
        percent_json(s["n_sgltn"][w], s["n_pair_all"][w]),
        s["n_diffchr"][w], s["n_diffhigh"][w],
    )


def out_json(s, w=None):
    w = w if w is not None else sys.stdout
    w.write("{\n \"QC-passed reads\": { \n" + _json_group(s, 0)
            + " },\n \"QC-failed reads\": { \n" + _json_group(s, 1)
            + " }\n}\n")


def out_tsv(s, w=None):
    w = w if w is not None else sys.stdout

    def p(line):
        w.write(line + "\n")
    p("%d\t%d\ttotal (QC-passed reads + QC-failed reads)" % s["n_reads"])
    p("%d\t%d\tprimary" % s["n_primary"])
    p("%d\t%d\tsecondary" % s["n_secondary"])
    p("%d\t%d\tsupplementary" % s["n_supp"])
    p("%d\t%d\tduplicates" % s["n_dup"])
    p("%d\t%d\tprimary duplicates" % s["n_pdup"])
    p("%d\t%d\tmapped" % s["n_mapped"])
    p("%s\t%s\tmapped %%" % (percent(s["n_mapped"][0], s["n_reads"][0]),
                             percent(s["n_mapped"][1], s["n_reads"][1])))
    p("%d\t%d\tprimary mapped" % s["n_pmapped"])
    p("%s\t%s\tprimary mapped %%" % (
        percent(s["n_pmapped"][0], s["n_primary"][0]),
        percent(s["n_pmapped"][1], s["n_primary"][1])))
    p("%d\t%d\tpaired in sequencing" % s["n_pair_all"])
    p("%d\t%d\tread1" % s["n_read1"])
    p("%d\t%d\tread2" % s["n_read2"])
    p("%d\t%d\tproperly paired" % s["n_pair_good"])
    p("%s\t%s\tproperly paired %%" % (
        percent(s["n_pair_good"][0], s["n_pair_all"][0]),
        percent(s["n_pair_good"][1], s["n_pair_all"][1])))
    p("%d\t%d\twith itself and mate mapped" % s["n_pair_map"])
    p("%d\t%d\tsingletons" % s["n_sgltn"])
    p("%s\t%s\tsingletons %%" % (
        percent(s["n_sgltn"][0], s["n_pair_all"][0]),
        percent(s["n_sgltn"][1], s["n_pair_all"][1])))
    p("%d\t%d\twith mate mapped to a different chr" % s["n_diffchr"])
    p("%d\t%d\twith mate mapped to a different chr (mapQ>=5)"
      % s["n_diffhigh"])


def _count_fn(dev):
    """Counts of one batch (the JAX ``_pick_count_fn``,
    samtools_tpu/tools/flagstat_cmd.py:151-172): numpy for the host
    branch (``dev`` None); the mesh census when SAMTPU_SHARDS asks for
    more than one of ``dev``'s devices; else K11 on ``dev``.  All three
    give the same counts."""
    if dev is None:
        return fsops.flagstat_numpy
    n = device_shards(dev)
    if n > 1:
        mesh = make_mesh(n_data=n, devices=common.mesh_devices(dev, n))
        return lambda part: flagstat_counts_sharded(mesh, part)
    return lambda part: fsops.flagstat_counts(part, dev)


def main_flagstat(argv: list[str], device=None) -> int:
    ga = GlobalArgs()
    out_fmt = "default"
    try:
        opts, args = gnu_getopt(argv, "@:O:", [])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-O", "--output-fmt"):
            out_fmt = v
        elif not handle_global_opt(ga, o, v):
            usage(sys.stderr)
            return 1
    if len(args) != 1:
        usage(sys.stdout if not args else sys.stderr)
        return 0 if not args else 1
    try:
        dev = pick_device(device)
    except RuntimeError as e:     # no CUDA card
        return no_card("flagstat", e)
    count_fn = _count_fn(dev)
    s = None
    try:
        # a BGZF BAM streams with bounded memory; flagstat needs only the
        # fixed-width fields, so fields=0 skips every ragged copy
        st = open_stream(args[0], ga.nthreads) if args[0] != "-" else None
        if st is not None:
            with st:
                for part in st.batches(fields=0):
                    p = count_fn(part)
                    s = p if s is None else {
                        k: (s[k][0] + p[k][0], s[k][1] + p[k][1])
                        for k in s}
        if s is None:
            s = count_fn(read_alignments(args[0], threads=ga.nthreads).batch)
    except OSError as e:
        print_error_errno("flagstat",
                          'Cannot open input file "%s"', args[0], exc=e)
        return 1
    except Exception as e:
        print_error("flagstat", 'error reading from "%s": %s', args[0], e)
        return 1
    if out_fmt.lower() == "json":
        out_json(s)
    elif out_fmt.lower() == "tsv":
        out_tsv(s)
    else:
        out_default(s)
    return 0
