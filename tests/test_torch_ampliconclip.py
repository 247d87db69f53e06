"""``python -m samtools_tpu_torch ampliconclip`` against ``python -m
samtools_tpu ampliconclip``, on the CPU: one parity test over the table
of cases, each run by the port in-process with the JAX tool's argument
list (``torch_tool_fixtures.check_case``: exit code, standard error,
standard output and every file; a BAM must be the bytes of the JAX
tool's zlib run, ``SAMTPU_NO_NATIVE=1``).

Inputs are ``torch_tool_fixtures.make_amplicon_inputs``'s: reads of an
ARTIC-shaped panel and a second panel contig (``sim.amplicon_panel``:
ends on, near and beyond the primers, alternative primers, indels and
soft clips inside primers, reads shorter than a primer, unmapped mates,
QC failures, secondary and hard-clipped supplementary records, unplaced
pairs, NM and MD tags), its BED, and BEDs that are refused or read
otherwise.  No case launches a kernel.
"""

import re

import numpy as np
import pytest
from torch_tool_fixtures import (AMP_CONTIGS, AMP_READS, check_case,
                                 jax_case_runs, make_amplicon_inputs,
                                 run_jax_full, run_port_case, run_port_full)

from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.tools import ampliconclip_cmd as ac

SAM = ["--no-PG", "-O", "sam", "-b", "{primers}"]

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "soft_keep_tag": (["--keep-tag", *SAM, "{amp}"], None),
    "hard_keep_tag": (["--keep-tag", "--hard-clip", *SAM, "{amp}"], None),
    "soft_clip_option": (["--soft-clip", *SAM, "{amp}"], None),
    "strand": (["--keep-tag", "--strand", *SAM, "{amp}"], None),
    "both_ends": (["--strand", "--both-ends", *SAM, "{amp}"], None),
    "both_ends_hard": (["--both-ends", "--hard-clip", *SAM, "{amp}"],
                       None),
    "original": (["--original", *SAM, "{amp}"], None),
    "original_hard_both": (["--original", "--hard-clip", "--both-ends",
                            "--keep-tag", *SAM, "{amp}"], None),
    "delete_tag": ([*SAM, "{amp}"], None),
    "filter_len": (["--strand", "--filter-len", "120", *SAM, "{amp}"],
                   None),
    "fail_len": (["--strand", "--fail-len", "120", *SAM, "{amp}"], None),
    "unmap_len": (["--unmap-len", "125", *SAM, "{amp}"], None),
    "unmap_len_hard": (["--hard-clip", "--unmap-len", "10", *SAM, "{amp}"],
                       None),
    "fail": (["--fail", *SAM, "{amp}"], None),
    "clipped": (["--clipped", *SAM, "{amp}"], None),
    "no_excluded": (["--no-excluded", *SAM, "{amp}"], None),
    "rejects_and_counts": (["--both-ends", "--strand", "--filter-len",
                            "130", "--rejects-file", "{o}/rej.sam",
                            "--primer-counts", "{o}/pc.txt", "-o",
                            "{o}/out.sam", *SAM, "{amp}"], None),
    "rejects_bam": (["--no-excluded", "--clipped", "--rejects-file",
                     "{o}/rej.bam", "-o", "{o}/out.bam", "-b", "{primers}",
                     "{amp}"], None),
    "counts_no_strand": (["--primer-counts", "{o}/pc.txt", *SAM, "{amp}"],
                         None),
    "counts_bed3": (["--primer-counts", "{o}/pc.txt", "--no-PG", "-O", "sam",
                     "-b", "{bed3}", "{amp}"], None),
    "stats_file": (["-f", "{o}/stats.txt", "-o", "{o}/out.bam", "-b",
                    "{primers}", "{amp}"], None),
    "stats_file_unwritable": (["-f", "{o}/none/stats.txt", *SAM, "{amp}"],
                              None),
    "counts_unwritable": (["--primer-counts", "{o}/none/pc.txt", *SAM,
                           "{amp}"], None),
    "uncompressed": (["-u", "-o", "{o}/out.bam", "-b", "{primers}",
                      "{amp}"], None),
    "bam_stdout": (["-b", "{primers}", "{amp}"], None),
    "bam_by_name": (["--both-ends", "-o", "{o}/x.bam", "-b", "{primers}",
                     "{amp}"], None),
    "level_1": (["--output-fmt-option", "level=1", "-o", "{o}/out.bam",
                 "-b", "{primers}", "{amp}"], None),
    "level_bad": (["--output-fmt-option", "level=x", "-o", "{o}/out.bam",
                   "-b", "{primers}", "{amp}"], None),
    "output_fmt_long": (["--no-PG", "--output-fmt=sam", "-b", "{primers}",
                         "{amp}"], None),
    "tolerance_negative": (["--tolerance", "-3", *SAM, "{amp}"], None),
    "tolerance_zero": (["--tolerance", "0", "--both-ends", *SAM, "{amp}"],
                       None),
    "tolerance_ten": (["--tolerance", "10", "--strand", *SAM, "{amp}"],
                      None),
    "one_contig_bed": (["--no-PG", "-O", "sam", "-b", "{artic_only}",
                        "{amp}"], None),
    "header_pg_so": (["-O", "sam", "-b", "{primers}", "{amp}"], None),
    "sam_input": (["--both-ends", *SAM[:-2], "-b", "{artic}",
                   "{s0_sam}"], None),
    "stdin": ([*SAM, "-"], "amp"),
    "threads": (["-@", "2", "-o", "{o}/out.bam", "-b", "{primers}",
                 "{amp}"], None),
    "bad_strand": (["--strand", *SAM[:-1], "{bad_strand}", "{amp}"], None),
    "bad_strand_unused": ([*SAM[:-1], "{bad_strand}", "{amp}"], None),
    "bed3_strand": (["--strand", *SAM[:-1], "{bed3}", "{amp}"], None),
    "short_row_strand": (["--strand", *SAM[:-1], "{short_row}", "{amp}"],
                         None),
    "missing_bed": ([*SAM[:-1], "{dir}/none.bed", "{amp}"], None),
    "missing_input": ([*SAM, "{dir}/none.bam"], None),
    "no_arguments": ([], None),
    "no_bed": (["{amp}"], None),
    "no_input": (["-b", "{primers}"], None),
    "bad_option": (["--no-such", *SAM, "{amp}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_amplicon_inputs(str(tmp_path_factory.mktemp("amplicon")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("ampliconclip", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ampliconclip_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("ampliconclip", inputs, CASES, case),
               want[case], case)
    assert not any(kernels.launches.values())


def test_cases_reach_every_path(want):
    """The table counts clipped, unclipped, excluded, filtered and
    failed reads, rewrites @HD's SO:coordinate, and ends in each error
    exit it names."""
    (rc, _, err, files), _ = want["rejects_and_counts"]
    stats = dict(ln.split(": ", 1) for ln in err.splitlines()[1:])
    assert rc == 0 and all(int(stats[k]) > 0 for k in (
        "FORWARD CLIPPED", "REVERSE CLIPPED", "BOTH CLIPPED", "NOT CLIPPED",
        "EXCLUDED", "FILTERED"))
    assert int(stats["TOTAL READS"]) == int(stats["WRITTEN"]) + int(
        stats["FILTERED"])
    assert "FAILED: 0" not in want["fail"][0][2]
    # OA with NM (",MAPQ,NM;") and without (samtools' "MAPQ,;")
    oa = want["original"][0][1].decode()
    assert re.search(r"\tOA:Z:[^\t]*[MIDNSHP=X],\d+,\d+;", oa)
    assert re.search(r"\tOA:Z:[^\t]*[MIDNSHP=X]\d+,;", oa)
    assert b"@HD\tVN:1.6\tSO:unknown\n" in want["header_pg_so"][0][1]
    assert [c for c in CASES if want[c][0][0] != 0] == [
        "bad_strand", "bed3_strand", "short_row_strand", "missing_bed",
        "missing_input", "no_arguments", "no_bed", "no_input",
        "bad_option"]


def test_soft_clip_starts_past_the_primer(inputs):
    """A forward read the port clipped, and left mapped, starts at or
    past the right end of a left primer of its amplicon (the
    simulator's truth: main or alternative, whichever lay within the
    tolerance), and keeps its bases in its soft clip."""
    got = run_port_case("ampliconclip", inputs, {"x": (
        ["--strand", "--keep-tag", "-o", "{o}/x.bam", "-b", "{primers}",
         "{amp}"], None)}, "x")
    assert got[0] == 0
    panel = sim.amplicon_panel(AMP_READS, 81, AMP_CONTIGS)
    b = read_alignments(inputs["amp"]).batch
    with open(inputs["dir"] + "/x.bam", "wb") as f:
        f.write(got[3]["x.bam"])
    c = read_alignments(inputs["dir"] + "/x.bam").batch
    assert c.n == b.n
    fwd = (panel.amplicon >= 0) & ((b.flag & 0x14) == 0)
    clipped = fwd & (c.pos != b.pos) & ((c.flag & 0x4) == 0)
    assert clipped.sum() > 0.8 * fwd.sum()
    ends = np.array([min(r for _, r in panel.lefts[a]) if a >= 0 else 0
                     for a in panel.amplicon])
    assert (c.pos[clipped] >= ends[clipped]).all()
    assert (c.pos[clipped] > b.pos[clipped]).all()
    assert np.array_equal(c.l_qseq, b.l_qseq)


def test_trims_walk_multi_op_cigars():
    """trim_left and trim_right over insertions, deletions, soft and hard
    clips, soft and hard, and a read the clip consumes whole."""
    cig = np.array([(5 << 4) | 5, (3 << 4) | 4, (4 << 4) | 0, (2 << 4) | 1,
                    (6 << 4) | 0, (3 << 4) | 2, (10 << 4) | 0], np.uint32)
    assert ac.cigar_str(cig) == "5H3S4M2I6M3D10M"
    new, pos, q, empty = ac.trim_left(cig, 100, 25, 7, False)
    assert (ac.cigar_str(new), pos, q, empty) == ("5H12S3M3D10M", 107, 0,
                                                  False)
    new, pos, q, empty = ac.trim_left(cig, 100, 25, 7, True)
    assert (ac.cigar_str(new), pos, q, empty) == ("17H3M3D10M", 107, 12,
                                                  False)
    new, q, empty = ac.trim_right(cig, 25, 12, False)
    assert (ac.cigar_str(new), q, empty) == ("5H3S4M2I6M1D10S", 0, False)
    new, q, empty = ac.trim_right(cig, 25, 12, True)
    assert (ac.cigar_str(new), q, empty) == ("5H3S4M2I6M1D10H", 10, False)
    assert ac.trim_left(cig, 100, 25, 99, True) == ([], 100, 25, True)
    assert ac.trim_right(cig, 25, 99, True) == ([], 25, True)
    assert ac.active_query_len(cig) == 22


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["ampliconclip"], None)},
                        "x")
    assert got[:3] == run_jax_full("help", ["ampliconclip"])


def test_top_level_help_lists_the_amplicon_tools():
    """``help`` prints the JAX tool's text, the package's name masked,
    with ampliconclip under Editing and ampliconstats under Statistics."""
    rc, out, err = run_port_full("help", [])
    assert (rc, err) == (0, "")
    want = run_jax_full("help", [])
    assert out.replace(b"samtools_tpu_torch", b"samtools_tpu") == want[1]
    assert b"     ampliconclip   clip oligos from the end of reads\n" in out
    assert b"     ampliconstats  generate amplicon specific stats\n" in out
