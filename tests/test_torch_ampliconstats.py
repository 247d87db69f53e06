"""``python -m samtools_tpu_torch ampliconstats`` against ``python -m
samtools_tpu ampliconstats``, on the CPU: one parity test over the table
of cases, each run by the port in-process with the JAX tool's argument
list (``torch_tool_fixtures.check_case``: exit code, standard error,
standard output and every file).

Inputs are ``torch_tool_fixtures.make_amplicon_inputs``'s: four samples
of an ARTIC-shaped panel (``sim.amplicon_panel``) and their BED, one of
them clipped by ``ampliconclip --both-ends --strand`` and sorted, the
two-contig panel's reads and BED, a sample under a header that differs,
and BEDs ampliconstats refuses.  The JAX tool's refusals the port keeps
(each exits 1; whether samtools does the same is not checked here):
``--output`` and ``-p``, which its usage or short options name but
nothing handles; ``--required-flag`` and ``--filter-flag``, which its
usage names but its long options lack; and a 3-column BED, since it
always asks for strands.  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_amplicon_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.tools import ampliconstats_cmd as ast

FOUR = ["{s0}", "{s1}", "{s2}", "{s3}"]

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "one_file": (["{artic}", "{s0}"], None),
    "four_files": (["{artic}", *FOUR], None),
    "sample_names": (["-s", "{artic}", *FOUR], None),
    "single_ref": (["-S", "{artic}", "{s0}", "{s1}"], None),
    "single_ref_two_contigs": (["-S", "{primers}", "{amp}"], None),
    "two_contigs": (["{primers}", "{amp}"], None),
    "first_contig_bed": (["{artic_only}", "{amp}"], None),
    "options": (["-t", "50", "-c", "3", "-b", "5", "-D", "0.05", "-d",
                 "1,10,20", "-m", "10", "-a", "200", "-l", "600", "-F", "0",
                 "-f", "PAIRED", "{primers}", "{amp}"], None),
    "long_options": (["--tlen-adjust", "20", "--tcoord-min-count", "2",
                      "--tcoord-bin", "20", "--depth-bin", "0.2",
                      "--min-depth", "5,15", "--pos-margin", "5",
                      "--flag-filter", "UNMAP,SECONDARY", "--flag-require",
                      "0", "--use-sample-name", "{artic}", "{s0}", "{s1}"],
                     None),
    "filter_flags_twice": (["-F", "0x4", "-F", "0x100", "{artic}", "{s0}"],
                           None),
    "clipped": (["-s", "{artic}", "{clipped}", "{s1}"], None),
    "sam_input": (["{artic}", "{s0_sam}"], None),
    "stdin": (["{artic}"], "s0"),
    "output_file": (["-o", "{o}/astats.txt", "{artic}", "{s0}", "{s1}"],
                    None),
    "headers_differ": (["{artic}", "{s0}", "{other}"], None),
    "contigs_differ": (["{artic}", "{s0}", "{amp}"], None),
    "too_many_amplicons": (["-a", "50", "{artic}", "{s0}"], None),
    "amplicons_too_long": (["-l", "300", "{artic}", "{s0}"], None),
    "output_long_refused": (["--output", "{o}/x.txt", "{artic}", "{s0}"],
                            None),
    "p_refused": (["-p", "2", "{artic}", "{s0}"], None),
    "required_flag_refused": (["--required-flag", "PAIRED", "{artic}",
                               "{s0}"], None),
    "filter_flag_refused": (["--filter-flag", "0", "{artic}", "{s0}"],
                            None),
    "bed3_refused": (["{bed3}", "{amp}"], None),
    "bad_strand": (["{bad_strand}", "{amp}"], None),
    "bad_flag": (["-f", "NOPE", "{artic}", "{s0}"], None),
    "missing_bed": (["{dir}/none.bed", "{s0}"], None),
    "missing_input": (["{artic}", "{s0}", "{dir}/none.bam"], None),
    "no_arguments": ([], None),
    "help": (["-h"], None),
    "bad_option": (["--no-such", "{artic}", "{s0}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_amplicon_inputs(str(tmp_path_factory.mktemp("astats")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("ampliconstats", inputs, CASES, zlib_run=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ampliconstats_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("ampliconstats", inputs, CASES, case),
               want[case], case)
    assert not any(kernels.launches.values())


def test_cases_reach_every_path(want):
    """Per-file and combined blocks, template coordinates, and each
    refusal the table names."""
    out = want["four_files"][0][1].decode()
    assert out.count("\nFREADS\t") == 4 and "\nCREADS\tCOMBINED" in out
    assert "\nFTCOORD\t" in out and "\nCAMP\tCOMBINED\t0\t" in out
    assert [c for c in CASES if want[c][0][0] != 0] == [
        "single_ref_two_contigs", "headers_differ", "contigs_differ",
        "too_many_amplicons", "amplicons_too_long", "output_long_refused",
        "p_refused", "required_flag_refused", "filter_flag_refused",
        "bed3_refused", "bad_strand", "bad_flag", "missing_bed",
        "missing_input", "bad_option"]
    assert "[amplicon] error: invalid bed file format in line 1 of " in \
        want["bed3_refused"][0][2]


def test_combined_block_is_the_sum_of_the_files(inputs, want):
    """CREADS COMBINED is the per-amplicon sum of the four FREADS rows,
    CSS's raw totals the sum of the FSS ones; each file's FREADS adds up
    to its matching sequences."""
    rows = [ln.split("\t") for ln in
            want["four_files"][0][1].decode().splitlines()]
    freads = [list(map(int, r[2:])) for r in rows if r[0] == "FREADS"]
    comb = [list(map(int, r[2:])) for r in rows
            if r[:2] == ["CREADS", "COMBINED"]][0]
    assert [sum(x) for x in zip(*freads)] == comb
    fss = {}
    for r in rows:
        if r[0] in ("FSS", "CSS"):
            fss.setdefault((r[0], r[3]), []).append(int(r[4]))
    assert sum(fss[("FSS", "raw total sequences:")]) == \
        fss[("CSS", "raw total sequences:")][0]
    assert [sum(f) for f in freads] == fss[("FSS", "matching sequences:")]


def test_reset_keeps_the_pairs_seen_five_times():
    """AStats.reset drops the template coordinates counted fewer than 5
    times and zeroes the others (their keys decide the next file's
    rows)."""
    s = ast.AStats(100, 4, 50)
    s.tcoord[1] = {10: 4, 11: 5 | (1 << 32), 12: 7}
    s.tcoord[0] = {13: 1}
    s.reset()
    assert s.tcoord[1] == {11: 0, 12: 0} and s.tcoord[0] == {}


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["ampliconstats"], None)},
                        "x")
    assert got[:3] == run_jax_full("help", ["ampliconstats"])
