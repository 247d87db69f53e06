"""``python -m samtools_tpu_torch reference`` against ``python -m
samtools_tpu reference``, on the CPU: one parity test over the table of
cases, each run by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file).

Inputs are ``torch_tool_fixtures.make_md_inputs``'s: ``md`` (the messy
reads, with indels and soft clips, through the JAX ``calmd -b``, those
that start before ``MD_KEEP_END``, every 7th without its MD tag) and
its SAM twin, ``messy`` (no MD tags at all) and ``cram`` (a CRAM, for
``-e``).  No case launches a kernel.
"""

import numpy as np
import pytest
from torch_tool_fixtures import (MD_KEEP_END, REF_LEN, check_case,
                                 jax_case_runs, make_md_inputs,
                                 run_jax_full, run_port_case)

from samtools_tpu_torch import kernels

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "plain": (["{md}"], None),
    "quiet": (["-q", "{md}"], None),
    "quiet_long": (["--quiet", "{md}"], None),
    "output": (["-o", "{o}/ref.fa", "{md}"], None),
    "output_long": (["--output", "{o}/ref.fa", "-q", "{md}"], None),
    "sam_input": (["{md_sam}"], None),
    "no_md": (["{messy}"], None),
    "region_inside": (["-r", "sim1:20001-25000", "{md}"], None),
    "region_from": (["-r", "sim1:90000", "{md}"], None),
    "region_whole": (["--region", "sim1", "{md}"], None),
    "region_outside": (["-r", "sim1:%d-%d" % (MD_KEEP_END + 2000,
                                              MD_KEEP_END + 2500),
                        "{md}"], None),
    "region_outside_quiet": (["-q", "-r", "sim1:%d-%d" % (
        MD_KEEP_END + 2000, MD_KEEP_END + 2100), "{md}"], None),
    "region_past_end": (["-r", "sim1:%d-%d" % (REF_LEN - 100, REF_LEN + 50),
                         "{md}"], None),
    "region_bad": (["-r", "nope:1-10", "{md}"], None),
    "embedded_bam": (["-e", "{md}"], None),
    "embedded_cram": (["--embedded", "{cram}"], None),
    "threads": (["-@", "2", "-q", "{md}"], None),
    "stdin": (["-q", "-"], "md"),
    "stdin_implied": ([], "md_sam"),
    "missing": (["{dir}/none.bam"], None),
    "not_alignments": (["{fa}"], None),
    "bad_option": (["--no-such", "{md}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_md_inputs(str(tmp_path_factory.mktemp("reference")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("reference", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("reference", inputs, CASES, case), want[case],
               case)
    assert not any(kernels.launches.values())


def test_bases_agree_with_the_reference(inputs):
    """Every base that is not N is the FASTA's; the reads cover most of
    the contig's first MD_KEEP_END bases."""
    rc, out, err, _ = run_port_case("reference", inputs,
                                    {"x": (["{md}"], None)}, "x")
    assert rc == 0 and err.startswith("Dump ref 0 len %d, coverage "
                                      % REF_LEN)
    lines = out.decode().split("\n")
    assert lines[0] == ">sim1" and max(len(x) for x in lines) == 60
    got = np.frombuffer("".join(lines[1:]).encode(), np.uint8)
    ref = inputs["ref"]
    assert got.size == ref.size
    known = got != ord("N")
    assert np.array_equal(got[known], ref[known])
    assert known[:MD_KEEP_END].mean() > 0.95 and not known[
        MD_KEEP_END + 500:].any()


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["reference"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["reference"])
