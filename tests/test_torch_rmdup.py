"""``python -m samtools_tpu_torch rmdup`` against ``python -m samtools_tpu
rmdup``, on the CPU: one parity test over the table of cases, each run by
the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BGZF outputs are the bytes of the JAX tool's zlib
run).

Inputs are ``torch_tool_fixtures.make_dup_inputs``'s: ``dup`` (pairs with
copies, single-end copies, supplementary records, two read groups of two
libraries), ``dup_marked``, ``gsorted`` (reads with mates on another
contig, three read groups, one without a library, unmapped reads at the
end), ``mc`` (the pairs through ``fixmate -m``, one library) and a SAM
without a header.  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_dup_inputs,
                                 run_port_case)

from samtools_tpu_torch import kernels

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
RMDUP = {
    "default": (["{dup}", "{o}/r.bam"], None),
    "sam_output": (["{dup}", "{o}/r.sam"], None),
    "single": (["-s", "{dup}", "{o}/r.bam"], None),
    "force_single": (["-S", "{dup}", "{o}/r.sam"], None),
    "libraries": (["{gsorted}", "{o}/r.sam"], None),
    "libraries_single": (["-s", "{gsorted}", "{o}/r.sam"], None),
    "libraries_force_single": (["-S", "{gsorted}", "{o}/r.sam"], None),
    "pairs": (["{mc}", "{o}/r.bam"], None),
    "marked": (["{dup_marked}", "{o}/r.sam"], None),
    "threads": (["-@", "2", "{dup}", "{o}/r.bam"], None),
    "output_fmt": (["--output-fmt", "sam", "{dup}", "{o}/r.out"], None),
    "samgz_output": (["-s", "{dup}", "{o}/r.sam.gz"], None),
    "stdout": (["{dup}", "-"], None),
    "stdout_sam": (["--output-fmt", "sam", "-s", "{dup}", "-"], None),
    "stdin": (["-", "{o}/r.bam"], "dup"),
    "sam_input": (["{dup_sam}", "{o}/r.sam"], None),
    "headerless": (["{headerless}", "{o}/r.bam"], None),
    "missing": (["{dir}/none.bam", "{o}/r.bam"], None),
    "no_arguments": ([], None),
    "one_argument": (["{dup}"], None),
    "bad_option": (["-x", "{dup}", "{o}/r.bam"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_dup_inputs(str(tmp_path_factory.mktemp("rmdup")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("rmdup", inputs, RMDUP)


@pytest.mark.parametrize("case", sorted(RMDUP))
def test_rmdup_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("rmdup", inputs, RMDUP, case), want[case],
               case)
    assert not any(kernels.launches.values())


def test_fixture_removes_duplicates(want):
    """Both modes remove reads of both libraries of ``dup``."""
    err = want["default"][0][2] + want["single"][0][2]
    for lib in ("libA", "libB"):
        assert f"in library '{lib}'" in err
    assert "[bam_rmdupse_core]" in err
    assert not err.count(" 0 / ")
