"""``python -m samtools_tpu_torch reset`` against ``python -m samtools_tpu
reset``, on the CPU: one parity test over the table of cases, each run
by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BGZF outputs must be the bytes of the JAX tool's
zlib run).

Inputs are ``torch_tool_fixtures.make_fastq_inputs``'s: ``dup`` (pairs
in two read groups, reverse reads, supplementary records with SA tags,
MC/ms tags, a chain of three @PG lines), ``dup_marked`` (duplicate flags,
dt/do tags), ``general`` (three read groups, aux fields of every type,
reads without qualities, secondary-like hard clips) and ``pgchain``
(three @PG chain ends).  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_fastq_inputs, run_port_case)

from samtools_tpu_torch import kernels

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
RESET = {
    "plain": (["{dup}"], None),
    "general": (["{general}"], None),
    "output_bam": (["-o", "{o}/x.bam", "{dup}"], None),
    "output_sam": (["-o", "{o}/x.sam", "{general}"], None),
    "output_fmt": (["-O", "bam", "-o", "{o}/x.out", "{dup}"], None),
    "output_fmt_long": (["--output-fmt", "sam.gz", "-o", "{o}/x.gz",
                         "{dup}"], None),
    "output_cram": (["-o", "{o}/x.cram", "{pgchain}"], None),
    "no_rg": (["--no-RG", "{dup}"], None),
    "no_rg_keep": (["--no-RG", "--keep-tag", "RG,BC", "{dup}"], None),
    "no_pg": (["--no-PG", "{dup}"], None),
    "dupflag": (["--dupflag", "{dup_marked}"], None),
    "dupflag_off": (["{dup_marked}"], None),
    "remove_tag": (["-x", "BC,ms", "{dup}"], None),
    "remove_tag_long": (["--remove-tag", "XA", "--remove-tag", "XB",
                         "{general}"], None),
    "keep_not": (["-x", "^RG,ms", "{dup}"], None),
    "keep_tag": (["--keep-tag", "BC", "{dup}"], None),
    "keep_and_remove": (["--keep-tag", "BC,RG", "-x", "BC", "{dup}"], None),
    "reject_pg": (["--reject-PG", "samtools.1", "{dup}"], None),
    "reject_pg_first": (["--reject-PG", "samtools", "{dup}"], None),
    "reject_pg_missing": (["--reject-PG", "nope", "{dup}"], None),
    "reject_pg_no_pg": (["--reject-PG", "samtools.2", "--no-PG", "{dup}"],
                        None),
    "pg_chains": (["{pgchain}"], None),
    "pg_chains_reject": (["--reject-PG", "pic", "{pgchain}"], None),
    "threads": (["-@", "2", "-o", "{o}/x.bam", "{dup}"], None),
    "sam_input": (["{dup_sam}"], None),
    "cram_input": (["{grouped_cram}"], None),
    "stdin": (["-"], "dup"),
    "too_many": (["{dup}", "{general}"], None),
    "missing": (["{dir}/none.bam"], None),
    "bad_output": (["-o", "{dir}/no_dir/x.sam", "{dup}"], None),
    "bad_option": (["--no-such", "{dup}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_fastq_inputs(str(tmp_path_factory.mktemp("reset")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("reset", inputs, RESET)


@pytest.mark.parametrize("case", sorted(RESET))
def test_reset_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("reset", inputs, RESET, case), want[case],
               case)
    assert not any(kernels.launches.values())
