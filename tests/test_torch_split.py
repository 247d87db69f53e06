"""``python -m samtools_tpu_torch split`` against ``python -m samtools_tpu
split``, on the CPU: one parity test over the table of cases, each run
by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BGZF outputs must be the bytes of the JAX tool's
zlib run).  Every case names its outputs under its own directory
(``-f {o}/...``): the default format writes into the working directory.

Inputs are ``torch_tool_fixtures.make_fastq_inputs``'s: ``dup`` (two
read groups, every read in one), ``general`` (three read groups, one
with no reads, reads without a read group), ``norg`` (RG tags, no @RG
line), ``tagged`` (XN:i and XC:c values, negative ones too, and BC
values), ``slash_rg`` (a read group ID with a '/') and ``hdr`` (a header
for ``-h``).  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_fastq_inputs, run_port_case)

from samtools_tpu_torch import kernels

F = ["-f", "{o}/%*_%!.%."]
# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
SPLIT = {
    "read_groups": ([*F, "{dup}"], None),
    "index_format": (["-f", "{o}/%#_%%_%*.%.", "{dup}"], None),
    "index_padded": (["-p", "3", "-f", "{o}/%#.%.", "{dup}"], None),
    "verbose": (["-v", *F, "{dup}"], None),
    "unaccounted": (["-u", "{o}/u.bam", *F, "{general}"], None),
    "unaccounted_header": (["-u", "{o}/u.bam", "-h", "{hdr}", *F,
                            "{general}"], None),
    "unaccounted_header_refs": (["-u", "{o}/u.bam", "-h", "{dup}", *F,
                                 "{general}"], None),
    "unaccounted_header_lengths": (["-u", "{o}/u.bam", "-h", "{md_missing}",
                                    *F, "{dup}"], None),
    "unaccounted_header_missing": (["-u", "{o}/u.bam", "-h",
                                    "{dir}/none.sam", *F, "{general}"],
                                   None),
    "no_read_group": ([*F, "{general}"], None),
    "unknown_read_group": ([*F, "{norg}"], None),
    "tag_rg": (["-d", "RG", *F, "{norg}"], None),
    "tag_string": (["-d", "BC", *F, "{tagged}"], None),
    "tag_int": (["-d", "XN", "-u", "{o}/u.bam", *F, "{tagged}"], None),
    "tag_int_padded": (["-d", "XN", "-p", "4", "-u", "{o}/u.bam", "-f",
                        "{o}/%!_%#.%.", "{tagged}"], None),
    "tag_char_padded": (["-d", "XC", "-p", "2", "-u", "{o}/u.bam", *F,
                         "{tagged}"], None),
    "tag_missing_values": (["-d", "XN", *F, "{tagged}"], None),
    "max_split": (["-d", "XN", "-M", "5", "-u", "{o}/u.bam", *F,
                   "{tagged}"], None),
    "max_split_long": (["-d", "BC", "--max-split", "2", "-u", "{o}/u.bam",
                        *F, "{tagged}"], None),
    "max_split_exceeded": (["-d", "BC", "-M", "1", *F, "{tagged}"], None),
    "max_split_below_groups": (["-M", "1", *F, "{dup}"], None),
    "max_split_zero": (["-M", "0", *F, "{dup}"], None),
    "output_sam": (["--output-fmt", "sam", *F, "{dup}"], None),
    "output_samgz": (["--output-fmt", "sam.gz", *F, "{dup}"], None),
    "output_cram": (["--output-fmt", "cram", *F, "{tagged}"], None),
    "no_pg": (["--no-PG", "-u", "{o}/u.sam", *F, "{general}"], None),
    "threads": (["-@", "2", *F, "{dup}"], None),
    "sam_input": ([*F, "{dup_sam}"], None),
    "slash_in_id": ([*F, "{slash_rg}"], None),
    "slash_in_id_tag": (["-d", "RG", "-f", "{o}/x_%!.%.", "{slash_rg}"],
                        None),
    "trailing_percent": (["-f", "{o}/x%", "{dup}"], None),
    "unknown_specifier": (["-f", "{o}/x%z", "{dup}"], None),
    "bad_tag": (["-d", "RGX", *F, "{dup}"], None),
    "no_input": (F, None),
    "two_inputs": ([*F, "{dup}", "{general}"], None),
    "missing": ([*F, "{dir}/none.bam"], None),
    "bad_output": (["-f", "{dir}/no_dir/%!.bam", "{dup}"], None),
    "bad_unaccounted": (["-u", "{dir}/no_dir/u.bam", *F, "{general}"],
                        None),
    "bad_option": (["--no-such", *F, "{dup}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_fastq_inputs(str(tmp_path_factory.mktemp("split")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("split", inputs, SPLIT)


@pytest.mark.parametrize("case", sorted(SPLIT))
def test_split_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("split", inputs, SPLIT, case), want[case],
               case)
    assert not any(kernels.launches.values())
