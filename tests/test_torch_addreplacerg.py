"""``python -m samtools_tpu_torch addreplacerg`` against ``python -m
samtools_tpu addreplacerg``, on the CPU: one parity test over the table of
cases, each run by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BGZF outputs are the bytes of the JAX tool's zlib
run).

Inputs are ``torch_tool_fixtures.make_dup_inputs``'s: ``dup`` (two read
groups, every read in one), ``general`` (three read groups, reads in
none of them), ``norg`` (RG tags, no @RG line) and ``grouped2k`` for
CRAM output.  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_dup_inputs,
                                 run_port_case)

from samtools_tpu_torch import kernels

LINE = "@RG\\tID:x\\tSM:y"

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
ADDREPLACERG = {
    "line": (["-r", LINE, "{dup}"], None),
    "line_parts": (["-r", "ID:x", "-r", "SM:y", "-r", "LB:z", "{dup}"],
                   None),
    "line_output_bam": (["-r", LINE, "-o", "{o}/a.bam", "{dup}"], None),
    "line_orphan_only": (["-r", LINE, "-m", "orphan_only", "-o",
                          "{o}/a.sam", "{general}"], None),
    "line_overwrite_all": (["-r", LINE, "-m", "overwrite_all",
                            "{general}"], None),
    "existing_id": (["-R", "grpB", "{dup}"], None),
    "existing_id_orphan_only": (["-R", "grpC", "-m", "orphan_only",
                                 "{general}"], None),
    "missing_id": (["-R", "nope", "{dup}"], None),
    "first_header_id": (["-o", "{o}/a.bam", "{general}"], None),
    "no_read_group": (["{norg}"], None),
    "duplicate_line": (["-r", "@RG\\tID:grpA\\tSM:z", "{dup}"], None),
    "overwrite_line": (["-w", "-r", "@RG\\tID:grpA\\tSM:z", "{dup}"], None),
    "overwrite_line_orphan_only": (["-w", "-m", "orphan_only", "-r",
                                    "@RG\\tID:grpA\\tSM:z", "{general}"],
                                   None),
    "both_options": (["-r", "ID:x", "-R", "grpA", "{dup}"], None),
    "line_without_id": (["-r", "@RG\\tSM:y", "{dup}"], None),
    "newline_escape": (["-r", "@RG\\tID:x\\nSM:y", "{dup}"], None),
    "unsupported_escape": (["-r", "@RG\\qID:x", "{dup}"], None),
    "unterminated_escape": (["-r", "@RG\\tID:x\\", "{dup}"], None),
    "backslash_escape": (["-r", "@RG\\tID:x\\\\y", "{dup}"], None),
    "bad_mode": (["-m", "bogus", "-R", "grpA", "{dup}"], None),
    "uncompressed": (["-u", "-O", "bam", "-o", "{o}/a.bam", "-R", "grpA",
                      "{dup}"], None),
    "output_fmt": (["--output-fmt", "bam", "-o", "{o}/a.out", "-r", "ID:x",
                    "{dup}"], None),
    "samgz_output": (["-o", "{o}/a.sam.gz", "-R", "grpA", "{dup}"], None),
    "cram_output": (["-O", "cram", "--reference", "{fa}", "-o",
                     "{o}/a.cram", "-r", "ID:x", "{grouped2k}"], None),
    "no_pg": (["--no-PG", "-R", "grpA", "{dup}"], None),
    "threads": (["-@", "2", "-o", "{o}/a.bam", "-r", "ID:x", "{dup}"],
                None),
    "sam_input": (["-r", "ID:x", "{dup_sam}"], None),
    "stdin": (["-R", "grpB", "-"], "dup"),
    "help": (["-h"], None),
    "no_arguments": ([], None),
    "no_input": (["-r", "ID:x"], None),
    "missing": (["-r", "ID:x", "{dir}/none.bam"], None),
    "bad_output": (["-r", "ID:x", "-o", "{dir}/no_dir/a.sam", "{dup}"],
                   None),
    "bad_option": (["--no-such", "{dup}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_dup_inputs(str(tmp_path_factory.mktemp("addrg")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("addreplacerg", inputs, ADDREPLACERG)


@pytest.mark.parametrize("case", sorted(ADDREPLACERG))
def test_addreplacerg_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("addreplacerg", inputs, ADDREPLACERG, case),
               want[case], case)
    assert not any(kernels.launches.values())
