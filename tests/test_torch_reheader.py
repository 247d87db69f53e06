"""``python -m samtools_tpu_torch reheader`` against ``python -m
samtools_tpu reheader``, on the CPU: one parity test over the table of
cases, each run by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; the BAM on standard output must be the bytes of
the JAX tool's zlib run, ``SAMTPU_NO_NATIVE=1``, and its blocks those of
the default run).

Inputs are ``torch_tool_fixtures.make_header_inputs``'s: ``general`` and
the other BAMs (the first record shares a BGZF block with the header),
``hsplit`` (the header in blocks of its own), ``hdr`` (a header SAM),
the SAM twin and CRAM 3.0/3.1 files.  ``-i`` rewrites a CRAM in place,
so those cases start from a copy in the case's directory, which is one
of the files compared.  No case launches a kernel.
"""

import os
import shutil

import numpy as np
import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_header_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.io import bgzf
from samtools_tpu_torch.io.files import read_alignments

# the CRAMs -i rewrites, copied into each case's directory
COPIED = {"grouped_cram": "in30.cram", "grouped_cram31": "in31.cram",
          "general": "in.bam"}

SED = "sed -e 's/view inputs/edited by sed/' -e '/^@RG\tID:grpC/d'"

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "from_sam": (["{hdr}", "{general}"], None),
    "from_sam_no_pg": (["-P", "{hdr}", "{general}"], None),
    "from_sam_no_pg_long": (["--no-PG", "{hdr}", "{ha}"], None),
    "from_bam_header": (["{norg}", "{ha}"], None),
    "header_own_blocks": (["{hdr}", "{hsplit}"], None),
    "command": (["-c", SED, "{general}"], None),
    "command_long": (["--command", "grep -v '^@CO'", "-P", "{hb}"], None),
    "command_fails": (["-c", "exit 3", "{general}"], None),
    "command_empty_header": (["-c", "grep '^@HD'", "{general}"], None),
    "command_own_blocks": (["-c", "cat", "{hsplit}"], None),
    "in_place_bam": (["-i", "{hdr}", "{o}/in.bam"], None),
    "in_place_cram30": (["-i", "-P", "-c", SED, "{o}/in30.cram"], None),
    "in_place_cram31": (["--in-place", "{hdr}", "{o}/in31.cram"], None),
    "in_place_too_big": (["-i", "-c", "yes '@CO\tfiller' | head -5000",
                          "{o}/in30.cram"], None),
    "cram30": (["{hdr}", "{grouped_cram}"], None),
    "cram31": (["-c", "cat", "{grouped_cram31}"], None),
    "sam_input": (["{hdr}", "{general_sam}"], None),
    "samgz_input": (["-P", "{hdr}", "{general_samgz}"], None),
    "missing_header": (["{dir}/none.sam", "{general}"], None),
    "missing_input": (["{hdr}", "{dir}/none.bam"], None),
    "missing_input_command": (["-c", "cat", "{dir}/none.bam"], None),
    "one_argument": (["{general}"], None),
    "three_arguments": (["{hdr}", "{general}", "{ha}"], None),
    "command_and_two": (["-c", "cat", "{hdr}", "{general}"], None),
    "bad_option": (["--no-such", "{hdr}", "{general}"], None),
    "help": (["-h"], None),
}


def _copy_inputs(inputs):
    def prepare(odir):
        for key, name in COPIED.items():
            shutil.copy(inputs[key], os.path.join(odir, name))
    return prepare


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_header_inputs(str(tmp_path_factory.mktemp("reheader")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("reheader", inputs, CASES, _copy_inputs(inputs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reheader_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("reheader", inputs, CASES, case,
                             _copy_inputs(inputs)), want[case], case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("key", ["general", "hsplit"])
def test_records_blocks_are_copied_raw(inputs, key):
    """The blocks after the header's (and after the re-deflated tail of
    the block the old header ends in) are the input's bytes."""
    got = run_port_case("reheader", inputs,
                        {"x": (["-P", "{hdr}", "{%s}" % key], None)}, "x")
    assert got[0] == 0
    with open(inputs[key], "rb") as f:
        data = f.read()
    coffs, _ = bgzf.scan_blocks(data)
    new = got[1]
    ncoffs, _ = bgzf.scan_blocks(new)
    tail = data[int(coffs[1]):]
    assert new.endswith(tail) and len(new) - len(tail) == int(ncoffs[-(
        coffs.size - 1)])


def test_in_place_cram_keeps_the_records(inputs, tmp_path):
    """``-i`` on a CRAM: the header is the new one, the records decode as
    before."""
    path = str(tmp_path / "x.cram")
    shutil.copy(inputs["grouped_cram31"], path)
    got = run_port_case("reheader", inputs, {"x": (
        ["-i", "-P", "-c", "cat; printf '@CO\\tadded\\n'", path], None)},
        "x")
    assert got[:3] == (0, b"", "")
    old, new = read_alignments(inputs["grouped_cram31"]), \
        read_alignments(path)
    assert new.header.text == old.header.text + "@CO\tadded\n"
    assert new.batch.n == old.batch.n > 0
    for k in ("pos", "flag", "seq", "qual", "cigar", "aux"):
        assert np.array_equal(getattr(new.batch, k), getattr(old.batch, k))


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["reheader"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["reheader"])
