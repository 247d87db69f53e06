"""``python -m samtools_tpu_torch depad`` against ``python -m samtools_tpu
depad``, on the CPU: one parity test over the table of cases, each run
by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BAM outputs must be the bytes of the JAX tool's
zlib run, ``SAMTPU_NO_NATIVE=1``).

Inputs are ``torch_tool_fixtures.make_padded_inputs``'s: simulated
unpadded reads on two contigs padded by ``sim.pad_reads`` (pad columns
in the references, inserted bases as M on pad columns, pads passed as
D; reads that start on a pad column, one that opens with a D over pads,
mates on the other contig, hard and soft clips, unmapped reads), the
padded FASTA and one missing a contig, the same reads with embedded
reference reads, and a read with an I op, which depad refuses.  No case
launches a kernel.
"""

import numpy as np
import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_padded_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.io.files import read_alignments

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "sam": (["-s", "-T", "{padded_fa}", "{padded}"], None),
    "bam": (["-T", "{padded_fa}", "-o", "{o}/u.bam", "{padded}"], None),
    "bam_stdout": (["--reference", "{padded_fa}", "{padded}"], None),
    "uncompressed": (["-u", "-T", "{padded_fa}", "-o", "{o}/u.bam",
                      "{padded}"], None),
    "fast": (["-1", "-T", "{padded_fa}", "-o", "{o}/u.bam", "{padded}"],
             None),
    "cram": (["-C", "-T", "{padded_fa}", "-o", "{o}/u.cram", "{padded}"],
             None),
    "sam_no_pg": (["-s", "--no-PG", "-T", "{padded_fa}", "{padded}"],
                  None),
    "sam_input": (["-S", "-s", "-T", "{padded_fa}", "{o}/in.sam"], None),
    "embedded_with_fasta": (["-s", "-T", "{padded_fa}", "{padded_emb}"],
                            None),
    "embedded_mates_elsewhere": (["-s", "{padded_emb}"], None),
    "embedded_one_contig": (["-s", "{padded_emb1}"], None),
    "no_fasta": (["-s", "{padded}"], None),
    "fasta_missing_contig": (["-s", "-T", "{padded_fa1}", "{padded}"],
                             None),
    "fasta_missing": (["-s", "-T", "{dir}/none.fa", "{padded}"], None),
    "i_op": (["-s", "-T", "{padded_fa}", "{padded_bad}"], None),
    "threads_refused": (["-@", "2", "-T", "{padded_fa}", "-o", "{o}/u.bam",
                 "{padded}"], None),
    "stdin": (["-s", "-T", "{padded_fa}", "-"], "padded"),
    "no_input": ([], None),
    "missing": (["{dir}/none.bam"], None),
    "bad_option": (["--no-such", "{padded}"], None),
    "question": (["-?"], None),
}


def _sam_copy(inputs):
    """The padded BAM as SAM, beside each case's outputs (``sam_input``);
    removed again by the case's own file listing."""
    def prepare(odir):
        if odir.endswith("_sam_input"):
            from samtools_tpu.io.files import read_alignments as jread
            from samtools_tpu.io.files import write_alignments as jwrite
            f = jread(inputs["padded"])
            jwrite(odir + "/in.sam", f.header, f.batch)
    return prepare


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_padded_inputs(str(tmp_path_factory.mktemp("depad")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("depad", inputs, CASES, _sam_copy(inputs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_depad_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("depad", inputs, CASES, case,
                             _sam_copy(inputs)), want[case], case)
    assert not any(kernels.launches.values())


def test_depad_gives_back_the_unpadded_reads(inputs, tmp_path):
    """Each read comes back at its unpadded position, with its unpadded
    reference span and mate position, and the @SQ lengths are the
    unpadded ones."""
    out = str(tmp_path / "u.bam")
    got = run_port_case("depad", inputs, {"x": (
        ["-T", "{padded_fa}", "-o", out, "{padded}"], None)}, "x")
    assert got[0] == 0 and got[2] == ""
    u = read_alignments(out)
    want = inputs["unpadded"]
    assert u.header.ref_lens == [len(r) for r in inputs["refs"]]
    for k in ("tid", "pos", "mtid", "mpos", "flag"):
        assert np.array_equal(getattr(u.batch, k), getattr(want, k)), k
    assert np.array_equal(u.batch.ref_span(), want.ref_span())
    assert np.array_equal(u.batch.seq, want.seq)
    ops = {int(c) & 0xF for c in u.batch.cigar}
    assert {0, 1, 2, 4, 5, 6} <= ops


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["depad"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["depad"])
