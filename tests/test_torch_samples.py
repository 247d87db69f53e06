"""``python -m samtools_tpu_torch samples`` against ``python -m
samtools_tpu samples``, on the CPU (one parity test over the table of
cases, ``torch_tool_fixtures.check_case``: exit code, standard error,
standard output and every file), and ``FastaIndex.nseq`` of the port's
``io/fasta.py`` against the JAX module's.

Inputs are ``torch_tool_fixtures.make_header_inputs``'s: ``general``
(three read groups with samples s1-s3, two with a library; no index),
``indexed`` and ``bigidx`` (with a ``.bai``), ``norg`` (no @RG), the SAM,
sam.gz and CRAM twins, ``fa`` (sim1 only: the contigs of ``messy``) and
``two_fa`` (sim1 and sim2: those of ``general``), and lists of FASTAs,
of file names and of file and index names.  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_header_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu.io import fasta as jfasta
from samtools_tpu_torch import kernels
from samtools_tpu_torch.io import bgzf, fasta

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "plain": (["{general}"], None),
    "several": (["{general}", "{norg}", "{messy}", "{pairs}"], None),
    "header_row": (["-h", "{general}"], None),
    "index": (["-i", "{general}", "{indexed}", "{bigidx}"], None),
    "index_header_row": (["-h", "-i", "{indexed}"], None),
    "tag_sm": (["-T", "SM", "{general}"], None),
    "tag_lb": (["-T", "LB", "{general}", "{pairs}"], None),
    "tag_id": (["-h", "-T", "ID", "{general}"], None),
    "tag_bad": (["-T", "LIB", "{general}"], None),
    "fasta_match": (["-f", "{two_fa}", "{general}"], None),
    "fasta_no_match": (["-f", "{fa}", "{general}", "{messy}"], None),
    "fasta_two": (["-h", "-f", "{fa}", "-f", "{two_fa}", "{general}",
                   "{messy}", "{norg}"], None),
    "fasta_list": (["-F", "{fa_list}", "-i", "{indexed}", "{messy}"], None),
    "fasta_list_missing": (["-F", "{dir}/none.txt", "{general}"], None),
    "fasta_missing": (["-f", "{dir}/none.fa", "{general}"], None),
    "paired_index_names": (["-X", "-i", "{indexed}", "{general}",
                            "{indexed}.bai", "{dir}/general.bam.bai"],
                           None),
    "paired_index_odd": (["-X", "-i", "{indexed}", "{general}",
                          "{indexed}.bai"], None),
    "paired_index_tabs": (["-X", "-i", "-h"], "idx_pairs"),
    "stdin_names": (["-i"], "names"),
    "stdin_names_fasta": (["-f", "{two_fa}"], "names"),
    "no_rg": (["{norg}"], None),
    "no_rg_tag": (["-T", "LB", "-i", "{norg}"], None),
    "sam_input": (["{general_sam}", "{general_samgz}"], None),
    "cram_input": (["-i", "{general_cram}", "{grouped_cram}"], None),
    "output": (["-o", "{o}/s.tsv", "-h", "{general}"], None),
    "missing": (["{dir}/none.bam", "{general}"], None),
    "bad_option": (["--no-such", "{general}"], None),
    "question": (["-?"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_header_inputs(str(tmp_path_factory.mktemp("samples")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("samples", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_samples_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("samples", inputs, CASES, case), want[case],
               case)
    assert not any(kernels.launches.values())


def test_samples_rows(inputs):
    """The rows name each sample once, with the index column and the
    matching FASTA."""
    got = run_port_case("samples", inputs, {"x": (
        ["-i", "-f", "{fa}", "-f", "{two_fa}", "{general}", "{norg}"],
        None)}, "x")
    g, n, fa2 = inputs["general"], inputs["norg"], inputs["two_fa"]
    assert got[:3] == (0, (f"s1\t{g}\tN\t{fa2}\ns2\t{g}\tN\t{fa2}\n"
                           f"s3\t{g}\tN\t{fa2}\n.\t{n}\tN\t{fa2}\n"
                           ).encode(), "")


def test_samples_reads_only_the_header(inputs, tmp_path):
    """A BAM's record blocks are not inflated: one that does not inflate
    (the last before the EOF block, a byte of its deflate stream flipped)
    leaves the rows as they are on the intact file."""
    with open(inputs["general"], "rb") as f:
        data = bytearray(f.read())
    coffs, _ = bgzf.scan_blocks(bytes(data))
    assert coffs.size > 2
    data[int(coffs[-2]) + 18] ^= 0xFF
    bad = str(tmp_path / "bad.bam")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    cases = {"x": (["-h", "-T", "LB", "{general}"], None),
             "y": (["-h", "-T", "LB", bad], None)}
    good = run_port_case("samples", inputs, cases, "x")
    got = run_port_case("samples", inputs, cases, "y")
    assert got[0] == good[0] == 0 and got[2] == good[2] == ""
    assert got[1] == good[1].replace(inputs["general"].encode(),
                                     bad.encode())


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["samples"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["samples"])


@pytest.mark.parametrize("key", ["fa", "two_fa", "general_sam"])
def test_nseq_equals_jax(inputs, key):
    mine = fasta.load_fasta(inputs[key])
    want = jfasta.load_fasta(inputs[key])
    assert mine.nseq() == want.nseq() == len(want.names())
    assert mine.order == want.names()
