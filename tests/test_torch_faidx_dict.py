"""``python -m samtools_tpu_torch faidx``/``fqidx``/``dict`` against the
same commands of ``python -m samtools_tpu``, on the CPU, and the port's
``io/fasta.py`` against ``samtools_tpu/io/fasta.py`` directly.

The commands: one parity test over each table of cases, each run by the
port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file).  ``faidx`` and ``fqidx`` write a ``.fai`` beside
their input, so each of their runs starts from fresh copies of the
inputs in the case's directory (``_copy_inputs``), and the ``.fai`` it
writes is one of the files compared.

Inputs are ``torch_tool_fixtures.make_fastq_inputs``'s: ``multi_fa``
(``FASTA_CONTIGS``: mixed line widths, lower case, descriptions, a colon
in a name, CRLF line ends, an empty contig, no last line end), its BGZF
and gzip copies, FASTQ from the JAX ``fastq`` (``fq0``, ``cas_i1``) and
the hand-made multi-line ``multi_fq``.  No case launches a kernel.
"""

import os
import shutil

import numpy as np
import pytest
from torch_tool_fixtures import (FASTA_CONTIGS, check_case, jax_case_runs,
                                 make_fastq_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu.io import fasta as jfasta
from samtools_tpu_torch import kernels
from samtools_tpu_torch.io import fasta

# the inputs faidx and fqidx read, copied into each case's directory
COPIED = {"multi_fa": "multi.fa", "multi_fa_gz": "multi.fa.gz",
          "multi_fa_gzip": "multi.fa.gzip", "multi_fq": "multi.fq",
          "fq0": "fq0.fq", "regions": "regions.txt"}

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory (which holds the COPIED inputs), {{
# and }} stand for braces
FAIDX = {
    "index_only": (["{o}/multi.fa"], None),
    "whole_contigs": (["{o}/multi.fa", "chr1", "chr2", "HLA:01", "MT"],
                      None),
    "ranges": (["{o}/multi.fa", "chr1:5-80", "chr2:1-1", "chr3:100-200",
                "chrM:1,000-1,050", "chr1:-20", "chr1:200-", "chr3:7"],
               None),
    "colon_names": (["{o}/multi.fa", "HLA:01:3-20", "{{HLA:01}}:1-4",
                     "{{HLA:01}}", "HLA:01:"], None),
    "past_the_end": (["{o}/multi.fa", "MT:190-999", "chr2:500-600"],
                     None),
    "zero_length": (["{o}/multi.fa", "empty", "empty:1-5"], None),
    "crlf_contig": (["{o}/multi.fa", "chrM", "chrM:55-70"], None),
    "missing_region": (["{o}/multi.fa", "chr1:1-5", "nope:1-5", "chr2"],
                       None),
    "bad_number": (["{o}/multi.fa", "chr1:a-b", "chr2"], None),
    "continue": (["-c", "{o}/multi.fa", "nope", "chr1:1-5"], None),
    "line_length": (["-n", "7", "{o}/multi.fa", "chr1:1-50", "chr2"],
                    None),
    "line_length_zero": (["--length", "0", "{o}/multi.fa", "chr1"], None),
    "reverse_complement": (["-i", "{o}/multi.fa", "HLA:01", "chr2:3-40"],
                           None),
    "mark_strand_no": (["-i", "--mark-strand", "no", "{o}/multi.fa",
                        "chr1:1-9"], None),
    "mark_strand_sign": (["--mark-strand", "sign", "{o}/multi.fa",
                          "chr1:1-9"], None),
    "mark_strand_sign_rc": (["-i", "--mark-strand", "sign", "{o}/multi.fa",
                             "chr1:1-9"], None),
    "mark_strand_custom": (["-i", "--mark-strand", "custom,<+>,<->",
                            "{o}/multi.fa", "chr1:1-9"], None),
    "mark_strand_custom_short": (["--mark-strand", "custom,P",
                                  "{o}/multi.fa", "chr1:1-9"], None),
    "mark_strand_rc": (["--mark-strand", "rc", "-i", "{o}/multi.fa",
                        "chr1:1-9"], None),
    "mark_strand_bad": (["--mark-strand", "bogus", "{o}/multi.fa"], None),
    "region_file": (["-r", "{o}/regions.txt", "{o}/multi.fa"], None),
    "region_file_and_args": (["--region-file", "{o}/regions.txt",
                              "{o}/multi.fa", "chr1:1-3"], None),
    "output": (["-o", "{o}/out.fa", "{o}/multi.fa", "chr2"], None),
    "fai_idx": (["--fai-idx", "{o}/other.fai", "{o}/multi.fa", "chr3"],
                None),
    "fai_idx_unwritable": (["--fai-idx", "{dir}/no_dir/x.fai",
                            "{o}/multi.fa"], None),
    "gzi_idx": (["--gzi-idx", "{o}/x.gzi", "{o}/multi.fa", "chr3:1-5"],
                None),
    "bgzf_input": (["{o}/multi.fa.gz", "chr2:10-30", "HLA:01"], None),
    "gzip_input": (["{o}/multi.fa.gzip", "MT:1-10"], None),
    "fastq_flag": (["-f", "{o}/multi.fq", "r1:ACGT+TTGA", "r3:acgt+GGCC"],
                   None),
    "fastq_as_fasta": (["{o}/fq0.fq"], None),
    "missing": (["{dir}/none.fa"], None),
    "help": (["-h"], None),
    "no_arguments": ([], None),
    "bad_option": (["--no-such", "{o}/multi.fa"], None),
}

FQIDX = {
    "index_only": (["{o}/fq0.fq"], None),
    "multi_line": (["{o}/multi.fq", "r1:ACGT+TTGA", "r3:acgt+GGCC:2-5",
                    "r4/1"], None),
    "reverse": (["-i", "-n", "5", "{o}/multi.fq", "r1:ACGT+TTGA"], None),
    "region_file": (["-r", "{o}/regions.txt", "-c", "{o}/multi.fq"], None),
    "missing_read": (["{o}/multi.fq", "nope"], None),
    "help": (["--help"], None),
}

DICT = {
    "plain": (["{multi_fa}"], None),
    "options": (["-a", "GRCh38", "-s", "human", "-u", "http://x/y.fa",
                 "{multi_fa}"], None),
    "no_header": (["-H", "{multi_fa}"], None),
    "alias": (["-A", "{multi_fa}"], None),
    "alias_long": (["--alternative-name", "--alias", "{multi_fa}"], None),
    "alt": (["-l", "{alt}", "{multi_fa}"], None),
    "alt_missing": (["--alt", "{dir}/none.txt", "{multi_fa}"], None),
    "output": (["-o", "{o}/x.dict", "{multi_fa}"], None),
    "bgzf_input": (["{multi_fa_gz}"], None),
    "gzip_input": (["{multi_fa_gzip}"], None),
    "fastq_input": (["{multi_fq}"], None),
    "stdin": (["-"], "multi_fa"),
    "stdin_implied": ([], "multi_fa"),
    "empty_stdin": ([], "empty"),
    "missing": (["{dir}/none.fa"], None),
    "bad_option": (["--no-such", "{multi_fa}"], None),
}

TABLES = {"faidx": FAIDX, "fqidx": FQIDX, "dict": DICT}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_fastq_inputs(str(tmp_path_factory.mktemp("faidx")))


def _copy_inputs(inputs):
    def prepare(odir):
        for key, name in COPIED.items():
            shutil.copy(inputs[key], os.path.join(odir, name))
    return prepare


@pytest.fixture(scope="module")
def want(inputs):
    return {cmd: jax_case_runs(cmd, inputs, cases, _copy_inputs(inputs))
            for cmd, cases in TABLES.items()}


@pytest.mark.parametrize("cmd,case", [(cmd, case) for cmd in TABLES
                                      for case in sorted(TABLES[cmd])])
def test_faidx_dict_equal_jax_tool(inputs, want, cmd, case):
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, TABLES[cmd], case,
                             _copy_inputs(inputs)),
               want[cmd][case], f"{cmd}/{case}")
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("length,region,warns", [
    (4611686018427387905, "c1", False), (30, "c1:1-20", True)])
def test_truncation_warning_follows_the_jax_tool(tmp_path, length, region,
                                                 warns):
    """A ``.fai`` that claims more bases than the file holds: at 2^62
    bases or more the JAX tool prints what there is without a warning,
    below that both warn "Truncated sequence"."""
    fa = tmp_path / "a.fa"
    fa.write_text(">c1\nACGTACGTAC\nGGTT\n")
    (tmp_path / "a.fa.fai").write_text(f"c1\t{length}\t4\t10\t11\n")
    got = run_port_case("faidx", {"dir": str(tmp_path)},
                        {"run": ([str(fa), region], None)}, "run")
    want = run_jax_full("faidx", [str(fa), region])
    assert got[:3] == want and got[3] == {}
    assert got[0] == 0 and b"ACGTACGTAC" in got[1]
    assert got[2] == (f"[faidx] Truncated sequence: {region}\n" if warns
                      else "")


# the port's io/fasta.py against the JAX module
INDEXED = ("multi_fa", "multi_fa_gz", "multi_fa_gzip", "multi_fq", "fq0",
           "cas_i1")


def _records(idx):
    return [tuple(vars(idx.records[n]).values()) for n in idx.order]


@pytest.mark.parametrize("key", INDEXED)
@pytest.mark.parametrize("fastq", [False, True])
def test_build_fai_and_fai_text_equal_jax(inputs, key, fastq):
    """The port's one build equals the JAX module's with either
    ``fastq``, which there changes nothing either."""
    mine = fasta.build_fai(inputs[key])
    want = jfasta.build_fai(inputs[key], fastq=fastq)
    assert _records(mine) == _records(want) and mine.order == want.order
    assert mine.order == want.names() and len(mine.order) == want.nseq()
    for text_fastq in (False, True):
        assert fasta.fai_text(mine, text_fastq) == \
            jfasta.fai_text(want, text_fastq)
    parsed = fasta.parse_fai(fasta.fai_text(mine), inputs[key])
    assert _records(parsed) == _records(mine)
    for name in mine.order + ["nope"]:
        assert mine.length(name) == want.length(name)
        assert mine.has(name) == want.has(name)


@pytest.mark.parametrize("key", INDEXED)
def test_fetch_and_fetch_qual_equal_jax(inputs, key):
    mine = fasta.build_fai(inputs[key])
    want = jfasta.build_fai(inputs[key])
    rng = np.random.default_rng(20)
    for name in (mine.order[:60] + ["nope"]):
        L = max(mine.length(name), 1)
        spans = [(0, None), (-5, 3), (L - 1, L + 10), (3, 3), (7, 2),
                 (L, None)]
        spans += [tuple(sorted(rng.integers(0, L + 5, 2).tolist()))
                  for _ in range(8)]
        for beg, end in spans:
            assert mine.fetch(name, beg, end) == want.fetch(name, beg, end)
            assert mine.fetch_qual(name, beg, end) == \
                want.fetch_qual(name, beg, end)


def test_fetch_gives_the_contigs(inputs):
    """The hand-made FASTA's sequences come back whole, whatever their
    line widths and line ends."""
    idx = fasta.build_fai(inputs["multi_fa"])
    for hdr, seq, _, _ in FASTA_CONTIGS:
        name = hdr.split()[0]
        assert idx.fetch(name) == seq.encode()
        assert idx.length(name) == len(seq)


def test_load_fasta_equal_jax(inputs, tmp_path):
    """Without a .fai both build in memory and write nothing; with one
    both read it (a .fai naming one contig gives that contig only)."""
    path = str(tmp_path / "ref.fa")
    shutil.copy(inputs["multi_fa"], path)
    got, want = fasta.load_fasta(path), jfasta.load_fasta(path)
    assert _records(got) == _records(want) == \
        _records(jfasta.build_fai(inputs["multi_fa"]))
    assert not os.path.exists(path + ".fai")
    full = jfasta.build_fai(path)
    one = jfasta.FastaIndex(records={"chr2": full.records["chr2"]},
                            order=["chr2"], path=path)
    with open(path + ".fai", "w") as f:
        f.write(jfasta.fai_text(one))
    got, want = fasta.load_fasta(path), jfasta.load_fasta(path)
    assert got.order == want.order == ["chr2"]
    assert _records(got) == _records(want)
    assert got.fetch("chr2", 5, 40) == want.fetch("chr2", 5, 40) == \
        full.fetch("chr2", 5, 40)
