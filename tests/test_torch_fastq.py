"""``python -m samtools_tpu_torch fastq``/``fasta`` against ``python -m
samtools_tpu fastq``/``fasta``, on the CPU: one parity test over each
table of cases, each run by the port in-process with the JAX tool's
argument list (``torch_tool_fixtures.check_case``: exit code, standard
error, standard output and every file; a ``.gz`` output is BGZF and must
be the bytes of the JAX tool's zlib run).

Inputs are ``torch_tool_fixtures.make_fastq_inputs``'s: ``dup_grouped``
(name-grouped pairs with BC tags in two read groups, supplementary
records, QC-failed and single-end reads, unmapped mates), ``dup`` (the
same coordinate-sorted, for the warning), ``general`` (three read
groups, reads without one, reads without qualities, aux fields of every
type) and ``tagged`` (OQ, RX, OX, XN, and BC tags with a '-' and a QT).
No case launches a kernel.  Beside the tables: an output in a missing
directory fails as in the JAX tool (an exception, not a message), and
``help <cmd>`` prints each new command's usage as the JAX tool does.
"""

import os

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_fastq_inputs, run_jax_full,
                                 run_port_case, run_port_full)

from samtools_tpu_torch import cli, kernels

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
SPLIT = ["-1", "{o}/r1.fq", "-2", "{o}/r2.fq", "-0", "{o}/r0.fq", "-s",
         "{o}/s.fq"]
FASTQ = {
    "plain": (["{dup_grouped}"], None),
    "coordinate_sorted": (["{dup}"], None),
    "split_files": ([*SPLIT, "-N", "-T", "RG", "{dup_grouped}"], None),
    "split_singletons": ([*SPLIT, "-f", "0x40", "{dup_grouped}"], None),
    "interleaved_same_path": (["-1", "{o}/x.fq", "-2", "{o}/x.fq",
                               "{dup_grouped}"], None),
    "output_both": (["-o", "{o}/x.fq", "-0", "{o}/r0.fq",
                     "{dup_grouped}"], None),
    "output_both_suffix": (["-N", "-o", "{o}/x.fq", "{dup_grouped}"], None),
    "gz_outputs": (["-1", "{o}/r1.fq.gz", "-2", "{o}/r2.fq.gz", "-0",
                    "{o}/r0.fq.bgz", "{dup_grouped}"], None),
    "gz_level": (["-c", "9", "-1", "{o}/r1.fq.gz", "-2", "{o}/r2.fq.bgzf",
                  "-s", "{o}/s.fq.gz", "{dup_grouped}"], None),
    "no_suffix": (["-n", "{dup_grouped}"], None),
    "copy_tags": (["-t", "{dup_grouped}"], None),
    "tags_listed": (["-T", "BC,RG,SA", "{dup_grouped}"], None),
    "tags_all": (["-T", "*", "{general}"], None),
    "tags_empty": (["-T", "", "{tagged}"], None),
    "casava": (["-i", "--index-format", "i8", "{dup_grouped}"], None),
    "casava_files": (["-i", "--index-format", "i4i4", "-1", "{o}/r1.fq",
                      "-2", "{o}/r2.fq", "-t", "{tagged}"], None),
    "casava_barcode_tag": (["-i", "--index-format", "n2i*",
                            "--barcode-tag", "RX", "--quality-tag", "OQ",
                            "{tagged}"], None),
    "casava_no_format": (["-i", "{dup_grouped}"], None),
    "index_files": (["--i1", "{o}/i1.fq", "--i2", "{o}/i2.fq",
                     "--index-format", "i4i4", "-1", "{o}/r1.fq", "-2",
                     "{o}/r2.fq", "{tagged}"], None),
    "index_one_file": (["--i1", "{o}/i1.fq", "--index-format", "i*",
                        "{tagged}"], None),
    "index_skip": (["--I1", "{o}/i1.fq", "--I2", "{o}/i2.fq", "--IF",
                    "n2i2i*", "-v", "20", "{tagged}"], None),
    "index_bad_code": (["--i1", "{o}/i1.fq", "--if", "i2x2", "{tagged}"],
                       None),
    "index_two_without_one": (["--i2", "{o}/i2.fq", "--index-format", "i*",
                               "{tagged}"], None),
    "index_file_without_format": (["--i1", "{o}/i1.fq", "{tagged}"],
                                  None),
    "index_three": (["--index-format", "i1i1i1", "{tagged}"], None),
    "no_softclips": (["--no-sc", "-N", "{dup_grouped}"], None),
    "no_softclips_no_backup": (["--no-sc", "--no-sc-bkp", "{dup_grouped}"],
                               None),
    "softclip_tag": (["--no-sc", "--sc-aux", "XS", "-T", "XS",
                      "{dup_grouped}"], None),
    "softclip_tag_bad": (["--sc-aux", "X", "{dup_grouped}"], None),
    "require_flags": (["-f", "0x80", "{dup_grouped}"], None),
    "exclude_flags": (["-F", "0x200", "{dup_grouped}"], None),
    "exclude_none": (["-F", "0", "-T", "SA", "{dup_grouped}"], None),
    "all_off": (["-G", "0x41", "{dup_grouped}"], None),
    "any_on": (["--rf", "0x10", "--incl-flags", "0x200", "{dup_grouped}"],
               None),
    "tag_value": (["-d", "RG:grpA", "{dup_grouped}"], None),
    "tag_any_value": (["-d", "XN", "{tagged}"], None),
    "tag_int_value": (["-d", "XN:3", "--tag", "XN:-5", "{tagged}"], None),
    "tag_file": (["-D", "RG:{rgfile}", "{general}"], None),
    "tag_bad": (["-d", "RGX", "{dup_grouped}"], None),
    "tag_other_tag": (["-d", "RG:grpA", "-d", "BC:x", "{dup_grouped}"],
                      None),
    "tag_file_bad": (["-D", "RG", "{dup_grouped}"], None),
    "tag_file_missing": (["-D", "RG:{dir}/none.txt", "{dup_grouped}"],
                         None),
    "original_quals": (["-O", "{tagged}"], None),
    "umi": (["-U", "{tagged}"], None),
    "umi_tag": (["--UMI", "--UMI-tag", "OX", "-i", "--index-format", "i*",
                 "{tagged}"], None),
    "default_qual": (["-v", "30", "{general}"], None),
    "default_qual_bad": (["-v", "94", "{general}"], None),
    "threads": (["-@", "2", "{dup_grouped}"], None),
    "sam_input": (["{dup_sam}"], None),
    "cram_input": (["{grouped_cram}"], None),
    "stdin": (["-N", "-"], "dup_grouped"),
    "too_many": (["{dup}", "{dup_grouped}"], None),
    "missing": (["{dir}/none.bam"], None),
    "bad_option": (["--no-such", "{dup_grouped}"], None),
}

FASTA = {
    "plain": (["{dup_grouped}"], None),
    "split_files": ([*SPLIT, "{dup_grouped}"], None),
    "casava": (["-i", "--index-format", "i4i4", "--i1", "{o}/i1.fa",
                "{tagged}"], None),
    "tags": (["-T", "RG,XN", "-N", "{tagged}"], None),
    "no_softclips": (["--no-sc", "{dup_grouped}"], None),
    "gz_output": (["-o", "{o}/x.fa.gz", "{dup_grouped}"], None),
    "no_qualities": (["{general}"], None),
    "missing": (["{dir}/none.bam"], None),
}

TABLES = {"fastq": FASTQ, "fasta": FASTA}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_fastq_inputs(str(tmp_path_factory.mktemp("fastq")))


@pytest.fixture(scope="module")
def want(inputs):
    return {cmd: jax_case_runs(cmd, inputs, cases)
            for cmd, cases in TABLES.items()}


@pytest.mark.parametrize("cmd,case", [(cmd, case) for cmd in TABLES
                                      for case in sorted(TABLES[cmd])])
def test_fastq_equals_jax_tool(inputs, want, cmd, case):
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, TABLES[cmd], case),
               want[cmd][case], f"{cmd}/{case}")
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("cmd", sorted(TABLES))
def test_unwritable_output_raises_as_in_jax_tool(inputs, cmd):
    """An output file in a missing directory: ``OutFile`` lets the
    FileNotFoundError out in both packages (no samtools message); the JAX
    tool's process dies of it with exit code 1."""
    args = ["-1", os.path.join(inputs["dir"], "no_dir", "r1.fq"),
            inputs["dup_grouped"]]
    with pytest.raises(FileNotFoundError):
        cli.main([cmd, *args])
    rc, out, err = run_jax_full(cmd, args)
    assert (rc, out) == (1, b"")
    assert err.rstrip().splitlines()[-1].startswith("FileNotFoundError")


@pytest.mark.parametrize("cmd", ["faidx", "fqidx", "dict", "fastq", "fasta",
                                 "import", "split", "reset"])
def test_help_equals_jax_tool(cmd):
    """``help <cmd>`` runs the command with ``--help``: each prints the
    JAX tool's usage, with its exit code."""
    assert run_port_full("help", [cmd]) == run_jax_full("help", [cmd])
