"""``python -m samtools_tpu_torch import`` against ``python -m samtools_tpu
import``, on the CPU: one parity test over the table of cases, each run
by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BAM and BGZF'd SAM outputs must be the bytes of
the JAX tool's zlib run, and CRAM is compared byte for byte).

Inputs are ``torch_tool_fixtures.make_fastq_inputs``'s FASTQ and FASTA
files, written by the JAX ``fastq``/``fasta`` from ``dup_grouped``
(``-1 -2 -0 -s``, ``-N`` interleaved, BGZF'd, gzip'd, CASAVA with an
index file, every aux field in the comment) and by hand (multi-line
records, UMIs in the names, CRLF line ends, bad records).  No case
launches a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_fastq_inputs, run_port_case)

from samtools_tpu_torch import kernels

PAIR = ["-1", "{fq1}", "-2", "{fq2}"]
# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
IMPORT = {
    "pair": (PAIR, None),
    "pair_long": (["--r1", "{fq1}", "--r2", "{fq2}"], None),
    "pair_positional": (["{fq1}", "{fq2}"], None),
    "single_positional": (["{fq_inter}"], None),
    "single": (["-s", "{fq_inter}"], None),
    "unpaired": (["-0", "{fq0}"], None),
    "read1_only": (["-1", "{fq1}"], None),
    "read2_only": (["-2", "{fq2}"], None),
    "bgzf_input": (["-1", "{fq1_gz}", "-2", "{fq2_gz}"], None),
    "gzip_input": (["-s", "{fq1_gzip}"], None),
    "casava": (["-i", "-1", "{cas1}", "-2", "{cas2}"], None),
    "casava_barcode_tag": (["-i", "--barcode-tag", "XB", "-s", "{cas1}"],
                           None),
    "casava_off": (["-1", "{cas1}", "-2", "{cas2}"], None),
    "index_file": (["--i1", "{cas_i1}", "-1", "{cas1}", "-2", "{cas2}"],
                   None),
    "index_file_both": (["-b", "--i1", "{cas_i1}", "--i2", "{cas_i1}",
                         "--quality-tag", "XQ", "-1", "{cas1}", "-2",
                         "{cas2}", "-i"], None),
    "tags_all": (["-T", "*", "-1", "{tag1}", "-2", "{tag2}"], None),
    "tags_listed": (["-T", "RG", "-1", "{tag1}", "-2", "{tag2}"], None),
    "tags_empty": (["-T", "", "-s", "{tag1}"], None),
    "tags_off": (["-1", "{tag1}", "-2", "{tag2}"], None),
    "multi_line": (["-T", "*", "{multi_fq}"], None),
    "umi": (["-U", "{multi_fq}"], None),
    "umi_tag": (["--UMI", "--UMI-tag", "OX", "-T", "*", "{multi_fq}"],
                None),
    "fasta_input": (["-1", "{fa1}", "-2", "{fa2}"], None),
    "read_group_line": (["-r", "ID:x", "-r", "SM:y", *PAIR], None),
    "read_group_at_line": (["-r", "@RG\tID:x\tSM:y", "-s", "{fq0}"], None),
    "read_group_no_id": (["-r", "SM:y", *PAIR], None),
    "read_group_id": (["-R", "grp1", "--rg", "grp2", *PAIR], None),
    "read_group_both": (["-R", "grp1", "--rg-line", "ID:x", "-s", "{fq0}"],
                        None),
    "order": (["--order", "XO", *PAIR], None),
    "order_padded": (["--order", "XO:6", "-s", "{fq_inter}"], None),
    "name2": (["-N", "-T", "*", "-s", "{tag1}"], None),
    "output_bam": (["-o", "{o}/x.bam", *PAIR], None),
    "output_samgz": (["-o", "{o}/x.sam.gz", "-s", "{fq0}"], None),
    "output_fmt": (["-O", "bam", "-o", "{o}/x.out", "-s", "{fq0}"], None),
    "output_fmt_long": (["--output-fmt", "bam", "-s", "{fq0}"], None),
    "output_cram": (["-o", "{o}/x.cram", *PAIR], None),
    "output_cram_fmt": (["-O", "cram,version=3.0", "-o", "{o}/x.cr", "-s",
                         "{fq0}"], None),
    "uncompressed": (["-u", "-o", "{o}/x.bam", "-s", "{fq0}"], None),
    "no_pg": (["--no-PG", *PAIR], None),
    "threads": (["-@", "2", "-o", "{o}/x.bam", *PAIR], None),
    "stdin": (["-s", "-"], "fq_inter"),
    "differing_records": (["-1", "{fq1}", "-2", "{fq0}"], None),
    "bad_record": (["-s", "{bad_fq}"], None),
    "short_quality": (["-s", "{short_fq}"], None),
    "empty": (["-s", "{empty}"], None),
    "missing": (["-1", "{dir}/none.fq", "-2", "{fq2}"], None),
    "help": (["-h"], None),
    "no_arguments": ([], None),
    "bad_option": (["--no-such", "{fq1}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_fastq_inputs(str(tmp_path_factory.mktemp("import")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("import", inputs, IMPORT)


@pytest.mark.parametrize("case", sorted(IMPORT))
def test_import_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("import", inputs, IMPORT, case), want[case],
               case)
    assert not any(kernels.launches.values())
