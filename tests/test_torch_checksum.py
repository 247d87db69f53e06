"""``python -m samtools_tpu_torch checksum`` against ``python -m
samtools_tpu checksum``, on the CPU, and the port's ``ops/checksum.py``
against ``samtools_tpu/ops/checksum.py`` directly.

The command: one parity test over the table of cases, each run by the
port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file).  Inputs are
``torch_tool_fixtures.make_header_inputs``'s: ``ha``/``hb`` (reads in
three read groups and none, aux fields of every type, reads without
qualities, unmapped reads in ``hb``), ``norg`` (no @RG), the SAM and
CRAM twins of ``general``, and reports the JAX tool wrote for ``-m``.
No case launches a kernel.
"""

import numpy as np
import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_header_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu.ops import checksum as jchecksum
from samtools_tpu_torch import kernels
from samtools_tpu_torch.ops import checksum

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "plain": (["{ha}"], None),
    "general": (["{general}"], None),
    "two_files": (["{ha}", "{hb}"], None),
    "all": (["-a", "{hb}"], None),
    "all_long": (["--all", "{general}"], None),
    "bamseqchksum": (["-B", "{ha}"], None),
    "bamseqchksum_long": (["--bamseqchksum", "{general}"], None),
    "tabs": (["-T", "{hb}"], None),
    "tabs_all": (["-T", "-a", "{ha}"], None),
    "no_rev_comp": (["-c", "{ha}"], None),
    "check_pos": (["-P", "{general}"], None),
    "check_cigar": (["-C", "{general}"], None),
    "check_mate": (["-M", "{general}"], None),
    "check_all_three": (["-P", "-C", "-M", "-T", "{hb}"], None),
    "in_order": (["-O", "{ha}"], None),
    "in_order_group": (["-O", "-O", "{ha}"], None),
    "flag_mask": (["-b", "0xfff", "{ha}"], None),
    "flag_mask_names": (["-b", "PAIRED,REVERSE", "{ha}"], None),
    "flag_mask_bad": (["-b", "nope", "{ha}"], None),
    "tags": (["-t", "BC,RG,NM,XZ", "{general}"], None),
    "tags_all": (["-t", "*", "{general}"], None),
    "tags_all_but": (["-t", "*,RG,XB", "{general}"], None),
    "tags_long": (["--tags", "XI,XS", "{ha}"], None),
    "tags_bad_length": (["-t", "BC,ABC", "{ha}"], None),
    "tags_illegal": (["-t", "B{{", "{ha}"], None),
    "require_flags": (["-f", "0x40", "{ha}"], None),
    "require_flags_names": (["-f", "READ2", "{hb}"], None),
    "exclude_flags": (["-F", "0x10", "{hb}"], None),
    "exclude_none": (["-F", "0", "{hb}"], None),
    "exclude_flags_bad": (["-F", "junk", "{hb}"], None),
    "count": (["-N", "100", "{ha}"], None),
    "count_hex": (["-N", "0x20", "-O", "{ha}"], None),
    "verbose": (["-v", "{ha}"], None),
    "verbose_norg": (["-v", "{norg}"], None),
    "show_qc": (["-q", "{hb}"], None),
    "show_qc_verbose": (["-q", "-v", "-T", "{hb}"], None),
    "sanitize": (["-z", "all,cigarx", "{general}"], None),
    "sanitize_bad": (["-z", "nothing", "{general}"], None),
    "norg": (["{norg}"], None),
    "norg_bamseqchksum": (["-B", "{norg}"], None),
    "sam_input": (["{general_sam}"], None),
    "cram_input": (["{general_cram}"], None),
    "cram_input_all": (["-a", "{grouped_cram}"], None),
    "output": (["-o", "{o}/r.chk", "{ha}"], None),
    "output_bad": (["-o", "{dir}/no_dir/r.chk", "{ha}"], None),
    "threads": (["-@", "2", "{ha}"], None),
    "stdin": (["-"], "ha"),
    "stdin_implied": ([], "hb"),
    "merge": (["-m", "{chk_ha}", "{chk_hb}"], None),
    "merge_tabs": (["-m", "-T", "{chk_ha}", "{chk_hb}"], None),
    "merge_bamseqchksum_mixed": (["-m", "{chk_hb_B}", "{chk_ha}"], None),
    "merge_tag_mismatch": (["-m", "{chk_ha}", "{chk_hb_tags}"], None),
    "merge_pos_cigar_mate": (["-m", "-v", "{chk_hb_pcm}", "{chk_hb_pcm}"],
                             None),
    "merge_missing": (["-m", "{chk_ha}", "{dir}/none.chk"], None),
    "merge_not_a_report": (["-m", "{list}"], None),
    "missing": (["{dir}/none.bam"], None),
    "not_alignments": (["{fa}"], None),
    "bad_option": (["--no-such", "{ha}"], None),
    "help": (["--help"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_header_inputs(str(tmp_path_factory.mktemp("checksum")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("checksum", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_checksum_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("checksum", inputs, CASES, case), want[case],
               case)
    assert not any(kernels.launches.values())


def test_report_of_halves_merges_to_the_whole(inputs):
    """The product is order-free: ``-m`` over the reports of ``ha`` and
    ``hb`` gives the rows of ``gsorted``, the file they were cut from."""
    whole = run_port_case("checksum", inputs,
                          {"x": (["{gsorted}"], None)}, "x")
    merged = run_port_case("checksum", inputs,
                           {"x": (["-m", "{chk_ha}", "{chk_hb}"], None)},
                           "x")
    assert whole[0] == merged[0] == 0

    def rows(out):
        return [ln for ln in out.decode().splitlines()
                if ln and not ln.startswith("#")]
    assert len(rows(whole[1])) >= 4
    assert rows(merged[1]) == rows(whole[1])


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["checksum"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["checksum"])


# the port's ops/checksum.py against the JAX module
EDGES = np.array([0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1, 2],
                 np.uint32)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 1 << 32, n,
                                               dtype=np.uint32)])


def _fold(vals) -> int:
    acc = 1
    for v in vals.tolist():
        acc = checksum.gf31_mul(acc, v)
    return acc


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 1001])
def test_map_crc_and_products_equal_jax(n):
    vals = _values(n, n)
    mine, want = checksum.map_crc(vals), jchecksum.map_crc(vals)
    assert mine.dtype == want.dtype and np.array_equal(mine, want)
    # 0 goes to 1; 2^31 - 1 stays (the JAX module's behaviour, kept)
    assert mine.min() >= 1 and mine.max() <= (1 << 31) - 1
    assert checksum.map_crc(EDGES).tolist() == [1, (1 << 31) - 1, 1,
                                                (1 << 31) - 1, 1, 2]
    # a fold of gf31_mul is the JAX module's product tree, in any order
    for k in (0, 1, 2, 3, n, n + 5):
        assert _fold(mine[:k]) == jchecksum.gf31_product(mine[:k])
    assert _fold(mine) == _fold(mine[::-1]) == jchecksum.gf31_product(mine)


@pytest.mark.parametrize("nseg", [1, 3, 8])
def test_merged_parts_equal_jax(nseg):
    """Products of parts (one part empty) merged by gf31_mul, as
    checksum -m merges reports, equal the JAX module's products of the
    parts and of the whole."""
    vals = checksum.map_crc(_values(500, 10 + nseg))
    rng = np.random.default_rng(nseg)
    seg = rng.integers(0, nseg, vals.size)
    seg[seg == nseg - 1] = 0  # the last segment stays empty
    parts = [_fold(vals[seg == i]) for i in range(nseg + 1)]
    want = jchecksum.gf31_segment_product(vals, seg, nseg + 1)
    assert parts == want.tolist() and parts[-1] == 1
    total = 1
    for v in parts:
        total = checksum.gf31_mul(total, v)
    assert total == jchecksum.gf31_product(vals)
