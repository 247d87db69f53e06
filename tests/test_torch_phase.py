"""``python -m samtools_tpu_torch phase`` against ``python -m samtools_tpu
phase``, on the CPU: the port in-process (K13's plain version) prints the
JAX tool's bytes, and so does its host branch (``SAMTPU_DEVICE=0``, on
``HOST_CASES``); no
kernel counts a launch on CPU tensors.  With ``-b`` the three BAMs
(``.0``, ``.1``, ``.chimera``) hold the JAX tool's records and header
text: the port's BGZF is ``zlib``'s, so the files are compared decoded.

Inputs are ``torch_tool_fixtures.make_diploid_inputs``'s: het SNPs every
~1 kbp (single-marker phase sets), every ~50 bp in [2000, 3000) and ~8
bp in [3000, 3600) (blocks that run the dynamic program), chimeric reads
there (masked regions, flipped fragments),
mapq 0 reads, indels and skips; a two-contig file whose second contig's
reads come first (phase walks contigs in order of first appearance).
Cases: the defaults, ``-A``, ``-F``, ``-e``, ``-k 7``, ``-q 20``, ``-D
30``, ``-Q``/``--min-BQ``/``--min-bq``, ``-l`` (ignored), ``-b`` with
and without ``--no-PG`` and with ``--output-fmt sam`` (BAM bytes under a
``.sam`` name); and the usage and error exits."""

import os

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (check_no_card, make_diploid_inputs,
                                 run_jax_cases, run_port_full)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.io.files import read_alignments

torch.set_num_threads(1)

# name -> (arguments, input); {x} names an input of the fixture, {pre} the
# case's -b prefix
CASES = {
    "default": ([], "dip"),
    "drop_ambiguous": (["-A"], "dip"),
    "no_chimera_fix": (["-F"], "dip"),
    "list_excluded": (["-e"], "dip"),
    "block_7": (["-k", "7"], "dip"),
    "min_lod_20": (["-q", "20"], "dip"),
    "max_depth_30": (["-D", "30"], "dip"),
    "min_bq": (["-Q", "25"], "dip"),
    "min_bq_long": (["--min-BQ", "5", "--min-bq", "30"], "dip"),
    "site_list_ignored": (["-l", "{dir}/none.txt"], "dip"),
    "two_contigs": ([], "dip2"),
    "bams": (["-b", "{pre}"], "dip"),
    "bams_no_pg": (["-b", "{pre}", "--no-PG", "-A"], "dip"),
    "bams_sam_name": (["--output-fmt", "sam", "-b", "{pre}"], "dip2"),
}
# name -> arguments of a run that exits 1
ERRORS = {
    "no_arguments": [],
    "bad_option": ["-z", "{dip}"],
    "missing_input": ["{dir}/none.bam"],
}
# the cases also run on the port's host branch (SAMTPU_DEVICE=0)
HOST_CASES = ("default", "two_contigs", "bams")
COLUMNS = ("tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen", "qname",
           "qname_off", "cigar", "cigar_off", "seq", "seq_off", "qual",
           "aux", "aux_off")


def _args(inputs, name):
    if name in ERRORS:
        return [a.format(**inputs) for a in ERRORS[name]]
    extra, which = CASES[name]
    pre = os.path.join(inputs["dir"], name, "ph")
    return [a.format(pre=pre, **inputs) for a in extra] + [inputs[which]]


def _take_bams(inputs, name) -> dict:
    """The decoded BAMs a -b case wrote (header text, @SQ list, every
    column), removed after reading."""
    d = os.path.join(inputs["dir"], name)
    got = {}
    for fn in sorted(os.listdir(d)):
        f = read_alignments(os.path.join(d, fn))
        got[fn] = (f.header.text, f.header.ref_names, f.header.ref_lens,
                   f.batch.n, {c: getattr(f.batch, c).tobytes()
                               for c in COLUMNS})
        os.remove(os.path.join(d, fn))
    return got


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    got = make_diploid_inputs(str(tmp_path_factory.mktemp("phase")))
    for name in CASES:
        os.makedirs(os.path.join(got["dir"], name))
    return got


@pytest.fixture(scope="module")
def want(inputs):
    got = run_jax_cases("phase", {k: (_args(inputs, k), None)
                                  for k in (*CASES, *ERRORS)})
    return {k: (*v, _take_bams(inputs, k) if k in CASES else {})
            for k, v in got.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_equals_jax_tool(inputs, want, monkeypatch, case):
    kernels.reset_launches()
    rc, out, err = run_port_full("phase", _args(inputs, case))
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert (rc, out) == want[case][:2], err
    assert out.count(b"\nPS\t") > 5
    bams = _take_bams(inputs, case)
    assert bams == want[case][3]
    assert len(bams) == (3 if case.startswith("bams") else 0)
    if case not in HOST_CASES:
        return
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    assert run_port_full("phase", _args(inputs, case))[:2] == (rc, out)
    assert _take_bams(inputs, case) == bams


def test_phase_input_has_blocks_and_masks(want):
    """The fixture reaches phase's block paths: multi-marker blocks (M1),
    masked markers (M2) and regions (FL), evidence reads (EV), flipped
    fragments (YF:i:1), singletons (M0), and -b routes reads to all three
    files."""
    out = want["default"][1]
    for kind in (b"\nM0\t", b"\nM1\t", b"\nM2\t", b"\nFL\t", b"\nEV\t",
                 b"\tYF:i:1\t"):
        assert out.count(kind) > 2, kind
    bams = want["bams"][3]
    assert sorted(bams) == ["ph.0.bam", "ph.1.bam", "ph.chimera.bam"]
    assert all(v[3] > 0 for v in bams.values())
    assert "@PG\tID:samtools" in bams["ph.0.bam"][0]
    assert "@PG" not in want["bams_no_pg"][3]["ph.0.bam"][0]
    assert sorted(want["bams_sam_name"][3]) == [
        "ph.0.sam", "ph.1.sam", "ph.chimera.sam"]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_phase_error_exits(inputs, want, case):
    rc, out, err = run_port_full("phase", _args(inputs, case))
    assert (rc, out, err) == want[case][:3]
    assert rc == 1 and err


def test_phase_no_card(inputs, monkeypatch):
    check_no_card("phase", [inputs["dip"]], monkeypatch)


def test_phase_zp_tags(want):
    """Phased reads in -b's .0/.1 files carry ZP:A:Y; the chimera file's
    reads do not."""
    for fn, (_t, _n, _l, n, cols) in want["bams"][3].items():
        aux = np.frombuffer(cols["aux"], np.uint8).tobytes()
        assert (aux.count(b"ZPAY") > 0) == (fn != "ph.chimera.bam"), fn
