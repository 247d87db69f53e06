"""``python -m samtools_tpu_torch targetcut`` against ``python -m
samtools_tpu targetcut``, on the CPU: the port in-process (K13's and K8's
plain versions) prints the JAX tool's bytes, and so does its host branch
(``SAMTPU_DEVICE=0``, on the default and the K8 cases); no kernel counts
a launch on CPU tensors.

Inputs are ``torch_tool_fixtures.make_diploid_inputs``'s: a 24 kbp
diploid contig with two islands of reads (so the segmentation has gaps to
cut), and a two-contig file whose second contig's reads come first.
Cases: the default, ``-f`` (BAQ through ``apply_baq_batch``: K8 on the
uniform all-M group, the host HMM for the rest), ``--reference``,
``-Q 0``/``-Q 45``, ``-i``, ``-0/-1/-2``, a FASTA that lacks the contig
(the JAX tool's BAQ changes nothing there; the port skips it), a FASTA
that does not load, both contigs with and without ``-f``; and the usage
and error exits."""

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (check_no_card, make_diploid_inputs,
                                 run_jax_cases, run_port_full)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.ops import baq_device

torch.set_num_threads(1)

# name -> (arguments, input); {x} names an input of the fixture
CASES = {
    "default": ([], "dip"),
    "reference": (["-f", "{dip_fa}"], "dip"),
    "reference_long_min_bq": (["--reference", "{dip_fa}", "-Q", "20"],
                              "dip"),
    "min_bq_0": (["-Q", "0"], "dip"),
    "min_bq_45": (["-Q", "45", "-f", "{dip_fa}"], "dip"),
    "in_penalty": (["-i", "300"], "dip"),
    "emissions": (["-0", "-2", "-1", "3", "-2", "9"], "dip"),
    "fasta_lacks_contig": (["-f", "{other_fa}"], "dip"),
    "fasta_does_not_load": (["-f", "{dir}/none.fa"], "dip"),
    "two_contigs": ([], "dip2"),
    "two_contigs_reference": (["-f", "{dip2_fa}"], "dip2"),
}
# name -> arguments of a run that exits 1
ERRORS = {
    "no_arguments": [],
    "bad_option": ["-z", "{dip}"],
    "missing_input": ["{dir}/none.bam"],
}
# the cases whose BAQ reaches K8 (a uniform all-M group of >= 2048 reads)
K8_CASES = ("reference", "reference_long_min_bq", "min_bq_45",
            "two_contigs_reference")


def _args(inputs, name):
    if name in CASES:
        extra, which = CASES[name]
        return [a.format(**inputs) for a in extra] + [inputs[which]]
    return [a.format(**inputs) for a in ERRORS[name]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_diploid_inputs(str(tmp_path_factory.mktemp("targetcut")))


@pytest.fixture(scope="module")
def want(inputs):
    return run_jax_cases("targetcut", {k: (_args(inputs, k), None)
                                       for k in (*CASES, *ERRORS)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_targetcut_equals_jax_tool(inputs, want, monkeypatch, case):
    calls = []
    apply = baq_device.baq_apply_nt16

    def spy(*a, **k):
        calls.append(a[1].size)
        return apply(*a, **k)
    monkeypatch.setattr(baq_device, "baq_apply_nt16", spy)
    kernels.reset_launches()
    rc, out, err = run_port_full("targetcut", _args(inputs, case))
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert (rc, out) == want[case][:2], err
    # quals are 2-40, so -Q 45 keeps no base and cuts no region
    assert out.count(b"\n") >= (case != "min_bq_45")
    assert bool(calls) == (case in K8_CASES), calls
    if case == "fasta_does_not_load":
        assert err == want[case][2]
    if case not in ("default", *K8_CASES):
        return
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    n = len(calls)
    assert run_port_full("targetcut", _args(inputs, case))[:2] == (rc, out)
    assert len(calls) == n          # the host branch takes the host HMM


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_targetcut_error_exits(inputs, want, case):
    rc, out, err = run_port_full("targetcut", _args(inputs, case))
    assert (rc, out, err) == want[case]
    assert rc == 1 and err


def test_targetcut_fasta_lacking_contig_changes_nothing(inputs, want):
    """The JAX tool's BAQ on a contig its FASTA lacks changes no quality:
    its bytes equal those of the run without ``-f``."""
    assert want["fasta_lacks_contig"][1] == want["default"][1]
    assert want["reference"][1] != want["default"][1]


def test_targetcut_no_card(inputs, monkeypatch):
    check_no_card("targetcut", ["-f", inputs["dip_fa"], inputs["dip"]],
                  monkeypatch)


def test_targetcut_k8_group_takes_most_reads(inputs):
    """The fixture's all-M reads form one group past DEVICE_GROUP_MIN, so
    K8's path runs, beside reads that take the host HMM."""
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.ops.baq import DEVICE_GROUP_MIN
    b = read_alignments(inputs["dip"]).batch
    all_m = np.diff(b.cigar_off) == 1
    assert all_m.sum() >= DEVICE_GROUP_MIN and (~all_m).sum() > 100
