"""``consensus`` on the port against the JAX tool where either runs its
scalar engine (``pileup_loop``), and with regions: ``-m simple`` (with
``-A``, ``-c``, ``--use-qual``), ``-m bayesian_116``, ``-f pileup`` (with
``-aa``, ``--show-del``), ``-r`` on an unindexed BAM (the JAX tool's
scalar fallback; the port reads the file whole and runs its vectorised
engine) and on an indexed one (the JAX tool's vectorised engine through
the index), ``-a -r`` and ``--regions-file``.  Bytes equal on both JAX
branches and the port's host branch (tests/torch_tool_fixtures.py,
``check_consensus_case``)."""

import pytest
import torch
from torch_tool_fixtures import check_consensus_case, make_consensus_inputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_consensus_inputs(str(tmp_path_factory.mktemp("cons_sc")))


CASES = {
    "simple": (["-m", "simple"], "indexed"),
    "simple_ambig": (["-m", "simple", "-A", "-c", "0.6", "--use-qual"],
                     "indexed"),
    "bayesian_116": (["-m", "bayesian_116"], "indexed"),
    "pileup": (["-f", "pileup", "--show-del", "yes"], "indexed"),
    "pileup_aa": (["-f", "pileup", "-aa"], "indexed"),
    "region_unindexed": (["-r", "sim1:17001-20000"], "unindexed"),
    "region_indexed": (["-r", "sim1:17001-20000"], "indexed"),
    "region_all": (["-a", "-r", "sim1:15001-22000", "-f", "fastq"],
                   "unindexed"),
    "regions_file": (["--regions-file", "{cons_bed}"], "small"),
    "regions_file_pileup": (["--regions-file", "{cons_bed}", "-f",
                             "pileup"], "small"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_equals_jax_tool(inputs, monkeypatch, case):
    check_consensus_case(inputs, *CASES[case], monkeypatch)
