"""``consensus`` on the port against the JAX tool on reads with
insertions of 1-12 bases, some with a deletion after them, and MD tags,
with pads (P; tests/torch_tool_fixtures.py, ``padins``: the window goes to
the scalar engine) and without (``longins``: insertion sub-columns through
the vectorised engine's exact per-site engine); with ``--mark-ins``, ``--use-MQ`` with its NM halo and soft-clip
cost, ``-f pileup``, ``-aa -f fastq``, ``-X hifi``, ``-a -T`` with
``--ref-qual`` and ``--homopoly-fix``.  Bytes equal on both JAX branches
and the port's host branch (``check_consensus_case``)."""

import pytest
import torch
from torch_tool_fixtures import check_consensus_case, make_consensus_inputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_consensus_inputs(str(tmp_path_factory.mktemp("cons_pi")))


CASES = {
    "padins": ([], "padins"),
    "padins_pileup": (["-f", "pileup"], "padins"),
    "padins_fastq_aa": (["-aa", "-f", "fastq", "--show-del", "yes"],
                        "padins"),
    "longins": ([], "longins"),
    "mark_ins": (["--mark-ins", "--show-del", "yes"], "longins"),
    "use_mq": (["--use-MQ", "--NM-halo", "20", "--SC-cost", "40"],
               "longins"),
    "config_hifi": (["-X", "hifi"], "longins"),
    "ref_qual": (["-a", "-T", "{padins_fa}", "--ref-qual", "7",
                  "--homopoly-fix"], "longins"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_equals_jax_tool(inputs, monkeypatch, case):
    check_consensus_case(inputs, *CASES[case], monkeypatch)
