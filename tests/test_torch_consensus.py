"""``python -m samtools_tpu_torch consensus`` against ``python -m
samtools_tpu consensus``, on the CPU, in its vectorised engine: the port
(K13's plain version and K10's, whose f64 column sums add each column's
entries in order, with no risky-column gate) prints the JAX tool's
bytes, on both of the JAX tool's branches (``SAMTPU_DEVICE=1``, its f32
device scorer on the JAX CPU backend; ``=0``, its f64 host scorer), and
with ``SAMTPU_DEVICE=0`` the port's own host branch prints them too.

Cases: the default on single-end and paired reads, the gap5 modes
(``bayesian_r``, ``_p``, ``_m``), ``-f fastq``, ``-a``/``-aa`` over a
header with a contig no read touches, ``--show-ins``/``--show-del``,
``--no-use-MQ``, ``-A``/``-C``/``--het-only``, the flag and quality
filters, ``-o`` and a 16 Kbp window size.  The scalar engine's cases are
in tests/test_torch_consensus_scalar.py, pads and long insertions in
tests/test_torch_consensus_padins.py."""

import os

import pytest
import torch
from torch_tool_fixtures import (check_consensus_case, make_consensus_inputs,
                                 run_jax_tool)

from samtools_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_consensus_inputs(str(tmp_path_factory.mktemp("cons")))


# name -> (arguments, input); {x} names an input of the fixture
CASES = {
    "default": ([], "small"),
    "pairs": ([], "pairs_small"),
    "bayesian_p": (["-m", "bayesian_p"], "small"),
    "bayesian_m": (["-m", "bayesian_m"], "small"),
    "bayesian_r_fastq": (["-m", "bayesian_r", "-f", "fastq", "-l", "50"],
                         "small"),
    "all": (["-a"], "small2"),
    "all_all": (["-aa", "-f", "fastq"], "small2"),
    "no_ins_del": (["--show-ins", "no", "--show-del", "yes"], "small"),
    "no_use_mq": (["--no-use-MQ", "--min-BQ", "20"], "small"),
    "ambig_cutoff": (["-A", "-C", "20", "--het-only", "--min-depth", "3"],
                     "small"),
    "flags": (["--ff", "UNMAP,DUP", "--min-MQ", "10", "-q"],
              "pairs_small"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_equals_jax_tool(inputs, monkeypatch, case):
    check_consensus_case(inputs, *CASES[case], monkeypatch)


def test_consensus_output_file_and_small_windows(inputs, monkeypatch):
    """-o FILE, and the stream cut into 16 Kbp windows (halo reads carried
    over eight window edges): the JAX tool's bytes at its 1 Mbp window."""
    import samtools_tpu_torch.io.stream as stream_mod
    orig = stream_mod.WindowedReader.__init__
    seen = []

    def small(self, streams, window_cols=1 << 20, **kw):
        seen.append(window_cols)
        orig(self, streams, window_cols=1 << 14, **kw)
    monkeypatch.setattr(stream_mod.WindowedReader, "__init__", small)
    out = os.path.join(inputs["dir"], "cons.fa")
    assert cli.main(["consensus", "-o", out, inputs["messy"]],
                    device="cpu") == 0
    assert seen == [1 << 20]
    with open(out, "rb") as f:
        mine = f.read()
    assert mine == run_jax_tool("consensus", [inputs["messy"]], "0")
