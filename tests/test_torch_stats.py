"""``python -m samtools_tpu_torch stats`` against ``python -m samtools_tpu
stats``, on the CPU: the port prints the JAX tool's bytes (its default
host branch) through K12's plain version, its host branch
(``SAMTPU_DEVICE=0``, the host library's histogram pass) and its
per-record path (``SAMTPU_STATS_SCALAR=1``).

Inputs: single-end messy reads, overlapping pairs with read groups
(both fragments, so the last-fragment matrices fill), reads without
qualities (0xFF), reads of 30-500 bases that grow the histograms past
300 cycles mid-file, an unsorted file, and a BAM streamed in several
windows and chunks.  Once against the JAX device branch
(``SAMTPU_STATS_DEVICE=1``).  The options are in
tests/test_torch_stats_options.py, K12, K7n and the host library's
passes in tests/test_torch_stats_parts.py."""

import os
import subprocess
import sys

import pytest
import torch
from torch_tool_fixtures import (REPO, check_stats_case, make_stats_inputs,
                                 run_jax_tool, run_port_stdout)

from samtools_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_stats_inputs(str(tmp_path_factory.mktemp("stats")))


@pytest.mark.parametrize("which", ["messy", "pairs", "qualless", "realloc",
                                   "unsorted"])
def test_stats_equals_jax_tool(inputs, monkeypatch, which):
    check_stats_case(inputs, [], which, monkeypatch)


def test_realloc_grows_the_cycles(inputs, monkeypatch):
    """The realloc fixture's reads cross nbases = 300 mid-file: the
    first-fragment quality matrix runs past cycle 300."""
    out = check_stats_case(inputs, ["-c", "1,100,1"], "realloc",
                           monkeypatch, scalar=False).decode()
    ffq = [ln for ln in out.splitlines() if ln.startswith("FFQ\t")]
    assert max(int(ln.split("\t")[1]) for ln in ffq) > 300


def test_stats_in_several_windows_and_chunks(inputs, monkeypatch):
    """A stream window of 64 KiB and chunks of 1,000 records: K12 runs
    many times, and the histograms and the round buffer carry across."""
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", "65536")
    from samtools_tpu_torch.tools import stats_batch
    monkeypatch.setattr(stats_batch, "CHUNK_RECORDS", 1000)
    check_stats_case(inputs, ["-r", "{fa}"], "messy", monkeypatch,
                     scalar=False)


def test_stats_equals_jax_device_branch(inputs):
    """The JAX device branch (``SAMTPU_STATS_DEVICE=1``, its jitted
    scatter-adds on the JAX CPU backend) prints the same bytes as the
    port's K12 path."""
    args = [inputs["pairs"]]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SAMTPU_STATS_DEVICE="1")
    p = subprocess.run([sys.executable, "-m", "samtools_tpu", "stats",
                        *args], capture_output=True, env=env, cwd=REPO,
                       timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert run_port_stdout("stats", args) == p.stdout
    assert p.stdout == run_jax_tool("stats", args, "0")


def test_sam_input_exits_1_with_one_line(inputs, monkeypatch):
    """SAM is read (tests/test_torch_sam_input.py), and CRAM now: stats
    on the CRAM fixture prints the JAX tool's bytes on each of the port's
    paths (this case held the exit of a CRAM input before)."""
    check_stats_case(inputs, [], "cram", monkeypatch)


def test_stats_without_cuda_fails_before_any_output(inputs):
    env = {k: v for k, v in os.environ.items() if k != "SAMTPU_DEVICE"}
    env["PYTHONPATH"] = REPO
    p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                        "stats", inputs["messy"]], capture_output=True,
                       env=env, cwd=REPO, timeout=300)
    assert p.returncode == 1
    assert p.stdout == b""
    assert b"CUDA" in p.stderr
