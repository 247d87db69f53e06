"""The port's sharded runs against the JAX tool, on the CPU:

* ``mpileup -f`` under SAMTPU_SHARDS=2 and 3 (two and three span workers,
  ``python -m samtools_tpu_torch`` processes on the CPU) on a seeded
  2.5 Mi contig at low depth (3,145 messy reads, so each worker is mostly
  its start), indexed and not: the bytes of the port's serial run and of
  the JAX tool under the same variable.  The JAX tool runs on the
  unindexed copy: its workers' ``-r`` query fails on a BAM of more than a
  few BGZF blocks (ROADMAP Queue 3), and it then exits 1;
* ``consensus`` and ``consensus -a -f fastq`` under SAMTPU_SHARDS=3,
  indexed (three workers) and not (the workers exit 3 and the run is
  serial): the JAX tool's bytes and the port's serial run's;
* a span worker's raw ``#SPANMETA`` output equals the JAX worker's on the
  first span (the JAX worker fails on the others by the same defect);
* a worker that fails for another reason (here: no CUDA for the device
  its parent handed it) makes the parent exit 1 and print that worker's
  standard error, with no output and no serial run;
* the ``depth`` (``-a``, ``-a -q 13 -J``) and ``flagstat`` (default,
  ``-O json``, ``-O tsv``) mesh branches, run in-process with
  ``tools/common.mesh_devices`` giving 8 CPU shards: the JAX tool's bytes
  under SAMTPU_SHARDS=8 on its 8 virtual devices.

The JAX runs start together in a module fixture, three at a time, while
the port runs; the port's workers inherit OMP_NUM_THREADS=1.
"""

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (REPO, run_port, run_port_full,
                                 run_port_stdout, write_fasta)

from samtools_tpu_torch import sim
from samtools_tpu_torch.core import flags as F
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.tools import common, consensus_cmd, depth_cmd
from samtools_tpu_torch.tools import flagstat_cmd, mpileup_cmd
from samtools_tpu_torch.tools.index_cmd import main_index

torch.set_num_threads(1)

CONTIG = 5 << 19     # 2.5 Mi: three spans under SAMTPU_SHARDS=3, two at 2
SPAN0 = "0:0:1048576"

# name -> (command, arguments, environment); {key} names an input
JAX_RUNS = {
    "mpileup_2": ("mpileup", ["-f", "{fa}", "{unindexed}"],
                  {"SAMTPU_SHARDS": "2"}),
    "mpileup_3": ("mpileup", ["-f", "{fa}", "{unindexed}"],
                  {"SAMTPU_SHARDS": "3"}),
    "consensus_indexed": ("consensus", ["{indexed}"],
                          {"SAMTPU_SHARDS": "3"}),
    "consensus_unindexed": ("consensus", ["{unindexed}"],
                            {"SAMTPU_SHARDS": "3"}),
    "fastq_indexed": ("consensus", ["-a", "-f", "fastq", "{indexed}"],
                      {"SAMTPU_SHARDS": "3"}),
    "fastq_unindexed": ("consensus", ["-a", "-f", "fastq", "{unindexed}"],
                        {"SAMTPU_SHARDS": "3"}),
    "span0": ("consensus", ["-o", "{dir}/jax_span0.raw", "{indexed}"],
              {"SAMTPU_CONSENSUS_SPAN": SPAN0}),
    "depth_a": ("depth", ["-a", "{small}"],
                {"SAMTPU_SHARDS": "8", "SAMTPU_DEVICE": "1"}),
    "depth_aqJ": ("depth", ["-a", "-q", "13", "-J", "{small}"],
                  {"SAMTPU_SHARDS": "8", "SAMTPU_DEVICE": "1"}),
    "flagstat": ("flagstat", ["{flagged}"],
                 {"SAMTPU_SHARDS": "8", "SAMTPU_DEVICE": "1"}),
    "flagstat_json": ("flagstat", ["-O", "json", "{flagged}"],
                      {"SAMTPU_SHARDS": "8", "SAMTPU_DEVICE": "1"}),
    "flagstat_tsv": ("flagstat", ["-O", "tsv", "{flagged}"],
                     {"SAMTPU_SHARDS": "8", "SAMTPU_DEVICE": "1"}),
}


def _jax_stdout(cmd: str, args: list[str], env: dict) -> bytes:
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                SAMTPU_DEVICE="0", OMP_NUM_THREADS="1")
    full.update(env)
    p = subprocess.run([sys.executable, "-m", "samtools_tpu", cmd, *args],
                       capture_output=True, env=full, cwd=REPO,
                       stdin=subprocess.DEVNULL, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    return p.stdout


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    ref = sim.simulate_reference(CONTIG, seed=31)
    got = {"dir": d, "fa": os.path.join(d, "ref.fa")}
    write_fasta(got["fa"], ref)
    b = sim.simulate_messy(sim.simulate_batch(
        ref_len=CONTIG, coverage=0.12, read_len=100, seed=32, paired=False,
        ref=ref), 32)
    got["unindexed"] = os.path.join(d, "unindexed.bam")
    write_bam(got["unindexed"], sim.make_header(CONTIG), b)
    got["indexed"] = os.path.join(d, "indexed.bam")
    shutil.copy(got["unindexed"], got["indexed"])
    assert main_index([got["indexed"]]) == 0
    # depth's and flagstat's: 64 kbp of messy reads at 6x, a few
    # duplicates; pairs with every flag bit drawn at random
    L = 1 << 16
    small = sim.simulate_messy(sim.simulate_batch(
        ref_len=L, coverage=6.0, read_len=100, seed=33, paired=False), 33)
    rng = np.random.default_rng(33)
    small.flag[rng.random(small.n) < 0.05] |= F.FDUP
    got["small"] = os.path.join(d, "small.bam")
    write_bam(got["small"], sim.make_header(L), small)
    pairs = sim.simulate_overlapping_pairs(L, coverage=6.0, seed=34)
    pairs.flag = rng.integers(0, 1 << 12, pairs.n).astype(np.uint16)
    pairs.mapq = rng.integers(0, 60, pairs.n).astype(np.uint8)
    pairs.mtid = rng.integers(-1, 1, pairs.n).astype(np.int32)
    got["flagged"] = os.path.join(d, "flagged.bam")
    write_bam(got["flagged"], sim.make_header(L), pairs)
    pool = ThreadPoolExecutor(3)
    got["jax"] = {k: pool.submit(_jax_stdout, cmd,
                                 [a.format(**got) for a in args], env)
                  for k, (cmd, args, env) in JAX_RUNS.items()}
    yield got
    pool.shutdown(wait=True, cancel_futures=True)


@pytest.fixture
def workers_env(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("SAMTPU_SHARDS", raising=False)
    monkeypatch.delenv("SAMTPU_CONSENSUS_SPAN", raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def serial(inputs):
    """The port's serial runs: mpileup's, consensus's default and
    fastq."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SAMTPU_SHARDS", raising=False)
        return {
            "mpileup": run_port(["-f", inputs["fa"], inputs["indexed"]],
                                os.path.join(inputs["dir"], "serial.txt")),
            "consensus": run_port_stdout("consensus", [inputs["indexed"]]),
            "fastq": run_port_stdout("consensus", ["-a", "-f", "fastq",
                                                   inputs["indexed"]]),
        }


@pytest.mark.parametrize("shards", ["2", "3"])
@pytest.mark.parametrize("which", ["indexed", "unindexed"])
def test_mpileup_span_workers_print_serial_and_jax_bytes(
        inputs, serial, workers_env, shards, which):
    workers_env.setenv("SAMTPU_SHARDS", shards)
    out = os.path.join(inputs["dir"], f"mpileup_{shards}_{which}.txt")
    got = run_port(["-f", inputs["fa"], inputs[which]], out)
    assert got.count(b"\n") > 250000
    assert got == serial["mpileup"]
    assert got == inputs["jax"][f"mpileup_{shards}"].result()


@pytest.mark.parametrize("which", ["indexed", "unindexed"])
@pytest.mark.parametrize("fmt", ["consensus", "fastq"])
def test_consensus_span_workers_print_jax_bytes(inputs, serial, workers_env,
                                                fmt, which):
    """Indexed: three span workers stitched; unindexed: every worker
    exits 3 and the run is serial."""
    workers_env.setenv("SAMTPU_SHARDS", "3")
    args = ([] if fmt == "consensus" else ["-a", "-f", "fastq"]) \
        + [inputs[which]]
    calls = []
    real = common.run_span_workers

    def spy(*a, **k):
        calls.append(got := real(*a, **k))
        return got
    workers_env.setattr(consensus_cmd, "run_span_workers", spy)
    got = run_port_stdout("consensus", args)
    assert [rc for rc, _ in calls[0]] == ([0] * 3 if which == "indexed"
                                          else [3] * 3)
    assert got == serial[fmt]
    assert got == inputs["jax"][f"{fmt}_{which}"].result()


def test_span_worker_raw_output_equals_jax(inputs, workers_env):
    workers_env.setenv("SAMTPU_CONSENSUS_SPAN", SPAN0)
    out = os.path.join(inputs["dir"], "port_span0.raw")
    rc, stdout, _ = run_port_full("consensus", ["-o", out,
                                                inputs["indexed"]])
    assert (rc, stdout) == (0, b"")
    inputs["jax"]["span0"].result()
    with open(out, "rb") as f, open(os.path.join(
            inputs["dir"], "jax_span0.raw"), "rb") as g:
        mine = f.read()
        assert mine == g.read()
    assert mine.startswith(b"#SPANMETA ") and mine.count(b"\n") == 3
    # no index: the worker's exit code 3
    rc, _, _ = run_port_full("consensus", ["-o", out, inputs["unindexed"]])
    assert rc == consensus_cmd.NO_INDEX == 3


@pytest.mark.parametrize("cmd", ["mpileup", "consensus"])
def test_failed_worker_exits_1_with_its_stderr(inputs, workers_env, cmd):
    """A worker handed the CUDA card where there is none fails (exit 1,
    its CUDA line): the parent exits 1 with no output and copies the
    workers' standard error, where the JAX tool hides it (and its
    consensus runs serially)."""
    workers_env.setenv("SAMTPU_SHARDS", "3")

    def to_card(dev, **extra):
        env = common.worker_env(dev, **extra)
        env[common.WORKER_DEVICE] = "cuda"
        return env
    mod = mpileup_cmd if cmd == "mpileup" else consensus_cmd
    workers_env.setattr(mod, "worker_env", to_card)
    args = (["-f", inputs["fa"]] if cmd == "mpileup" else []) \
        + [inputs["indexed"]]
    rc, out, err = run_port_full(cmd, args)
    assert (rc, out) == (1, b"")
    said = [ln for ln in err.splitlines() if "CUDA is not available" in ln]
    assert len(said) == 3, err
    assert all(ln.startswith(f"[{cmd}] ") for ln in said)


def test_worker_env_hands_over_the_device(monkeypatch):
    monkeypatch.setenv(common.WORKER_DEVICE, "stale")
    env = common.worker_env(torch.device("cpu"), SAMTPU_X="1")
    assert env[common.WORKER_DEVICE] == "cpu" and env["SAMTPU_X"] == "1"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert common.WORKER_DEVICE not in common.worker_env(None)
    assert common.worker_device("cpu") == "cpu"
    assert common.worker_device(None) == "stale"
    monkeypatch.delenv(common.WORKER_DEVICE)
    assert common.worker_device(None) is None


@pytest.fixture
def cpu8(monkeypatch):
    """SAMTPU_SHARDS=8 with the tools' mesh over 8 CPU shards, and a count
    of the mesh branch's calls."""
    monkeypatch.setenv("SAMTPU_SHARDS", "8")
    monkeypatch.setattr(common, "mesh_devices",
                        lambda dev, n: [torch.device("cpu")] * min(n, 8))
    calls = []
    for mod, name in ((depth_cmd, "depth_window_sharded"),
                      (flagstat_cmd, "flagstat_counts_sharded")):
        real = getattr(mod, name)

        def spy(mesh, *a, _real=real):
            calls.append(mesh.size)
            return _real(mesh, *a)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("case,args", [
    ("depth_a", ["-a"]), ("depth_aqJ", ["-a", "-q", "13", "-J"])])
def test_depth_mesh_branch_prints_jax_bytes(inputs, cpu8, case, args):
    got = run_port_stdout("depth", [*args, inputs["small"]])
    assert got.count(b"\n") == 1 << 16
    assert cpu8 and set(cpu8) == {8}
    assert got == inputs["jax"][case].result()


@pytest.mark.parametrize("case,args", [
    ("flagstat", []), ("flagstat_json", ["-O", "json"]),
    ("flagstat_tsv", ["-O", "tsv"])])
def test_flagstat_mesh_branch_prints_jax_bytes(inputs, cpu8, case, args):
    got = run_port_stdout("flagstat", [*args, inputs["flagged"]])
    assert cpu8 and set(cpu8) == {8}
    assert got == inputs["jax"][case].result()
