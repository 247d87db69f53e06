"""``python -m samtools_tpu_torch flagstat`` and K11 against the JAX
package, on the CPU (K11's plain version):

* the command prints the JAX tool's bytes (default, ``-O json``, ``-O
  tsv``) on the messy reads, on pairs that carry every counted flag
  (QC-fail, duplicate, secondary, supplementary, unmapped mates, mates on
  another contig at high and low mapping quality), on standard input,
  on a BAM streamed in several batches, and with ``SAMTPU_DEVICE=0`` (the
  numpy branch); the JAX tool runs with both of its ``SAMTPU_DEVICE``
  values;
* K11's plain version equals ``flagstat_numpy`` and the JAX
  ``flagstat_numpy`` exactly, and counts nothing on no records;
* under SAMTPU_SHARDS (``all``, malformed) it runs on one device and
  prints the JAX tool's bytes; under SAMTPU_SHARDS=2 with two devices it
  runs its mesh branch and prints them too; without CUDA it fails before
  any output."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (REF_LEN, REPO, make_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu.ops import flagstat as jfs
from samtools_tpu_torch import kernels
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader
from samtools_tpu_torch.ops import flagstat as fs
from samtools_tpu_torch.tools import common

torch.set_num_threads(1)


def flagged_pairs(path_in: str, path_out: str, seed: int = 3) -> None:
    """The pairs fixture under a two-contig header, with every flag that
    flagstat counts set on some reads."""
    b = read_alignments(path_in).batch
    rng = np.random.default_rng(seed)
    n = b.n
    flag = b.flag.astype(np.int64)
    for bit, share in ((0x200, 0.07), (0x400, 0.1), (0x100, 0.05),
                       (0x800, 0.04), (0x8, 0.06), (0x4, 0.03), (0x2, 0.2),
                       (0x1, 0.05)):
        flag ^= np.where(rng.random(n) < share, bit, 0)
    b.flag = flag.astype(np.uint16)
    b.mtid = np.where(rng.random(n) < 0.15, 1, b.mtid).astype(np.int32)
    b.mapq = rng.integers(0, 61, n).astype(np.uint8)
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{REF_LEN}\n"
            "@SQ\tSN:sim2\tLN:5000\n")
    write_bam(path_out, SamHeader.from_text(text), b)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    got = make_inputs(str(tmp_path_factory.mktemp("flagstat")))
    got["flagged"] = os.path.join(got["dir"], "flagged.bam")
    flagged_pairs(got["pairs"], got["flagged"])
    return got


CASES = {
    "messy": ([], "messy", None),
    "flagged": ([], "flagged", None),
    "flagged_json": (["-O", "json"], "flagged", None),
    "flagged_tsv": (["-O", "tsv"], "flagged", None),
    "pairs_json": (["-O", "json"], "pairs", None),
    "stdin": ([], "-", "flagged"),
    "stdin_tsv": (["--output-fmt", "tsv"], "-", "messy"),
    "batches": (["-@", "2"], "flagged", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flagstat_equals_jax_tool(inputs, monkeypatch, case):
    extra, which, stdin = CASES[case]
    if case == "batches":
        monkeypatch.setenv("SAMTPU_STREAM_WINDOW", "65536")
    path = "-" if which == "-" else inputs[which]
    stdin_path = inputs[stdin] if stdin else None
    kernels.reset_launches()
    mine = run_port_stdout("flagstat", [*extra, path], stdin=stdin_path)
    assert kernels.launches["flagstat"] == 0   # a CPU tensor never counts
    assert mine == run_jax_tool("flagstat", [*extra, path], "1",
                                stdin=stdin_path)
    assert mine == run_jax_tool("flagstat", [*extra, path], "0",
                                stdin=stdin_path)
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    assert run_port_stdout("flagstat", [*extra, path],
                           stdin=stdin_path) == mine


def test_flagged_fixture_counts_every_flag(inputs):
    s = fs.flagstat_numpy(read_alignments(inputs["flagged"]).batch)
    for k in ("n_secondary", "n_supp", "n_dup", "n_pdup", "n_sgltn",
              "n_diffchr", "n_diffhigh"):
        assert min(s[k]) > 0, (k, s[k])
    assert s["n_diffhigh"][0] < s["n_diffchr"][0]


def _tensors(b):
    return (torch.from_numpy(b.flag.astype(np.uint16)),
            torch.from_numpy(b.mapq.astype(np.uint8)),
            torch.from_numpy(b.tid.astype(np.int32)),
            torch.from_numpy(b.mtid.astype(np.int32)))


@pytest.mark.parametrize("which", ["messy", "pairs", "flagged"])
def test_plain_k11_equals_numpy_and_jax(inputs, which):
    b = read_alignments(inputs[which]).batch
    got = fs.flagstat_census(*_tensors(b))
    assert got.dtype == torch.int64 and got.shape == (16, 2)
    want = fs.flagstat_numpy(b)
    assert {k: (int(got[i, 0]), int(got[i, 1]))
            for i, k in enumerate(fs.COUNTERS)} == want
    assert fs.flagstat_counts(b, torch.device("cpu")) == want
    assert want == jfs.flagstat_numpy(b)
    assert fs.COUNTERS == jfs.COUNTERS


def test_plain_k11_on_random_flags_equals_numpy():
    """Every flag combination, tid/mtid equal and not, mapq on both sides
    of 5."""
    rng = np.random.default_rng(9)
    n = 50_000

    class B:
        flag = rng.integers(0, 1 << 12, n).astype(np.uint16)
        mapq = rng.integers(0, 10, n).astype(np.uint8)
        tid = rng.integers(-1, 3, n).astype(np.int32)
        mtid = rng.integers(-1, 3, n).astype(np.int32)
    got = fs.flagstat_census(*_tensors(B))
    want = fs.flagstat_numpy(B)
    assert {k: (int(got[i, 0]), int(got[i, 1]))
            for i, k in enumerate(fs.COUNTERS)} == want
    assert want == jfs.flagstat_numpy(B)
    empty = fs.flagstat_census(*(t[:0] for t in _tensors(B)))
    assert empty.shape == (16, 2) and int(empty.abs().sum()) == 0


def test_k11_rejects_wrong_dtype_and_mixed_devices():
    t = (torch.zeros(4, dtype=torch.uint16), torch.zeros(4, dtype=torch.uint8),
         torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        fs.flagstat_census(t[0].to(torch.int32), *t[1:])
    with pytest.raises(ValueError):
        fs.flagstat_census(t[0], t[1][:3], *t[2:])


# (SAMTPU_SHARDS, input).  The SAMTPU_SHARDS cases run now: capped at the
# device count (1 on the CPU), "all" and a malformed value run the
# single-device path; "shards" runs the mesh branch, over 2 CPU shards
# (``mesh_devices`` patched), where the JAX tool meshes over its 2 virtual
# devices.  Each prints the JAX tool's bytes.
NOT_PORTED = {
    "shards": ("2", "flagged"),
    "shards_all": ("all", "flagged"),
    "shards_malformed": ("two", "flagged"),
    # SAM is read (tests/test_torch_sam_input.py), and CRAM now: the
    # port prints the JAX tool's bytes on it
    "sam_input": (None, "cram"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_exits_1_with_one_line(inputs, monkeypatch, case):
    what, which = NOT_PORTED[case]
    if case.startswith("shards"):
        monkeypatch.setenv("SAMTPU_SHARDS", what)
        meshes = []
        if case == "shards":
            monkeypatch.setattr(common, "mesh_devices", lambda dev, n: (
                meshes.append(n) or [torch.device("cpu")] * n))
        # the JAX tool on as many devices as the port's mesh has shards
        monkeypatch.setenv("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=%d"
                           % (2 if case == "shards" else 1))
        mine = run_port_stdout("flagstat", [inputs[which]])
        assert set(meshes) == ({2} if case == "shards" else set())
        for engine in ("1", "0"):
            assert mine == run_jax_tool("flagstat", [inputs[which]], engine)
        return
    mine = run_port_stdout("flagstat", [inputs[which]])
    assert mine.startswith(b"200 + 0 in total")
    assert mine == run_jax_tool("flagstat", [inputs[which]], "1")


def test_flagstat_without_cuda_fails_before_any_output(inputs):
    env = {k: v for k, v in os.environ.items() if k != "SAMTPU_DEVICE"}
    env["PYTHONPATH"] = REPO
    p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                        "flagstat", inputs["messy"]], capture_output=True,
                       env=env, cwd=REPO, timeout=300)
    assert p.returncode != 0
    assert p.stdout == b""
    assert b"CUDA" in p.stderr
