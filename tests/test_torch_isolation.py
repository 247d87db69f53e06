"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points do not fall back to the CPU, and a CPU tensor never counts
as a kernel launch."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from samtools_tpu_torch import kernels
from samtools_tpu_torch.device import resolve
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.ops.consensus_vec import consensus_segsum
from samtools_tpu_torch.ops.flagstat import flagstat_census
from samtools_tpu_torch.ops.pileup import stable_order
from samtools_tpu_torch.ops.pileup_device import (pileup_counts,
                                                  pileup_counts_tiled)
from samtools_tpu_torch.ops.segment_kernel import (segment_census,
                                                   segment_contract)
from samtools_tpu_torch.ops.stats_kernels import split_hists, stats_hists

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "samtools_tpu_torch"


def _forbidden(mod: str) -> bool:
    # the port's own name starts with "samtools_tpu": match whole names
    return mod == "jax" or mod.startswith("jax.") or mod == "jaxlib" \
        or mod.startswith("jaxlib.") or mod == "samtools_tpu" \
        or mod.startswith("samtools_tpu.")


def _sources():
    # and what runs on the card's machine, which has no JAX
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_core_profile.py",
        ROOT / "scripts" / "torch_dryrun_dist.py",
        ROOT / "scripts" / "torch_apply_depth_kernels.py",
        ROOT / "tests" / "test_torch_cuda.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path}: imports {name}"


_PROBE = """
import sys, tempfile, os
import numpy as np
from samtools_tpu_torch import sim
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.stream import BamStream
from samtools_tpu_torch.ops.mpileup_device import DeviceCensusPipeline
L = 4096
ref = sim.simulate_reference(L, seed=1)
lut = np.full(256, 4, np.uint8)
lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
b = sim.simulate_batch(ref_len=L, coverage=2.0, read_len=100, seed=1,
                       paired=False, ref=ref)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "p.bam")
    write_bam(path, sim.make_header(L), b)
    pipe = DeviceCensusPipeline(lut[ref], L, device="cpu", chunk_reads=64)
    with BamStream(path) as st:
        for batch in st.batches():
            pipe.add_batch(batch)
    census, qsum = pipe.finish()
    pipe.finish_checksum()
assert census.sum() > 0
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib")
             or m.startswith(("jax.", "jaxlib.")) or m == "samtools_tpu"
             or m.startswith("samtools_tpu."))
print("FORBIDDEN", bad)
"""


def test_port_runs_without_jax_modules():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = np.zeros(1000, np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        md.DeviceCensusPipeline(ref, 1000)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve()
    assert md.DeviceCensusPipeline(ref, 1000, device="cpu").device.type \
        == "cpu"


def test_cpu_tensors_never_count_a_launch():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    B, LQ, LRM = 8, 20, 28
    t = torch.from_numpy
    bq, good, risky = bd.baq_hmm(
        t(rng.integers(0, 4, (B, LRM)).astype(np.uint8)),
        t(rng.integers(0, 4, (B, LQ)).astype(np.uint8)),
        t(rng.integers(2, 40, (B, LQ)).astype(np.uint8)),
        torch.zeros(LQ, B, dtype=torch.int32),
        torch.full((B,), LQ + 3, dtype=torch.int32),
        torch.full((B,), 0.999 / (LQ + 3)), torch.full((B,), 0.001 /
                                                       (LQ + 3)),
        LQ, LRM, 7)
    seg = torch.zeros(B, LQ, dtype=torch.int32)
    bd.baq_finalize(bq, good, t(rng.integers(2, 40, (B, LQ))
                                .astype(np.uint8)), seg)
    out = torch.zeros(256, 6, dtype=torch.int32)
    segment_contract(torch.zeros(10, dtype=torch.int32),
                     torch.ones(10, 6, dtype=torch.int8),
                     torch.tensor([0, 10], dtype=torch.int32),
                     torch.tensor([10, 10], dtype=torch.int32), 0, 128, out)
    assert int(out[0, 0]) == 10
    segment_census(torch.zeros(2, 5, dtype=torch.int32),
                   torch.zeros(2, 5, dtype=torch.int32),
                   torch.zeros(2, 5, dtype=torch.uint8),
                   torch.full((2, 5), 20, dtype=torch.uint8),
                   torch.zeros(2, dtype=torch.bool), 0, 0, 256, 13,
                   torch.tensor([0, 10], dtype=torch.int32),
                   torch.tensor([10, 10], dtype=torch.int32), 0, 128, out)
    assert int(out[0, 0]) == 20 and int(out[0, 5]) == 210
    buf = rng.integers(0, 16, (B, 4 + 2 * LQ)).astype(np.uint8)
    buf[:, :4] = 0
    buf[:, 4 + LQ:] = rng.integers(2, 40, (B, LQ))
    appq, _ = bd.baq_apply(t(rng.integers(0, 4, 64).astype(np.uint8)),
                           t(buf))
    assert appq.shape == (B, LQ)
    stable_order(torch.tensor([3, 1, 3, 0], dtype=torch.int32))
    S, _, depth = consensus_segsum(
        torch.ones(6 * 101 * 101, 16, dtype=torch.float64),
        torch.tensor([[0, 1, 1, 1], [2, 3, 4, 1]], dtype=torch.uint8),
        torch.tensor([0, 2]))
    assert int(depth[0]) == 2 and float(S[0, 0]) == 2.0
    got = flagstat_census(torch.tensor([0, 512], dtype=torch.uint16),
                          torch.zeros(2, dtype=torch.uint8),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert got[0].tolist() == [1, 1]
    u8 = torch.tensor([2, 4, 8], dtype=torch.uint8)
    hists = stats_hists(u8, u8, torch.tensor([0, 3]), torch.tensor([0]),
                        torch.tensor([1], dtype=torch.uint8),
                        torch.tensor([0], dtype=torch.uint8), 3, 4, 3)
    assert int(split_hists(hists, 1, 3, 4)["gc"][0]) == 2
    buf, cdt, _ = md.census_narrow(torch.ones(8, 6, dtype=torch.int32), 4)
    assert cdt == torch.uint8 and buf.numel() == 28
    ok = torch.ones(3, dtype=torch.bool)
    i3 = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert int(pileup_counts(i3, i3, ok, 4).sum()) == 3
    assert int(pileup_counts_tiled(i3[None], i3[None], ok[None], 4, 1)
               .sum()) == 3
    census = torch.ones(8, 6, dtype=torch.int32)
    assert md.census_checksum_dev(census, 4) == md.census_checksum(
        np.ones((4, 5), np.int64), np.ones(4, np.int64))
    cb = torch.zeros(2, md.HDR + 2 * 8, dtype=torch.uint8)
    x = md.chunk_expand(cb, torch.zeros(16, dtype=torch.uint8),
                        torch.from_numpy(md.NT16_TO4), 8)
    assert x["seg"].shape == (2, 8)
    q = torch.zeros(2, 16, dtype=torch.uint8)
    assert int(md.qual_deltas(q + 1, q, 2)[0]) == 32
    win, sq, _ = bd.apply_expand(t(np.arange(64, dtype=np.uint8) % 5),
                                 torch.zeros(B, 4 + 2 * LQ,
                                             dtype=torch.uint8))
    assert win.shape == (B, LQ + bd.APPLY_PAD) and sq.shape == (B, LQ)
    col = torch.ones(20, 1, dtype=torch.int32)
    assert pe.depth_scan(col, None, 10).tolist() == list(range(1, 11))
    assert pe.cov_reduce(torch.ones(8, 4, dtype=torch.int32), 4,
                         1).tolist() == [[4, 516, 4], [4, 516, 4]]
    assert kernels.launches == {"segment_contract": 0, "segment_census": 0,
                                "baq_hmm": 0, "baq_finalize": 0,
                                "baq_apply": 0, "stable_order": 0,
                                "consensus_segsum": 0, "flagstat": 0,
                                "stats_hists": 0, "census_narrow": 0,
                                "pileup_scatter": 0, "pileup_tiled": 0,
                                "census_checksum": 0, "chunk_expand": 0,
                                "qual_deltas": 0, "apply_expand": 0,
                                "depth_scan": 0, "cov_reduce": 0}


def test_mixed_devices_raise():
    cpu = torch.zeros(3)
    with pytest.raises(ValueError):
        kernels.on_card(cpu, torch.zeros(3, device="meta"))


def test_chip_smoke_alone_fails(tmp_path):
    """Without a card, or without the rest of the checkout, the smoke
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
