"""The port's nine commands on CRAM input against ``python -m
samtools_tpu``, on the CPU (the plain versions of the port's kernels):

* ``mpileup -f``, ``depth``, ``coverage``, ``bedcov``, ``consensus``,
  ``flagstat``, ``stats`` and ``idxstats`` print the JAX tool's bytes on
  a CRAM 3.0 of messy reads and a CRAM 3.1 of overlapping pairs with two
  read groups (both written by the JAX writer under ``@SQ`` lines with
  M5 tags), with ``REF_PATH`` naming the sequences' MD5 store and without
  it (a mapped read's bases are then ``N``), with ``-r`` (a whole-file
  filter: a CRAM has no BAI/CSI) and, for mpileup and flagstat, through a
  ``file://`` URL;
* ``index`` writes the JAX tool's ``.crai``;
* a truncated CRAM makes each command fail as the JAX tool does: the same
  exception (an uncaught one exits 1 with its traceback), or flagstat's
  exit 1 with the same stderr line; nothing is printed on stdout.
"""

import contextlib
import gzip
import hashlib
import io
import os

import numpy as np
import pytest
from test_mpileup_device_tool import _messy_batch
from torch_tool_fixtures import (REF_LEN, run_jax_tool, run_port_stdout,
                                 write_fasta)

from samtools_tpu.core.batch import ReadBatch as JReadBatch
from samtools_tpu.io.files import write_alignments as jwrite
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu.tools import run_command as jrun_command
from samtools_tpu_torch import cli, kernels, sim


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """``cram30``: the first 1,500 messy reads as CRAM 3.0; ``cram31``:
    600 overlapping pairs, a third of them in read group grpA and the
    rest in grpB, as CRAM 3.1; ``store``: a REF_PATH directory holding
    the sequence under its MD5; ``bed``: 20 intervals; ``trunc``: the
    CRAM 3.0 cut in its second container."""
    d = tmp_path_factory.mktemp("cram_tools")
    ref = sim.simulate_reference(REF_LEN, seed=7)
    fa = str(d / "ref.fa")
    write_fasta(fa, ref)
    md5 = hashlib.md5(ref.tobytes()).hexdigest()
    store = d / "store"
    store.mkdir()
    (store / md5).write_bytes(ref.tobytes())
    sq = f"@SQ\tSN:sim1\tLN:{REF_LEN}\tM5:{md5}\n"
    got = {"dir": str(d), "fa": fa, "store": str(store)}
    messy = _messy_batch(ref, REF_LEN).take(np.arange(1500))
    got["cram30"] = str(d / "messy.cram")
    jwrite(got["cram30"], JSamHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n" + sq), messy, fmt="cram",
        reference=fa)
    pairs = sim.simulate_overlapping_pairs(REF_LEN, coverage=6.0, ref=ref,
                                           seed=5).take(np.arange(600))
    tags = [b"RGZgrpA\0", b"RGZgrpB\0"]
    pick = np.arange(pairs.n) % 3 != 0
    pairs.aux = np.frombuffer(b"".join(tags[int(k)] for k in pick),
                              np.uint8)
    pairs.aux_off = np.concatenate([[0], np.cumsum(
        [len(tags[int(k)]) for k in pick])]).astype(np.int64)
    got["cram31"] = str(d / "pairs.cram")
    jwrite(got["cram31"], JSamHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n" + sq
        + "@RG\tID:grpA\tSM:s1\n@RG\tID:grpB\tSM:s2\n"),
        JReadBatch(**vars(pairs)), fmt="cram", reference=fa,
        fmt_opts={"version": "3.1"})
    rng = np.random.default_rng(21)
    got["bed"] = str(d / "regions.bed")
    with open(got["bed"], "w") as f:
        for s0 in np.sort(rng.integers(0, 30000, 20)):
            f.write(f"sim1\t{s0}\t{s0 + rng.integers(50, 2000)}\n")
    with open(got["cram30"], "rb") as f:
        data = f.read()
    got["trunc"] = str(d / "trunc.cram")
    with open(got["trunc"], "wb") as f:
        f.write(data[:len(data) // 2])
    return got


# (command, arguments, REF_PATH set); {x} names an input, {url:x} its
# file:// URL
CASES = {
    "mpileup": ("mpileup", ["-f", "{fa}", "{cram30}"], True),
    "mpileup_no_ref": ("mpileup", ["-f", "{fa}", "{cram30}"], False),
    "mpileup_region_31": ("mpileup", ["-f", "{fa}", "-r", "sim1:2000-9000",
                                      "{cram31}"], True),
    "mpileup_url": ("mpileup", ["-f", "{fa}", "{url:cram31}"], True),
    "depth": ("depth", ["-a", "{cram30}"], True),
    "depth_region_31": ("depth", ["-r", "sim1:5000-8000", "{cram31}"],
                        False),
    "coverage_31": ("coverage", ["{cram31}"], True),
    "coverage_region": ("coverage", ["-r", "sim1:1-10000", "{cram30}"],
                        True),
    "bedcov": ("bedcov", ["{bed}", "{cram30}"], True),
    "consensus": ("consensus", ["{cram30}"], True),
    "consensus_region_31_no_ref": ("consensus", ["-r", "sim1:1-10000",
                                                 "{cram31}"], False),
    "flagstat_31": ("flagstat", ["{cram31}"], True),
    "flagstat_url": ("flagstat", ["{url:cram30}"], False),
    "stats": ("stats", ["{cram30}"], True),
    "stats_31_no_ref": ("stats", ["{cram31}"], False),
    "idxstats_31": ("idxstats", ["{cram31}"], False),
}


def _arg(a: str, inputs) -> str:
    if a.startswith("{url:"):
        return "file://" + inputs[a[5:-1]]
    return a.format(**inputs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cram_prints_the_jax_tools_bytes(inputs, monkeypatch, case):
    cmd, argv, ref_path = CASES[case]
    monkeypatch.delenv("REF_CACHE", raising=False)
    if ref_path:
        monkeypatch.setenv("REF_PATH", inputs["store"])
    else:
        monkeypatch.delenv("REF_PATH", raising=False)
    args = [_arg(a, inputs) for a in argv]
    kernels.reset_launches()
    mine = run_port_stdout(cmd, args)
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert mine.count(b"\n") >= 2
    assert mine == run_jax_tool(cmd, args, "0")


def test_index_writes_the_jax_tools_crai(inputs, tmp_path):
    crai = {}
    for who in ("jax", "port"):
        path = str(tmp_path / f"{who}.cram")
        with open(inputs["cram31"], "rb") as f, open(path, "wb") as g:
            g.write(f.read())
        if who == "jax":
            run_jax_tool("index", [path], "0")
        else:
            assert cli.main(["index", path]) == 0
        with gzip.open(path + ".crai") as f:
            crai[who] = f.read()
    assert crai["port"] == crai["jax"]
    assert crai["port"].count(b"\n") >= 1


# the truncated CRAM through each command: (command, arguments before it)
TRUNCATED = {
    "mpileup": ["-f", "{fa}"], "depth": ["-a"], "coverage": [],
    "bedcov": ["{bed}"], "consensus": [], "flagstat": [], "stats": [],
    "idxstats": [], "index": [],
}


def _run(fn, capfd):
    """(exit code or None, exception or None, stdout, first stderr line)
    of ``fn()``."""
    capfd.readouterr()
    rc, exc = None, None
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn()
    except Exception as e:      # noqa: BLE001 -- the parity is the point
        exc = e
    err = capfd.readouterr().err.splitlines()
    return rc, exc, buf.getvalue(), err[0] if err else ""


@pytest.mark.parametrize("cmd", sorted(TRUNCATED))
def test_truncated_cram_fails_as_the_jax_tool(inputs, capfd, monkeypatch,
                                              cmd):
    """No path catches the decode error and carries on: the port raises
    the JAX tool's exception, or exits with its code and stderr line."""
    monkeypatch.setenv("SAMTPU_DEVICE", "0")    # the JAX tool's host path
    args = [a.format(**inputs) for a in TRUNCATED[cmd]] + [inputs["trunc"]]
    want = _run(lambda: jrun_command(cmd, list(args)), capfd)
    monkeypatch.delenv("SAMTPU_DEVICE")
    got = _run(lambda: cli.main([cmd, *args], device="cpu"), capfd)
    assert (want[0] is None) == (want[1] is not None)
    assert got[0] == want[0]
    assert type(got[1]) is type(want[1])
    assert str(got[1]) == str(want[1])
    assert got[2] == want[2] == ""
    assert got[3] == want[3]
    if cmd == "flagstat":
        assert got[0] == 1 and "error reading from" in got[3]
    else:
        assert got[1] is not None
