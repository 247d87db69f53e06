"""``mpileup --checkpoint`` on the port against the JAX tool, on the CPU:

* the streams' record virtual offsets (``BamStream.next_record_voffset``,
  ``batches(start_voffset=...)``) equal the JAX stream's, batch for batch;
* an uninterrupted run with ``--checkpoint`` prints the JAX tool's bytes
  and saves, window by window, the JAX tool's states (``tid``, ``wb``,
  ``voffs``, ``last_tid``, ``last_pos``, ``out_off``);
* a run cut in the middle (the output truncated to a saved state and a
  half-written line appended) resumes to the uninterrupted bytes, on one
  file (the native writer) and on two (the pileup table);
* without ``-o`` the option is ignored with the JAX tool's message.

Windows of 16 Kbp and stream windows of 64 KiB make eight windows and
several batches per file out of the 128 kbp fixtures."""

import json
import os

import numpy as np
import pytest
import torch
from torch_tool_fixtures import make_inputs

from samtools_tpu import cli as jcli
from samtools_tpu.io.stream import BamStream as JBamStream
from samtools_tpu.tools import mpileup_cmd as jmc
from samtools_tpu_torch import cli
from samtools_tpu_torch.io.stream import BamStream
from samtools_tpu_torch.tools import mpileup_cmd

torch.set_num_threads(1)

STREAM_WINDOW = "65536"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture
def small_windows(monkeypatch):
    monkeypatch.setattr(mpileup_cmd, "WINDOW_COLS", 1 << 14)
    monkeypatch.setattr(jmc, "WINDOW_COLS", 1 << 14)
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", STREAM_WINDOW)


def _args(inputs, case):
    bams = [inputs["messy"]] if case == "one" else [inputs["messy"],
                                                    inputs["pairs"]]
    return ["mpileup", "-f", inputs["fa"], *bams]


def _run(which, argv, monkeypatch, ck=None):
    """Run one tool in-process; the checkpoint states it saved, in order
    (read back at each rename onto ``ck``)."""
    states = []
    orig = os.replace

    def spy(a, b):
        orig(a, b)
        if b == ck:
            with open(ck) as f:
                states.append(json.load(f))
    monkeypatch.setattr(os, "replace", spy)
    try:
        if which == "jax":
            # the JAX host engine: its bytes are its device engine's
            monkeypatch.setenv("SAMTPU_DEVICE", "0")
            assert jcli.main(argv) == 0
        else:
            monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
            assert cli.main(argv, device="cpu") == 0
    finally:
        monkeypatch.setattr(os, "replace", orig)
        monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
    return states


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("which", ["messy", "pairs"])
def test_stream_voffsets_equal_jax(inputs, monkeypatch, which):
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", STREAM_WINDOW)
    path = inputs[which]
    with BamStream(path) as st, JBamStream(path) as jst:
        assert st._hdr_voffset == jst._hdr_voffset
        mine, theirs = [], []
        for b in st.batches():
            mine.append((st.next_record_voffset, b.n, int(b.pos[0])))
        for b in jst.batches():
            theirs.append((jst.next_record_voffset, b.n, int(b.pos[0])))
        assert mine == theirs and len(mine) > 2
        # resuming at each saved offset yields the rest of the file
        total = sum(n for _, n, _ in mine)
        for k, (voff, _, _) in enumerate(mine[:-1]):
            rest = list(st.batches(start_voffset=voff))
            assert sum(b.n for b in rest) == total - sum(
                n for _, n, _ in mine[:k + 1])
            assert int(rest[0].pos[0]) == mine[k + 1][2]


@pytest.mark.parametrize("case", ["one", "two"])
def test_checkpoint_states_and_bytes_equal_jax(inputs, small_windows,
                                               monkeypatch, case):
    d = inputs["dir"]
    argv = _args(inputs, case)
    out, jout = os.path.join(d, f"ck_{case}.txt"), \
        os.path.join(d, f"ck_{case}.jax.txt")
    ck, jck = out + ".ck", jout + ".ck"
    for p in (ck, jck):
        if os.path.exists(p):
            os.remove(p)
    mine = _run("port", [*argv, "-o", out, "--checkpoint", ck], monkeypatch,
                ck)
    theirs = _run("jax", [*argv, "-o", jout, "--checkpoint", jck],
                  monkeypatch, jck)
    assert _read(out) == _read(jout)
    assert len(mine) == len(theirs) >= 6
    keys = ("tid", "wb", "voffs", "last_tid", "last_pos", "out_off")
    assert [{k: s[k] for k in keys} for s in mine] == \
        [{k: s[k] for k in keys} for s in theirs]
    assert mine[-1]["out_off"] == os.path.getsize(out)
    # the offsets move on through the file (a carried read keeps the
    # offset of the earliest batch it came from, so they move seldom)
    assert len({tuple(s["voffs"]) for s in mine}) > 1


@pytest.mark.parametrize("case", ["one", "two"])
def test_checkpoint_resume_equals_uninterrupted(inputs, small_windows,
                                                monkeypatch, case):
    d = inputs["dir"]
    argv = _args(inputs, case)
    full = os.path.join(d, f"full_{case}.txt")
    _run("jax", [*argv, "-o", full], monkeypatch)
    truth = _read(full)
    out = os.path.join(d, f"resume_{case}.txt")
    ck = out + ".ck"
    if os.path.exists(ck):
        os.remove(ck)
    states = _run("port", [*argv, "-o", out, "--checkpoint", ck],
                  monkeypatch, ck)
    assert _read(out) == truth
    mid = states[len(states) // 2]
    assert 0 < mid["out_off"] < len(truth)
    with open(ck, "w") as f:
        json.dump(mid, f)
    with open(out, "r+") as f:
        f.truncate(mid["out_off"])
        f.seek(mid["out_off"])
        f.write("PARTIAL###")   # a run that stopped mid-line
    resumed = _run("port", [*argv, "-o", out, "--checkpoint", ck],
                   monkeypatch, ck)
    assert _read(out) == truth
    # the resumed run saved only the windows after the one it resumed at
    assert [s["wb"] for s in resumed] == [s["wb"] for s in states
                                          if s["wb"] > mid["wb"]]


def test_checkpoint_from_other_inputs_is_ignored(inputs, small_windows,
                                                 monkeypatch):
    """A state saved for other inputs (their sizes differ) is not used:
    the run starts over and prints the whole output."""
    d = inputs["dir"]
    argv = _args(inputs, "one")
    out = os.path.join(d, "other.txt")
    ck = out + ".ck"
    with open(ck, "w") as f:
        json.dump({"sig": [[inputs["messy"], 1]], "tid": 0, "wb": 1 << 15,
                   "voffs": [0], "last_tid": 0, "last_pos": 10,
                   "out_off": 5}, f)
    with open(out, "w") as f:
        f.write("stale")
    _run("port", [*argv, "-o", out, "--checkpoint", ck], monkeypatch, ck)
    jout = os.path.join(d, "other.jax.txt")
    _run("jax", [*argv, "-o", jout], monkeypatch)
    assert _read(out) == _read(jout)


def test_checkpoint_without_output_file_is_ignored(inputs, capfd):
    """--checkpoint without -o: the JAX tool's one-line warning, then the
    ordinary output on standard output."""
    from torch_tool_fixtures import run_jax_tool, run_port_stdout
    args = ["-f", inputs["fa"], "--checkpoint",
            os.path.join(inputs["dir"], "nowhere.ck"), inputs["messy"]]
    capfd.readouterr()
    mine = run_port_stdout("mpileup", args)
    err = capfd.readouterr().err
    assert "[mpileup] --checkpoint requires -o FILE; ignoring" in err
    assert not os.path.exists(os.path.join(inputs["dir"], "nowhere.ck"))
    assert mine == run_jax_tool("mpileup", args, "0")
    assert np.frombuffer(mine, np.uint8).size > 0
