"""``python -m samtools_tpu_torch tview`` against ``python -m samtools_tpu
tview``, on the CPU: the port in-process (K13's plain version) prints the
JAX tool's bytes in its text (``-d T``) and HTML (``-d H``) modes; no
kernel counts a launch on CPU tensors.  The curses mode (``-d C``) runs
in a pseudo-terminal as a subprocess on the host branch.

Inputs are ``torch_tool_fixtures.make_diploid_inputs``'s (reads in two
islands, so a window can hold none; insertions for the ``-i`` switch;
read groups grpA/grpB of samples s1/s2 for ``-s``).  Cases: ``-p`` at a
het-dense window, ``-w``, ``-i``, ``-s`` by sample and by read group,
``COLUMNS`` (and a value under 10, which means 80), an empty window in
text and HTML, no reference, no ``-p``, ``-X`` (the reference as the
third argument), ``--reference``, the second contig of a two-contig
file, a window that crosses an island's end; and the usage and error
exits (no arguments, a bad option, an unknown region, an unknown sample,
a missing input, a FASTA that does not load, ``-d C`` without a
terminal)."""

import os
import sys

import pytest
import torch
from torch_tool_fixtures import (REPO, check_no_card, make_diploid_inputs,
                                 run_jax_cases, run_port_full)

from samtools_tpu_torch import kernels

torch.set_num_threads(1)

# name -> (arguments, COLUMNS); {x} names an input of the fixture
CASES = {
    "text": (["-d", "T", "-p", "sim1:3001", "{dip}", "{dip_fa}"], "80"),
    "html": (["-d", "H", "-p", "sim1:3001", "{dip}", "{dip_fa}"], "80"),
    "width": (["-d", "T", "-w", "150", "-p", "sim1:12500", "{dip}",
               "{dip_fa}"], "80"),
    "hide_inserts": (["-d", "T", "-i", "-w", "200", "-p", "sim1:3001",
                      "{dip}", "{dip_fa}"], "80"),
    "show_inserts": (["-d", "T", "-w", "200", "-p", "sim1:3001", "{dip}",
                      "{dip_fa}"], "80"),
    "sample": (["-d", "T", "-s", "s1", "-p", "sim1:5001", "{dip}",
                "{dip_fa}"], "80"),
    "read_group": (["-d", "H", "-s", "grpB", "-p", "sim1:5001", "{dip}",
                    "{dip_fa}"], "80"),
    "columns": (["-d", "T", "-p", "sim1:1001", "{dip}", "{dip_fa}"], "137"),
    "columns_under_10": (["-d", "T", "-p", "sim1:1001", "{dip}",
                          "{dip_fa}"], "5"),
    "empty_window": (["-d", "T", "-p", "sim1:9001", "{dip}", "{dip_fa}"],
                     "80"),
    "empty_window_html": (["-d", "H", "-p", "sim1:9001", "{dip}"], "80"),
    "no_reference": (["-d", "T", "-p", "sim1:3001", "{dip}"], "80"),
    "no_position": (["-d", "t", "-w", "1100", "{dip}", "{dip_fa}"], "80"),
    "index_argument": (["-d", "T", "-X", "-p", "sim1:1501", "{dip}",
                        "{dip}", "{dip_fa}"], "80"),
    "reference_option": (["-d", "T", "--reference", "{dip_fa}", "-p",
                          "sim1:1501", "{dip}"], "80"),
    "second_contig": (["-d", "T", "-p", "sim2:1000", "{dip2}", "{dip2_fa}"],
                      "80"),
    "island_end_html": (["-d", "H", "-w", "300", "-p", "sim1:6900",
                         "{dip}", "{dip_fa}"], "80"),
}
# name -> arguments of a run that exits 1
ERRORS = {
    "no_arguments": [],
    "bad_option": ["-z", "{dip}"],
    "unknown_region": ["-d", "T", "-p", "chrX:5", "{dip}"],
    "unknown_sample": ["-d", "T", "-s", "zz", "-p", "sim1:3001", "{dip}"],
    "missing_input": ["-d", "T", "{dir}/none.bam"],
    "fasta_does_not_load": ["-d", "T", "{dip}", "{dir}/none.fa"],
    "curses_without_terminal": ["-d", "C", "-p", "sim1:3001", "{dip}"],
}


def _args(inputs, name):
    extra = CASES[name][0] if name in CASES else ERRORS[name]
    return [a.format(**inputs) for a in extra]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_diploid_inputs(str(tmp_path_factory.mktemp("tview")))


@pytest.fixture(scope="module")
def want(inputs):
    return run_jax_cases("tview", {
        k: (_args(inputs, k), {"COLUMNS": CASES[k][1] if k in CASES
                               else "80"})
        for k in (*CASES, *ERRORS)}, workers=3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tview_equals_jax_tool(inputs, want, monkeypatch, case):
    monkeypatch.setenv("COLUMNS", CASES[case][1])
    kernels.reset_launches()
    rc, out, err = run_port_full("tview", _args(inputs, case))
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert (rc, out) == want[case][:2], err
    assert out.count(b"\n") >= 2 or out.startswith(b"<html>")
    if case in ("text", "empty_window"):
        monkeypatch.setenv("SAMTPU_DEVICE", "0")
        assert run_port_full("tview", _args(inputs, case))[:2] == (rc, out)


def test_tview_input_reaches_its_paths(want):
    """The windows show reads on many rows, insertions (hidden by -i),
    the consensus line's calls, and an empty window shows only the ruler
    and the reference."""
    text = want["text"][1].decode().split("\n")
    assert len(text) > 20 and any(c in text[2] for c in "ACGTMRWSYK")
    assert want["hide_inserts"][1] != want["show_inserts"][1]
    empty = want["empty_window"][1].decode().split("\n")
    assert empty[1].strip() and not any(ln.strip() for ln in empty[3:])
    assert want["sample"][1] != want["read_group"][1]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_tview_error_exits(inputs, want, monkeypatch, case):
    monkeypatch.setenv("COLUMNS", "80")
    rc, out, err = run_port_full("tview", _args(inputs, case))
    assert (rc, out, err) == want[case]
    assert rc == 1 and err


def test_tview_no_card(inputs, monkeypatch):
    check_no_card("tview", ["-d", "T", "-p", "sim1:3001", inputs["dip"]],
                  monkeypatch)


def test_tview_curses_interactive(inputs):
    """The curses display in a pty on the host branch: draw at a region,
    open help, go to another region, quit."""
    import pty
    import select
    import time

    argv = [sys.executable, "-m", "samtools_tpu_torch", "tview", "-d", "C",
            "-p", "sim1:3001", inputs["dip"], inputs["dip_fa"]]
    env = dict(os.environ, TERM="xterm", SAMTPU_DEVICE="0", PYTHONPATH=REPO)
    pid, fd = pty.fork()
    if pid == 0:
        os.execve(sys.executable, argv, env)
    out = b""

    def drain(t):
        nonlocal out
        end = time.time() + t
        while time.time() < end:
            r, _, _ = select.select([fd], [], [], 0.2)
            if r:
                try:
                    d = os.read(fd, 65536)
                except OSError:
                    return
                if not d:
                    return
                out += d

    drain(20)
    for k in [b"l", b"?", b" ", b"g", b"sim1:12300\r"]:
        os.write(fd, k)
        drain(1)
    os.write(fd, b"q")
    drain(5)
    _, status = os.waitpid(pid, 0)
    text = out.decode("latin-1", "replace")
    assert "-=-    Help    -=-" in text
    assert "Goto:" in text
    assert "12301" in text          # the ruler after going to sim1:12300
    assert os.waitstatus_to_exitcode(status) == 0
