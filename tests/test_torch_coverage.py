"""``python -m samtools_tpu_torch coverage`` and ``bedcov`` and their device
path against the JAX package, on the CPU (the plain versions of the
port's kernels):

* ``coverage_window_device`` equals the JAX device function where that
  one is exact (qualities below 128, sums below 2^31) and the port's
  numpy ``window_host`` everywhere;
* the commands print the JAX tool's bytes; on a read stored without
  qualities the port's ``coverage`` equals the JAX host branch and not
  the JAX device branch (which caps a base's quality at 127), and the
  port's coverage reduction sums a deep window exactly where the JAX one
  wraps at 2^31;
* ``coverage -m``/``-D`` print the JAX tool's histograms, on both of its
  branches and on the port's host branch;
* on a CRAM they print the JAX tool's bytes; without CUDA they fail
  before any row;
* the streamed window reader, the header's name lookup and the small
  helpers equal their JAX counterparts."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_tool_fixtures import (make_pileup_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.io.stream import BamStream as JBamStream
from samtools_tpu.io.stream import WindowedReader as JWindowedReader
from samtools_tpu.ops import pileup_engine as jpe
from samtools_tpu.tools import coverage_cmd as jcc
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader
from samtools_tpu_torch.io.stream import BamStream, WindowedReader
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.tools import coverage_cmd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_pileup_inputs(str(tmp_path_factory.mktemp("coverage")))


def _parts(paths, wb, we, j=False):
    """(batch, reads overlapping [wb, we)) per file: the port's, or the
    JAX package's batches."""
    out = []
    for p in paths:
        b = (jread(p) if j else read_alignments(p)).batch
        keep = (b.flag.astype(np.int64) & coverage_cmd.DEFAULT_FF) == 0
        out.append((b, np.nonzero(keep & (b.tid == 0) & (b.pos < we)
                                  & (b.end_pos() > wb))[0]))
    return out


# (files, window, min_baseq, min_depth)
WINDOW_CASES = {
    "messy_all": (("messy",), (0, 1 << 17), 0, 1),
    "messy_sub_q20_d3": (("messy",), (30137, 41000), 20, 3),
    "two_files": (("messy", "pairs"), (1000, 90000), 13, 1),
    "deep": (("deep",), (0, 20000), 13, 1),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_coverage_window_device_equals_jax(inputs, case):
    names, (wb, we), mbq, md = WINDOW_CASES[case]
    paths = [inputs[n] for n in names]
    kernels.reset_launches()
    got = pe.coverage_window_device(_parts(paths, wb, we), wb, we, mbq, md,
                                    device="cpu")
    assert kernels.launches == {k: 0 for k in kernels.launches}
    host = coverage_cmd.window_host(_parts(paths, wb, we), wb, we, mbq, md)
    want = jpe.coverage_window_device(_parts(paths, wb, we, j=True), wb, we,
                                      mbq, md)
    assert got.dtype == np.int64 and got[0] > 0
    assert np.array_equal(got, host) and np.array_equal(got, want)


def test_coverage_window_keeps_qualities_above_127(inputs):
    """A read stored without qualities (0xFF each): the port adds 255 per
    base, as the JAX host branch; the JAX device function adds 127."""
    path = inputs["qualless"]
    got = pe.coverage_window_device(_parts([path], 0, 5000), 0, 5000, 0, 1,
                                    device="cpu")
    host = coverage_cmd.window_host(_parts([path], 0, 5000), 0, 5000, 0, 1)
    jdev = jpe.coverage_window_device(_parts([path], 0, 5000, j=True), 0,
                                      5000, 0, 1)
    assert np.array_equal(got, host)
    assert got[:2].tolist() == jdev[:2].tolist()
    assert got[2] - jdev[2] == 100 * (255 - 127)


def test_coverage_reduction_does_not_wrap():
    """1,000x at Q40 over one 65,536-column subwindow: the quality sum is
    2,621,440,000; the JAX reduction sums in int32 and wraps."""
    rows = 1 << 16
    census = torch.zeros(rows, pe.COV_K, dtype=torch.int32)
    census[:, 0] = 1000
    census[:, 1] = 40 * 1000
    census[:, 2] = 1000
    got = pe.cov_reduce(census, rows, 1)
    assert got.dtype == torch.int64
    assert got.tolist() == [[1000 * rows, 40 * 1000 * rows, rows]]
    jcensus = jnp.asarray(census[:, :3].numpy())
    jgot = np.asarray(jpe._cov_reduce_jit()(jcensus, rows, 1))
    assert int(jgot[0, 1]) == -1673527296 != 40 * 1000 * rows
    # quality >> 7 counts 128 each; the gate drops what min_depth fails
    census[:5, 3] = 2
    census[5:9, 0] = 3
    got = pe.cov_reduce(census, 1 << 15, 1000)
    assert got.shape == (2, 3)
    assert int(got[:, 2].sum()) == rows - 4
    assert int(got[0, 1]) == 40000 * ((1 << 15) - 4) + 5 * 256


# ------------------------------------------------------------- the tools
COVERAGE_CASES = {
    "default": ["{messy}"],
    "Q20_q30": ["-Q", "20", "-q", "30", "{messy}"],
    "min_depth": ["--min-depth", "5", "{messy}"],
    "l90": ["-l", "90", "{pairs}"],
    "ff_rf": ["--ff", "UNMAP,DUP", "--rf", "READ1", "{pairs}"],
    "region": ["-r", "sim1:20001-60000", "{messy}"],
    "two_files": ["-H", "{messy}", "{pairs}"],
    "two_contigs": ["{messy2}"],
    "deep": ["-Q", "13", "{deep}"],
}


@pytest.mark.parametrize("case", sorted(COVERAGE_CASES))
def test_coverage_equals_jax_tool(inputs, case):
    args = [a.format(**inputs) for a in COVERAGE_CASES[case]]
    kernels.reset_launches()
    port = run_port_stdout("coverage", args)
    assert kernels.launches == {k: 0 for k in kernels.launches}
    assert port.count(b"\n") >= 1
    assert port == run_jax_tool("coverage", args, "0")
    if case in ("default", "region", "deep"):
        assert port == run_jax_tool("coverage", args, "1")


@pytest.mark.parametrize("args", [[], ["-r", "sim1:1-5000"]])
def test_coverage_qualless_equals_jax_host_branch(inputs, args):
    """The qualities of a read stored without them count whole (255 per
    base), as the JAX host branch counts them; the JAX device branch caps
    them at 127 (ROADMAP, Queue 3)."""
    args = [*args, inputs["qualless"]]
    port = run_port_stdout("coverage", args)
    assert port == run_jax_tool("coverage", args, "0")
    assert port != run_jax_tool("coverage", args, "1")
    assert port == run_port_stdout("coverage", ["-r", "sim1",
                                                inputs["qualless"]])


def test_coverage_streamed_windows_do_not_change_the_table(inputs,
                                                           monkeypatch):
    """16 Kbp stream windows (reads carried across window edges) and 16
    Kbp region windows give the 1 Mi-column table."""
    want = run_port_stdout("coverage", [inputs["messy"], inputs["pairs"]])
    monkeypatch.setattr(coverage_cmd, "STREAM_COLS", 1 << 14)
    assert run_port_stdout("coverage", [inputs["messy"],
                                        inputs["pairs"]]) == want
    region = run_port_stdout("coverage", ["-r", "sim1", inputs["messy"]])
    monkeypatch.setattr(coverage_cmd, "REGION_COLS", 1 << 14)
    assert run_port_stdout("coverage", ["-r", "sim1",
                                        inputs["messy"]]) == region


BEDCOV_CASES = {
    "c": ["-c", "{bed}", "{messy}"],
    "d5": ["-d", "5", "{bed}", "{messy}", "{pairs}"],
    "j": ["-j", "{bed}", "{messy}"],
    "H": ["-H", "{bed}", "{pairs}"],
    "stdin": ["-c", "-d", "3", "-j", "{bed}", "-"],
}


@pytest.mark.parametrize("case", sorted(BEDCOV_CASES))
def test_bedcov_equals_jax_tool(inputs, case):
    args = [a.format(**inputs) for a in BEDCOV_CASES[case]]
    stdin = inputs["messy"] if case == "stdin" else None
    port = run_port_stdout("bedcov", args, stdin=stdin)
    assert port.count(b"\n") == 40 + (case == "H")
    assert port == run_jax_tool("bedcov", args, "0", stdin=stdin)
    if case == "stdin":
        # the JAX in-memory branch on its device path
        assert port == run_jax_tool("bedcov", args, "1", stdin=stdin)


# the histograms (-w sets the width; without it the width comes from
# COLUMNS, which both tools read)
HIST_CASES = {
    "m": ["-m", "{messy}"],
    "D": ["-D", "{messy}"],
    "m_A_w40": ["-m", "-A", "-w", "40", "{messy}"],
    "m_two_files_q": ["-m", "-Q", "20", "-q", "30", "{messy}", "{pairs}"],
    "D_region": ["-D", "-r", "sim1:20001-60000", "{messy}"],
    "m_two_contigs": ["-m", "-w", "70", "{messy2}"],
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_coverage_histogram_equals_jax_tool(inputs, monkeypatch, case):
    monkeypatch.setenv("COLUMNS", "100")
    args = [a.format(**inputs) for a in HIST_CASES[case]]
    kernels.reset_launches()
    port = run_port_stdout("coverage", args)
    assert kernels.launches == {k: 0 for k in kernels.launches}
    assert port.count(b"\n") >= 11
    for engine in ("1", "0"):
        assert port == run_jax_tool("coverage", args, engine), engine
    monkeypatch.setenv("SAMTPU_DEVICE", "host")
    assert run_port_stdout("coverage", args, device=None) == port


# SAM is read (tests/test_torch_sam_input.py), and CRAM now: these cases
# once held the exit of a CRAM input and now hold the port's bytes on it
# to the JAX tool's
@pytest.mark.parametrize("cmd,argv,rows", [
    pytest.param("coverage", ["{cram}"], 2, id="coverage-argv0-SAM"),
    pytest.param("coverage", ["-m", "{cram}"], 11,
                 id="coverage-argv1-SAM"),
    pytest.param("coverage", ["-r", "sim1", "{cram}"], 2,
                 id="coverage-argv2-SAM"),
    pytest.param("bedcov", ["{bed}", "{cram}"], 40,
                 id="bedcov-argv3-SAM"),
])
def test_not_ported_exits_1_with_one_line(inputs, cmd, argv, rows):
    args = [a.format(**inputs) for a in argv]
    port = run_port_stdout(cmd, args)
    assert port.count(b"\n") >= rows
    assert port == run_jax_tool(cmd, args, "0")


@pytest.mark.parametrize("cmd,argv", [
    ("coverage", ["{messy}"]), ("coverage", ["-r", "sim1", "{messy}"]),
    ("bedcov", ["{bed}", "{messy}"])])
def test_without_cuda_fails_before_any_row(inputs, capfd, monkeypatch, cmd,
                                           argv):
    monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capfd.readouterr()
    assert cli.main([cmd, *[a.format(**inputs) for a in argv]]) == 1
    out, err = capfd.readouterr()
    assert out == "" and "CUDA" in err
    monkeypatch.setenv("SAMTPU_DEVICE", "host")
    assert run_port_stdout(cmd, [a.format(**inputs) for a in argv],
                           device=None).count(b"\n") > 1


# ---------------------------------------------------------- host modules
def test_windowed_reader_equals_jax(inputs):
    """16 Kbp windows over two streams: the same windows, and the same
    reads in each."""
    paths = [inputs["messy"], inputs["pairs"]]

    def keep(b):
        return (b.flag.astype(np.int64) & 0x4) == 0
    sts = [BamStream(p) for p in paths]
    jsts = [JBamStream(p) for p in paths]
    try:
        got = list(WindowedReader(sts, window_cols=1 << 14,
                                  filter_fn=keep))
        want = list(JWindowedReader(jsts, window_cols=1 << 14,
                                    filter_fn=keep))
    finally:
        for st in sts + jsts:
            st.close()
    assert len(got) == len(want) == 8
    for (t, wb, we, subs), (jt, jwb, jwe, jsubs) in zip(got, want):
        assert (t, wb, we) == (jt, jwb, jwe)
        for s, js in zip(subs, jsubs):
            assert s.n == js.n > 0
            assert np.array_equal(s.pos, js.pos)
            assert np.array_equal(s.qname, js.qname)


def test_helpers_equal_jax(inputs):
    b = read_alignments(inputs["pairs"]).batch
    assert np.array_equal(coverage_cmd.qlen_query(b),
                          jcc.qlen_query(jread(inputs["pairs"]).batch))
    for n in (0, 999, 1000, 12345, 5e6, 7.5e9, 3e13, 2e16):
        assert coverage_cmd.readable_bps(n) == jcc.readable_bps(n)
    text = ("@SQ\tSN:chr1\tLN:100\tAN:1,one\n@SQ\tSN:chr2\tLN:50\tAN:chr1\n"
            "@SQ\tSN:2\tLN:10\n")
    from samtools_tpu.io.header import SamHeader as JSamHeader
    h, jh = SamHeader.from_text(text), JSamHeader.from_text(text)
    for name in ("chr1", "chr2", "1", "one", "2", "x"):
        assert h.tid(name) == jh.tid(name)
    out = io.StringIO()
    coverage_cmd._tab_line(out, "c", 0, 0, 0, 0, 0, 0, 0, 0)
    assert out.getvalue() == "c\t1\t0\t0\t0\t0\t0\t0\t0\n"
