"""``python -m samtools_tpu_torch depth`` and its device path against the
JAX package, on the CPU (the plain versions of the port's kernels):

* ``depth_window_device`` equals the JAX ``depth_window_device`` (its XLA
  path, and the Pallas kernel in interpret mode on a small case) and the
  JAX host ``ops.depth.depth_window``, exactly;
* the command prints the JAX tool's bytes, whichever branch the JAX tool
  takes (``SAMTPU_DEVICE=1`` and ``=0``);
* under SAMTPU_SHARDS (``all``, malformed) it runs on one device and
  prints the JAX tool's bytes, as the JAX tool does on one device; under
  SAMTPU_SHARDS=2 with two devices it runs its mesh branch and prints them
  too; on a CRAM it prints the JAX tool's bytes; without CUDA it fails
  before any row;
* its host modules (regions, whole-file reading, the clips, the row set,
  the row writer) equal their JAX counterparts."""

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (REF_LEN, make_pileup_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu.core.regions import RegionError as JRegionError
from samtools_tpu.core.regions import parse_region as jparse_region
from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.ops import depth as jdepth
from samtools_tpu.ops import pileup_engine as jpe
from samtools_tpu.tools import depth_cmd as jdc
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.core.regions import RegionError, parse_region
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import depth as dops
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.tools import common, depth_cmd
from samtools_tpu_torch.tools.common import device_shards

torch.set_num_threads(1)

COLUMNS = ("tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen", "qname",
           "qname_off", "cigar", "cigar_off", "seq", "seq_off", "qual", "aux",
           "aux_off")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    got = make_pileup_inputs(str(tmp_path_factory.mktemp("depth")))
    got["list"] = got["dir"] + "/bams.txt"
    with open(got["list"], "w") as f:
        f.write(f"{got['messy']}\n{got['pairs']}\n")
    return got


def _both(path):
    """The port's and the JAX package's batch of one BAM, and the reads
    depth selects by default (placed, none of UNMAP/SECONDARY/QCFAIL/DUP)."""
    b, jb = read_alignments(path).batch, jread(path).batch
    keep = (b.tid >= 0) & ((b.flag.astype(np.int64) & depth_cmd.DEFAULT_EXCL)
                           == 0)
    return b, jb, np.nonzero(keep)[0]


# (file, min_qual, count_del, clips, window): "all" spans the reads,
# "sub" cuts them at both edges
WINDOW_CASES = {
    "mq0": ("messy", 0, False, False, "all"),
    "mq13": ("messy", 13, False, False, "all"),
    "mq0_del": ("messy", 0, True, False, "all"),
    "mq20_del": ("messy", 20, True, False, "all"),
    "clips_mq0": ("pairs", 0, False, True, "all"),
    "clips_mq13_del": ("pairs", 13, True, True, "all"),
    "sub_mq0_del": ("messy", 0, True, False, "sub"),
    "sub_mq13_del": ("messy", 13, True, False, "sub"),
    "deep_mq13": ("deep", 13, True, False, "all"),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_depth_window_device_equals_jax(inputs, case):
    which, mq, cdel, use_clips, win = WINDOW_CASES[case]
    b, jb, sel = _both(inputs[which])
    clips = dops.overlap_clips(b, sel) if use_clips else None
    if win == "all":
        wbeg, wend = int(b.pos[sel].min()), int(b.end_pos()[sel].max())
    else:
        # reads cut at both edges, and reads wholly outside the window
        wbeg, wend = 30137, 30137 + 5611
        sel = sel[(b.pos[sel] > wbeg - 3000) & (b.pos[sel] < wend + 3000)]
    kernels.reset_launches()
    got = pe.depth_window_device(b, sel, wbeg, wend, mq, cdel, clips,
                                 device="cpu")
    assert kernels.launches == {k: 0 for k in kernels.launches}
    want = jpe.depth_window_device(jb, sel, wbeg, wend, mq, cdel, clips)
    host = jdepth.depth_window(jb, sel, wbeg, wend, mq, cdel, clips)
    assert got.dtype == np.int32 and got.shape == (wend - wbeg,)
    assert np.array_equal(got, want) and np.array_equal(got, host)
    assert np.array_equal(dops.depth_window(b, sel, wbeg, wend, mq, cdel,
                                            clips), host)
    if which == "deep":
        # the pile's tile slice is wider than the JAX plan's item window
        # (at most 16,384 items): several passes there, one slice here
        plan = pe.depth_items(b, sel, wbeg, wend, mq, cdel, clips)[1][2]
        width = int((plan.hi - plan.lo).max())
        assert -(-width // jpe._bucket(width)) > 1


def test_depth_window_device_equals_jax_pallas_interpret(inputs,
                                                         monkeypatch):
    """The JAX function through its Pallas kernel (interpret mode), on a
    small window."""
    monkeypatch.setenv("SAMTPU_PALLAS", "interpret")
    b, jb, sel = _both(inputs["messy"])
    sel = sel[(b.pos[sel] >= 40000) & (b.pos[sel] < 41500)]
    wbeg, wend = 40050, 41400
    for mq, cdel in ((0, True), (13, False)):
        got = pe.depth_window_device(b, sel, wbeg, wend, mq, cdel,
                                     device="cpu")
        want = jpe.depth_window_device(jb, sel, wbeg, wend, mq, cdel)
        assert np.array_equal(got, want)


def test_window_end_events_when_tiles_fill_the_window(inputs):
    """L a multiple of the tile: the end events at wend fall in no tile
    and are dropped (the plan's rule, in both packages)."""
    b, jb, sel = _both(inputs["messy"])
    wbeg = 20000
    wend = wbeg + 10 * pe.pick_tile(1280)
    assert (wend - wbeg) % pe.pick_tile(wend - wbeg) == 0
    ends = b.end_pos()[sel]
    assert ((b.pos[sel] < wend) & (ends > wend)).any()
    diff, _ = pe.depth_items(b, sel, wbeg, wend, 0, True)
    assert (diff[0] == wend).any()
    for mq in (0, 13):
        got = pe.depth_window_device(b, sel, wbeg, wend, mq, True,
                                     device="cpu")
        assert np.array_equal(got, jpe.depth_window_device(
            jb, sel, wbeg, wend, mq, True))
        assert np.array_equal(got, jdepth.depth_window(jb, sel, wbeg, wend,
                                                       mq, True))


def test_empty_selection_gives_zeros(inputs):
    b, jb, _ = _both(inputs["messy"])
    none = np.empty(0, np.int64)
    got = pe.depth_window_device(b, none, 100, 900, 13, True, device="cpu")
    assert got.dtype == np.int32 and not got.any() and got.size == 800
    assert np.array_equal(got, jpe.depth_window_device(jb, none, 100, 900,
                                                       13, True))


@pytest.mark.parametrize("top,dtype", [(200, "uint8"), (300, "int16"),
                                       (40000, "int32")])
def test_depth_scan_narrows_losslessly(top, dtype, monkeypatch):
    """The copy to the host takes the narrowest type that holds the max
    over the plan's rows (the JAX _fetch_narrow's choice)."""
    rows = 512
    diff = torch.zeros(rows, 1, dtype=torch.int32)
    diff[3, 0], diff[400, 0] = top, -top
    direct = torch.zeros(rows, 1, dtype=torch.int32)
    direct[10, 0] = 7
    seen = []
    real = torch.Tensor.to

    def spy(self, *a, **k):
        seen.append(a[0] if a else k.get("dtype"))
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "to", spy)
    got = pe.depth_scan(diff, direct, 450)
    monkeypatch.undo()
    want = np.zeros(450, np.int64)
    want[3:400] = top
    want[10] += 7
    assert got.dtype == np.int32 and np.array_equal(got, want)
    narrowed = [d for d in seen if d in (torch.uint8, torch.int16)]
    assert narrowed == ([] if dtype == "int32" else [getattr(torch, dtype)])


def test_segment_matmul_refuses_int32_item_overflow(monkeypatch):
    monkeypatch.setattr(pe, "MAX_ITEMS", 9)
    plan = pe.tile_plan(np.array([0]), np.array([5]), np.array([0, 10]), 0,
                        128, 128)
    with pytest.raises(ValueError, match="int32"):
        pe.segment_matmul(np.zeros(10, np.int64), np.ones((10, 1), np.int8),
                          plan, "cpu")


# -------------------------------------------------------------- the tool
# arguments ({name} is an input) and the BAMs the JAX tool reads instead
TOOL_CASES = {
    "default": ["{messy}"],
    "a": ["-a", "{messy2}"],
    "aa": ["-aa", "{messy2}"],
    "q13_Q10_J": ["-q", "13", "-Q", "10", "-J", "{messy}"],
    "s_pairs": ["-s", "{pairs}"],
    "region_bai": ["-r", "sim1:20001-60000", "{indexed}"],
    "region_no_bai": ["-r", "sim1:20001-60000", "{unindexed}"],
    "bed": ["-b", "{bed}", "{messy}"],
    "H": ["-H", "{messy}"],
    "two_files": ["{messy}", "{pairs}"],
    "l90": ["-l", "90", "{messy}"],
    "deep_q13": ["-a", "-q", "13", "{deep}"],
    "f_list": ["-f", "{list}"],
    "X_index": ["-X", "{indexed}", "{indexed}.bai"],
    "g_unmap_dup": ["-g", "UNMAP,DUP", "{pairs}"],
    "G_read2": ["-G", "READ2", "{pairs}"],
    "incl_flags": ["--incl-flags", "READ1,MREVERSE", "{pairs}"],
    "require_flags": ["--require-flags", "PAIRED,PROPER_PAIR,READ2",
                      "{pairs}"],
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
def test_depth_equals_jax_tool(inputs, case):
    args = [a.format(**inputs) for a in TOOL_CASES[case]]
    kernels.reset_launches()
    port = run_port_stdout("depth", args)
    assert kernels.launches == {k: 0 for k in kernels.launches}
    assert port.count(b"\n") > 500
    for engine in ("1", "0"):
        assert port == run_jax_tool("depth", args, engine), engine
    if case == "region_bai":
        assert port == run_port_stdout("depth", [
            "-r", "sim1:20001-60000", inputs["unindexed"]])


def test_depth_output_file_and_host_branch(inputs, tmp_path, monkeypatch):
    """-o writes the same bytes; SAMTPU_DEVICE=0 takes the numpy branch,
    which needs no card."""
    out = tmp_path / "d.txt"
    want = run_port_stdout("depth", ["-J", inputs["messy"]])
    assert cli.main(["depth", "-J", "-o", str(out), inputs["messy"]],
                    device="cpu") == 0
    assert out.read_bytes() == want
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_port_stdout("depth", ["-J", inputs["messy"]],
                           device=None) == want


# SAMTPU_SHARDS values: capped at the device count (1 on the CPU), so
# "all" and a malformed value run the single-device path; "shards" runs
# the mesh branch, over 2 CPU shards (``mesh_devices`` patched), where
# the JAX tool meshes over its 2 virtual devices.  Each prints the JAX
# tool's bytes.
SHARDS = {"shards": "2", "shards_all": "all", "shards_malformed": "two"}


@pytest.mark.parametrize("case", [*SHARDS, "sam_input"])
def test_not_ported_exits_1_with_one_line(inputs, monkeypatch, case):
    path = inputs["messy"]
    if case in SHARDS:
        monkeypatch.setenv("SAMTPU_SHARDS", SHARDS[case])
        meshes = []
        if case == "shards":
            monkeypatch.setattr(common, "mesh_devices", lambda dev, n: (
                meshes.append(n) or [torch.device("cpu")] * n))
        # the JAX tool on as many devices as the port's mesh has shards
        monkeypatch.setenv("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=%d"
                           % (2 if case == "shards" else 1))
        port = run_port_stdout("depth", ["-a", path])
        assert set(meshes) == ({2} if case == "shards" else set())
        assert port.count(b"\n") > 500
        for engine in ("1", "0"):
            assert port == run_jax_tool("depth", ["-a", path], engine)
        return
    # SAM is read (tests/test_torch_sam_input.py), and CRAM now: the
    # port prints the JAX tool's bytes
    args = ["-a", inputs["cram"]]
    port = run_port_stdout("depth", args)
    assert port.count(b"\n") == REF_LEN
    assert port == run_jax_tool("depth", args, "1")


def test_shards_cap_at_the_device_count(monkeypatch):
    """device_shards: 'all' is every device, a malformed value 1, a count
    capped at the device count; 1 on the CPU whatever the value."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for v, want in (("1", 1), ("2", 2), ("9", 4), ("all", 4), ("0", 1),
                    ("-3", 1), ("two", 1), ("", 1)):
        monkeypatch.setenv("SAMTPU_SHARDS", v)
        assert device_shards(cuda) == want, v
        assert device_shards(cpu) == 1, v
    monkeypatch.delenv("SAMTPU_SHARDS")
    assert device_shards(cuda) == 1


def test_without_cuda_fails_before_any_row(inputs, capfd, monkeypatch):
    monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capfd.readouterr()
    assert cli.main(["depth", "-H", inputs["messy"]]) == 1
    out, err = capfd.readouterr()
    assert out == "" and "CUDA" in err


# ---------------------------------------------------------- host modules
@pytest.mark.parametrize("reg", [
    "sim1", "sim1:100", "sim1:1,000-2,000", "sim1:5k-6k", "sim1:-300",
    "{sim1}:10-20", ".", "*", "sim2", "nope:1-5", "sim1:50-10"])
def test_parse_region_equals_jax(inputs, reg):
    h = read_alignments(inputs["messy2"]).header
    try:
        want = jparse_region(reg, jread(inputs["messy2"]).header.tid)
    except JRegionError:
        with pytest.raises(RegionError):
            parse_region(reg, h.tid)
        return
    got = parse_region(reg, h.tid)
    assert (got.tid, got.name, got.beg, got.end) == (
        want.tid, want.name, want.beg, want.end)


@pytest.mark.parametrize("which", ["messy", "pairs", "qualless"])
def test_read_alignments_equals_jax(inputs, which):
    got, want = read_alignments(inputs[which]), jread(inputs[which])
    assert got.batch.n == want.batch.n > 0
    for c in COLUMNS:
        assert np.array_equal(getattr(got.batch, c),
                              getattr(want.batch, c)), c
    assert got.header.ref_names == want.header.ref_names
    assert got.header.ref_lens == want.header.ref_lens
    assert got.header.text == want.header.text


def test_clips_qlen_envelope_and_rows_equal_jax(inputs):
    b, jb, sel = _both(inputs["pairs"])
    assert np.array_equal(dops.overlap_clips(b, sel),
                          jdepth.overlap_clips(jb, sel))
    assert np.array_equal(depth_cmd.qlen_used(b), jdc.qlen_used(jb))
    pos, end = b.pos[sel], b.end_pos()[sel]
    for wbeg, wend in ((0, 140000), (5000, 7777)):
        assert np.array_equal(
            dops.coverage_envelope(pos, end, wbeg, wend),
            jdepth.coverage_envelope(pos, end, wbeg, wend))
    import io
    rng = np.random.default_rng(3)
    pos1 = np.sort(rng.integers(1, 10 ** 9, 3000))
    cols = [rng.integers(0, 10 ** k, 3000) for k in (1, 4, 12)]
    cols[0][:5] = 0
    a, j = io.StringIO(), io.StringIO()
    depth_cmd._emit(a, "chr1", pos1, cols)
    jdc._emit(j, "chr1", pos1, cols)
    assert a.getvalue() == j.getvalue()
