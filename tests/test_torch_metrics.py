"""The port's stage report (``core/metrics.py``) against the JAX tool's, on
the CPU.

Under ``SAMTPU_METRICS=1`` or ``--verbosity 4`` both print, after a
command, one ``[M::cmd]`` line a stage: its name, calls, items and unit,
in the order first seen.  The port's report must have the JAX report's
lines with the seconds and rates masked, and the rest of stderr must be
the JAX tool's (the spill sorter's ``merging from N files...`` line at
``--verbosity 4``).  Host runs are held to the JAX tool's host branch
(``SAMTPU_DEVICE=0``); device runs (the port's plain versions on the
CPU) to its device branch (``SAMTPU_DEVICE=1``), whose stages
(``device.baq``, ``device.segment_matmul``, ``device.pileup_sort``,
``mpileup.device_window``) sit at the same function boundaries in the
port, with the same counts.  Without either setting nothing more is
printed.
"""

import re

import pytest
from torch_tool_fixtures import make_inputs, run_jax_cases, run_port_full

from samtools_tpu_torch.core import metrics

# name -> (command, arguments, environment, port device)
CASES = {
    "sort": ("sort", ["-o", "{o}.bam", "{pairs}"],
             {"SAMTPU_METRICS": "1"}, None),
    "sort_spilled": ("sort", ["--verbosity", "4", "-m", "200K", "-T",
                              "{o}.tmp", "-o", "{o}.bam", "{pairs}"],
                     {}, None),
    "sort_name_sam": ("sort", ["-n", "-O", "sam", "-o", "{o}.sam",
                               "{sam}"], {"SAMTPU_METRICS": "1"}, None),
    "view_bam": ("view", ["-b", "-o", "{o}.bam", "{messy}"],
                 {"SAMTPU_METRICS": "1"}, None),
    "view_bam_from_sam": ("view", ["--verbosity", "4", "-b", "-o",
                                   "{o}.bam", "{sam}"], {}, None),
    "depth_host": ("depth", ["-a", "{pairs}"],
                   {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "0"}, None),
    "depth_device": ("depth", ["-a", "{pairs}"],
                     {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "1"}, "cpu"),
    "mpileup_host": ("mpileup", ["-f", "{fa}", "{messy}"],
                     {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "0"}, None),
    "mpileup_device": ("mpileup", ["-f", "{fa}", "{messy}"],
                       {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "1"}, "cpu"),
    "mpileup_general_host": ("mpileup", ["-s", "-O", "-f", "{fa}",
                                         "{messy}", "{pairs}"],
                             {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "0"},
                             None),
    "mpileup_general_device": ("mpileup", ["--verbosity", "4", "-s", "-O",
                                           "-f", "{fa}", "{messy}",
                                           "{pairs}"],
                               {"SAMTPU_DEVICE": "1"}, "cpu"),
    "coverage_device": ("coverage", ["{pairs}"],
                        {"SAMTPU_METRICS": "1", "SAMTPU_DEVICE": "1"},
                        "cpu"),
    "no_report": ("sort", ["-o", "{o}.bam", "{pairs}"], {}, None),
}

# each case's stages, in order (what the JAX tool's report holds)
STAGES = {
    "sort": ["stream.decode", "encode+write"],
    "sort_spilled": ["stream.decode"],   # the streamed writer: no stage
    "sort_name_sam": ["read+decode", "decode.records", "encode+write"],
    "view_bam": ["stream.decode"],
    "view_bam_from_sam": ["read+decode", "decode.records", "encode+write"],
    "depth_host": ["read+decode", "decode.records"],
    "depth_device": ["read+decode", "decode.records",
                     "device.segment_matmul"],
    "mpileup_host": ["stream.decode", "native.baq"],
    "mpileup_device": ["stream.decode", "mpileup.device_window"],
    "mpileup_general_host": ["stream.decode", "native.baq"],
    "mpileup_general_device": ["stream.decode", "device.baq", "native.baq",
                               "device.pileup_sort"],
    "coverage_device": ["stream.decode", "device.segment_matmul"],
    "no_report": [],
}


def _args(inputs, case):
    """The case's arguments; {o} is an output path of its own."""
    o = f"{inputs['dir']}/{case}"
    return [a.format(o=o, **inputs) for a in CASES[case][1]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from samtools_tpu_torch.tools.view_cmd import main_view
    d = str(tmp_path_factory.mktemp("metrics"))
    got = make_inputs(d)
    got["sam"] = d + "/pairs.sam"
    assert main_view(["-h", "-o", got["sam"], got["pairs"]]) == 0
    return got


@pytest.fixture(scope="module")
def want(inputs):
    """Each case's JAX run, two at a time (a batch a command)."""
    out = {}
    for cmd in sorted({c[0] for c in CASES.values()}):
        out.update(run_jax_cases(cmd, {
            k: (_args(inputs, k), c[2]) for k, c in CASES.items()
            if c[0] == cmd}))
    return out


def _mask(err: str) -> str:
    """stderr with the report's seconds and rates masked, and without the
    JAX runtime's own log lines (XLA's glog lines on its device
    branch)."""
    err = re.sub(r"^[EWIF][0-9]{4} [0-9:.]+ +[0-9]+ \S+:[0-9]+\] .*\n", "",
                 err, flags=re.M)
    err = re.sub(r"\(total instrumented [0-9.]+s\)", "(total #s)", err)
    err = re.sub(r" +[0-9]+\.[0-9]{3}s  x", " #s  x", err)
    return re.sub(r"  [0-9.]+[kMG]? (\S+)/s$", r"  # \1/s", err,
                  flags=re.M)


def _report(err: str, cmd: str) -> list[str]:
    return [ln.split()[1] for ln in err.splitlines()
            if ln.startswith(f"[M::{cmd}]   ")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_report_equals_jax(inputs, want, monkeypatch, case):
    cmd, _, env, device = CASES[case]
    for k in ("SAMTPU_METRICS", "SAMTPU_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc, out, err = run_port_full(cmd, _args(inputs, case), device=device)
    jrc, jout, jerr = want[case]
    assert (rc, out) == (jrc, jout)
    assert _report(jerr, cmd) == STAGES[case]
    assert _mask(err) == _mask(jerr)
    if case == "sort_spilled":
        assert "[I::sort] merging from " in err


def test_verbosity_is_per_command(inputs, monkeypatch):
    """``--verbosity 4`` reaches ``metrics`` for its command only: the next
    command starts at the default level and prints no report."""
    monkeypatch.delenv("SAMTPU_METRICS", raising=False)
    seen = []
    real = metrics.report

    def spy(tool, out=None):
        seen.append(metrics.verbosity())
        real(tool, out)
    monkeypatch.setattr(metrics, "report", spy)
    rc, _, err = run_port_full("view", ["--verbosity", "4", "-c",
                                        inputs["messy"]])
    assert rc == 0 and seen == [4] and "[M::view]" in err
    rc, _, err = run_port_full("view", ["-c", inputs["messy"]])
    assert rc == 0 and seen == [4, metrics.DEFAULT_VERBOSITY]
    assert err == ""
