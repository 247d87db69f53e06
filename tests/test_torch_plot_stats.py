"""``python -m samtools_tpu_torch plot-ampliconstats`` and
``plot-bamstats`` against the JAX tool, on the CPU: one parity test over
each table of cases, each run by the port in-process with the JAX
tool's argument list (``torch_tool_fixtures.check_case``: exit code,
standard error, standard output and every PNG and HTML file, byte for
byte).

Inputs are the JAX tool's own ``ampliconstats`` of four samples of an
ARTIC-shaped panel and its ``stats`` of the two-contig panel's reads
(``torch_tool_fixtures.make_amplicon_inputs``).  Both commands import
matplotlib when they run; the package imports without it.  No case
launches a kernel.
"""

import os
import subprocess
import sys

import pytest
from torch_tool_fixtures import (REPO, check_case, jax_case_runs,
                                 make_amplicon_inputs, run_port_case,
                                 run_port_full, take_files)

from samtools_tpu_torch import kernels

pytest.importorskip("matplotlib")

# cmd -> name -> (arguments, standard input); {x} names an input of the
# fixture, {o} the case's output directory
CASES = {
    "plot-ampliconstats": {
        "prefix": (["{o}/pl", "{astats}"], None),
        "prefix_option": (["-p", "{o}/pl", "{astats}"], None),
        "prefix_long_option": (["--prefix", "{o}/x"], "astats"),
        "stdin": (["{o}/pl"], "astats"),
        "no_sections": (["{o}/pl", "{stats}"], None),
        "help": (["-h"], None),
        "no_argument": ([], None),
        "bad_option": (["--no-such", "{o}/pl", "{astats}"], None),
    },
    "plot-bamstats": {
        "prefix_dir": (["-p", "{o}/", "{stats}"], None),
        "prefix_file": (["-p", "{o}/bs", "{stats}"], None),
        "prefix_long": (["--prefix", "{o}/b", "{stats}"], None),
        "astats_input": (["-p", "{o}/a", "{astats}"], None),
        "help": (["--help"], None),
        "no_argument": ([], None),
        "two_arguments": (["{stats}", "{astats}"], None),
        "bad_option": (["--no-such", "{stats}"], None),
    },
}
ALL = [(cmd, name) for cmd in CASES for name in sorted(CASES[cmd])]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_amplicon_inputs(str(tmp_path_factory.mktemp("plots")))


@pytest.fixture(scope="module")
def want(inputs):
    return {cmd: jax_case_runs(cmd, inputs, cases, zlib_run=False)
            for cmd, cases in CASES.items()}


@pytest.mark.parametrize("cmd,case", ALL)
def test_plot_equals_jax_tool(inputs, want, cmd, case):
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, CASES[cmd], case),
               want[cmd][case], f"{cmd} {case}")
    assert not any(kernels.launches.values())


def test_cases_draw_every_plot(want):
    """The amplicon plots of the four per-file sections the JAX tool
    draws, and the stats plots with their index, in both prefix forms."""
    (rc, _, _, files), _ = want["plot-ampliconstats"]["prefix"]
    assert rc == 0 and sorted(files) == [
        "pl-fdepth.png", "pl-freads.png", "pl-frperc.png", "pl-fvdepth.png",
        "pl-index.html"]
    (rc, _, _, files), _ = want["plot-bamstats"]["prefix_dir"]
    assert rc == 0 and "index.html" in files and len(files) >= 9
    (rc, _, _, files), _ = want["plot-bamstats"]["prefix_file"]
    assert rc == 0 and "bs.html" in files and "bs-coverage.png" in files


def test_bamstats_default_prefix(inputs, tmp_path, monkeypatch):
    """With no -p, plot-bamstats writes into a directory named after the
    stats file, in the working directory: the JAX tool's files."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    p = subprocess.run([sys.executable, "-m", "samtools_tpu",
                        "plot-bamstats", inputs["stats"]], cwd=jdir,
                       env=env, capture_output=True, timeout=600)
    monkeypatch.chdir(pdir)
    rc, out, err = run_port_full("plot-bamstats", [inputs["stats"]])
    assert (rc, out, err) == (p.returncode, p.stdout, p.stderr.decode())
    assert os.listdir(jdir) == os.listdir(pdir) == ["stats"]
    want = take_files(str(jdir / "stats"))
    assert "index.html" in want
    assert take_files(str(pdir / "stats")) == want
