"""The port's mpileup options against the JAX tool's, byte for byte, on the
BAM of overlapping messy pairs with two read groups (so the overlap tweak,
the orphan filter and the read-group filter all have work).  The JAX tool
runs its host engine here: ``test_torch_mpileup.py`` holds its device and
host engines to the same bytes."""

import os

import pytest
import torch
from torch_tool_fixtures import make_inputs, run_jax, run_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("opts")
    got = make_inputs(str(d))
    bed = d / "t.bed"
    # BED intervals, a 2-column position, a comment and a track line
    bed.write_text("track name=t\n# c\nsim1\t1000\t5000\nsim1\t20000\t20100"
                   "\nsim1 70001\nsim1\t90000\t131072\n")
    rg = d / "rg.txt"
    rg.write_text("grpB\n")
    got.update(bed=str(bed), rg=str(rg))
    return got


OPTIONS = {
    "all": ["-a"],
    "all_all_no_overlaps": ["-aa", "-x"],
    "no_baq_illumina": ["-B", "-6"],
    "redo_baq_depth5": ["-E", "-d", "5"],
    "positions_bed": ["-l", "{bed}"],
    "quals_mapq_orphans": ["-Q", "20", "-q", "30", "-A"],
    "markers": ["--reverse-del", "--no-output-ins", "--no-output-del",
                "--no-output-ends"],
    "read_groups_flags": ["-G", "{rg}", "--rf", "READ2", "--ff",
                          "UNMAP,DUP", "-R", "--threads", "3"],
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_equals_jax_tool(inputs, case):
    opts = [a.format(**inputs) for a in OPTIONS[case]]
    args = ["-f", inputs["fa"], *opts, inputs["pairs"]]
    port = run_port(args, os.path.join(inputs["dir"], f"{case}.txt"))
    assert port == run_jax(args, "0")
    assert port.count(b"\n") > 1000
