"""``python -m samtools_tpu_torch stats`` with its options, against
``python -m samtools_tpu stats`` on the CPU: each case prints the JAX
tool's bytes through K12's plain version, the host branch
(``SAMTPU_DEVICE=0``) and, where the batch engine takes the option, the
per-record path (``SAMTPU_STATS_SCALAR=1``).  ``-r ref.fa`` (GC-depth
bins from the reference, mismatches per cycle), ``--ref-stats``,
``-c``, ``-i``, ``-q``, ``-f``/``-F``/``-d``, ``-l``, ``-x``, a region
argument, ``-t`` with ``-g``, ``-I``, ``-p`` and ``-S RG -P prefix``
(with its .bamstat files).  Inputs from
``torch_tool_fixtures.make_stats_inputs``."""

import os

import pytest
import torch
from torch_tool_fixtures import check_stats_case, make_stats_inputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    got = make_stats_inputs(str(tmp_path_factory.mktemp("stats_opts")))
    got["prefix"] = os.path.join(got["dir"], "split")
    return got


# name -> (arguments, input, also per record); {x} names an input of the
# fixture.  Regions, -t, -I, -p and -S run the per-record path anyway.
CASES = {
    "ref_fa": (["-r", "{fa}"], "messy", True),
    "ref_fa_pairs": (["-r", "{fa}", "--GC-depth", "5000"], "pairs", False),
    "ref_stats": (["--ref-stats", "-r", "{fa}"], "messy", False),
    "ref_stats_no_fa": (["--ref-stats"], "pairs", False),
    "coverage": (["-c", "1,1000,1"], "messy", False),
    "coverage_steps": (["-c", "2,40,3"], "pairs", False),
    "insert_size": (["-i", "2000"], "pairs", True),
    "trim_quality": (["-q", "20"], "realloc", True),
    "required_flag": (["-f", "0x2"], "pairs", False),
    "filter_flag": (["-F", "0x400"], "realloc", False),
    "remove_dups": (["-d"], "realloc", False),
    "read_length": (["-l", "50"], "realloc", False),
    "sparse": (["-x"], "pairs", False),
    "region": (["{messy}", "sim1:1000-20000"], None, False),
    "targets": (["-t", "{targets}", "-g", "5"], "messy", False),
    "read_group": (["-I", "grpA"], "pairs", False),
    "remove_overlaps": (["-p"], "pairs", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_option_equals_jax_tool(inputs, monkeypatch, case):
    extra, which, scalar = CASES[case]
    if which is None:       # the input comes first, the region after it
        inputs = dict(inputs, last="sim1:1000-20000")
        extra, which = extra[:1], "last"
    check_stats_case(inputs, extra, which, monkeypatch, scalar=scalar)


def test_stats_split_equals_jax_tool(inputs, monkeypatch):
    check_stats_case(inputs, ["-S", "RG", "-P", "{prefix}"], "pairs",
                     monkeypatch, scalar=False, split=inputs["prefix"])
