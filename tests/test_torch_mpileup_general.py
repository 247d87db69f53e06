"""``python -m samtools_tpu_torch mpileup``'s general path against the JAX
tool, byte for byte, on the CPU (the plain versions of K8 and K13): several
input files and ``-b``, ``-r`` on an indexed and an unindexed BAM, standard
input, ``-C 50``, ``-aa`` over two files, and reads with stored BQ or ZQ
tags with and without ``-E``.  The JAX tool runs as a subprocess on its
CPU backend, once with its device branch forced (``SAMTPU_DEVICE=1``: its
K8 and K13) and once on the host (``=0``)."""

import pytest
import torch
from torch_tool_fixtures import (make_general_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu_torch import kernels

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_general_inputs(str(tmp_path_factory.mktemp("general")))


# arguments after -f ref.fa ({name} is an input), and the file read as
# standard input
CASES = {
    "two_files": (["{messy}", "{pairs}"], None),
    "bam_list": (["-b", "{list}"], None),
    "region_bai": (["-r", "sim1:17001-20000", "{indexed}"], None),
    "region_no_bai": (["-r", "sim1:17001-20000", "{unindexed}"], None),
    "region_two_files_a": (["-a", "-r", "sim1:30001-34000", "{messy}",
                            "{pairs}"], None),
    "stdin": (["-"], "messy"),
    "adjust_mq_50": (["-C", "50", "{messy}"], None),
    "adjust_mq_50_two_files": (["-C", "50", "-s", "{messy}", "{pairs}"],
                               None),
    "aa_two_files_s": (["-aa", "-s", "{messy2}", "{pairs}"], None),
    "bq_tags": (["{bq}"], None),
    "bq_tags_redo": (["-E", "{bq}"], None),
    "zq_tags": (["{zq}"], None),
    "zq_tags_redo": (["-E", "{zq}"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_general_path_equals_jax_tool(inputs, case):
    extra, stdin = CASES[case]
    args = ["-f", inputs["fa"], *[a.format(**inputs) for a in extra]]
    stdin = inputs[stdin] if stdin else None
    kernels.reset_launches()
    port = run_port_stdout("mpileup", args, stdin=stdin)
    assert kernels.launches == {k: 0 for k in kernels.launches}
    assert port.count(b"\n") > 1000
    for engine in ("1", "0"):
        assert port == run_jax_tool("mpileup", args, engine,
                                    stdin=stdin), engine
