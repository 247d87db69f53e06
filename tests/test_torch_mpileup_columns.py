"""mpileup's extra columns on the port against the JAX tool, byte for
byte, on the CPU: ``-O``, ``--output-BP-5``, ``-s``, ``--output-QNAME``,
``--output-extra`` with read fields and aux tags (``--output-sep``,
``--output-empty``) and ``-M`` base modifications with and without
``--no-output-ins-mods``.  The port renders the read-field columns in
bulk (numpy) where the JAX tool writes them column by column; the
renderer is also held against the port's own per-column writer."""

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (make_general_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.fasta import load_fasta
from samtools_tpu_torch.ops import baq
from samtools_tpu_torch.tools import mpileup_cmd as mc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_general_inputs(str(tmp_path_factory.mktemp("columns")))


CASES = {
    "output_bp": ["-O", "{pairs}"],
    "output_bp_5": ["--output-BP-5", "{messy}"],
    "output_mq": ["-s", "{pairs}"],
    "output_qname": ["--output-QNAME", "{pairs}"],
    "output_extra_fields": ["--output-extra",
                            "FLAG,POS,MAPQ,RNAME,RNEXT,PNEXT,RLEN",
                            "{pairs}"],
    "output_extra_tags": ["-r", "sim1:1-30000", "--output-extra",
                          "FLAG,POS,MAPQ,RNAME,RNEXT,PNEXT,RLEN,RG,XY,NOPE",
                          "--output-sep", ";", "--output-empty", "-",
                          "-s", "{pairs}"],
    "mods": ["-M", "{mods}"],
    "mods_no_ins_mods": ["-M", "--no-output-ins-mods", "{mods}"],
    "mods_s_O_two_files": ["-M", "-s", "-O", "{mods}", "{messy}"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_columns_equal_jax_tool(inputs, case):
    args = ["-f", inputs["fa"], *[a.format(**inputs) for a in CASES[case]]]
    port = run_port_stdout("mpileup", args)
    assert port.count(b"\n") > 1000
    for engine in ("1", "0"):
        assert port == run_jax_tool("mpileup", args, engine), engine


@pytest.mark.parametrize("flags", [
    mc.COL_MAPQ_CHAR | mc.COL_QPOS,
    mc.COL_QPOS5 | mc.COL_QNAME | mc.COL_RNAME | mc.COL_RNEXT,
    mc.COL_FLAG | mc.COL_POS | mc.COL_MAPQ | mc.COL_PNEXT | mc.COL_RLEN])
def test_bulk_renderer_equals_per_column_writer(inputs, flags):
    """Two files' states over 4 kbp with -a-style empty positions: the
    bulk renderer's bytes equal the per-column writer's rows."""
    fai = load_fasta(inputs["fa"])
    ref = fai.fetch("sim1")
    conf = dict(min_baseQ=13, rev_del=1, no_ends=0, no_ins=0, no_del=0,
                no_ins_mods=0, flag_cols=flags, auxtags=[], sep=",",
                empty="*")
    states = []
    for name in ("messy", "pairs"):
        f = read_alignments(inputs[name])
        b = f.batch
        sub = b.take(np.nonzero((b.pos >= 50000) & (b.pos < 54000))[0])
        baq.apply_baq_batch(sub, baq._ref_ints(ref))
        p = mc.build_pileup(sub, torch.device("cpu"))
        states.append(mc.FileState(sub, p, *mc.build_entry_pieces(
            sub, p, ref, len(ref), conf)))
    emit = np.arange(49990, 54200, dtype=np.int64)
    got = mc._render_rows(emit, states, "sim1", ref, len(ref), conf,
                          f.header).tobytes()
    rows = []
    for pos in emit.tolist():
        row = ["sim1", "\t", str(pos + 1), "\t", chr(ref[pos])]
        for s in states:
            mc._append_file_column(row, s, pos, conf, f.header)
        rows.append("".join(row) + "\n")
    assert got == "".join(rows).encode()
