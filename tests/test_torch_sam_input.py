"""SAM input and index-driven ``-r`` in the port's commands, against the
JAX package on the CPU:

* ``mpileup``, ``depth``, ``coverage``, ``bedcov``, ``consensus``,
  ``flagstat`` and ``stats`` print the JAX tool's bytes on SAM text,
  gzip'd SAM, BGZF'd SAM, a SAM without a header (contigs named by the
  records) and, where the JAX tool reads it, SAM on standard input;
* ``-r`` in ``mpileup``, ``depth`` and ``consensus`` reads an indexed BAM
  through ``BamStream.query`` and prints the JAX tool's bytes: on a BAM
  of two BGZF blocks against the JAX tool's own index query, and on one
  of more than 50 blocks (where the JAX query raises) against the JAX
  tool on an unindexed copy; the port prints those bytes on the
  unindexed copy too;
* the SAM parser and the SAM aux conversion equal the JAX functions.

The JAX tools run in-process (their host branch, ``SAMTPU_DEVICE=0``);
the port runs in-process on the CPU through its kernels' plain versions.
"""

import contextlib
import gzip
import io
import os
import shutil

import numpy as np
import pytest
import torch
from torch_tool_fixtures import REF_LEN, make_inputs, run_port_stdout

from samtools_tpu.core import aux as jaux
from samtools_tpu.io import sam_text as jsam
from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.io.files import write_alignments as jwrite
from samtools_tpu.tools import run_command as jrun
from samtools_tpu_torch import cli, sim
from samtools_tpu_torch.core import aux
from samtools_tpu_torch.io import bgzf, sam_text, stream
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import detect_format

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sam_input"))
    got = make_inputs(d)
    f = jread(got["messy"])
    b = f.batch.take(np.nonzero(f.batch.pos < 40000)[0])
    got["sam"] = os.path.join(d, "x.sam")
    jwrite(got["sam"], f.header, b, fmt="sam")
    with open(got["sam"], "rb") as fh:
        text = fh.read()
    got["sam_gz"] = got["sam"] + ".gz"
    with open(got["sam_gz"], "wb") as fh:
        fh.write(gzip.compress(text))
    got["sam_bgzf"] = os.path.join(d, "x.bgzf.sam.gz")
    jwrite(got["sam_bgzf"], f.header, b, fmt="sam.gz")
    got["headerless"] = os.path.join(d, "headerless.sam")
    with open(got["headerless"], "wb") as fh:
        fh.write(b"".join(ln + b"\n" for ln in text.split(b"\n")
                          if ln and not ln.startswith(b"@")))
    got["bed"] = os.path.join(d, "r.bed")
    with open(got["bed"], "w") as fh:
        fh.write("sim1\t100\t5000\tr1\nsim1\t10000\t30000\tr2\n")
    # two BGZF blocks: the JAX index query reads them
    got["few"] = os.path.join(d, "few.bam")
    write_bam(got["few"], f.header, f.batch.take(np.nonzero(
        (f.batch.pos >= 16000) & (f.batch.pos < 21000))[0]))
    # more than 50 blocks: the JAX index query raises
    many = sim.simulate_messy(sim.simulate_batch(
        ref_len=REF_LEN, coverage=20.0, paired=False, seed=21,
        ref=got["ref"]), 21)
    got["many"] = os.path.join(d, "many.bam")
    write_bam(got["many"], sim.make_header(REF_LEN), many)
    with open(got["many"], "rb") as fh:
        assert bgzf.scan_blocks(fh.read())[0].size > 50
    for k in ("few", "many"):
        got[k + "_unindexed"] = os.path.join(d, f"{k}_unindexed.bam")
        shutil.copy(got[k], got[k + "_unindexed"])
        assert cli.main(["index", got[k]]) == 0
    return got


def jax_stdout(cmd: str, args: list[str], monkeypatch,
               stdin: str | None = None) -> bytes:
    """What the JAX tool (host branch) writes to standard output, run
    in-process."""
    buf = io.StringIO()
    with monkeypatch.context() as m:
        m.setenv("SAMTPU_DEVICE", "0")
        if stdin is not None:
            m.setattr("sys.stdin", io.TextIOWrapper(open(stdin, "rb")))
        with contextlib.redirect_stdout(buf):
            rc = jrun(cmd, args)
    assert rc in (0, None), rc
    return buf.getvalue().encode()


COMMANDS = {
    "mpileup": ["-f", "{fa}"],
    "depth": ["-a"],
    "coverage": [],
    "bedcov": ["{bed}"],
    "consensus": ["-a"],
    "flagstat": [],
    "stats": [],
}
# the JAX consensus and stats stream a path and do not read "-"
STDIN = ("mpileup", "depth", "coverage", "bedcov", "flagstat")
SAM_CASES = [(cmd, which) for cmd in COMMANDS
             for which in ("sam", "sam_gz", "sam_bgzf", "headerless")] + [
    (cmd, "stdin") for cmd in STDIN]


@pytest.mark.parametrize("cmd,which", SAM_CASES)
def test_sam_input_prints_jax_bytes(inputs, monkeypatch, cmd, which):
    args = [a.format(**inputs) for a in COMMANDS[cmd]]
    if which == "stdin":
        want = jax_stdout(cmd, args + ["-"], monkeypatch, inputs["sam"])
        got = run_port_stdout(cmd, args + ["-"], stdin=inputs["sam"])
    else:
        want = jax_stdout(cmd, args + [inputs[which]], monkeypatch)
        got = run_port_stdout(cmd, args + [inputs[which]])
    assert got == want
    # depth -a prints no row for contigs of length 0
    assert len(want) > 40 or (cmd, which) == ("depth", "headerless")


def test_detect_format(inputs):
    assert [detect_format(inputs[k]) for k in (
        "sam", "sam_gz", "sam_bgzf", "headerless", "messy", "cram")] == [
        "sam", "sam.gz", "sam.gz", "sam", "bam", "cram"]


REGION_ARGS = {
    "mpileup": ["-f", "{fa}", "-r", "{reg}"],
    "depth": ["-a", "-r", "{reg}"],
    "consensus": ["-r", "{reg}"],
    "consensus_pileup": ["-f", "pileup", "-r", "{reg}"],
}
REGIONS = {"few": "sim1:17001-20000", "many": "sim1:40001-45000"}


@pytest.mark.parametrize("which", ["few", "many"])
@pytest.mark.parametrize("case", sorted(REGION_ARGS))
def test_region_through_index_prints_jax_bytes(inputs, monkeypatch, case,
                                               which):
    cmd = case.split("_")[0]
    args = [a.format(reg=REGIONS[which], **inputs)
            for a in REGION_ARGS[case]]
    # the JAX query works on the few-block BAM; on the many-block one it
    # raises, so the JAX tool reads the unindexed copy
    want = jax_stdout(cmd, args + [inputs[which if which == "few"
                                          else "many_unindexed"]],
                      monkeypatch)
    queries = []
    real = stream.BamStream.query

    def counting(self, *a, **k):
        got = real(self, *a, **k)
        queries.append(got.n)
        return got
    with monkeypatch.context() as m:
        m.setattr(stream.BamStream, "query", counting)
        got = run_port_stdout(cmd, args + [inputs[which]])
    assert queries and sum(queries) > 0
    assert got == want and len(want) > 1000
    assert run_port_stdout(cmd, args + [inputs[which + "_unindexed"]]) == want


@pytest.mark.parametrize("cmd", ["mpileup", "depth", "consensus"])
def test_region_on_sam_prints_jax_bytes(inputs, monkeypatch, cmd):
    args = [a.format(reg="sim1:20001-30000", **inputs)
            for a in REGION_ARGS[cmd]] + [inputs["sam"]]
    assert run_port_stdout(cmd, args) == jax_stdout(cmd, args, monkeypatch)


SAM_LINES = [
    "r1\t0\tsim1\t11\t60\t4M\t*\t0\t0\tACGT\tIIII",
    "r2\t99\tchrA\t5\t0\t2S3M1I2D4M\t=\t40\t50\tACGTNACGTA\t!!!!!#####",
    "r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
    "r4\t16\tchrB\t7\t3\t3M\tchrA\t2\t-9\tacu\t*\tNM:i:1\tXA:A:q",
    "r5\t0\tchrB\t9\t3\t2M\t*\t0\t0\tAC\tII\tXB:B:s,-1,300\tXF:f:2.5"
    "\tXH:H:1AE3\tXI:i:-70000\tXJ:i:4000000000\tXZ:Z:a b c",
]


@pytest.mark.parametrize("header", ["", "@HD\tVN:1.6\n@SQ\tSN:chrB\tLN:90\n"
                                    "@SQ\tSN:sim1\tLN:50\tAN:chrA\n"])
def test_parse_sam_equals_jax(header):
    text = header + "\n".join(SAM_LINES) + "\n"
    h, b = sam_text.parse_sam(text.encode())
    jh, jb = jsam.parse_sam(text.encode())
    assert (h.text, h.ref_names, h.ref_lens) == (jh.text, jh.ref_names,
                                                  jh.ref_lens)
    for k, v in vars(jb).items():
        got = getattr(b, k)
        assert (got == v if k == "n" else
                got.dtype == v.dtype and np.array_equal(got, v)), k


def test_sam_parse_errors_equal_jax():
    for bad in ("r\t0\tsim1\t1\t0\t4Q\t*\t0\t0\tACGT\tIIII",
                "r\t0\tsim1\t1\t0\t4M\t*\t0\t0\tACGT",
                "r\t0\tsim1\t1\t0\t4M\t*\t0\t0\tACGT\tIII"):
        with pytest.raises(sam_text.SamParseError):
            sam_text.parse_sam(bad)
        with pytest.raises(jsam.SamParseError):
            jsam.parse_sam(bad)
    with pytest.raises(sam_text.SamParseError, match="unknown reference"):
        sam_text.parse_sam("@SQ\tSN:a\tLN:5\nr\t0\tb\t1\t0\t1M\t*\t0\t0\t"
                           "A\tI\n")


@pytest.mark.parametrize("field", [
    "XA:A:q", "NM:i:0", "NM:i:255", "NM:i:256", "NM:i:65536", "NM:i:-1",
    "NM:i:-129", "NM:i:-40000", "NM:i:4294967295", "XF:f:-1.25e3",
    "XD:d:0.1", "XZ:Z:", "XZ:Z:hello world", "XH:H:0A1B",
    "XB:B:c,-1,2", "XB:B:C,255", "XB:B:s,-300", "XB:B:S,1,2,3",
    "XB:B:i,-70000", "XB:B:I,4000000000", "XB:B:f,1.5,-2", "XB:B:i"])
def test_sam_field_to_aux_equals_jax(field):
    assert aux.sam_field_to_aux(field) == jaux.sam_field_to_aux(field)


@pytest.mark.parametrize("field", ["NM:i:4294967296", "NM:i:-2147483649",
                                   "XQ:Q:1", "NM", "NMi:1"])
def test_sam_field_to_aux_rejects_what_jax_rejects(field):
    with pytest.raises(aux.AuxError):
        aux.sam_field_to_aux(field)
    with pytest.raises(jaux.AuxError):
        jaux.sam_field_to_aux(field)
