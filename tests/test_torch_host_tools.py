"""``python -m samtools_tpu_torch`` ``head``, ``flags``, ``quickcheck`` and
``cat`` against the JAX tool, on the CPU: the exit code, stderr, stdout
and every file written, byte for byte (BGZF against the JAX tool's zlib
run, and its default run's blocks: ``torch_tool_fixtures.check_output``).

Inputs are ``make_view_inputs``'s plus: the general BAM cut in two halves
(BAM, SAM and CRAM 3.0), truncated copies (100 bytes off; only the EOF
block off; a CRAM without its EOF container), an empty file, a text file
that is not SAM, a BAM with no targets and a list of inputs for ``cat
-b``.  The five host commands (view too) run with ``torch.cuda`` patched
to raise on any use, and launch no kernel.
"""

import os

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (check_case, jax_case_runs, make_view_inputs,
                                 run_port_case, run_port_full)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import read_alignments, write_alignments
from samtools_tpu_torch.io.header import SamHeader

HEAD = {
    "default": (["{general}"], None),
    "records": (["-n", "5", "{general}"], None),
    "headers": (["-h", "2", "{general}"], None),
    "headers_and_records": (["--headers", "0", "--records", "3",
                             "{general}"], None),
    "many_records": (["-n", "100000", "-h", "40", "{indexed}"], None),
    "sam": (["-n", "4", "{general_sam}"], None),
    "stdin": (["-n", "2", "-"], "general"),
    "cram": (["-n", "3", "-T", "{fa}", "{general_cram}"], None),
    "hex_count": (["-n", "0x3", "{general}"], None),
    "two_files": (["{general}", "{general}"], None),
    "bad_option": (["-H", "{general}"], None),
    "missing": (["{dir}/none.bam"], None),
    "not_alignments": (["{text}"], None),
}
FLAGS = {
    "number": (["0x63"], None),
    "several": (["99", "147", "0", "4095", "0x1000", "0o17"], None),
    "leading_zero": (["017"], None),
    "names": (["PAIRED,READ1,MREVERSE", "UNMAP"], None),
    "empty_names": ([",PAIRED,"], None),
    "usage": ([], None),
    "bad_name": (["PAIRED,NOPE"], None),
    "bad_after_good": (["0x10", "bogus"], None),
}
QUICKCHECK = {
    "good": (["{general}", "{general_sam}", "{general_samgz}",
              "{general_cram}", "{indexed}"], None),
    "verbose": (["-v", "{general}", "{cut}", "{general_cram}"], None),
    "truncated": (["-v", "{cut}"], None),
    "no_eof": (["-v", "{noeof}"], None),
    "no_eof_quiet": (["-q", "{noeof}"], None),
    "cram_no_eof": (["-v", "{cram_noeof}"], None),
    "no_targets": (["-v", "{notargets}"], None),
    "no_targets_unmapped": (["-u", "-v", "{notargets}"], None),
    "empty": (["-v", "{empty}"], None),
    "not_sequence": (["-v", "{text}"], None),
    "missing": (["-v", "-v", "{dir}/none.bam"], None),
    "very_verbose": (["-vvv", "{general}", "{cut}", "{noeof}"], None),
    "quiet_very_verbose": (["-q", "-vv", "{cut}"], None),
    "usage": ([], None),
    "bad_option": (["-x", "{general}"], None),
}
CAT = {
    "bam": (["{half_a}", "{half_b}"], None),
    "bam_to_file": (["-o", "{o}/all.bam", "{half_a}", "{half_b}"], None),
    "bam_header_file": (["-h", "{hdr}", "{half_a}", "{half_b}"], None),
    "bam_no_pg": (["--no-PG", "{half_a}", "{half_b}"], None),
    "bam_list": (["-b", "{list}", "{half_a}"], None),
    "bam_fast": (["-q", "{half_a}", "{half_b}"], None),
    "bam_shared_block": (["{indexed}", "{general}"], None),
    "cram": (["-o", "{o}/all.cram", "{cram_a}", "{cram_b}"], None),
    "cram_header_file": (["-h", "{hdr}", "{cram_a}", "{cram_b}"], None),
    "cram_to_bam": (["-o", "{o}/all.bam", "{cram_a}", "{cram_b}"], None),
    "sam_inputs": (["{sam_a}", "{sam_b}"], None),
    "mixed": (["{half_a}", "{sam_b}"], None),
    "mixed_cram": (["{cram_a}", "{half_b}"], None),
    "to_sam": (["-o", "{o}/all.sam", "{half_a}", "{half_b}"], None),
    "output_format": (["--output-fmt", "sam", "{half_a}", "{half_b}"],
                      None),
    "other_dictionary": (["{half_a}", "{messy}"], None),
    "other_dictionary_cram": (["{cram_a}", "{cram}"], None),
    "missing": (["{half_a}", "{dir}/none.bam"], None),
    "missing_list": (["-b", "{dir}/none.txt"], None),
    "usage": ([], None),
}
TOOLS = {"head": HEAD, "flags": FLAGS, "quickcheck": QUICKCHECK, "cat": CAT}


def _extra_inputs(got: dict) -> dict:
    d = got["dir"]
    p = os.path.join
    af = read_alignments(got["general"])
    h, b = af.header, af.batch
    half = b.n // 2
    got["half_a"], got["half_b"] = p(d, "half_a.bam"), p(d, "half_b.bam")
    write_bam(got["half_a"], h, b.take(np.arange(half)))
    write_bam(got["half_b"], h, b.take(np.arange(half, b.n)))
    got["sam_a"], got["sam_b"] = p(d, "half_a.sam"), p(d, "half_b.sam")
    write_alignments(got["sam_a"], h, b.take(np.arange(half)))
    write_alignments(got["sam_b"], h, b.take(np.arange(half, b.n)))
    cf = read_alignments(got["general_cram"], reference=got["fa"])
    ch, cb = cf.header, cf.batch
    got["cram_a"], got["cram_b"] = p(d, "half_a.cram"), p(d, "half_b.cram")
    write_alignments(got["cram_a"], ch, cb.take(np.arange(cb.n // 2)),
                     fmt="cram", reference=got["fa"])
    write_alignments(got["cram_b"], ch, cb.take(np.arange(cb.n // 2, cb.n)),
                     fmt="cram", reference=got["fa"])
    with open(got["general"], "rb") as f:
        data = f.read()
    with open(got["general_cram"], "rb") as f:
        cdata = f.read()
    for key, body in (("cut", data[:-100]), ("noeof", data[:-28]),
                      ("cram_noeof", cdata[:-38]), ("empty", b""),
                      ("text", b"hello\tworld\n")):
        got[key] = p(d, key + ".bin")
        with open(got[key], "wb") as f:
            f.write(body)
    got["notargets"] = p(d, "notargets.bam")
    um = b.take(np.nonzero(b.tid < 0)[0])
    write_bam(got["notargets"], SamHeader.from_text("@HD\tVN:1.6\n"), um)
    got["list"] = p(d, "list.txt")
    with open(got["list"], "w") as f:
        f.write(f"{got['half_a']}\n\n{got['half_b']}\n")
    return got


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _extra_inputs(make_view_inputs(str(tmp_path_factory.mktemp(
        "host"))))


@pytest.fixture(scope="module")
def want(inputs):
    return {cmd: jax_case_runs(cmd, inputs, cases)
            for cmd, cases in TOOLS.items()}


@pytest.mark.parametrize("cmd,case", [(c, k) for c, cases in TOOLS.items()
                                      for k in sorted(cases)])
def test_host_tool_equals_jax_tool(inputs, want, cmd, case):
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, TOOLS[cmd], case),
               want[cmd][case], f"{cmd} {case}")
    assert not any(kernels.launches.values())


def test_cases_reach_their_exits(want):
    """The table's failing cases fail and the others do not."""
    failing = {(c, k) for c, cases in want.items()
               for k, (run, _) in cases.items() if run[0] != 0}
    assert failing == {
        ("head", "two_files"), ("head", "bad_option"), ("head", "missing"),
        ("head", "not_alignments"), ("flags", "bad_name"),
        ("flags", "bad_after_good"), ("flags", "leading_zero"),
        ("quickcheck", "verbose"),
        ("quickcheck", "truncated"), ("quickcheck", "no_eof"),
        ("quickcheck", "no_eof_quiet"), ("quickcheck", "cram_no_eof"),
        ("quickcheck", "no_targets"), ("quickcheck", "empty"),
        ("quickcheck", "not_sequence"), ("quickcheck", "missing"),
        ("quickcheck", "very_verbose"), ("quickcheck", "quiet_very_verbose"),
        ("quickcheck", "usage"), ("quickcheck", "bad_option"),
        ("cat", "other_dictionary"), ("cat", "other_dictionary_cram"),
        ("cat", "missing"), ("cat", "missing_list"), ("cat", "usage")}


def test_cat_of_halves_is_the_whole(inputs, tmp_path):
    """cat of the two halves (BAM splice, CRAM splice) decodes to the
    whole file's records."""
    for a, b, whole, ext in (("half_a", "half_b", "general", "bam"),
                             ("cram_a", "cram_b", "general_cram", "cram")):
        out = str(tmp_path / f"all.{ext}")
        rc, _, err = run_port_full("cat", ["-o", out, inputs[a], inputs[b]])
        assert rc == 0, err
        x = read_alignments(out, reference=inputs["fa"]).batch
        y = read_alignments(inputs[whole], reference=inputs["fa"]).batch
        for col in ("flag", "pos", "mapq", "cigar", "seq", "qual", "aux"):
            np.testing.assert_array_equal(getattr(x, col), getattr(y, col))


class _NoCuda:
    def __getattr__(self, name):
        raise AssertionError(f"torch.cuda.{name} used")


@pytest.mark.parametrize("cmd,args", [
    ("view", ["-b", "-o", "{dir}/nc.bam", "{general}"]),
    ("view", ["-c", "-e", "mapq > 3", "{general}", "sim1:1-20000"]),
    ("head", ["-n", "3", "{general}"]),
    ("flags", ["0x63"]),
    ("quickcheck", ["{general}", "{general_cram}"]),
    ("cat", ["-o", "{dir}/nc2.bam", "{half_a}", "{half_b}"]),
])
def test_host_tools_need_no_card(inputs, monkeypatch, cmd, args):
    """The five commands start no CUDA context: torch.cuda raises on any
    use, and device=None (the card) is never resolved."""
    monkeypatch.setattr(torch, "cuda", _NoCuda())
    rc, _, err = run_port_full(cmd, [a.format(**inputs) for a in args],
                               device=None)
    assert rc == 0, err
