"""``python -m samtools_tpu_torch calmd`` (and ``fillmd``) against
``python -m samtools_tpu calmd``, on the CPU: one parity test over the
table of cases, each run by the port in-process with the JAX tool's
argument list (``torch_tool_fixtures.check_case``: exit code, standard
error, standard output and every file; BGZF outputs are the bytes of the
JAX tool's zlib run, which also takes the JAX tool's path without the
host library's tag scan).

Inputs are ``torch_tool_fixtures.make_dup_inputs``'s: ``md`` (reads with
indels, soft clips and skips, wrong NM and MD tags, reads with many
mismatches, one without a sequence) against
``md_fa``, a slice of the contig that the last reads run past (half of it
in lower case); ``md_small`` (300 reads without soft clips or
insertions) for the per-read HMM of ``-r`` and ``-C``; ``md_nmz`` (NM
stored as a string); ``md_missing``, with reads on a contig the FASTA
lacks.  The
scalar path (``SAMTPU_CALMD_SCALAR=1``) and 64 KiB stream windows give
the batch path's bytes.  No case launches a kernel.
"""

import contextlib
import io

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_dup_inputs,
                                 run_jax_full, run_port_case)

from samtools_tpu_torch import cli, kernels

MD = ["{md}", "{md_fa}"]
SMALL = ["{md_small}", "{md_fa}"]
MISSING = ["{md_missing}", "{md_fa}"]

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CALMD = {
    "default": (MD, None),
    "equal": (["-e", *MD], None),
    "bam": (["-b", *MD], None),
    "uncompressed": (["-u", *MD], None),
    "bin_qual": (["-q", *MD], None),
    "no_update": (["-N", "-e", *MD], None),
    "max_nm": (["-n", "3", *MD], None),
    "max_nm_equal": (["-n", "1", "-e", "-b", *MD], None),
    "quiet": (["-Q", *MD], None),
    "drop_tags": (["-d", *MD], None),
    "ignored_options": (["-S", "-h", "-e", *MD], None),
    "cap_mapq": (["-C", "50", *SMALL], None),
    "cap_mapq_off": (["-C", "10", *MD], None),
    "realign": (["-r", *SMALL], None),
    "realign_apply": (["-A", "-r", *SMALL], None),
    "realign_extended": (["-E", "-r", "-b", *SMALL], None),
    "realign_cap_equal": (["-r", "-C", "50", "-e", *SMALL], None),
    "no_pg": (["--no-PG", *MD], None),
    "threads": (["-@", "2", "-b", *MD], None),
    "reference_option": (["--reference", "{md_fa}", "{md}"], None),
    "samgz_output": (["--output-fmt", "sam.gz", *MD], None),
    "whole_fasta": (["-e", "{dup}", "{fa}"], None),
    "sam_input": (["{dup_sam}", "{fa}"], None),
    "stdin": (["-e", "-", "{md_fa}"], "md"),
    "missing_contig": (MISSING, None),
    "missing_contig_realign": (["-r", *MISSING], None),
    "missing_contig_cap": (["-C", "50", *MISSING], None),
    "missing_contig_cap_off": (["-C", "10", "-b", *MISSING], None),
    "missing_reference": (["{md}", "{dir}/none.fa"], None),
    "missing_input": (["{dir}/none.bam", "{md_fa}"], None),
    "no_arguments": ([], None),
    "one_argument": (["{md}"], None),
    "bad_option": (["--no-such", *MD], None),
    "nm_string": (["{md_nmz}", "{md_fa}"], None),
}
FILLMD = {k: CALMD[k] for k in ("default", "equal", "missing_contig",
                                "no_arguments")}

# cases run again on the scalar path, and in 64 KiB stream windows
SCALAR = ("default", "equal", "bin_qual", "max_nm", "max_nm_equal",
          "drop_tags", "no_update", "realign", "realign_cap_equal",
          "missing_contig", "stdin", "sam_input")
STREAMED = ("default", "bam", "max_nm", "drop_tags", "realign_apply",
            "missing_contig_realign", "whole_fasta")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_dup_inputs(str(tmp_path_factory.mktemp("calmd")))


@pytest.fixture(scope="module")
def want(inputs):
    return {"calmd": jax_case_runs("calmd", inputs, CALMD),
            "fillmd": jax_case_runs("fillmd", inputs, FILLMD)}


def _check(inputs, want, cmd, case):
    cases = CALMD if cmd == "calmd" else FILLMD
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, cases, case), want[cmd][case],
               case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case", sorted(CALMD))
def test_calmd_equals_jax_tool(inputs, want, case):
    _check(inputs, want, "calmd", case)


@pytest.mark.parametrize("case", sorted(FILLMD))
def test_fillmd_equals_jax_tool(inputs, want, case):
    _check(inputs, want, "fillmd", case)


@pytest.mark.parametrize("case", SCALAR)
def test_scalar_path_equals_batch_path(inputs, want, monkeypatch, case):
    """``SAMTPU_CALMD_SCALAR=1``: fillmd_one a record, the bytes of the
    JAX tool's batch path."""
    monkeypatch.setenv("SAMTPU_CALMD_SCALAR", "1")
    _check(inputs, want, "calmd", case)


@pytest.mark.parametrize("case", STREAMED)
def test_small_stream_windows_keep_the_bytes(inputs, want, monkeypatch,
                                             case):
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", "65536")
    _check(inputs, want, "calmd", case)


@pytest.mark.parametrize("args,env,error", [
    (["{md_nmz}", "{md_fa}"], {"SAMTPU_CALMD_SCALAR": "1"},
     "TypeError: %d format: a real number is required, not str"),
    (["-r", "{md_clipped}", "{md_fa}"], {},
     "AuxError: unknown aux type"),
])
def test_faults_shared_with_jax_tool(inputs, monkeypatch, args, env, error):
    """Two faults of the JAX package that the port keeps (ROADMAP Queue
    3): the scalar path formats an NM stored as a string with %d; ``-r``
    leaves the BQ bytes of soft-clipped and inserted bases unclamped, so
    a NUL can end the tag early and the next tag lookup fails.  Both
    packages raise the same error."""
    argv = [a.format(**inputs) for a in args]
    rc, out, err = run_jax_full("calmd", argv, env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = io.TextIOWrapper(io.BytesIO(), encoding="latin-1")
    with pytest.raises(Exception) as got, \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(["calmd", *argv])
    mine = f"{type(got.value).__name__}: {got.value}"
    assert mine.startswith(error)
    assert rc == 1 and err.rstrip().endswith(mine), err[-300:]


def test_fixture_takes_every_path(want):
    """The fixture's reads reach each message of bam_fillmd1: changed NM
    and MD, a read without a sequence, the missing contig; ``-r`` gives
    reads BQ tags."""
    err = want["calmd"]["default"][0][2]
    assert "different NM for read" in err and "different MD for read" in err
    assert "no sequence in alignment record" in err
    assert err.endswith("reads skipped\n")
    assert "fail to find sequence 'sim2'" in \
        want["calmd"]["missing_contig"][0][2]
    assert want["calmd"]["missing_contig_realign"][0][0] == 1
    assert b"\tBQ:Z:" in want["calmd"]["realign"][0][1]
