"""``python -m samtools_tpu_torch markdup`` against ``python -m
samtools_tpu markdup``, on the CPU: one parity test over the table of
cases, each run by the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, standard error, standard
output and every file; BGZF outputs are the bytes of the JAX tool's zlib
run).

Inputs are ``torch_tool_fixtures.make_dup_inputs``'s: pairs through
``fixmate -m`` and ``sort`` with Illumina-style names, copies within and
beyond the optical distance, single-end and QC-failed copies, soft clips
at the 5' ends, supplementary records with ``SA`` tags, UMIs in names,
``BC`` tags and two read groups.  The streamed cases also run in 64 KiB
stream windows (``SAMTPU_MARKDUP_WINDOW``), which cut key windows and
duplicate chains across batches: the bytes stay the same.  No case
launches a kernel; ``-S`` leaves no spill file or directory behind.
"""

import contextlib
import io
import os
import struct
import tempfile

import numpy as np
import pytest
from torch_tool_fixtures import (aux_blob, check_case, jax_case_runs,
                                 make_dup_inputs, run_jax_full,
                                 run_port_case, run_port_full)

from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.core import aux as auxmod

OUT = ["{dup}", "{o}/m.bam"]
COORDS = "^SIM:1:FC1:1:([[:digit:]]+):([[:digit:]]+):([[:digit:]]+)"
COORDS_XY = "^SIM:1:FC1:1:[0-9]+:([0-9]+):([0-9]+)"

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
MARKDUP = {
    "default": (OUT, None),
    "remove": (["-r", *OUT], None),
    "stats": (["-s", *OUT], None),
    "stats_file": (["-f", "{o}/stats.txt", *OUT], None),
    "stats_bad_file": (["-f", "{dir}/no_dir/stats.txt", *OUT], None),
    "json": (["--json", "-f", "{o}/stats.json", *OUT], None),
    "json_stderr": (["--json", "{dup}", "{o}/m.sam"], None),
    "supp": (["-S", "-s", *OUT], None),
    "supp_tmp_prefix": (["-S", "-T", "{o}/spill", "-t", "-d", "100",
                         *OUT], None),
    "supp_remove_stdout": (["-S", "-r", "-d", "100", "--output-fmt", "sam",
                            "{dup}", "-"], None),
    "tag": (["-t", "{dup}", "{o}/m.sam"], None),
    "optical": (["-d", "100", "-s", *OUT], None),
    "optical_tag_stats": (["-d", "100", "-t", "-f", "{o}/s.txt", "{dup}",
                           "{o}/m.sam"], None),
    "optical_no_multi_dup": (["-d", "100", "-t", "--no-multi-dup", "-s",
                              "{dup}", "{o}/m.sam"], None),
    "optical_small": (["-d", "20", "-s", *OUT], None),
    "clear": (["-c", "{dup_marked}", "{o}/m.sam"], None),
    "clear_remark": (["-c", "-t", "-d", "50", "-s", "{dup_marked}",
                      "{o}/m.sam"], None),
    "marked_no_clear": (["-s", "{dup_marked}", "{o}/m.sam"], None),
    "mode_s": (["-m", "s", "-s", *OUT], None),
    "mode_t": (["--mode", "t", "-d", "100", "-s", *OUT], None),
    "mode_bad": (["-m", "x", *OUT], None),
    "max_length": (["-l", "50", "-s", *OUT], None),
    "max_length_negative": (["-l", "-3", "-d", "-1", *OUT], None),
    "uncompressed": (["-u", *OUT], None),
    "include_fails": (["--include-fails", "-s", *OUT], None),
    "read_coords": (["--read-coords", COORDS, "--coords-order", "txy",
                     "-d", "100", "-s", *OUT], None),
    "read_coords_xy": (["--read-coords", COORDS_XY, "--coords-order", "xy",
                        "-d", "100", "-t", "-s", "{dup}", "{o}/m.sam"],
                       None),
    "read_coords_fewer_groups": (["--read-coords", COORDS_XY,
                                  "--coords-order", "txy", "-d", "100",
                                  "-s", *OUT], None),
    "barcode_tag": (["--barcode-tag", "BC", "-s", *OUT], None),
    "barcode_name": (["--barcode-name", "-s", *OUT], None),
    "barcode_rgx": (["--barcode-rgx", ":([ACGT]+)$", "-s", *OUT], None),
    "read_groups": (["--use-read-groups", "-s", *OUT], None),
    "read_groups_json": (["--use-read-groups", "--json", "-d", "100", "-f",
                          "{o}/s.json", *OUT], None),
    "read_groups_none": (["--use-read-groups", "-s", "{dup_norg}",
                          "{o}/m.bam"], None),
    "duplicate_count": (["--duplicate-count", "{dup}", "{o}/m.sam"], None),
    "duplicate_count_supp": (["--duplicate-count", "-S", "{dup}",
                              "{o}/m.sam"], None),
    "move_umi": (["--barcode-name", "--move-umi-to-tag", "{dup}",
                  "{o}/m.sam"], None),
    "move_umi_separator": (["--barcode-rgx", "([ACGT]+)$",
                            "--move-umi-to-tag", "--umi-separator", ":",
                            "-S", "-s", "{dup}", "{o}/m.sam"], None),
    "everything": (["-S", "-t", "-d", "100", "--use-read-groups",
                    "--duplicate-count", "--barcode-tag", "BC", "--json",
                    "-f", "{o}/s.json", "-T", "{o}/spill", "-@", "2", *OUT],
                   None),
    "no_pg": (["--no-PG", *OUT], None),
    "threads": (["-@", "2", "-s", *OUT], None),
    "sam_output": (["{dup}", "{o}/m.sam"], None),
    "samgz_output": (["{dup}", "{o}/m.sam.gz"], None),
    "stdout_sam": (["--output-fmt", "sam", "{dup}", "-"], None),
    "stdout_bam": (["-O", "bam", "{dup}", "-"], None),
    "sam_input": (["-s", "{dup_sam}", "{o}/m.bam"], None),
    "stdin": (["-s", "-d", "100", "-", "{o}/m.bam"], "dup"),
    "queryname": (["{dup_name}", "{o}/m.bam"], None),
    "no_mc": (["{dup_nomc}", "{o}/m.bam"], None),
    "not_sorted": (["{dup_grouped}", "{o}/m.bam"], None),
    "missing": (["{dir}/none.bam", "{o}/m.bam"], None),
    "no_arguments": ([], None),
    "one_argument": (["{dup}"], None),
    "bad_option": (["--no-such", *OUT], None),
}

# cases that stream a BAM path, run again in 64 KiB stream windows
STREAMED = ("default", "remove", "supp", "supp_tmp_prefix", "optical",
            "optical_tag_stats", "optical_no_multi_dup", "clear_remark",
            "mode_s", "read_coords", "barcode_name", "read_groups_json",
            "duplicate_count_supp", "move_umi_separator", "everything")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_dup_inputs(str(tmp_path_factory.mktemp("dup")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("markdup", inputs, MARKDUP)


def _check(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("markdup", inputs, MARKDUP, case), want[case],
               case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case", sorted(MARKDUP))
def test_markdup_equals_jax_tool(inputs, want, case):
    _check(inputs, want, case)


@pytest.mark.parametrize("case", STREAMED)
def test_small_stream_windows_keep_the_bytes(inputs, want, monkeypatch,
                                             case):
    """64 KiB windows: many batches, each held until final, hash entries
    evicted at the frontier, chains and key windows cut between them."""
    monkeypatch.setenv("SAMTPU_MARKDUP_WINDOW", "65536")
    _check(inputs, want, case)


def test_fixture_exercises_every_branch(inputs, want):
    """The stats of the fixture's runs count what each case is for:
    optical pair and single duplicates, non-primary (``-S``) ones, read
    groups, and the excluded QC-failed reads that ``--include-fails``
    examines."""
    def stats(case):
        text = want[case][0][2]
        return {k: int(v) for k, _, v in (ln.partition(": ")
                                          for ln in text.splitlines())
                if v.isdigit()}
    opt = stats("optical")
    assert opt["DUPLICATE PAIR OPTICAL"] > 100
    assert opt["DUPLICATE SINGLE OPTICAL"] > 10
    assert opt["DUPLICATE PAIR"] > opt["DUPLICATE PAIR OPTICAL"]
    supp = stats("supp")
    assert supp["DUPLICATE NON PRIMARY"] > 50
    assert stats("include_fails")["EXAMINED"] > stats("stats")["EXAMINED"]
    assert stats("barcode_name")["DUPLICATE PAIR"] \
        < stats("stats")["DUPLICATE PAIR"]
    assert "READ GROUP: grpB" in want["read_groups"][0][2]
    assert "cannot decipher read name weird_name" in want["optical"][0][2]


def test_spill_leaves_nothing_behind(inputs, monkeypatch, tmp_path):
    """``-S`` to standard output spills into a private directory under
    the temporary directory; it is gone after the run, on success and on
    an error (no MC tag)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for src, want_rc in (("dup", 0), ("dup_nomc", 1)):
        raw = io.BytesIO()
        out = io.TextIOWrapper(raw, encoding="latin-1", write_through=True)
        err = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["markdup", "-S", "--output-fmt", "sam",
                           inputs[src], "-"])
        assert rc == want_rc, err.getvalue()
        assert raw.getvalue().startswith(b"@HD") == (rc == 0)
    assert "no MC tag" in err.getvalue()
    assert os.listdir(tmp_path) == []


def test_cram_output_fails_as_in_jax_tool(inputs):
    """Neither package streams CRAM: both raise the same error before
    any output."""
    from samtools_tpu_torch.io.files import FormatError
    with pytest.raises(FormatError,
                       match="streaming output not supported for cram"):
        run_port_full("markdup", ["--output-fmt", "cram", inputs["dup"],
                                  os.path.join(inputs["dir"], "m.cram")])
    rc, out, err = run_jax_full("markdup", [
        "--output-fmt", "cram", inputs["dup"],
        os.path.join(inputs["dir"], "m.cram")])
    assert rc == 1 and out == b""
    assert err.rstrip().endswith(
        "FormatError: streaming output not supported for cram")


@pytest.mark.parametrize("value", [0, 1, 255, 256, 65535, 65536, -1, -128,
                                   -129, -32769, 2 ** 32 - 1])
def test_int_tag_updater_equals_jax(value):
    """update_int_tag picks the JAX package's smallest type (the dc
    widths of 1, 255, 256 and 65,536 among them) and splices the field
    in place, or appends it."""
    from samtools_tpu.core import aux as jaux
    rng = np.random.default_rng(value & 0xFFFF)
    for blob in (b"", aux_blob(rng) + b"dcC\x05" + aux_blob(rng),
                 aux_blob(rng)):
        buf = np.frombuffer(blob, np.uint8)
        got = auxmod.update_int_tag(buf, "dc", value)
        assert bytes(got) == bytes(jaux.update_int_tag(buf, "dc", value))
        assert auxmod.get_value(got, "dc")[1] == value


def test_str_tag_updater_and_find_tag_equal_jax():
    """update_str_tag and find_tag on fields of every type: the same
    spans and bytes as the JAX package's."""
    from samtools_tpu.core import aux as jaux
    rng = np.random.default_rng(19)
    for k in range(200):
        blob = aux_blob(rng)
        if k % 3 == 0:
            blob += b"doZ" + b"name%d" % k + b"\0"
        if k % 4 == 0:
            blob = b"dtZSQ\0" + blob
        buf = np.frombuffer(blob, np.uint8)
        for tag in ("do", "dt", "NM", "XA", "BC", "XZ", "Bc"):
            assert auxmod.find_tag(buf, tag) == jaux.find_tag(buf, tag)
        for tag, val in (("do", "SIM:1:FC1:1:1101:5:7"), ("dt", "LB"),
                         ("RX", "")):
            got = auxmod.update_str_tag(buf, tag, val)
            assert bytes(got) == bytes(jaux.update_str_tag(buf, tag, val))
    assert bytes(auxmod.update_int_tag(
        np.frombuffer(b"dcS" + struct.pack("<H", 300), np.uint8), "dc",
        2)) == b"dcC\x02"
