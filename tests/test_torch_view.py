"""``python -m samtools_tpu_torch view`` against ``python -m samtools_tpu
view``, on the CPU: one parity test over a table of cases, each run by
the port in-process with the JAX tool's argument list.

Text outputs (SAM, counts, stderr) must be the JAX tool's bytes.  The
port's BGZF is Python's zlib: a BAM or gzip'd SAM (on standard output or
in a file) must be the bytes of the JAX tool run with
``SAMTPU_NO_NATIVE=1`` (its zlib path), and, against its default run
(libdeflate), the same blocks' uncompressed sizes and bytes.  CRAM
outputs and indexes are held the same way (a BAI's virtual offsets are
the zlib run's).  The exit code and stderr are
the default run's; a malformed ``-e`` expression or a record the CRAM
writer cannot hold raises the JAX tool's exception.

Inputs are ``torch_tool_fixtures.make_view_inputs``'s (pairs with every
aux type, two contigs, unmapped reads, read groups with libraries).
``STREAMED`` cases also run with the stream path forced off (the
whole-file path) and with small stream windows: the bytes stay the
same.  No case launches a kernel.
"""

import os

import numpy as np
import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_view_inputs,
                                 run_jax_full, run_port_case, run_port_full)

from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.tools import view_cmd

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    # output forms
    "sam": (["{general}"], None),
    "sam_header": (["-h", "{general}"], None),
    "header_only": (["-H", "{general}"], None),
    "header_only_bam": (["-H", "-b", "{general}"], None),
    "header_only_stdin": (["-H", "-"], "general"),
    "no_header": (["-h", "--no-header", "{general}"], None),
    "count": (["-c", "{general}"], None),
    "count_to_file": (["-c", "-o", "{o}/n.txt", "-F", "4", "{general}"],
                      None),
    "save_counts": (["--save-counts", "{o}/n.txt", "-q", "20",
                     "{general}"], None),
    "bam": (["-b", "{general}"], None),
    "uncompressed": (["-u", "{general}"], None),
    "fast": (["-1", "{general}"], None),
    "level_option": (["-O", "bam,level=2", "{general}"], None),
    "samgz": (["-O", "sam.gz", "-h", "{general}"], None),
    "cram_reference": (["-C", "-T", "{fa}", "{messy}"], None),
    "cram_31": (["-O", "cram,version=3.1", "-T", "{fa}", "{messy}"], None),
    "cram_21_to_file": (["-O", "cram,version=2.1", "--reference", "{fa}",
                         "-o", "{o}/x.cram", "{messy}"], None),
    "cram_no_reference": (["-C", "{messy}"], None),
    "out_bam_by_name": (["-o", "{o}/out.bam", "{general}"], None),
    "out_samgz_by_name": (["-o", "{o}/out.sam.gz", "{general}"], None),
    "unoutput": (["-q", "30", "-o", "{o}/sel.sam", "-U", "{o}/un.sam",
                  "{general}"], None),
    "unoutput_bam": (["-b", "-q", "30", "-o", "{o}/sel.bam", "-U",
                      "{o}/un.bam", "{general}"], None),
    "unmap": (["-p", "-q", "30", "-o", "{o}/p.sam", "{general}"], None),
    "write_index": (["--write-index", "-b", "-o", "{o}/wi.bam",
                     "{general}"], None),
    "write_index_cram": (["--write-index", "-C", "-T", "{fa}", "-o",
                          "{o}/wi.cram", "{messy}"], None),
    "threads": (["-@", "4", "-b", "{general}"], None),
    # regions
    "region_indexed": (["{indexed}", "sim1:17000-18000"], None),
    "region_indexed_bam": (["-b", "{indexed}", "sim1:17000-18000"], None),
    "region_unindexed": (["{unidx}", "sim1:17000-18000"], None),
    "region_contig": (["-c", "{indexed}", "sim1"], None),
    "regions_several": (["{general}", "sim1:1000-2000", "sim2",
                         "sim1:30000-31000"], None),
    "regions_several_indexed": (["{indexed}", "sim1:17000-17500",
                                 "sim1:20000-20500"], None),
    "region_unmapped": (["{general}", "*"], None),
    "region_everything": (["-c", "{general}", "."], None),
    "use_index": (["-M", "{indexed}", "sim1:17000-17500",
                   "sim1:20000-20500"], None),
    "region_file": (["--region-file", "{bed2}", "{indexed}"], None),
    "targets": (["-L", "{bed}", "{general}"], None),
    "targets_use_index": (["-M", "-L", "{bed}", "{indexed}"], None),
    "fetch_pairs": (["-P", "{indexed}", "sim1:17000-17200"], None),
    # filters
    "require_flags": (["-f", "0x40", "{general}"], None),
    "exclude_flags": (["-F", "UNMAP,REVERSE", "{general}"], None),
    "include_flags": (["--rf", "0x100,0x80", "{general}"], None),
    "exclude_all_flags": (["-G", "0x50", "{general}"], None),
    "min_mapq": (["-q", "30", "{general}"], None),
    "min_qlen": (["-m", "101", "{general}"], None),
    "library": (["-l", "libB", "{general}"], None),
    "read_group": (["-r", "grpA", "{general}"], None),
    "read_group_file": (["-R", "{rgfile}", "{general}"], None),
    "qname_file": (["-N", "{qnames}", "{general}"], None),
    "tag": (["-d", "XI", "{general}"], None),
    "tag_value": (["-d", "RG:grpC", "{general}"], None),
    "tag_file": (["-D", "NM:{tagvals}", "{general}"], None),
    "no_read_group": (["-n", "-c", "{general}"], None),
    "expr": (["-e", "pos > 10000 && length(seq) >= 100 && [NM] > 1",
              "{general}"], None),
    "expr_count": (["-c", "-q", "30", "-F", "0x10", "-e",
                    "pos > 1000 && length(seq) >= 100", "{general}"], None),
    "subsample": (["-s", "7.25", "{general}"], None),
    "subsample_count": (["-s", "7.25", "-c", "{general}"], None),
    "subsample_auto_seed": (["--subsample", "0.3", "{general}"], None),
    "subsample_seed": (["--subsample", "0.4", "--subsample-seed", "11",
                        "{general}"], None),
    "subsample_zero_seed": (["-s", "0.5", "{general}"], None),
    # transforms
    "add_flags": (["--add-flags", "DUP,0x200", "{general}"], None),
    "remove_flags": (["--remove-flags", "PAIRED", "{general}"], None),
    "remove_tags": (["-x", "XA,XZ", "-x", "NM", "{general}"], None),
    "keep_tags_caret": (["-x", "^RG,NM", "{general}"], None),
    "keep_tags": (["--keep-tag", "XB,BC", "{general}"], None),
    "remove_B": (["-B", "{general}"], None),
    "no_pg": (["--no-PG", "-h", "{general}"], None),
    "sanitize_ignored": (["-z", "on", "-t", "{fa}", "-h", "{general}"],
                         None),
    # inputs
    "stdin": (["-h", "-"], "general"),
    "stdin_bam": (["-b", "-"], "general"),
    "sam_input": (["-h", "{general_sam}"], None),
    "samgz_input": (["-b", "{general_samgz}"], None),
    "cram_input": (["-h", "{general_cram}"], None),
    "cram_input_reference": (["-T", "{fa}", "{general_cram}"], None),
    "cram_input_region": (["{general_cram}", "sim1:1000-5000"], None),
    "cram_to_bam": (["-b", "{general_cram}"], None),
    # exits
    "bad_subsample": (["-s", "1", "{general}"], None),
    "bad_subsample_fraction": (["--subsample", "2", "{general}"], None),
    "unoutput_and_unmap": (["-U", "{o}/u.sam", "-p", "{general}"], None),
    "missing_file": (["{dir}/none.bam"], None),
    "bad_region": (["{general}", "nope:1-5"], None),
    "bad_option": (["--no-such", "{general}"], None),
    "help": (["-?"], None),
}
# cases whose run raises this exception in both packages
RAISES = {
    "bad_expression": (["-e", "pos >>> 3", "{general}"], "ExprError"),
    "unknown_function": (["-e", "foo(1)", "{general}"], "ExprError"),
    "cram_without_d_type": (["-C", "-T", "{fa}", "{general}"],
                            "CramError"),
}
# cases that take the stream path (a BAM path, no region, -U, -p, -P or
# --write-index)
# (not header_only: the JAX stream path prints no header for -H without
# -h, its whole-file path prints it; test_view_header_only_paths)
STREAMED = ("sam", "sam_header", "count", "save_counts",
            "bam", "uncompressed", "samgz", "out_bam_by_name",
            "out_samgz_by_name", "cram_reference", "require_flags",
            "min_mapq", "library", "tag_file", "expr", "expr_count",
            "subsample", "subsample_auto_seed", "keep_tags", "remove_B",
            "targets", "threads")


ALL = {**CASES, **{k: (v[0], None) for k, v in RAISES.items()}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_view_inputs(str(tmp_path_factory.mktemp("view")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("view", inputs, ALL)


def run_port(inputs, name):
    return run_port_case("view", inputs, ALL, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_view_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port(inputs, case), want[case], case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case", sorted(RAISES))
def test_view_raises_as_jax_tool(inputs, want, case):
    (rc, out, err, _), _ = want[case]
    kind = RAISES[case][1]
    assert rc == 1 and kind in err.strip().splitlines()[-1]
    with pytest.raises(Exception) as exc:
        run_port(inputs, case)
    assert type(exc.value).__name__ == kind
    assert err.strip().splitlines()[-1].endswith(f"{kind}: {exc.value}")


@pytest.mark.parametrize("case", STREAMED)
def test_view_paths_print_the_same_bytes(inputs, want, monkeypatch, case):
    """A streamed case through the whole-file path (BamStream refused),
    and through the stream in 64 KiB windows: the JAX tool's bytes."""
    def refuse(*a, **k):
        raise RuntimeError("stream refused")
    seen = []
    real = view_cmd._stream_view

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)
    monkeypatch.setattr(view_cmd, "_stream_view", spy)
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", "65536")
    check_case(run_port(inputs, case), want[case], case)
    assert seen == [1]
    monkeypatch.setattr(view_cmd, "BamStream", refuse)
    check_case(run_port(inputs, case), want[case], case)
    assert seen == [1]


def test_view_header_only_paths(inputs, want):
    """-H on a BAM path (the stream path) prints nothing and on standard
    input (the whole-file path) prints the header, as in the JAX tool."""
    assert want["header_only"][0][1] == b""
    assert want["header_only_stdin"][0][1].startswith(b"@HD\t")
    assert run_port(inputs, "header_only")[1] == b""


def test_streamed_and_whole_file_bam_are_byte_equal(inputs, tmp_path):
    """view -b streamed, and with -U (the whole-file path): the same
    bytes, which decode to the input's records."""
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    assert cli.main(["view", "--no-PG", "-b", "-o", a, inputs["general"]]) \
        == 0
    assert cli.main(["view", "--no-PG", "-b", "-o", b, "-U",
                     str(tmp_path / "u.bam"), inputs["general"]]) == 0
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    from samtools_tpu_torch.io.files import read_alignments
    x, y = read_alignments(a).batch, read_alignments(inputs["general"]).batch
    for col in ("flag", "pos", "aux", "aux_off", "seq", "qual", "cigar"):
        np.testing.assert_array_equal(getattr(x, col), getattr(y, col))


def test_inputs_cover_every_path(inputs, want):
    """The table reaches both paths and every error exit it names."""
    assert all(want[c][0][0] == 0 for c in STREAMED)
    assert [c for c in CASES if want[c][0][0] != 0] == [
        "bad_subsample", "bad_subsample_fraction", "unoutput_and_unmap",
        "missing_file", "bad_region", "bad_option"]


def test_bgzf_crc32_is_not_checked(inputs, tmp_path):
    """Neither package checks a BGZF block's CRC32: ``general`` with its
    middle byte XORed with 0xFF still inflates, ``view -c`` and
    ``flagstat`` print the JAX tool's bytes (2,455 reads), and ``sort``
    writes the bytes of the JAX tool's zlib run."""
    with open(inputs["general"], "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    bad = str(tmp_path / "crc.bam")
    with open(bad, "wb") as f:
        f.write(data)
    for cmd, args in (("view", ["-c", bad]), ("flagstat", [bad])):
        got = run_port_full(cmd, args)
        assert got == run_jax_full(cmd, args), cmd
    assert run_port_full("view", ["-c", bad])[1] == b"2455\n"
    out = str(tmp_path / "sorted.bam")
    sort = ["sort", "-o", out, bad]
    jrc, jout, jerr = run_jax_full(sort[0], sort[1:],
                                   {"SAMTPU_NO_NATIVE": "1"})
    with open(out, "rb") as f:
        want = f.read()
    os.remove(out)
    assert run_port_full(sort[0], sort[1:]) == (jrc, jout, jerr) == (
        0, b"", "")
    with open(out, "rb") as f:
        assert f.read() == want
