"""``python -m samtools_tpu_torch sort`` against ``python -m samtools_tpu
sort``, on the CPU: one parity test over a table of cases, each run by
the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``: exit code, stdout, stderr and every
file written; BGZF outputs are the bytes of the JAX tool's zlib run,
``SAMTPU_NO_NATIVE=1``).

Inputs are ``torch_tool_fixtures.make_prep_inputs``'s.  Spilled runs
(``-m`` below the input's size, ``-T`` under the case's directory, so
the temporary names stay out of stderr) must also write the in-memory
run's bytes, spill to four runs or more and leave no temporary file;
the streamed and whole-file paths are each pinned.  No case launches a
kernel.
"""

import os

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_prep_inputs,
                                 run_jax_full, run_port_full, run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.io import bgzf
from samtools_tpu_torch.tools import sort_cmd

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    # orders
    "coordinate": (["-o", "{o}/s.bam", "{general}"], None),
    "stdout_bam": (["{general}"], None),
    "name": (["-n", "-o", "{o}/s.bam", "{general}"], None),
    "name_ascii": (["-N", "-O", "sam", "{general}"], None),
    "tag": (["-t", "RG", "-o", "{o}/s.bam", "{general}"], None),
    "tag_then_name": (["-n", "-t", "NM", "-O", "sam", "{general}"], None),
    "tag_then_name_ascii": (["-N", "-t", "XI", "-O", "sam", "{general}"],
                            None),
    "template": (["--template-coordinate", "-o", "{o}/s.bam", "{mc}"],
                 None),
    "template_without_mc": (["--template-coordinate", "-o", "{o}/s.bam",
                             "{general}"], None),
    "template_stdin_without_mc": (["--template-coordinate", "-O", "sam",
                                   "-"], "general"),
    "minhash": (["-M", "-o", "{o}/s.bam", "{unplaced}"], None),
    "minhash_forward_squash": (["-M", "-R", "-H", "-K", "15", "-O", "sam",
                                "{unplaced}"], None),
    "minhash_index": (["-I", "{fa}", "-w", "50", "-O", "sam",
                       "{unplaced}"], None),
    "minhash_index_squash": (["-M", "-I", "{fa}", "-H", "-K", "12", "-o",
                              "{o}/s.bam", "{unplaced}"], None),
    "minhash_mapped": (["-M", "-O", "sam", "{general}"], None),
    # the spill sorter
    "spill": (["-m", "100K", "-T", "{o}/tmp", "-o", "{o}/s.bam",
               "{general}"], None),
    "spill_name": (["-n", "-m", "100K", "-T", "{o}/tmp", "-o",
                    "{o}/s.bam", "{general}"], None),
    "spill_tag": (["-t", "XI", "-m", "100K", "-T", "{o}/tmp", "-O", "sam",
                   "{general}"], None),
    "spill_template": (["--template-coordinate", "-m", "300K", "-T",
                        "{o}/tmp", "-o", "{o}/s.bam", "{mc}"], None),
    "spill_threads": (["-@", "2", "-m", "50K", "-T", "{o}/tmp", "-o",
                       "{o}/s.sam.gz", "{general}"], None),
    "memory_suffix": (["-m", "1G", "-O", "sam", "{general}"], None),
    "memory_bad": (["-m", "lots", "{general}"], None),
    # output forms
    "uncompressed": (["-u", "-o", "{o}/s.bam", "{general}"], None),
    "level": (["-l", "1", "-o", "{o}/s.bam", "{general}"], None),
    "no_pg": (["--no-PG", "-O", "sam", "{general}"], None),
    "write_index": (["--write-index", "-o", "{o}/s.bam", "{general}"],
                    None),
    "write_index_whole_file": (["--write-index", "-o", "{o}/s.bam",
                                "{general_sam}"], None),
    "threads": (["-@", "3", "-o", "{o}/s.bam", "{general}"], None),
    "sam_output": (["-o", "{o}/s.sam", "{general}"], None),
    "samgz_output": (["-o", "{o}/s.sam.gz", "{general}"], None),
    "cram_output": (["-O", "cram", "--reference", "{fa}", "-o",
                     "{o}/s.cram", "{grouped2k}"], None),
    "cram_output_31": (["--output-fmt", "cram,version=3.1", "--reference",
                        "{fa}", "-n", "-o", "{o}/s.cram", "{grouped2k}"],
                       None),
    # inputs
    "stdin": (["-O", "sam", "-"], "general"),
    "stdin_name": (["-n", "-o", "{o}/s.bam", "-"], "grouped"),
    "sam_input": (["-n", "-o", "{o}/s.bam", "{general_sam}"], None),
    "samgz_input": (["-O", "sam", "{general_samgz}"], None),
    "cram_input": (["-O", "sam", "{grouped_cram}"], None),
    "verbosity": (["--verbosity", "2", "-O", "sam", "{general}"], None),
    # exits
    "too_many_arguments": (["{general}", "{o}/out"], None),
    "missing": (["{dir}/none.bam"], None),
    "bad_option": (["--no-such", "{general}"], None),
}

# order options whose spilled run is held to the in-memory run
SPILLED = {"coordinate": (["{general}"], "100K"),
           "name": (["-n", "{general}"], "100K"),
           "name_ascii": (["-N", "{general}"], "100K"),
           "tag": (["-t", "XI", "{general}"], "100K"),
           "tag_then_name": (["-n", "-t", "RG", "{general}"], "100K"),
           "template": (["--template-coordinate", "{mc}"], "300K")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_prep_inputs(str(tmp_path_factory.mktemp("sort")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("sort", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("sort", inputs, CASES, case), want[case], case)
    assert not any(kernels.launches.values())


def _port(inputs, argv):
    """The port's sort in-process; (exit code, stderr, {file: bytes})."""
    got = run_port_case("sort", inputs, {"run": (argv, None)}, "run")
    return got[0], got[2], got[3]


@pytest.mark.parametrize("order", sorted(SPILLED))
def test_spilled_sort_equals_in_memory_sort(inputs, order):
    """``-m`` spills four runs or more, writes the in-memory run's bytes
    and leaves nothing but the output in the directory of its ``-T``
    prefix."""
    args, mem = SPILLED[order]
    rc, err, whole = _port(inputs, ["--no-PG", "-o", "{o}/s.bam"] + args)
    assert (rc, err) == (0, "")
    rc, err, spilled = _port(inputs, [
        "--no-PG", "--verbosity", "4", "-m", mem, "-T", "{o}/tmp", "-o",
        "{o}/s.bam"] + args)
    assert rc == 0
    runs = int(err.split("[I::sort] merging from ")[1].split()[0])
    assert runs >= 4, err
    assert sorted(spilled) == ["s.bam"]
    assert spilled == whole


@pytest.mark.parametrize("case,streamed", [
    ("coordinate", True), ("spill_name", True), ("template", True),
    ("spill_threads", True), ("sam_input", False), ("stdin", False),
    ("cram_output", False), ("cram_input", False), ("minhash", False)])
def test_sort_takes_the_jax_tool_path(inputs, want, monkeypatch, case,
                                      streamed):
    """BAM paths into BAM, SAM or sam.gz go through the spill sorter;
    SAM or CRAM input, CRAM output, standard input and ``-M`` read the
    whole file.  Either way the bytes are the JAX tool's."""
    seen = []
    real = sort_cmd._try_external_sort

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    monkeypatch.setattr(sort_cmd, "_try_external_sort", spy)
    check_case(run_port_case("sort", inputs, CASES, case), want[case], case)
    assert (bool(seen) and seen[0] is not None) == streamed


@pytest.mark.parametrize("case", ["coordinate", "spill_name", "tag",
                                  "template"])
def test_refused_stream_reads_the_whole_file(inputs, want, monkeypatch,
                                             case):
    """A BAM the stream refuses (``open_stream`` gives None, as for a file
    that is not BGZF) takes the whole-file path, with the same bytes."""
    monkeypatch.setattr(sort_cmd, "open_stream", lambda *a: None)
    check_case(run_port_case("sort", inputs, CASES, case), want[case], case)


def test_spill_files_are_removed_when_the_merge_fails(inputs, monkeypatch,
                                                      tmp_path):
    """A write that fails mid-merge exits 1 and leaves no spill run."""
    def fail(self, batch):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(sort_cmd.StreamingWriter, "write_batch", fail)
    rc, err, files = _port(inputs, ["-m", "100K", "-T", str(tmp_path / "t"),
                                    "-o", "{o}/s.bam", "{general}"])
    assert rc == 1
    assert "failed writing to" in err and "No space left" in err
    assert os.listdir(tmp_path) == []


def test_corrupt_block_gives_the_jax_tool_error_line(inputs, tmp_path):
    """A BGZF block that does not inflate (the fifth of ``general``, one
    byte of its deflate stream flipped) stops the streamed sort with the
    JAX tool's one error line and exit code (its zlib run: the default
    run's libdeflate words the error its own way), not a traceback."""
    with open(inputs["general"], "rb") as f:
        data = bytearray(f.read())
    coffs, _ = bgzf.scan_blocks(bytes(data))
    data[int(coffs[4]) + 18] ^= 0xFF
    bad = str(tmp_path / "bad.bam")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    want = run_jax_full("sort", ["-o", str(tmp_path / "jax.bam"), bad],
                        {"SAMTPU_NO_NATIVE": "1"})
    got = run_port_full("sort", ["-o", str(tmp_path / "port.bam"), bad])
    assert got[0] == want[0] == 1
    assert got[1] == want[1] == b""
    assert got[2] == want[2]
    assert got[2].startswith("samtools sort: error while sorting: ")
    assert len(got[2].splitlines()) == 1
    assert os.path.exists(tmp_path / "jax.bam") == \
        os.path.exists(tmp_path / "port.bam")
