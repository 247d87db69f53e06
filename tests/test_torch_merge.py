"""``python -m samtools_tpu_torch merge`` against ``python -m samtools_tpu
merge``, on the CPU: one parity test over a table of cases, each run by
the port in-process with the JAX tool's argument list
(``torch_tool_fixtures.check_case``; BGZF outputs are the bytes of the
JAX tool's zlib run).

Inputs are ``torch_tool_fixtures.make_prep_inputs``'s: two sorted halves
whose @RG and @PG IDs collide, so every case that does not combine them
passes ``-s`` (the default seed is the clock).  The streamed merge and
the whole-file merge are each pinned, and a streamed merge equals the
whole-file one.  No case launches a kernel.
"""

import pytest
from torch_tool_fixtures import (case_dir, check_case, jax_case_runs,
                                 make_prep_inputs, run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.tools import merge_cmd

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    # orders
    "coordinate": (["-s", "7", "-o", "{o}/m.bam", "{ha}", "{hb}"], None),
    "output_positional": (["-s", "7", "{o}/m.bam", "{ha}", "{hb}"], None),
    "three_inputs": (["-s", "7", "-o", "{o}/m.bam", "{ha}", "{hb}", "{ha}"],
                     None),
    "name": (["-n", "-s", "1", "-o", "{o}/m.bam", "{na}", "{nb}"], None),
    "name_ascii": (["-N", "-s", "1", "-O", "sam", "-o", "-", "{na}",
                    "{nb}"], None),
    "tag": (["-t", "NM", "-s", "1", "-O", "sam", "-o", "-", "{ha}", "{hb}"],
            None),
    "tag_then_name": (["-n", "-t", "RG", "-s", "1", "-o", "{o}/m.bam",
                       "{na}", "{nb}"], None),
    "template": (["--template-coordinate", "-s", "1", "-o", "{o}/m.bam",
                  "{mc}", "{mc}"], None),
    # headers
    "combine": (["-c", "-p", "-o", "{o}/m.sam", "{ha}", "{hb}"], None),
    "combine_rg": (["-c", "-s", "3", "-O", "sam", "-o", "-", "{ha}", "{hb}"],
                   None),
    "combine_pg": (["-p", "-s", "3", "-O", "sam", "-o", "-", "{ha}",
                    "{hb}"], None),
    "attach_rg": (["-r", "-s", "3", "-O", "sam", "-o", "-", "{ha}", "{hb}"],
                  None),
    "attach_rg_whole_file": (["-r", "-c", "-p", "-o", "{o}/m.bam", "{ha}",
                              "{general_sam}"], None),
    "unknown_read_group": (["-s", "1", "-O", "sam", "-o", "-", "{norg}",
                            "{hb}"], None),
    "header_file": (["-h", "{hdr}", "-s", "1", "-1", "-o", "{o}/m.bam",
                     "{ha}", "{hb}"], None),
    "header_file_missing": (["-h", "{dir}/none.sam", "-o", "{o}/m.bam",
                             "{ha}"], None),
    # selections
    "region": (["-R", "sim1:1000-30000", "-s", "1", "-o", "{o}/m.bam",
                "{ha}", "{hb}"], None),
    "region_contig": (["-R", "sim2", "-s", "1", "-O", "sam", "-o", "-",
                       "{ha}", "{hb}"], None),
    "region_bad": (["-R", "nope:1-5", "-s", "1", "-o", "{o}/m.bam", "{ha}",
                    "{hb}"], None),
    "bed": (["-L", "{bed}", "-s", "1", "-o", "{o}/m.bam", "{ha}", "{hb}"],
            None),
    # input lists
    "list": (["-b", "{list}", "-s", "1", "-u", "-o", "{o}/m.bam"], None),
    "list_and_arguments": (["-b", "{list}", "-s", "1", "-o", "{o}/m.bam",
                            "{ha}"], None),
    "list_missing": (["-b", "{dir}/none.txt", "-o", "{o}/m.bam"], None),
    "index_files": (["-X", "-s", "1", "-o", "{o}/m.bam", "{ha}", "{hb}",
                     "{ha}.bai", "{hb}.bai"], None),
    # output forms
    "level": (["-l", "3", "-s", "1", "-o", "{o}/m.bam", "{ha}", "{hb}"],
              None),
    "uncompressed": (["-u", "-s", "1", "-o", "{o}/m.bam", "{ha}", "{hb}"],
                     None),
    "no_pg": (["--no-PG", "-s", "7", "-o", "{o}/m.bam", "{ha}", "{hb}"],
              None),
    "threads": (["-@", "2", "-s", "1", "-o", "{o}/m.bam", "{ha}", "{hb}"],
                None),
    "write_index": (["--write-index", "-s", "1", "-o", "{o}/m.bam", "{ha}",
                     "{hb}"], None),
    "sam_output": (["-s", "1", "-o", "{o}/m.sam", "{ha}", "{hb}"], None),
    "samgz_output": (["-s", "1", "-o", "{o}/m.sam.gz", "{ha}", "{hb}"],
                     None),
    "cram_output": (["-O", "cram", "--reference", "{fa}", "-s", "1", "-o",
                     "{o}/m.cram", "{grouped_cram}", "{grouped_cram}"],
                    None),
    # inputs
    "sam_input": (["-s", "1", "-o", "{o}/m.bam", "{ha}", "{general_sam}"],
                  None),
    "samgz_input": (["-s", "1", "-O", "sam", "-o", "-", "{general_samgz}",
                     "{hb}"], None),
    "cram_input": (["-s", "1", "-O", "sam", "-o", "-", "{grouped_cram}",
                    "{general_cram}"], None),
    "stdin": (["-s", "1", "-o", "{o}/m.bam", "{ha}", "-"], "hb"),
    # exits
    "exists": (["-s", "1", "-o", "{ha}", "{ha}", "{hb}"], None),
    "missing": (["-o", "{o}/m.bam", "{dir}/none.bam"], None),
    "no_inputs": (["-o", "{o}/m.bam"], None),
    "no_arguments": ([], None),
    "bad_option": (["--no-such", "{ha}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_prep_inputs(str(tmp_path_factory.mktemp("merge")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("merge", inputs, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("merge", inputs, CASES, case), want[case], case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case,streamed", [
    ("coordinate", True), ("three_inputs", True), ("attach_rg", True),
    ("list", True), ("samgz_output", True), ("name", False),
    ("tag", False), ("region", False), ("bed", False),
    ("write_index", False), ("cram_output", False), ("sam_input", False),
    ("stdin", False)])
def test_merge_takes_the_jax_tool_path(inputs, want, monkeypatch, case,
                                       streamed):
    """A coordinate merge of BGZF BAMs into BAM, SAM or sam.gz streams;
    other orders, regions, ``--write-index``, CRAM output and inputs that
    are not BGZF BAM read every file whole.  Either way the JAX tool's
    bytes."""
    seen = []
    real = merge_cmd._merge_streamed

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)
    monkeypatch.setattr(merge_cmd, "_merge_streamed", spy)
    check_case(run_port_case("merge", inputs, CASES, case), want[case], case)
    assert bool(seen) == streamed


@pytest.mark.parametrize("case", ["coordinate", "attach_rg", "samgz_output",
                                  "unknown_read_group"])
def test_refused_streams_merge_whole_files(inputs, want, monkeypatch, case):
    """Inputs the stream refuses take the whole-file merge: the same
    bytes and warnings."""
    monkeypatch.setattr(merge_cmd, "open_stream", lambda *a: None)
    check_case(run_port_case("merge", inputs, CASES, case), want[case], case)


def test_force_overwrites_the_output(inputs, want):
    """``-f`` replaces an existing output with the merge's bytes."""
    with open(case_dir(inputs, "merge", "f") + "/m.bam", "wb") as f:
        f.write(b"old")
    rc, out, err, files = run_port_case("merge", inputs, {"f": ([
        "-f", "--no-PG", "-s", "7", "-o", "{o}/m.bam", "{ha}", "{hb}"],
        None)}, "f")
    assert (rc, out, err) == (0, b"", "")
    check_case((rc, out, err, files), want["no_pg"], "force")
