"""``python -m samtools_tpu_torch collate`` and ``fixmate`` against
``python -m samtools_tpu``, on the CPU: one parity test over each
command's table of cases, each run by the port in-process with the JAX
tool's argument list (``torch_tool_fixtures.check_case``; BGZF outputs
are the bytes of the JAX tool's zlib run).

Inputs are ``torch_tool_fixtures.make_prep_inputs``'s: the pairs
(coordinate-sorted, and collated into ``grouped``), ``general`` and its
name-sorted ``gname``, and ``broken``, ``gname`` with what ``-z``
repairs.  The streamed paths also run in 64 KiB stream windows, which
cut templates across batches: the bytes stay the same.  No case launches
a kernel.
"""

import pytest
from torch_tool_fixtures import (check_case, jax_case_runs, make_prep_inputs,
                                 run_port_case)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.tools import collate_cmd, fixmate_cmd

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
COLLATE = {
    "prefix": (["{pairs}", "{o}/pre"], None),
    "output": (["-o", "{o}/c.bam", "{pairs}"], None),
    "stdout": (["-O", "{general}"], None),
    "stdout_sam": (["-O", "--output-fmt", "sam", "{general}"], None),
    "fast": (["-f", "-o", "{o}/c.bam", "{pairs}"], None),
    "fast_ring": (["-f", "-r", "50", "-o", "{o}/c.sam", "{pairs}"], None),
    "fast_tiny_ring": (["-f", "-r", "1", "-n", "8", "-O", "--output-fmt",
                        "sam", "{general}"], None),
    "buckets": (["-n", "3", "-o", "{o}/c.bam", "{general}"], None),
    "level": (["-l", "2", "-o", "{o}/c.bam", "{pairs}"], None),
    "uncompressed": (["-u", "{general}", "{o}/pre"], None),
    "no_pg": (["--no-PG", "-O", "--output-fmt", "sam", "{general}"], None),
    "threads": (["-@", "2", "-o", "{o}/c.bam", "{pairs}"], None),
    "prefix_sam": (["--output-fmt", "sam", "{pairs}", "{o}/pre"], None),
    "samgz_output": (["-o", "{o}/c.sam.gz", "{general}"], None),
    "cram_output": (["--output-fmt", "cram", "--reference", "{fa}", "-o",
                     "{o}/c.cram", "{grouped2k}"], None),
    "sam_input": (["-o", "{o}/c.bam", "{general_sam}"], None),
    "fast_sam_input": (["-f", "-O", "--output-fmt", "sam",
                        "{general_samgz}"], None),
    "cram_input": (["-O", "--output-fmt", "sam", "{grouped_cram}"], None),
    "stdin": (["-O", "-"], "pairs"),
    "stdin_fast": (["-f", "-O", "-"], "general"),
    "no_prefix": (["{pairs}"], None),
    "no_arguments": ([], None),
    "missing": (["-O", "{dir}/none.bam"], None),
    "bad_option": (["--no-such", "{pairs}"], None),
}

FIXMATE = {
    "default": (["{grouped}", "{o}/f.bam"], None),
    "mate_score": (["-m", "{grouped}", "{o}/f.bam"], None),
    "template_cigar": (["-c", "{grouped}", "{o}/f.bam"], None),
    "every_option": (["-r", "-p", "-c", "-m", "{gname}", "{o}/f.sam"],
                     None),
    "remove": (["-r", "{gname}", "{o}/f.bam"], None),
    "no_proper_pair_check": (["-p", "{gname}", "{o}/f.sam"], None),
    "sanitize_default": (["{broken}", "{o}/f.sam"], None),
    "sanitize_on_cigarx": (["-z", "on,cigarx", "-r", "{broken}",
                            "{o}/f.sam"], None),
    "sanitize_words": (["--sanitize", "pos,mqual,unmap,cigar,aux,cigdup",
                        "-m", "{broken}", "{o}/f.bam"], None),
    "sanitize_pos_only": (["-z", "pos", "-c", "{broken}", "{o}/f.sam"],
                          None),
    "sanitize_off": (["--sanitize", "off", "-u", "{broken}", "{o}/f.bam"],
                     None),
    "sanitize_bad": (["-z", "bogus", "{gname}", "{o}/f.bam"], None),
    "no_pg": (["--no-PG", "{grouped}", "{o}/f.bam"], None),
    "threads": (["-@", "2", "-m", "{grouped}", "{o}/f.bam"], None),
    "stdout_sam": (["-O", "sam", "{gname}", "-"], None),
    "stdout_default": (["{gname}"], None),
    "samgz_output": (["{grouped}", "{o}/f.sam.gz"], None),
    "cram_output": (["-O", "cram", "--reference", "{fa}", "-m",
                     "{grouped2k}", "{o}/f.cram"], None),
    "stdin": (["-m", "-", "{o}/f.bam"], "grouped"),
    "sam_input": (["-c", "{grouped_sam}", "{o}/f.bam"], None),
    "cram_input": (["-m", "{grouped_cram}", "{o}/f.bam"], None),
    "coordinate_sorted": (["{general}", "{o}/f.bam"], None),
    "missing": (["{dir}/none.bam", "{o}/f.bam"], None),
    "no_arguments": ([], None),
    "bad_option": (["--no-such", "{grouped}", "{o}/f.bam"], None),
}

# cases that stream a BAM path, run again in 64 KiB stream windows
COLLATE_STREAMED = ("output", "fast", "fast_ring", "fast_tiny_ring",
                    "buckets", "samgz_output")
FIXMATE_STREAMED = ("default", "mate_score", "template_cigar",
                    "every_option", "sanitize_default", "samgz_output",
                    "cram_output")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_prep_inputs(str(tmp_path_factory.mktemp("prep")))


@pytest.fixture(scope="module")
def want(inputs):
    return {"collate": jax_case_runs("collate", inputs, COLLATE),
            "fixmate": jax_case_runs("fixmate", inputs, FIXMATE)}


def _check(inputs, want, cmd, cases, case):
    kernels.reset_launches()
    check_case(run_port_case(cmd, inputs, cases, case), want[cmd][case],
               case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case", sorted(COLLATE))
def test_collate_equals_jax_tool(inputs, want, case):
    _check(inputs, want, "collate", COLLATE, case)


@pytest.mark.parametrize("case", sorted(FIXMATE))
def test_fixmate_equals_jax_tool(inputs, want, case):
    _check(inputs, want, "fixmate", FIXMATE, case)


@pytest.mark.parametrize("cmd,case", [("collate", c)
                                      for c in COLLATE_STREAMED]
                         + [("fixmate", c) for c in FIXMATE_STREAMED])
def test_small_stream_windows_keep_the_bytes(inputs, want, monkeypatch,
                                             cmd, case):
    """64 KiB stream windows: many batches, templates cut between them
    (fixmate carries the cut template into the next batch)."""
    monkeypatch.setenv("SAMTPU_STREAM_WINDOW", "65536")
    _check(inputs, want, cmd, COLLATE if cmd == "collate" else FIXMATE,
           case)


@pytest.mark.parametrize("cmd,case", [("collate", "output"),
                                      ("collate", "fast"),
                                      ("fixmate", "default"),
                                      ("fixmate", "every_option")])
def test_refused_stream_reads_the_whole_file(inputs, want, monkeypatch,
                                             cmd, case):
    """A BAM the stream refuses is read whole, with the same bytes."""
    mod = collate_cmd if cmd == "collate" else fixmate_cmd
    monkeypatch.setattr(mod, "open_stream", lambda *a: None)
    _check(inputs, want, cmd, COLLATE if cmd == "collate" else FIXMATE,
           case)
