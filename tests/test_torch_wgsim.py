"""The port's ``wgsim`` and ``wgsim_eval`` against the JAX package's, on
the CPU: one parity test a command over its table of cases, both
packages run in-process (``torch_tool_fixtures.check_ancillary``: exit
code, standard error with the package name masked, the mutation report
on standard output and both FASTQs), and the port's ``Drand48`` against
the JAX class.

Every ``wgsim`` case passes ``-S``: a seed of 0 takes the clock.  Inputs
are ``torch_tool_fixtures.make_wgsim_inputs``'s; the SAMs wgsim_eval
reads are built from the JAX wgsim's own read names.  No case launches a
kernel.
"""

import re

import numpy as np
import pytest
from torch_tool_fixtures import (check_ancillary, make_wgsim_inputs,
                                 run_inproc, wgsim_reads)

from samtools_tpu_torch import kernels
from samtools_tpu_torch.tools import wgsim_cmd

_OUT = ["{o}/r1.fq", "{o}/r2.fq"]

# name -> (arguments, standard input); {x} names an input of the
# fixture, {o} the case's output directory
WGSIM = {
    "defaults": (["-S", "11", "-N", "400", "{ref}", *_OUT], None),
    "haplotype": (["-S", "12", "-N", "300", "-h", "-r", "0.01", "{ref}",
                   *_OUT], None),
    "no_errors": (["-S", "13", "-N", "300", "-e", "0", "{ref}", *_OUT],
                  None),
    "no_mutations": (["-S", "14", "-N", "300", "-r", "0", "{ref}", *_OUT],
                     None),
    "indels": (["-S", "15", "-N", "300", "-r", "0.02", "-R", "0.6", "-X",
                "0.7", "{ref}", *_OUT], None),
    "lengths": (["-S", "16", "-N", "250", "-1", "100", "-2", "36", "-d",
                 "300", "-s", "20", "{ref}", *_OUT], None),
    "ambiguous": (["-S", "17", "-N", "300", "-A", "0", "{refn}", *_OUT],
                  None),
    "ambiguous_loose": (["-S", "18", "-N", "300", "-A", "0.5", "-r",
                         "0.01", "{refn}", *_OUT], None),
    "ambiguous_default": (["-S", "19", "-N", "200", "{refn}", *_OUT],
                          None),
    "contigs": (["-S", "20", "-N", "500", "-r", "0.005", "{multi}",
                 *_OUT], None),
    "contigs_gzip": (["-S", "21", "-N", "200", "{multi_gz}", *_OUT],
                     None),
    "short_only": (["-S", "22", "-N", "100", "-d", "9000", "-s", "10",
                    "{multi}", *_OUT], None),
    "options_after": (["{ref}", *_OUT, "-S", "23", "-N", "100", "-e",
                       "0.05"], None),
    "bad_option": (["-S", "24", "-Q", "{ref}", *_OUT], None),
    "fast": (["--fast", "-S", "25", "{ref}", *_OUT], None),
    "too_few_files": (["-S", "26", "{ref}", "{o}/r1.fq"], None),
    "no_arguments": ([], None),
    "bad_number": (["-S", "27", "-N", "x", "{ref}", *_OUT], None),
    "missing_reference": (["-S", "28", "{dir}/none.fa", *_OUT], None),
}
EVAL = {
    "alneval": (["alneval", "{sam}"], None),
    "alneval_print": (["alneval", "-p", "{sam}"], None),
    "alneval_coords": (["alneval", "-c", "-g", "20", "{sam}"], None),
    "alneval_roc": (["alneval", "-a", "{sam}"], None),
    "alneval_all": (["alneval", "-p", "-c", "-a", "-g", "2", "{sam}"],
                    None),
    "alneval_stdin": (["alneval"], "sam"),
    "alneval_tty": (["alneval"], "tty"),
    "vareval": (["vareval", "{snp}", "{pileup}"], None),
    "vareval_print": (["vareval", "-p", "-g", "3", "{snp}", "{pileup}"],
                      None),
    "vareval_stdin": (["vareval", "{snp}"], "pileup"),
    "vareval_no_arguments": (["vareval"], None),
    "unique": (["unique", "{sam}"], None),
    "unique_recal": (["unique", "-Q", "{sam}"], None),
    "unique_options": (["unique", "-Q", "-m", "-f", "100", "-q", "3",
                        "-r", "1", "-a", "2", "{sam}"], None),
    "unique_stdin": (["unique", "-Q"], "sam"),
    "unique_tty": (["unique"], "tty"),
    "uniqcmp": (["uniqcmp", "{sam}", "{sam2}"], None),
    "uniqcmp_print": (["uniqcmp", "-p", "-q", "30", "-s", "50", "-b", "2",
                       "{sam2}", "{sam}"], None),
    "uniqcmp_one_file": (["uniqcmp", "{sam}"], None),
    "no_command": ([], None),
    "bad_command": (["evaluate", "{sam}"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_wgsim_inputs(str(tmp_path_factory.mktemp("wgsim")))


TABLES = {"wgsim": WGSIM, "wgsim_eval": EVAL}


RUNS = [(c, k) for c, cases in TABLES.items() for k in sorted(cases)]


@pytest.mark.parametrize("cmd,case", RUNS, ids=["-".join(r) for r in RUNS])
def test_wgsim_equals_jax_tool(inputs, cmd, case):
    kernels.reset_launches()
    check_ancillary(cmd, inputs, TABLES[cmd], case)
    assert not any(kernels.launches.values())


def test_drand48_equals_jax_class():
    """The first 10,000 values of the port's Drand48 and the JAX class,
    bit for bit, for seeds that need the 32-bit mask."""
    from samtools_tpu.tools.wgsim_cmd import Drand48 as JDrand48
    for seed in (1, 11, 0x7FFFFFFF, 0x1234567890):
        a, b = wgsim_cmd.Drand48(seed), JDrand48(seed)
        got = np.array([a.next() for _ in range(10000)])
        want = np.array([b.next() for _ in range(10000)])
        assert got.tobytes() == want.tobytes() and a.x == b.x


def test_drand48_is_posix_lcg():
    """srand48(1) then drand48(): X1 = (a X0 + c) mod 2^48 with X0 =
    0x1330E, the value over 2^48."""
    r = wgsim_cmd.Drand48(1)
    x = (0x5DEECE66D * 0x1330E + 0xB) % (1 << 48)
    assert r.next() == x / (1 << 48)


def test_reads_follow_the_reference(inputs, tmp_path):
    """With no mutations and no errors, each read 1 of a pair is the
    reference's bases from its first coordinate on, or the reverse
    complement up to its second: the names carry the fragment's ends."""
    fq1, fq2 = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    rc, out, err = run_inproc("port", "wgsim", [
        "-S", "5", "-N", "200", "-e", "0", "-r", "0", "-1", "50", "-2",
        "40", inputs["ref"], fq1, fq2])
    assert rc == 0 and out == b""
    assert err.endswith("1 sequences, total length: 20000\n")
    with open(inputs["ref"]) as f:
        ref = "".join(f.read().split("\n")[1:])
    comp = str.maketrans("ACGT", "TGCA")
    pairs = wgsim_reads(fq1, fq2)
    assert len(pairs) == 200
    for name, s1, s2 in pairs:
        m = re.fullmatch(r"sim1_(\d+)_(\d+)_0:0:0_0:0:0_[0-9a-f]+", name)
        lo, hi = int(m.group(1)), int(m.group(2))
        fwd = ref[lo - 1:lo - 1 + len(s1)]
        rev = ref[hi - len(s1):hi][::-1].translate(comp)
        assert s1 in (fwd, rev) and len(s1) == 50 and len(s2) == 40
