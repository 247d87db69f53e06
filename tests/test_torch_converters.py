"""The port's aligner converters (``bowtie2sam``, ``psl2sam``,
``soap2sam``, ``zoom2sam``, ``maq2sam``, ``novo2sam``, ``export2sam``,
``blast2sam``), ``fasta-sanitize``, ``interpolate_sam`` and ``ace2sam``
against the JAX package's, on the CPU: one parity test over the table of
cases, both packages run in-process
(``torch_tool_fixtures.check_ancillary``: exit code, standard error with
the package name masked, standard output and every file written).

Inputs are ``torch_tool_fixtures.make_converter_inputs``'s: the aligner
outputs of the JAX package's converter tests and more records of each
kind, plain, gzip'd and on standard input, and ``sim.ace_assembly``'s
ACE.  No case launches a kernel.
"""

import re

import pytest
from torch_tool_fixtures import (check_ancillary, make_converter_inputs,
                                 run_inproc)

from samtools_tpu_torch import kernels, sim

# (command, case) -> (arguments, standard input); {x} names an input of
# the fixture, {o} the case's output directory; "tty": an empty terminal
CASES = {
    ("bowtie2sam", "file"): (["{bowtie}"], None),
    ("bowtie2sam", "gzip"): (["{bowtie_gz}"], None),
    ("bowtie2sam", "stdin"): ([], "bowtie"),
    ("bowtie2sam", "stdin_dash"): (["-"], "bowtie"),
    ("bowtie2sam", "tty"): ([], "tty"),
    ("bowtie2sam", "missing"): (["{dir}/none"], None),
    ("psl2sam", "file"): (["{psl}"], None),
    ("psl2sam", "scores"): (["-a", "2", "-b", "4", "-q", "7", "-r", "1",
                             "{psl}"], None),
    ("psl2sam", "gzip"): (["{psl_gz}"], None),
    ("psl2sam", "stdin"): (["-q", "1"], "psl"),
    ("psl2sam", "tty"): (["-a", "3"], "tty"),
    ("soap2sam", "file"): (["{soap}"], None),
    ("soap2sam", "pairs"): (["-p", "{soap}"], None),
    ("soap2sam", "gzip"): (["{soap_gz}"], None),
    ("soap2sam", "stdin"): (["-p"], "soap"),
    ("soap2sam", "tty"): (["-p"], "tty"),
    ("zoom2sam", "file"): (["36", "{zoom}"], None),
    ("zoom2sam", "pairs"): (["-p", "50", "{zoom}"], None),
    ("zoom2sam", "gzip"): (["36", "{zoom_gz}"], None),
    ("zoom2sam", "stdin"): (["-p", "36"], "zoom"),
    ("zoom2sam", "no_arguments"): ([], None),
    ("zoom2sam", "bad_length"): (["x", "{zoom}"], None),
    ("novo2sam", "file"): (["{novo}"], None),
    ("novo2sam", "pairs"): (["-p", "{novo}"], None),
    ("novo2sam", "gzip"): (["{novo_gz}"], None),
    ("novo2sam", "stdin"): (["-"], "novo"),
    ("novo2sam", "no_arguments"): ([], "novo"),
    ("maq2sam", "file"): (["{map}"], None),
    ("maq2sam", "read_group"): (["{map}", "grp1"], None),
    ("maq2sam", "stdin"): (["-", "grp2"], "map"),
    ("maq2sam", "truncated"): (["{map_trunc}"], None),
    ("maq2sam", "obsolete"): (["{map_old}"], None),
    ("maq2sam", "format_zero"): (["{map_zero}"], None),
    ("maq2sam", "not_gzip"): (["{bowtie}"], None),
    ("maq2sam", "no_arguments"): ([], None),
    ("maq2sam", "missing"): (["{dir}/none.map"], None),
    ("export2sam", "read1"): (["--read1={r1}"], None),
    ("export2sam", "pairs"): (["--read1={r1}", "--read2={r2}"], None),
    ("export2sam", "nofilter"): (["--read1={r1}", "--read2={r2}",
                                  "--nofilter"], None),
    ("export2sam", "qlogodds"): (["--qlogodds", "--read1={r1}"], None),
    ("export2sam", "qlogodds_low"): (["--qlogodds", "--read1={r1_lowq}"],
                                     None),
    ("export2sam", "gzip"): (["--read1={r1_gz}", "--read2={r2}"], None),
    ("export2sam", "stdin"): (["--read1=-", "--read2={r2}"], "r1"),
    ("export2sam", "version"): (["--version"], None),
    ("export2sam", "version_and_read"): (["--read1={r1}", "--version"],
                                         None),
    ("export2sam", "help"): (["--help"], None),
    ("export2sam", "no_arguments"): ([], None),
    ("export2sam", "unrecognized"): (["--read1={r1}", "extra", "--x"],
                                     None),
    ("export2sam", "no_read1"): (["--read2={r2}"], None),
    ("export2sam", "read2_short"): (["--read1={r1}", "--read2={r2_short}"],
                                    None),
    ("export2sam", "read2_long"): (["--read1={r1}", "--read2={r2_long}"],
                                   None),
    ("export2sam", "not_paired"): (["--read1={r1}",
                                    "--read2={r2_renamed}"], None),
    ("export2sam", "read_number"): (["--read1={r1}",
                                     "--read2={r2_readno}"], None),
    ("export2sam", "fields"): (["--read1={r1_fields}"], None),
    ("export2sam", "phred_low"): (["--read1={r1_lowq}"], None),
    ("blast2sam", "file"): (["{blast}"], None),
    ("blast2sam", "seq"): (["-s", "{blast}"], None),
    ("blast2sam", "seq_dummy"): (["-sd", "{blast}"], None),
    ("blast2sam", "dummy_seq"): (["-ds", "{blast}"], None),
    ("blast2sam", "dummy"): (["-d", "{blast}"], None),
    ("blast2sam", "both_flags"): (["-s", "-d", "{blast}"], None),
    ("blast2sam", "stdin"): (["-s"], "blast"),
    ("blast2sam", "tty"): ([], "tty"),
    ("blast2sam", "gzip"): (["{blast_gz}"], None),
    ("fasta-sanitize", "names"): (["{names}"], None),
    ("fasta-sanitize", "stdin"): ([], "names"),
    ("fasta-sanitize", "clean"): (["{bowtie}"], None),
    ("fasta-sanitize", "several"): (["{names}", "{names}"], None),
    ("interpolate_sam", "file"): (["{interp}"], None),
    ("interpolate_sam", "no_argument"): ([], "interp"),
    ("interpolate_sam", "missing"): (["{dir}/none.sam"], None),
    ("interpolate_sam", "directory"): (["{dir}"], None),
    ("ace2sam", "unpadded"): (["{ace}"], None),
    ("ace2sam", "padded"): (["-p", "{ace}"], None),
    ("ace2sam", "contigs"): (["-c", "{ace}"], None),
    ("ace2sam", "padded_contigs"): (["-pc", "{ace}"], None),
    ("ace2sam", "contigs_padded"): (["-cp", "{ace_gz}"], None),
    ("ace2sam", "separate_flags"): (["-c", "-p", "{ace}"], None),
    ("ace2sam", "gzip"): (["{ace_gz}"], None),
    ("ace2sam", "stdin"): (["-p", "-"], "ace"),
    ("ace2sam", "no_arguments"): ([], None),
    ("ace2sam", "missing"): (["{dir}/none.ace"], None),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_converter_inputs(str(tmp_path_factory.mktemp("convert")))


@pytest.mark.parametrize("cmd,case", sorted(CASES),
                         ids=["-".join(k) for k in sorted(CASES)])
def test_converter_equals_jax_tool(inputs, cmd, case):
    kernels.reset_launches()
    check_ancillary(cmd, inputs, {case: CASES[(cmd, case)]}, case)
    assert not any(kernels.launches.values())




def _query_len(cigar: str) -> int:
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
               if op in "MIS=X")


def _header_and_fasta(err: str):
    hdr = "".join(ln[2:] + "\n" for ln in err.splitlines()
                  if ln.startswith("H "))
    fa = "".join(ln[2:] + "\n" for ln in err.splitlines()
                 if ln.startswith("S "))
    return hdr, fa


def test_ace2sam_sam_is_valid(tmp_path):
    """``ace2sam -p -c`` of the simulated ACE: one record a read and one a
    contig, each CIGAR holding as many query bases as its sequence; with
    its stderr header put back in front, ``view`` reads it, and ``depad
    -T`` (the stderr consensus as the padded FASTA) gives each read the
    position and CIGAR of ``ace2sam``'s unpadded output."""
    asm = sim.ace_assembly(9)
    ace = tmp_path / "a.ace"
    ace.write_text(asm.ace)
    rc, out, err = run_inproc("port", "ace2sam", ["-p", "-c", str(ace)])
    assert rc == 0
    recs = [ln.split("\t") for ln in out.decode().splitlines()]
    assert len(recs) == len(asm.reads) + len(asm.padded)
    assert [r[0] for r in recs if r[1] == "516"] == list(asm.padded)
    assert all(_query_len(r[5]) == len(r[9]) for r in recs)
    assert sorted(r[0] for r in recs if r[1] != "516") == sorted(
        x.name for x in asm.reads)
    hdr, fa = _header_and_fasta(err)
    sam = tmp_path / "a.sam"
    sam.write_text(hdr + out.decode())
    (tmp_path / "pad.fa").write_text(fa)
    rc, got, _ = run_inproc("port", "view", ["-c", str(sam)])
    assert (rc, got) == (0, b"%d\n" % len(recs))
    rc, dep, _ = run_inproc("port", "depad", ["-s", "-T",
                                              str(tmp_path / "pad.fa"),
                                              str(sam)])
    assert rc == 0
    rc, unp, _ = run_inproc("port", "ace2sam", [str(ace)])
    want = [ln.split("\t")[:6] for ln in unp.decode().splitlines()]
    got = [ln.split("\t")[:6] for ln in dep.decode().splitlines()
           if not ln.startswith("@") and ln.split("\t")[1] != "516"]
    assert got == want
    for r in asm.reads:
        assert "*" not in r.padded[:r.beg] + r.padded[r.end:]
        assert r.padded[r.beg] != "*" and r.padded[r.end - 1] != "*"


def test_ace2sam_keeps_the_merged_d_fault(tmp_path):
    """A fault of the JAX tool that the port keeps: in unpadded output,
    where a read's pad over a consensus base (D), its pad over a
    consensus pad (P) and another D follow each other, the P is squeezed
    and the two D runs merge with their op codes added (2 + 2: S); the
    samtools tool adds only the lengths.  ``depad`` of the padded output
    gives the D there."""
    asm = sim.ace_assembly(37)
    ace = tmp_path / "a.ace"
    ace.write_text(asm.ace)
    unp = run_inproc("port", "ace2sam", [str(ace)])
    assert unp == run_inproc("jax", "ace2sam", [str(ace)])
    rc, out, err = run_inproc("port", "ace2sam", ["-p", str(ace)])
    hdr, fa = _header_and_fasta(err)
    (tmp_path / "a.sam").write_text(hdr + out.decode())
    (tmp_path / "pad.fa").write_text(fa)
    rc, dep, _ = run_inproc("port", "depad", [
        "-s", "-T", str(tmp_path / "pad.fa"), str(tmp_path / "a.sam")])
    got = [ln.split("\t") for ln in unp[1].decode().splitlines()]
    want = [ln.split("\t") for ln in dep.decode().splitlines()
            if not ln.startswith("@")]
    faulty = [(u, x) for u, x in zip(got, want) if u[5] != x[5]]
    assert len(faulty) == 1
    (u, x), = faulty
    ops_u = re.findall(r"\d+[MIDNSHP=X]", u[5])
    ops_x = re.findall(r"\d+[MIDNSHP=X]", x[5])
    diff = [(a, b) for a, b in zip(ops_u, ops_x) if a != b]
    assert len(ops_u) == len(ops_x) and u[:5] == x[:5]
    assert len(diff) == 1 and diff[0][0][-1] == "S" \
        and diff[0][1] == diff[0][0][:-1] + "D"
    assert _query_len(u[5]) > len(u[9]) and _query_len(x[5]) == len(x[9])
