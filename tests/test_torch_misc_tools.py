"""``python -m samtools_tpu_torch md5fa|md5sum-lite|seq_cache_populate``
against the JAX package's, on the CPU: one parity test a command over its
table of cases, both packages run in-process
(``torch_tool_fixtures.check_ancillary``: exit code, standard error with
the package name masked, standard output and every file written, the
cache trees file for file).

Inputs are ``torch_tool_fixtures.make_misc_inputs``'s.  No case
launches a kernel.
"""

import hashlib
import os
import shutil

import pytest
from torch_tool_fixtures import (check_ancillary, make_misc_inputs,
                                 run_inproc)

from samtools_tpu_torch import kernels

# name -> (arguments, standard input[, prepare]); {x} names an input of
# the fixture, {o} the case's output directory
MD5FA = {
    "fasta": (["{fa}"], None),
    "fastq": (["{fq}"], None),
    "gzip": (["{fa_gz}"], None),
    "several": (["{fa}", "{fa2}", "{fq}"], None),
    "stdin": ([], "fa"),
    "stdin_dash": (["-"], "fq"),
    "missing": (["{fa}", "{dir}/none.fa", "{fa2}"], None),
    "directory": (["{dir}"], None),
}
MD5SUM = {
    "files": (["{fa}", "{bin}", "{fa_gz}"], None),
    "stdin": ([], "bin"),
    "stdin_dash": (["{fq}", "-"], "fa"),
    "missing": (["{fa}", "{dir}/none"], None),
    "empty_stdin": ([], None),
}


def _cached(odir, inputs):
    """A cache that already holds one of the sequences (another
    seq_cache_populate run's), and a stale .tmp file."""
    rc, _, _ = run_inproc("port", "seq_cache_populate",
                          ["-root", os.path.join(odir, "cache"), "-subdirs",
                           "1", inputs["fa2"]])
    assert rc == 0
    with open(os.path.join(odir, "cache", "leftover.tmp"), "w") as f:
        f.write("x")


POPULATE = {
    "subdirs0": (["-root", "{o}/cache", "-subdirs", "0", "{fa}"], None),
    "default": (["-root", "{o}/cache", "{fa}", "{fq}"], None),
    "subdirs3": (["-subdirs", "3", "{fa_gz}", "-root", "{o}/c3"], None),
    "again": (["-root", "{o}/cache", "-subdirs", "1", "{fa}", "{fa2}"],
              None, _cached),
    "no_root": (["{fa}"], None),
    "no_files": (["-root", "{o}/cache"], None),
    "no_arguments": ([], None),
    "missing": (["-root", "{o}/cache", "{fa}", "{dir}/none.fa"], None),
    "unreadable": (["-root", "{o}/cache", "{dir}"], None),
    "stdin": (["-root", "{o}/cache", "-subdirs", "0", "-"], "fa2"),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_misc_inputs(str(tmp_path_factory.mktemp("misc")))


TABLES = {"md5fa": MD5FA, "md5sum-lite": MD5SUM,
          "seq_cache_populate": POPULATE}


RUNS = [(c, k) for c, cases in TABLES.items() for k in sorted(cases)]


@pytest.mark.parametrize("cmd,case", RUNS, ids=["-".join(r) for r in RUNS])
def test_misc_equals_jax_tool(inputs, cmd, case):
    kernels.reset_launches()
    check_ancillary(cmd, inputs, TABLES[cmd], case)
    assert not any(kernels.launches.values())


def _clean(seq: bytes) -> bytes:
    return bytes(c - 32 if 0x61 <= c <= 0x7A else c for c in seq
                 if 0x21 <= c <= 0x7E)


def test_md5fa_is_htslib_m5(inputs):
    """Each sequence's digest is the MD5 of its printable bytes in upper
    case (htslib's @SQ M5 rule); ordered is the MD5 of them all, in order,
    unordered the XOR of the digests."""
    rc, out, err = run_inproc("port", "md5fa", [inputs["fa2"]])
    assert rc == 0 and err == ""
    with open(inputs["fa2"], "rb") as f:
        recs, name = {}, None
        for line in f.read().split(b"\n"):
            if line.startswith(b">"):
                name = line[1:].decode()
                recs[name] = b""
            elif name is not None:
                recs[name] += line
    rows = [ln.split("  ") for ln in out.decode().splitlines()]
    want = [hashlib.md5(_clean(s)).hexdigest() for s in recs.values()]
    assert [r[0] for r in rows[:-2]] == want
    assert [r[2] for r in rows[:-2]] == list(recs)
    assert rows[-2][0] == hashlib.md5(b"".join(
        _clean(s) for s in recs.values())).hexdigest()
    x = bytes(16)
    for w in want:
        x = bytes(a ^ b for a, b in zip(x, bytes.fromhex(w)))
    assert rows[-1][0] == x.hex()


def test_md5sum_lite_is_md5(inputs):
    rc, out, _ = run_inproc("port", "md5sum-lite", [inputs["bin"]],
                            inputs["fa"])
    with open(inputs["bin"], "rb") as f:
        assert (rc, out.decode()) == (
            0, f"{hashlib.md5(f.read()).hexdigest()}  {inputs['bin']}\n")


def test_populated_cache_layout(inputs, tmp_path):
    """-subdirs N: the sequence under N two-character directories of its
    MD5 and the rest of it as the file name, its printable bytes in upper
    case."""
    root = str(tmp_path / "c")
    rc, _, err = run_inproc("port", "seq_cache_populate",
                            ["-root", root, "-subdirs", "2", inputs["fq"]])
    assert rc == 0 and err.endswith("Processed 4 sequences\n")
    for line in err.splitlines()[:-1]:
        name, dest = line.split(" -> ")
        rel = os.path.relpath(dest, root).split(os.sep)
        assert [len(x) for x in rel] == [2, 2, 28]
        with open(dest, "rb") as f:
            seq = f.read()
        assert hashlib.md5(seq).hexdigest() == "".join(rel)
        assert seq == _clean(seq)


def _lookup_both(header_text: str, env: dict, monkeypatch):
    from samtools_tpu.io import cram_decode as jcd
    from samtools_tpu.io.header import SamHeader as JHeader

    from samtools_tpu_torch.io import cram_decode as tcd
    from samtools_tpu_torch.io.header import SamHeader
    for k in ("REF_CACHE", "REF_PATH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return (tcd._ref_path_lookup(SamHeader.from_text(header_text), 0),
            jcd._ref_path_lookup(JHeader.from_text(header_text), 0))


def test_ref_cache_finds_only_the_flat_layout(inputs, tmp_path,
                                              monkeypatch):
    """Both packages' REF_CACHE lookup expands only %s: a cache that
    seq_cache_populate writes with -subdirs 0 is found, its default
    two-level layout is not, neither as a directory nor through htslib's
    %2s/%2s/%s pattern (a known defect of both packages, kept)."""
    seq = b"ACGTTGCA" * 50
    fa = tmp_path / "one.fa"
    fa.write_bytes(b">one\n" + seq + b"\n")
    md5 = hashlib.md5(seq).hexdigest()
    text = f"@SQ\tSN:one\tLN:{len(seq)}\tM5:{md5}\n"
    for sub in ("0", "2"):
        root = str(tmp_path / f"cache{sub}")
        rc, _, _ = run_inproc("port", "seq_cache_populate",
                              ["-root", root, "-subdirs", sub, str(fa)])
        assert rc == 0
    flat, deep = str(tmp_path / "cache0"), str(tmp_path / "cache2")
    assert _lookup_both(text, {"REF_CACHE": flat}, monkeypatch) == (seq, seq)
    assert _lookup_both(text, {"REF_CACHE": flat + "/%s"},
                        monkeypatch) == (seq, seq)
    assert _lookup_both(text, {"REF_CACHE": deep}, monkeypatch) == (None,
                                                                    None)
    assert _lookup_both(text, {"REF_CACHE": deep + "/%2s/%2s/%s"},
                        monkeypatch) == (None, None)
    shutil.rmtree(flat)
    shutil.rmtree(deep)
