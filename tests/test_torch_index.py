"""The port's BAI/CSI indexes against the JAX package, on the CPU:

* ``python -m samtools_tpu_torch index`` (BAI, ``-c``, ``-m 12``, ``-o``,
  ``-M``, the two-argument form) writes the JAX ``main_index``'s bytes on
  a BAM of one BGZF block and one of more than 50, each with two contigs
  of reads, unmapped reads placed and unplaced, and a contig with no
  reads.  A CSI is BGZF: its bytes equal those the JAX package writes
  with its zlib codec, and its content those of its libdeflate codec;
* ``read_bai`` / ``_parse_csi`` read back what the JAX reader reads, and
  ``query_chunks`` gives the JAX function's chunks on a grid of regions;
* ``BamStream.query`` equals the whole-file overlap filter on the
  many-block BAM, where the JAX query raises, and decodes only the
  records of the index's chunks;
* ``idxstats`` prints the JAX tool's bytes with and without an index.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
from torch_tool_fixtures import run_port_stdout

from samtools_tpu.io import bgzf as jbgzf
from samtools_tpu.io import index as jindex
from samtools_tpu.io.bam import BamError as JBamError
from samtools_tpu.io.bam import reg2bin as jreg2bin
from samtools_tpu.io.stream import BamStream as JBamStream
from samtools_tpu.tools.idxstats_cmd import main_idxstats as jmain_idxstats
from samtools_tpu.tools.index_cmd import main_index as jmain_index
from samtools_tpu_torch import cli, sim
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io import bgzf, index, stream
from samtools_tpu_torch.io.bam import read_bam_indexed, reg2bin, write_bam
from samtools_tpu_torch.io.bam import reg2bin_vec
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader

LENS = (60000, 30000, 5000)   # sim3 holds no reads
REGIONS = [(0, 0, 1000), (0, 15000, 17000), (0, 20000, 45000),
           (0, 59000, 60000), (0, 0, 60000), (1, 100, 200),
           (1, 29950, 30000), (1, 0, 1 << 29), (2, 0, 5000), (0, 60000, 70000)]


def _bam(path: str, coverage: float, seed: int) -> str:
    """Reads on sim1 and sim2 (coordinate sorted), some unmapped but
    placed beside their mates, then unplaced unmapped reads."""
    parts = []
    for tid, ln in enumerate(LENS[:2]):
        ref = sim.simulate_reference(ln, seed=seed + tid)
        b = sim.simulate_messy(sim.simulate_batch(
            ref_len=ln, coverage=coverage, paired=False, seed=seed + tid,
            ref=ref), seed + tid)
        b.tid[:] = tid
        unmap = np.arange(b.n) % 17 == 5
        b.flag[unmap] |= 4
        parts.append(b)
    b = parts[0]
    tail = b.take(np.arange(0, b.n, 40))
    tail.tid[:] = -1
    tail.pos[:] = -1
    tail.flag[:] = 4
    tail.cigar = np.empty(0, np.uint32)
    tail.cigar_off = np.zeros(tail.n + 1, np.int64)
    parts.append(tail)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:sim{i + 1}\tLN:{ln}\n" for i, ln in enumerate(LENS))
    write_bam(path, SamHeader.from_text(text), ReadBatch.concat(parts))
    return path


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("index"))
    got = {"dir": d, "small": _bam(os.path.join(d, "small.bam"), 0.15, 3),
           "big": _bam(os.path.join(d, "big.bam"), 30.0, 5)}
    for k in ("small", "big"):
        with open(got[k], "rb") as f:
            got[k + "_blocks"] = bgzf.scan_blocks(f.read())[0].size - 1
    assert got["small_blocks"] == 1 and got["big_blocks"] > 50
    return got


def _copies(bams, which, tag, pkgs=("port", "jax")):
    """Copies of a test BAM, one for each package."""
    out = []
    for pkg in pkgs:
        p = os.path.join(bams["dir"], f"{which}.{tag}.{pkg}.bam")
        shutil.copy(bams[which], p)
        out.append(p)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@contextlib.contextmanager
def jax_zlib_codec():
    """The JAX package's BGZF with zlib, as the port's, in place of its
    libdeflate host library (the same framing, other deflate bytes)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jbgzf, "_native", lambda: None)
        yield


# options, and the index files they write ({b}: the BAM without .bam)
INDEX_CASES = {
    "bai": ([], ["{b}.bam.bai"]),
    "csi": (["-c"], ["{b}.bam.csi"]),
    "min_shift_12": (["-m", "12"], ["{b}.bam.csi"]),
    "output": (["-o", "{b}.out.bai"], ["{b}.out.bai"]),
    "two_args": (["-c", "{b}.bam", "{b}.two.csi"], ["{b}.two.csi"]),
    "multiple": (["-M", "{b}.bam", "{b}.copy.bam"],
                 ["{b}.bam.bai", "{b}.copy.bam.bai"]),
}


@pytest.mark.parametrize("which", ["small", "big"])
@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_writes_jax_bytes(bams, which, case):
    opts, outs = INDEX_CASES[case]
    files = {}
    for pkg, path in zip(("port", "jax", "jax_native"),
                         _copies(bams, which, case,
                                 ("port", "jax", "jax_native"))):
        b = path[:-4]
        shutil.copy(path, b + ".copy.bam")
        argv = [o.format(b=b) for o in opts]
        if not any(a.endswith(".bam") for a in argv):
            argv.append(path)
        if pkg == "port":
            assert cli.main(["index", *argv]) == 0
        elif pkg == "jax":
            with jax_zlib_codec():
                assert jmain_index(argv) == 0
        else:
            assert jmain_index(argv) == 0
        files[pkg] = [o.format(b=b) for o in outs]
    for mine, want, native in zip(files["port"], files["jax"],
                                  files["jax_native"], strict=True):
        assert _read(mine) == _read(want), (mine, want)
        if mine.endswith(".csi"):
            assert bgzf.read_file(mine) == jbgzf.read_file(native)
        else:
            assert _read(mine) == _read(native)


def test_index_switches_to_csi_past_2_29(tmp_path):
    """A contig longer than a BAI can address gets a CSI, as in the JAX
    tool (and htslib)."""
    b = sim.simulate_batch(ref_len=4000, coverage=2.0, paired=False, seed=2)
    text = "@SQ\tSN:sim1\tLN:4000\n@SQ\tSN:big\tLN:600000000\n"
    for pkg in ("port", "jax"):
        write_bam(str(tmp_path / f"{pkg}.bam"), SamHeader.from_text(text), b)
    assert cli.main(["index", str(tmp_path / "port.bam")]) == 0
    with jax_zlib_codec():
        assert jmain_index([str(tmp_path / "jax.bam")]) == 0
    assert not (tmp_path / "port.bam.bai").exists()
    assert (_read(str(tmp_path / "port.bam.csi"))
            == _read(str(tmp_path / "jax.bam.csi")))


@pytest.mark.parametrize("which", ["small", "big"])
@pytest.mark.parametrize("fmt", ["bai", "csi"])
def test_read_index_and_query_chunks_equal_jax(bams, which, fmt):
    path = _copies(bams, which, "read" + fmt)[0]
    assert cli.main(["index", path] if fmt == "bai"
                    else ["index", "-c", path]) == 0
    ipath = f"{path}.{fmt}"
    mine, want = index.read_bai(ipath), jindex.read_bai(ipath)
    assert (mine.n_no_coor, mine.min_shift, mine.depth) == (
        want.n_no_coor, want.min_shift, want.depth)
    assert mine.n_no_coor > 0
    for r, jr in zip(mine.refs, want.refs, strict=True):
        for k in ("bin_ids", "chunk_beg", "chunk_end", "ioffset"):
            assert np.array_equal(getattr(r, k), getattr(jr, k)), k
        assert (r.off_beg, r.off_end, r.n_mapped, r.n_unmapped) == (
            jr.off_beg, jr.off_end, jr.n_mapped, jr.n_unmapped)
    assert mine.refs[2].bin_ids.size == 0
    for tid in range(-1, 4):
        assert mine.stat(tid) == want.stat(tid)
        for beg in range(0, 70000, 6500):
            for span in (1, 300, 16384, 40000):
                assert np.array_equal(
                    mine.query_chunks(tid, beg, beg + span),
                    want.query_chunks(tid, beg, beg + span))


def test_reg2bin_equals_jax():
    beg = np.arange(0, 1 << 27, 9973, dtype=np.int64)
    for span in (1, 100, 20000, 1 << 20, 1 << 26):
        got = reg2bin_vec(beg, beg + span)
        assert [reg2bin(int(b), int(b) + span) for b in beg[:300]] == \
            [jreg2bin(int(b), int(b) + span) for b in beg[:300]] == \
            got[:300].tolist()


def _overlap(batch, tid, beg, end):
    e = batch.end_pos()
    return batch.take(np.nonzero((batch.tid == tid) & (batch.pos < end)
                                 & (e > beg))[0])


@pytest.mark.parametrize("fmt", ["bai", "csi"])
def test_query_equals_whole_file_filter(bams, fmt):
    """The many-block BAM, where the JAX query raises."""
    path = _copies(bams, "big", "query" + fmt)[0]
    assert cli.main(["index", path] if fmt == "bai"
                    else ["index", "-c", path]) == 0
    whole = read_alignments(path).batch
    with stream.BamStream(path) as st:
        assert st.index() is not None
        for tid, beg, end in REGIONS:
            got, want = st.query(tid, beg, end), _overlap(whole, tid, beg,
                                                          end)
            assert got.n == want.n
            for k in ("pos", "flag", "cigar", "cigar_off", "seq", "qual",
                      "qname", "aux"):
                assert np.array_equal(getattr(got, k), getattr(want, k)), k
    with JBamStream(path) as jst, pytest.raises(JBamError,
                                                match="record boundary"):
        jst.query(1, 0, 30000)


def test_query_decodes_only_the_index_chunks(bams, monkeypatch):
    path = _copies(bams, "big", "decoded")[0]
    assert cli.main(["index", path]) == 0
    _, whole, vstart, _ = read_bam_indexed(path)
    decoded = []
    real = stream.decode_records

    def counting(data, offs, *a):
        decoded.append(offs.size)
        return real(data, offs, *a)
    monkeypatch.setattr(stream, "decode_records", counting)
    with stream.BamStream(path) as st:
        chunks = st.index().query_chunks(0, 20000, 21000)
        got = st.query(0, 20000, 21000)
    in_chunks = sum(int(((vstart >= vb) & (vstart < ve)).sum())
                    for vb, ve in chunks)
    assert sum(decoded) == in_chunks < whole.n // 4
    assert got.n == _overlap(whole, 0, 20000, 21000).n > 0


def _jax_stdout(fn, argv) -> bytes:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue().encode()


@pytest.mark.parametrize("which", ["small", "big"])
@pytest.mark.parametrize("case", ["bai", "csi", "custom", "none"])
def test_idxstats_equals_jax(bams, which, case):
    path = _copies(bams, which, "idx" + case)[0]
    argv = [path]
    if case == "bai":
        assert cli.main(["index", path]) == 0
    elif case == "csi":
        assert cli.main(["index", "-c", path]) == 0
    elif case == "custom":
        assert cli.main(["index", path, path + ".other"]) == 0
        argv = ["-X", path, path + ".other"]
    want = _jax_stdout(jmain_idxstats, argv)
    assert run_port_stdout("idxstats", argv) == want
    assert want.count(b"\n") == 4


def test_cram_input_is_not_ported(tmp_path, capfd):
    """CRAM is read now (tests/test_torch_cram_tools.py); this case, which
    held the exit of a CRAM input, now holds a truncated CRAM: ``index``
    and ``idxstats`` fail as the JAX tools do, with the same exception
    and no output."""
    p = tmp_path / "x.cram"
    p.write_bytes(b"CRAM\3\0" + bytes(40))
    for cmd, jmain in (("index", jmain_index), ("idxstats", jmain_idxstats)):
        with pytest.raises(Exception) as want:
            jmain([str(p)])
        capfd.readouterr()
        with pytest.raises(type(want.value)) as got:
            cli.main([cmd, str(p)])
        assert str(got.value) == str(want.value)
        assert capfd.readouterr().out == ""
