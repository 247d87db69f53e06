"""The port's SAM text formatter, its writers and its BGZF writer against
the JAX package, on the CPU:

* ``format_record`` (the Python oracle) and ``format_records`` (the host
  library's batch formatter, and the Python path it takes when a record's
  aux is malformed) print the JAX ``format_record``'s bytes on every
  fixture: all aux types, empty B arrays, %g floats, records without
  qualities or a sequence, mates on another contig, unmapped reads;
* a malformed aux field raises the JAX error; negative NaN is printed as
  each package's path prints it (htslib's printf: ``-nan``; Python's
  ``%g``: ``nan``);
* ``BgzfWriter`` and ``compress`` write the bytes of the JAX zlib path
  (its ``_native`` patched to None) at levels 0, 1 and 6, with 0 and 4
  threads, on empty input, written in pieces of every size; and the
  blocks and inflated bytes of its default (libdeflate) path;
* ``StreamingWriter`` and ``write_alignments`` (sam, sam.gz, bam; header
  only; no header) write the JAX writers' bytes; ``has_eof_block``,
  ``is_gzip``, ``infer_output_format`` and the aux helpers view uses
  (``iter_tags``, ``find_tag``, ``keep_tags``, ``delete_tags``,
  ``batch_adjust_tags``) equal the JAX functions.
"""

import io
import struct

import numpy as np
import pytest
from torch_tool_fixtures import jbatch, make_view_inputs

from samtools_tpu.core import aux as jaux
from samtools_tpu.io import bgzf as jbgzf
from samtools_tpu.io import files as jfiles
from samtools_tpu.io import sam_text as jsam
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu_torch.core import aux
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io import bgzf, files, native, sam_text
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_view_inputs(str(tmp_path_factory.mktemp("samtext")))


@pytest.fixture(scope="module", params=["general", "messy", "pairs",
                                        "general_cram"])
def loaded(request, inputs):
    af = read_alignments(inputs[request.param], reference=inputs["fa"])
    return af.header, af.batch


@pytest.fixture
def zlib_jax(monkeypatch):
    """The JAX package's BGZF on its zlib path."""
    monkeypatch.setattr(jbgzf, "_native", lambda: None)


def test_format_record_equals_jax(loaded):
    header, b = loaded
    jh, jb = JSamHeader.from_text(header.text), jbatch(b)
    for i in range(b.n):
        assert sam_text.format_record(header, b, i) == \
            jsam.format_record(jh, jb, i)


def test_format_records_native_and_python_equal_jax(loaded, monkeypatch):
    header, b = loaded
    jh, jb = JSamHeader.from_text(header.text), jbatch(b)
    want = "".join(jsam.format_record(jh, jb, i) + "\n"
                   for i in range(b.n))
    assert sam_text.format_records(header, b) == want
    idx = np.arange(b.n)[::-3]
    assert sam_text.format_records(header, b, idx) == "".join(
        jsam.format_record(jh, jb, int(i)) + "\n" for i in idx)
    monkeypatch.setattr(native, "sam_format", lambda *a: None)
    assert sam_text.format_records(header, b) == want


def _one(aux_bytes: bytes) -> ReadBatch:
    b = ReadBatch(n=1, tid=np.array([0], np.int32),
                  pos=np.array([9], np.int64), mapq=np.array([3], np.uint8),
                  flag=np.array([16], np.uint16),
                  mtid=np.array([-1], np.int32),
                  mpos=np.array([-1], np.int64),
                  tlen=np.array([0], np.int64),
                  qname=np.frombuffer(b"r1", np.uint8),
                  qname_off=np.array([0, 2], np.int64),
                  cigar=np.array([4 << 4], np.uint32),
                  cigar_off=np.array([0, 1], np.int64),
                  seq=np.array([1, 2, 4, 8], np.uint8),
                  seq_off=np.array([0, 4], np.int64),
                  qual=np.array([30, 31, 32, 33], np.uint8),
                  aux=np.frombuffer(aux_bytes, np.uint8).copy(),
                  aux_off=np.array([0, len(aux_bytes)], np.int64))
    return b


@pytest.mark.parametrize("blob", [b"XXQ\x01", b"XXi\x01\x02",
                                  b"XXBq\x01\x00\x00\x00\x01",
                                  b"XXBc\x05\x00\x00\x00\x01"])
def test_malformed_aux_raises_the_jax_error(blob):
    h = SamHeader.from_text("@SQ\tSN:c\tLN:100\n")
    b = _one(blob)
    assert native.sam_format(b, np.array([0]), np.frombuffer(b"c", np.uint8),
                             np.array([0, 1])) is None
    with pytest.raises(Exception) as mine:
        sam_text.format_records(h, b)
    with pytest.raises(Exception) as theirs:
        jsam.format_record(JSamHeader.from_text(h.text), jbatch(b), 0)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


def test_negative_nan_prints_as_each_path_prints_it():
    h = SamHeader.from_text("@SQ\tSN:c\tLN:100\n")
    nan = struct.pack("<I", 0xFFC00000)
    b = _one(b"XFf" + nan + b"XBBf\x01\x00\x00\x00" + nan)
    want = jsam.format_record(JSamHeader.from_text(h.text), jbatch(b), 0)
    assert sam_text.format_record(h, b, 0) == want
    assert want.endswith("XF:f:nan\tXB:B:f,nan")
    assert sam_text.format_records(h, b) == \
        want.replace("nan", "-nan") + "\n"


def _pieces(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(data):
        k = int(rng.choice([1, 17, 4000, 0xFF00, 0x1FE00 + 5, 200000]))
        yield data[i:i + k]
        i += k


def _payload(n: int) -> bytes:
    rng = np.random.default_rng(n)
    text = rng.integers(65, 70, n).astype(np.uint8)   # compressible
    text[::7] = rng.integers(0, 256, text[::7].size)
    return text.tobytes()


@pytest.mark.parametrize("level", [0, 1, 6])
@pytest.mark.parametrize("threads", [0, 4])
@pytest.mark.parametrize("n", [0, 100, 0xFF00, 700000])
def test_bgzf_writer_equals_jax(zlib_jax, level, threads, n):
    data = _payload(n)
    mine, theirs = io.BytesIO(), io.BytesIO()
    w = bgzf.BgzfWriter(mine, level=level, threads=threads)
    jw = jbgzf.BgzfWriter(theirs, level=level, threads=threads)
    for piece in _pieces(data, n):
        w.write(piece)
        jw.write(piece)
    w.close()
    jw.close()
    assert mine.getvalue() == theirs.getvalue()
    whole = bgzf.compress(data, level=level, threads=threads)
    assert whole == mine.getvalue() == jbgzf.compress(data, level=level,
                                                      threads=threads)
    assert bgzf.decompress(whole).tobytes() == data


@pytest.mark.parametrize("append_eof", [True, False])
@pytest.mark.parametrize("n", [1, 1000, 0xFF00, 0xFF00 * 3 + 1])
def test_compress_options_equal_jax(zlib_jax, append_eof, n):
    data = _payload(n)
    assert bgzf.compress(data, 6, 2, append_eof) == \
        jbgzf.compress(data, 6, 2, append_eof)
    assert bgzf.compress(b"", append_eof=append_eof) == \
        jbgzf.compress(b"", append_eof=append_eof)


def test_compress_blocks_equal_jax_libdeflate():
    """Against the JAX default codec: the same blocks' uncompressed sizes
    and bytes."""
    data = _payload(400000)
    mine, theirs = bgzf.compress(data), jbgzf.compress(data)

    def sizes(d):
        c, s = bgzf.scan_blocks(d)
        return [int.from_bytes(d[o + k - 4:o + k], "little")
                for o, k in zip(c.tolist(), s.tolist())]
    assert sizes(mine) == sizes(theirs)
    assert bgzf.decompress(mine).tobytes() == jbgzf.decompress(theirs)


def test_eof_block_and_gzip_sniff(tmp_path):
    good, cut, short = (str(tmp_path / n) for n in ("g", "c", "s"))
    data = bgzf.compress(_payload(5000))
    for path, body in ((good, data), (cut, data[:-1]), (short, data[:20])):
        with open(path, "wb") as f:
            f.write(body)
    for path in (good, cut, short, str(tmp_path / "none")):
        assert bgzf.has_eof_block(path) == jbgzf.has_eof_block(path)
    assert bgzf.has_eof_block(good) and not bgzf.has_eof_block(cut)
    for blob in (data, b"\x1f", b"\x1f\x8b", b"BAM\1", b""):
        assert bgzf.is_gzip(blob) == jbgzf.is_gzip(blob)


@pytest.mark.parametrize("fmt", ["sam", "sam.gz", "bam"])
@pytest.mark.parametrize("include_header", [True, False])
def test_streaming_writer_equals_jax(zlib_jax, inputs, tmp_path, fmt,
                                     include_header):
    af = read_alignments(inputs["general"])
    h, b = af.header, af.batch
    jh = JSamHeader.from_text(h.text)
    mine, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    w = files.StreamingWriter(mine, h, fmt, threads=2,
                              include_header=include_header)
    jw = jfiles.StreamingWriter(theirs, jh, fmt, threads=2,
                                include_header=include_header)
    for lo, hi in ((0, 7), (7, 7), (7, 1500), (1500, b.n)):
        part = b.take(np.arange(lo, hi))
        w.write_batch(part)
        jw.write_batch(jbatch(part))
    w.close()
    jw.close()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        got = f.read()
        assert got == g.read()
    # the whole-file writer gives the streamed bytes
    whole = str(tmp_path / "w")
    files.write_alignments(whole, h, b, fmt=fmt,
                           include_header=include_header)
    with open(whole, "rb") as f:
        assert f.read() == got


@pytest.mark.parametrize("kw", [{"fmt": "sam"}, {"fmt": "sam.gz"},
                                {"fmt": "bam", "level": 1},
                                {"fmt": "sam", "header_only": True},
                                {"fmt": "bam", "header_only": True},
                                {"fmt": "sam", "include_header": False}])
def test_write_alignments_equals_jax(zlib_jax, inputs, tmp_path, kw):
    af = read_alignments(inputs["general"])
    mine, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    files.write_alignments(mine, af.header, af.batch, **kw)
    jfiles.write_alignments(theirs, JSamHeader.from_text(af.header.text),
                            jbatch(af.batch), **kw)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_write_alignments_bad_cram_version(inputs, tmp_path):
    af = read_alignments(inputs["messy"])
    for v in ("4.0", "2.0"):
        with pytest.raises(files.FormatError) as mine:
            files.write_alignments(str(tmp_path / "a"), af.header, af.batch,
                                   fmt="cram", fmt_opts={"version": v})
        with pytest.raises(jfiles.FormatError) as theirs:
            jfiles.write_alignments(
                str(tmp_path / "b"), JSamHeader.from_text(af.header.text),
                jbatch(af.batch), fmt="cram", fmt_opts={"version": v})
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("path,explicit", [
    (None, None), ("-", None), ("x.BAM", None), ("x.cram", None),
    ("x.sam.gz", None), ("x.sam", None), ("x.txt", None), ("x.bam", "SAM"),
    (None, "cram")])
def test_infer_output_format_equals_jax(path, explicit):
    for default in ("sam", "bam"):
        assert files.infer_output_format(path, explicit, default) == \
            jfiles.infer_output_format(path, explicit, default)


def test_aux_helpers_equal_jax(inputs):
    b = read_alignments(inputs["general"]).batch
    rng = np.random.default_rng(3)
    for i in rng.choice(b.n, 300, replace=False):
        buf = b.aux_of(int(i))
        assert list(aux.iter_tags(buf)) == list(jaux.iter_tags(buf))
        assert aux.aux_to_sam_fields(buf) == jaux.aux_to_sam_fields(buf)
        for tag in ("RG", "NM", "XB", "QQ"):
            assert aux.find_tag(buf, tag) == jaux.find_tag(buf, tag)
        for tags in ({"RG"}, {"NM", "XZ", "BC"}, set()):
            np.testing.assert_array_equal(aux.keep_tags(buf, tags),
                                          jaux.keep_tags(buf, tags))
            np.testing.assert_array_equal(aux.delete_tags(buf, tags),
                                          jaux.delete_tags(buf, tags))
    for keep, remove in (({"RG", "NM"}, None), (None, {"XA", "XZ"}),
                         (set(), None), (None, None)):
        mine, theirs = b.take(np.arange(b.n)), jbatch(b)
        aux.batch_adjust_tags(mine, keep=keep, remove=remove)
        jaux.batch_adjust_tags(theirs, keep=keep, remove=remove)
        np.testing.assert_array_equal(mine.aux, theirs.aux)
        np.testing.assert_array_equal(mine.aux_off, theirs.aux_off)


def test_cigar_to_str_equals_jax(inputs):
    b = read_alignments(inputs["general"]).batch
    for i in range(0, b.n, 7):
        assert sam_text.cigar_to_str(b.cigar_of(i)) == \
            jsam.cigar_to_str(b.cigar_of(i))
