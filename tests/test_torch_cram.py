"""The port's CRAM modules (``samtools_tpu_torch/io/cram*.py``,
``io/hfile.py``) against the JAX package's, on the CPU:

* each block codec (rANS 4x8 o0/o1, rANS Nx16 o0/o1 and its PACK, RLE
  and STRIPE forms, arith, fqzcomp, tok3, and gzip/bzip2/lzma through
  ``uncompress``) on seeded numpy byte strings: the port's encoder gives
  the JAX encoder's bytes, and each package decodes the other's stream;
* ``read_alignments`` of CRAM 3.0 and 3.1 files written by the JAX writer
  (messy single-end reads; overlapping pairs with two read groups; mapped
  and unmapped reads under a two-contig header) equals the JAX read in
  every ``ReadBatch`` column and in the header text, with the FASTA, with
  ``REF_PATH`` as a directory and as a ``%s`` pattern (FASTA-form files),
  with ``REF_CACHE``, and with no reference, where a mapped read's bases
  that no feature stores stay ``N`` (the JAX package's fill);
* ``encode_cram`` and ``write_alignments`` give the JAX writer's bytes and
  ``.crai`` lines, and keep its fault past 2^21 (positions lost);
* ``hfile.resolve`` maps plain paths, ``file://`` URLs and cached remote
  URLs to the JAX package's local paths (nothing is fetched).
"""

import gzip
import hashlib
import os

import numpy as np
import pytest
from test_mpileup_device_tool import _messy_batch
from torch_tool_fixtures import REF_LEN, write_fasta

from samtools_tpu.core.batch import ReadBatch as JReadBatch
from samtools_tpu.io import cram_codecs as jcc
from samtools_tpu.io import cram_fqz as jfqz
from samtools_tpu.io import cram_tok3 as jtok
from samtools_tpu.io import hfile as jhfile
from samtools_tpu.io.cram_encode import encode_cram as jencode_cram
from samtools_tpu.io.cram_encode import itf8_enc as jitf8_enc
from samtools_tpu.io.files import cram_ref_lookup as jref_lookup
from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.io.files import write_alignments as jwrite
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu_torch import sim
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io import cram_codecs as cc
from samtools_tpu_torch.io import cram_fqz as fqz
from samtools_tpu_torch.io import cram_tok3 as tok
from samtools_tpu_torch.io import hfile
from samtools_tpu_torch.io.cram import itf8
from samtools_tpu_torch.io.cram_encode import encode_cram, itf8_enc
from samtools_tpu_torch.io.files import cram_ref_lookup, read_alignments
from samtools_tpu_torch.io.files import write_alignments
from samtools_tpu_torch.io.header import SamHeader

COLUMNS = ("n", "tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen",
           "qname", "qname_off", "cigar", "cigar_off", "seq", "seq_off",
           "qual", "aux", "aux_off")
SIM2_LEN = 5000


# ------------------------------------------------------------- codecs
def _data(shape: str, n: int = 3000) -> bytes:
    """Seeded byte strings of the shapes CRAM blocks hold."""
    rng = np.random.default_rng(sum(map(ord, shape)))
    if shape == "dna":
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
    if shape == "quals":
        return bytes(np.clip(rng.normal(30, 6, n), 2, 41).astype(np.uint8))
    if shape == "runs":
        syms = rng.choice(np.frombuffer(b"AB\x00", np.uint8), n // 20)
        return bytes(np.repeat(syms, rng.integers(1, 40, syms.size)))
    if shape == "one":
        return b"\x07" * n
    if shape == "bytes":
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if shape == "short":
        return bytes(rng.integers(0, 8, 20, dtype=np.uint8))
    raise ValueError(shape)


SHAPES = ("dna", "quals", "runs", "one", "bytes", "short")


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_rans4x8_both_directions(shape, order):
    d = _data(shape)
    want = jcc.rans4x8_compress(d, order)
    got = cc.rans4x8_compress(d, order)
    assert got == want
    assert cc.uncompress(cc.RANS4x8, want, len(d)) == d
    assert jcc.uncompress(jcc.RANS4x8, got, len(d)) == d


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_ransnx16_both_directions(shape, order):
    d = _data(shape)
    want = jcc.ransNx16_compress(d, order)
    got = cc.ransNx16_compress(d, order)
    assert got == want
    assert cc.uncompress(cc.RANSNx16, want, len(d)) == d
    assert jcc.uncompress(jcc.RANSNx16, got, len(d)) == d


def _inner(mod, data: bytes, order: int) -> tuple[int, bytes]:
    """An Nx16 stream of ``data`` from ``mod``'s encoder, split into its
    flags byte and the body after its size."""
    s = mod.ransNx16_compress(data, order)
    _, i = mod.uint7(s, 1)
    return s[0], s[i:]


def _pack(data: bytes) -> tuple[bytes, bytes]:
    """PACK's symbol map and packed bytes (CRAM codecs spec 3.4.2)."""
    syms = sorted(set(data))
    code = np.zeros(256, np.uint8)
    code[syms] = np.arange(len(syms))
    v = code[np.frombuffer(data, np.uint8)]
    per = 8 if len(syms) <= 2 else 4 if len(syms) <= 4 else 2
    v = np.concatenate([v, np.zeros(-v.size % per, np.uint8)])
    v = v.reshape(-1, per).astype(np.uint16)
    bits = 8 // per
    out = np.zeros(v.shape[0], np.uint16)
    for k in range(per):
        out |= v[:, k] << (bits * k)
    return bytes(syms), out.astype(np.uint8).tobytes()


def _rle(mod, data: bytes) -> tuple[bytes, bytes]:
    """RLE's raw meta (the run symbols, then each run's length less one)
    and its literals, for runs of the symbols A and 0."""
    rle_syms = sorted({s for s in data if s in b"A\x00"})
    meta = bytearray([len(rle_syms)]) + bytes(rle_syms)
    lits = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i]:
            j += 1
        if data[i] in rle_syms:
            lits.append(data[i])
            meta += mod.uint7_enc(j - i - 1)
        else:
            lits += data[i:j]
        i = j
    return bytes(meta), bytes(lits)


def _transformed(mod, data: bytes, form: str, order: int) -> bytes:
    """An Nx16 stream of ``data`` in a PACK, RLE, PACK+RLE or STRIPE form,
    its entropy-coded core from ``mod``'s encoder."""
    u7 = mod.uint7_enc
    if form == "stripe":
        parts = [mod.ransNx16_compress(data[j::4], order) for j in range(4)]
        return (bytes([mod.X_STRIPE]) + u7(len(data)) + bytes([4])
                + b"".join(u7(len(p)) for p in parts) + b"".join(parts))
    head = b""
    flags = 0
    body = data
    if "pack" in form:
        pmap, body = _pack(body)
        flags |= mod.X_PACK
        head += bytes([len(pmap)]) + pmap + u7(len(body))
    if "rle" in form:
        meta, body = _rle(mod, body)
        flags |= mod.X_RLE
        head += u7(len(meta) << 1 | 1) + u7(len(body)) + meta
    fl, core = _inner(mod, body, order)
    return bytes([fl | flags]) + u7(len(data)) + head + core


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("form", ["pack", "rle", "pack_rle", "stripe"])
def test_ransnx16_transforms_both_directions(form, order):
    d = _data("runs") if "rle" in form else _data("dna")
    want = _transformed(jcc, d, form, order)
    got = _transformed(cc, d, form, order)
    assert got == want
    assert want[0] & {"pack": cc.X_PACK, "rle": cc.X_RLE,
                      "pack_rle": cc.X_PACK | cc.X_RLE,
                      "stripe": cc.X_STRIPE}[form]
    assert cc.uncompress(cc.RANSNx16, want, len(d)) == d
    assert jcc.uncompress(jcc.RANSNx16, got, len(d)) == d
    assert cc.expand_method(cc.RANSNx16, want) == \
        jcc.expand_method(jcc.RANSNx16, want)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", ["dna", "quals", "one", "bytes"])
def test_arith_both_directions(shape, order):
    d = _data(shape, 1500)
    want = jfqz.arith_compress(d, order)
    got = fqz.arith_compress(d, order)
    assert got == want
    assert cc.uncompress(cc.ARITH, want, len(d)) == d
    assert jcc.uncompress(jcc.ARITH, got, len(d)) == d


def test_fqzcomp_both_directions():
    rng = np.random.default_rng(5)
    lengths = [int(x) for x in rng.integers(30, 150, 20)]
    q = bytes(np.clip(rng.normal(32, 5, sum(lengths)), 2, 41)
              .astype(np.uint8))
    want = jfqz.fqz_compress(q, lengths)
    got = fqz.fqz_compress(q, lengths)
    assert got == want
    assert cc.uncompress(cc.FQZ, want, len(q)) == q
    assert jcc.uncompress(jcc.FQZ, got, len(q)) == q
    assert fqz.fqz_uncompress(want, len(q)) == \
        jfqz.fqz_uncompress(want, len(q))


def test_tok3_both_directions():
    rng = np.random.default_rng(6)
    names = [f"SRR{1000 + i // 2}.{int(x)}:{i % 7}:{i:05d}".encode()
             for i, x in enumerate(rng.integers(0, 999, 300))]
    names += [b"read", b"read", b"r" * 40, b"x1y2z3"]
    want = jtok.tok3_compress(names)
    got = tok.tok3_compress(names)
    assert got == want
    joined = b"".join(n + b"\0" for n in names)
    assert cc.uncompress(cc.TOK3, want, len(joined)) == joined
    assert jcc.uncompress(jcc.TOK3, got, len(joined)) == joined


def test_stdlib_methods_through_uncompress():
    import bz2
    import lzma
    import zlib
    d = _data("quals")
    for method, blob in ((cc.RAW, d), (cc.GZIP, gzip.compress(d)),
                         (cc.GZIP, zlib.compress(d)),
                         (cc.BZIP2, bz2.compress(d)),
                         (cc.LZMA, lzma.compress(d))):
        assert cc.uncompress(method, blob, len(d)) == d
        assert jcc.uncompress(method, blob, len(d)) == d


def test_unknown_method_raises_as_the_jax_package():
    with pytest.raises(NotImplementedError) as want:
        jcc.uncompress(42, b"", 0)
    with pytest.raises(NotImplementedError) as got:
        cc.uncompress(42, b"", 0)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- CRAM files
def _to_jax(b: ReadBatch) -> JReadBatch:
    return JReadBatch(**vars(b))


def _unmapped_batch(messy: JReadBatch) -> JReadBatch:
    """300 messy reads: the first 180 on sim1 (every tenth one unmapped
    but placed), 60 moved to sim2, the last 60 unmapped and unplaced."""
    b = messy.take(np.arange(300))
    b.flag = b.flag.copy()
    b.tid, b.pos, b.mapq = b.tid.copy(), b.pos.copy(), b.mapq.copy()
    placed = np.arange(0, 180, 10)
    b.flag[placed] |= 4
    b.mapq[placed] = 0
    b.tid[180:240] = 1
    b.pos[180:240] = np.sort(b.pos[180:240] % (SIM2_LEN - 200))
    b.tid[240:] = -1
    b.pos[240:] = -1
    b.flag[240:] = 4
    b.mapq[240:] = 0
    return b


@pytest.fixture(scope="module")
def crams(tmp_path_factory):
    """The three inputs as CRAM 3.0 and 3.1 (JAX writer, the reference
    from the FASTA), under headers with M5 tags; the FASTA; a REF_CACHE
    directory of bare sequences and a REF_PATH directory of FASTA-form
    files, each named by its MD5."""
    d = tmp_path_factory.mktemp("cram")
    ref = sim.simulate_reference(REF_LEN, seed=7)
    ref2 = sim.simulate_reference(SIM2_LEN, seed=8)
    fa = str(d / "ref.fa")
    write_fasta(fa, ref)
    with open(fa, "a") as f:
        f.write(">sim2\n" + ref2.tobytes().decode() + "\n")
    cache, fasta_dir = d / "cache", d / "fasta_form"
    cache.mkdir()
    fasta_dir.mkdir()
    md5s = {}
    for name, seq in (("sim1", ref), ("sim2", ref2)):
        md5s[name] = hashlib.md5(seq.tobytes().upper()).hexdigest()
        (cache / md5s[name]).write_bytes(seq.tobytes())
        (fasta_dir / md5s[name]).write_bytes(
            b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")
    sq1 = f"@SQ\tSN:sim1\tLN:{REF_LEN}\tM5:{md5s['sim1']}\n"
    sq2 = f"@SQ\tSN:sim2\tLN:{SIM2_LEN}\tM5:{md5s['sim2']}\n"
    messy = _messy_batch(ref, REF_LEN)
    pairs = sim.simulate_overlapping_pairs(REF_LEN, coverage=6.0, ref=ref,
                                           seed=5).take(np.arange(600))
    tags = [b"RGZgrpA\0", b"RGZgrpB\0"]
    pick = np.arange(pairs.n) % 3 == 0
    pairs.aux = np.frombuffer(b"".join(tags[int(k)] for k in pick),
                              np.uint8)
    pairs.aux_off = np.concatenate([[0], np.cumsum(
        [len(tags[int(k)]) for k in pick])]).astype(np.int64)
    inputs = {
        "messy": ("@HD\tVN:1.6\tSO:coordinate\n" + sq1,
                  messy.take(np.arange(600))),
        "pairs": ("@HD\tVN:1.6\tSO:coordinate\n" + sq1
                  + "@RG\tID:grpA\tSM:s1\n@RG\tID:grpB\tSM:s2\n",
                  _to_jax(pairs)),
        "unmapped": ("@HD\tVN:1.6\tSO:coordinate\n" + sq1 + sq2,
                     _unmapped_batch(messy)),
    }
    files = {}
    for name, (text, b) in inputs.items():
        for v in ("3.0", "3.1"):
            p = str(d / f"{name}{v}.cram")
            jwrite(p, JSamHeader.from_text(text), b, fmt="cram",
                   reference=fa, write_index=True, fmt_opts={"version": v})
            files[name, v] = p
    return {"fa": fa, "cache": str(cache), "fasta_dir": str(fasta_dir),
            "files": files, "inputs": inputs}


def _ref_env(monkeypatch, crams, mode: str) -> str | None:
    """Set up one way of finding the reference; the FASTA to pass, if
    any."""
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)
    if mode == "ref_path_dir":
        monkeypatch.setenv("REF_PATH", crams["cache"])
    elif mode == "ref_path_pattern":
        monkeypatch.setenv("REF_PATH", "/nonexistent/%s:"
                           + crams["fasta_dir"] + "/%s")
    elif mode == "ref_cache":
        monkeypatch.setenv("REF_CACHE", crams["cache"])
    return crams["fa"] if mode == "fasta" else None


def _same_batch(got, want) -> None:
    for k in COLUMNS:
        g, w = getattr(got, k), getattr(want, k)
        if k == "n":
            assert g == w
            continue
        assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("mode", ["fasta", "ref_path_dir", "ref_path_pattern",
                                  "ref_cache", "none"])
@pytest.mark.parametrize("version", ["3.0", "3.1"])
@pytest.mark.parametrize("name", ["messy", "pairs", "unmapped"])
def test_read_cram_equals_jax(crams, monkeypatch, name, version, mode):
    fa = _ref_env(monkeypatch, crams, mode)
    path = crams["files"][name, version]
    want = jread(path, reference=fa)
    got = read_alignments(path, reference=fa)
    assert got.format == want.format == "cram"
    assert got.header.text == want.header.text
    assert got.header.ref_names == want.header.ref_names
    assert got.header.ref_lens == want.header.ref_lens
    _same_batch(got.batch, want.batch)
    text, b = crams["inputs"][name]
    assert got.batch.n == b.n
    mapped = (b.flag & 4) == 0
    if mode != "none":
        # the reference found: the bases are the ones written
        assert np.array_equal(got.batch.seq, b.seq)
    else:
        # no reference: a mapped read's matched bases stay N (the JAX
        # package's fill); its features (clips, insertions, substitutions
        # decoded against N) carry bases, and an unmapped read keeps its
        # stored ones.  The messy reads' indels misalign their bases, so
        # a third of them are substitutions.
        n_mapped = int(b.l_qseq[mapped].sum())
        fill = np.repeat(mapped, b.l_qseq) & (got.batch.seq == 15)
        assert fill.sum() > 0.5 * n_mapped
        assert np.array_equal(got.batch.seq[~np.repeat(mapped, b.l_qseq)],
                              b.seq[~np.repeat(mapped, b.l_qseq)])


@pytest.mark.parametrize("version", [(3, 0), (3, 1)])
@pytest.mark.parametrize("name", ["messy", "pairs", "unmapped"])
def test_encode_cram_equals_jax(crams, monkeypatch, name, version):
    _ref_env(monkeypatch, crams, "none")
    text, b = crams["inputs"][name]
    path = crams["files"][name, "%d.%d" % version]
    with open(path, "rb") as f:
        want = f.read()
    h = SamHeader.from_text(text)
    got, crai = encode_cram(h, ReadBatch.from_columns(vars(b)),
                            cram_ref_lookup(h, crams["fa"]), version=version)
    assert got == want
    _, jcrai = jencode_cram(JSamHeader.from_text(text), b,
                            jref_lookup(JSamHeader.from_text(text),
                                        crams["fa"]), version=version)
    assert crai == jcrai and len(crai) >= 1
    with gzip.open(path + ".crai") as f:
        assert f.read().decode() == "".join(
            "%d\t%d\t%d\t%d\t%d\t%d\n" % t for t in crai)


def test_write_alignments_cram_through_ref_cache(crams, monkeypatch,
                                                 tmp_path):
    """The port's writer finds the reference by M5 in REF_CACHE (no
    FASTA) and writes the JAX writer's bytes and .crai; a BAM too."""
    _ref_env(monkeypatch, crams, "ref_cache")
    text, b = crams["inputs"]["unmapped"]
    pb = ReadBatch.from_columns(vars(b))
    mine, theirs = str(tmp_path / "a.cram"), str(tmp_path / "b.cram")
    write_alignments(mine, SamHeader.from_text(text), pb, fmt="cram",
                     write_index=True)
    jwrite(theirs, JSamHeader.from_text(text), b, fmt="cram",
           write_index=True)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    with gzip.open(mine + ".crai") as f, gzip.open(theirs + ".crai") as g:
        assert f.read() == g.read()
    bam = str(tmp_path / "a.bam")
    write_alignments(bam, SamHeader.from_text(text), pb, fmt="bam")
    _same_batch(read_alignments(bam).batch, pb)


@pytest.mark.parametrize("version", ["3.0", "3.1"])
def test_cram_writer_loses_positions_past_2_21(tmp_path, version):
    """A fault of the JAX writer that the port keeps: ``itf8_enc`` takes
    its 3-byte form up to 2^22 where ITF8's holds 21 bits, so from 2^21
    (2,097,152) on a value is written with the 4-byte form's lead byte
    and read back as something else.  Reads of a contig of 2^21 + 4096
    bases from 2^21 - 300 on (18 reads): both writers give the same
    bytes, both readers the same batch, and every read at or past 2^21,
    and only those, comes back at a wrong position (the first, 2,097,184,
    as 8,671)."""
    for enc in (itf8_enc, jitf8_enc):
        assert itf8(enc((1 << 21) - 1), 0) == ((1 << 21) - 1, 3)
        assert enc(1 << 21) == b"\xe0\x00\x00"
    length = (1 << 21) + 4096
    ref = sim.simulate_reference(length, seed=7)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, ref)
    b = sim.simulate_batch(length, coverage=0.5, seed=3)
    b = b.take(np.flatnonzero(b.pos >= (1 << 21) - 300))
    m5 = hashlib.md5(ref.tobytes().upper()).hexdigest()
    text = (f"@HD\tVN:1.6\tSO:coordinate\n"
            f"@SQ\tSN:sim1\tLN:{length}\tM5:{m5}\n")
    mine, theirs = str(tmp_path / "a.cram"), str(tmp_path / "b.cram")
    write_alignments(mine, SamHeader.from_text(text), b, fmt="cram",
                     reference=fa, fmt_opts={"version": version})
    jwrite(theirs, JSamHeader.from_text(text), _to_jax(b), fmt="cram",
           reference=fa, fmt_opts={"version": version})
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got = read_alignments(mine, reference=fa).batch
    _same_batch(got, jread(mine, reference=fa).batch)
    assert b.n == got.n == 18
    np.testing.assert_array_equal(got.pos != b.pos, b.pos >= 1 << 21)
    first = int(np.argmax(b.pos >= 1 << 21))
    assert (b.pos[first], got.pos[first]) == (2_097_184, 8_671)


# --------------------------------------------------------------- hfile
def test_hfile_resolve_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SAMTPU_CACHE", str(tmp_path / "cache"))
    p = tmp_path / "x.cram"
    p.write_bytes(b"CRAM")
    url = "https://example.invalid/data/x.cram?token=1"
    for path in (str(p), "relative/x.bam", "-", "file://" + str(p)):
        assert hfile.is_remote(path) == jhfile.is_remote(path)
        assert hfile.resolve(path) == jhfile.resolve(path)
    assert hfile.resolve("file://" + str(p)) == str(p)
    assert all(hfile.is_remote(u) for u in (url, "http://h/x",
                                            "ftp://h/x"))
    # a URL already in the cache is served from it, never fetched
    key = hashlib.sha256(url.encode()).hexdigest()[:32]
    cached = os.path.join(str(tmp_path / "cache"), key + "-x.cram")
    os.makedirs(os.path.dirname(cached), exist_ok=True)
    with open(cached, "wb") as f:
        f.write(b"CRAM")
    assert hfile.resolve(url) == jhfile.resolve(url) == cached
