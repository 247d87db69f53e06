"""The host-side modules of the port's mpileup slice against their JAX
package counterparts, on the same inputs: ReadBatch.take/concat/end_pos,
the header's read groups, aux tag values, flag names, FASTA and BED
indexes, the CIGAR op table, the overlap tweak, the native text writer,
the contig codes, the host BAQ, the depth cap and the window cursor."""

import gzip

import numpy as np
import pytest
import torch

from samtools_tpu.core import aux as jaux
from samtools_tpu.core.batch import ReadBatch as JReadBatch
from samtools_tpu.io import bed as jbed
from samtools_tpu.io import fasta as jfasta
from samtools_tpu.io import native as jnative
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu.ops import baq as jbaq
from samtools_tpu.ops import cigar as jcigar
from samtools_tpu.ops import overlaps as jov
from samtools_tpu.tools import flags_cmd as jflags
from samtools_tpu.tools import mpileup_cmd as jmc
from samtools_tpu_torch import sim
from samtools_tpu_torch.core import aux
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io import bed, bgzf, fasta, native
from samtools_tpu_torch.io.header import SamHeader
from samtools_tpu_torch.ops import baq, cigar, overlaps
from samtools_tpu_torch.tools import flags_cmd, mpileup_cmd

torch.set_num_threads(1)

COLUMNS = ("tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen", "qname",
           "qname_off", "cigar", "cigar_off", "seq", "seq_off", "qual", "aux",
           "aux_off")


def _pairs(n_len=20000, seed=5, tags=True):
    ref = sim.simulate_reference(n_len, seed=3)
    b = sim.simulate_overlapping_pairs(n_len, coverage=6.0, ref=ref,
                                       seed=seed)
    if tags:
        vals = [b"RGZgrpA\0", b"XIi\x07\0\0\0", b"", b"RGZgrpB\0XAAq"]
        pick = [vals[i % 4] for i in range(b.n)]
        b.aux = np.frombuffer(b"".join(pick), np.uint8).copy()
        b.aux_off = np.concatenate([[0], np.cumsum([len(p) for p in pick])])
    return ref, b


def _jax(b):
    return JReadBatch(**{c: getattr(b, c).copy() for c in COLUMNS}, n=b.n)


def _same(a, b):
    assert a.n == b.n
    for c in COLUMNS:
        assert np.array_equal(getattr(a, c), getattr(b, c)), c


def test_take_concat_end_pos_equal_jax():
    _, b = _pairs()
    jb = _jax(b)
    rng = np.random.default_rng(1)
    idx = rng.permutation(b.n)[:b.n // 3]
    _same(b.take(idx), jb.take(idx))
    _same(b.take(np.zeros(0, np.int64)), jb.take(np.zeros(0, np.int64)))
    parts = [b.take(idx[:10]), ReadBatch(), b.take(idx[10:])]
    _same(ReadBatch.concat(parts),
          JReadBatch.concat([jb.take(idx[:10]), JReadBatch(),
                             jb.take(idx[10:])]))
    assert np.array_equal(b.end_pos(), jb.end_pos())
    with pytest.raises(IndexError):
        b.take(np.array([b.n]))


def test_read_groups_and_tag_values_equal_jax():
    text = ("@HD\tVN:1.6\n@RG\tID:a\tSM:s1\n@RG\tID:b\n@RG\tSM:x\tID:c"
            "\tSM:s1\n@CO\tRG\n")
    assert SamHeader.from_text(text).rg_to_sample() == \
        JSamHeader.from_text(text).rg_to_sample()
    _, b = _pairs(tags=True)
    b.aux = np.concatenate([b.aux, np.frombuffer(
        b"XFf\0\0\xc0?XBBC\3\0\0\0\1\2\3", np.uint8)])
    b.aux_off[-1] = b.aux.size
    for tag in ("RG", "XI", "XA", "XF", "XB", "ZZ"):
        mine = aux.batch_tag_values(b, tag)
        want = jaux.batch_tag_values(_jax(b), tag)
        assert list(mine) == list(want), tag
    assert aux.batch_tag_values(b, "RG")[0] == "grpA"


@pytest.mark.parametrize("s", ["0x904", "1796", "0o17", "UNMAP,DUP",
                               "PAIRED,,READ2", "SUPPLEMENTARY", "BOGUS",
                               "UNMAP,bogus", ""])
def test_str2flag_equals_jax(s):
    assert flags_cmd.str2flag(s) == jflags.str2flag(s)


@pytest.mark.parametrize("form", ["plain", "fai", "bgzf", "gzip", "crlf"])
def test_fasta_fetch_equals_jax(tmp_path, form):
    rng = np.random.default_rng(2)
    seqs = {"c1": rng.choice(list(b"ACGTNacgt"), 1000).astype(np.uint8),
            "c2 desc": rng.choice(list(b"ACGT"), 77).astype(np.uint8),
            "c3": rng.choice(list(b"ACGT"), 60).astype(np.uint8)}
    eol = b"\r\n" if form == "crlf" else b"\n"
    raw = b"".join(b">" + k.encode() + eol + b"".join(
        v[i:i + 60].tobytes() + eol for i in range(0, v.size, 60))
        for k, v in seqs.items())
    path = tmp_path / "r.fa"
    if form == "bgzf":
        path.write_bytes(bgzf.compress(raw))
    elif form == "gzip":
        path.write_bytes(gzip.compress(raw))
    else:
        path.write_bytes(raw)
    if form == "fai":
        (tmp_path / "r.fa.fai").write_text(
            "c1\t1000\t4\t60\t61\nc2\t77\t1025\t60\t61\n")
    mine, want = fasta.load_fasta(str(path)), jfasta.load_fasta(str(path))
    assert mine.order == want.order
    for name in ("c1", "c2", "c3", "none"):
        assert mine.has(name) == want.has(name)
        for beg, end in ((0, None), (5, 130), (59, 61), (990, 2000),
                         (70, 70)):
            assert mine.fetch(name, beg, end) == want.fetch(name, beg, end)
    if form != "fai":
        assert mine.fetch("c1") == seqs["c1"].tobytes()


def test_bed_overlap_equals_jax(tmp_path):
    path = tmp_path / "r.bed"
    path.write_text("browser x\ntrack t\n#c\nchr1\t100\t200\nchr1 50 60 x"
                    "\nchr1\t500\t400\nchr2\t10\t20\nchr1\t150\t900\n"
                    "chr3 7\nbad\tx\ty\nchr1\t-5\t3\n\n")
    mine, want = bed.read_bed(str(path)), jbed.read_bed(str(path))
    rng = np.random.default_rng(3)
    beg = rng.integers(-10, 1000, 500)
    end = beg + rng.integers(1, 50, 500)
    for chrom in ("chr1", "chr2", "chr3", "chrX"):
        assert np.array_equal(mine.overlap(chrom, beg, end),
                              want.overlap(chrom, beg, end))
        for p in (0, 6, 55, 199, 899, 900):
            assert mine.overlap_one(chrom, p, p + 1) == \
                want.overlap_one(chrom, p, p + 1)


def test_expand_ops_equals_jax():
    _, b = _pairs()
    idx = np.arange(0, b.n, 7)
    for sel in (None, idx):
        mine, want = cigar.expand_ops(b, sel), jcigar.expand_ops(_jax(b), sel)
        for f in ("rid", "op", "oplen", "rpos", "qpos", "op_off"):
            assert np.array_equal(getattr(mine, f), getattr(want, f)), f
        assert mine.n == want.n


def test_tweak_overlaps_equals_jax():
    _, b = _pairs()
    # an orphan-mate read (mpos -1), a read whose mate is unmapped, and a
    # pair whose first mate changed contig
    b.mpos[3] = -1
    b.flag[5] |= 0x8
    b.mtid[8] = 1
    jb = _jax(b)
    before = b.qual.copy()
    overlaps.tweak_overlaps(b)
    jov.tweak_overlaps(jb)
    assert np.array_equal(b.qual, jb.qual)
    assert (b.qual != before).sum() > 1000


@pytest.mark.parametrize("flags", [
    dict(all_mode=False, rev_del=0, no_ends=0, no_ins=0, no_del=0),
    dict(all_mode=True, rev_del=1, no_ends=1, no_ins=1, no_del=2),
    dict(all_mode=False, rev_del=1, no_ends=0, no_ins=2, no_del=1),
])
def test_text_writer_equals_jax(flags):
    ref, b = _pairs()
    # a padded insertion, a reference skip and a deletion behind an
    # insertion
    b.cigar = b.cigar.copy()
    for r, cig in ((4, [(40 << 4) | 0, (2 << 4) | 6, (3 << 4) | 1,
                        (57 << 4) | 0]),
                   (9, [(30 << 4) | 0, (500 << 4) | 3, (70 << 4) | 0]),
                   (12, [(20 << 4) | 0, (2 << 4) | 1, (3 << 4) | 2,
                         (78 << 4) | 0])):
        k = int(b.cigar_off[r])
        n_old = int(b.cigar_off[r + 1]) - k
        b.cigar = np.concatenate([b.cigar[:k], np.array(cig, np.uint32),
                                  b.cigar[k + n_old:]])
        b.cigar_off[r + 1:] += len(cig) - n_old
    refb = ref.tobytes().lower()[:15000]
    mask = (np.arange(3000) % 7 != 0).astype(np.uint8)
    args = (refb, "chrS", 1000, 4000, flags["all_mode"], mask, 13,
            flags["rev_del"], flags["no_ends"], flags["no_ins"],
            flags["no_del"])
    mine = native.mpileup_text(b, *args)
    assert mine == jnative.mpileup_text(_jax(b), *args)
    assert mine.count(b"\n") > 1000
    assert native.mpileup_text(b, None, "c", 0, 10, True, None, 0, 0, 0, 0,
                               0) == jnative.mpileup_text(
        _jax(b), None, "c", 0, 10, True, None, 0, 0, 0, 0, 0)
    with pytest.raises(ValueError):
        native.mpileup_text(b, *args[:5], mask[:10], *args[6:])


def test_ref_ints_equal_jax():
    ref = b"ACGTNacgtnRYKMSWBDHVuU=-*." * 3
    assert np.array_equal(baq._ref_ints(ref), jbaq._ref_ints(ref))


def test_host_baq_equals_jax(monkeypatch):
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    ref, b = _pairs(tags=False)
    jb = _jax(b)
    tagged = b.take(np.arange(4))
    baq.apply_baq_batch(b, baq._ref_ints(ref.tobytes()))
    jbaq.apply_baq_batch(jb, ref.tobytes(), ref.size)
    assert np.array_equal(b.qual, jb.qual)
    # a stored ZQ tag on one read: every read takes the per-read f64 path,
    # which applies the tag there and appends ZQ to the others
    tagged.aux = np.frombuffer(b"ZQZ" + b"A" * 100 + b"\0", np.uint8).copy()
    tagged.aux_off = np.array([0, 0, 0, tagged.aux.size, tagged.aux.size])
    jtagged = _jax(tagged)
    baq.apply_baq_batch(tagged, baq._ref_ints(ref.tobytes()))
    jbaq.apply_baq_batch(jtagged, ref.tobytes(), ref.size)
    _same(tagged, jtagged)
    assert tagged.aux.size > 3 * 100


@pytest.mark.parametrize("maxcnt", [3, 8, 8000])
def test_depth_cap_stream_equals_jax(maxcnt):
    _, b = _pairs(tags=False)
    wb, we = 0, 4000
    prev = jprev = None
    while wb < 20000:
        sel = np.nonzero((b.pos < we) & (b.end_pos() > wb))[0]
        sub = b.take(sel)
        keep, prev = mpileup_cmd._depth_cap_stream(sub, maxcnt, wb, we, prev)
        jkeep, jprev = jmc._depth_cap_stream(_jax(sub), maxcnt, wb, we,
                                             jprev)
        assert np.array_equal(keep, jkeep) and np.array_equal(prev, jprev)
        assert keep.all() == (maxcnt == 8000)
        wb, we = we, we + 4000


def test_window_cursor_equals_jax(tmp_path, monkeypatch):
    """The cursor's windows over a two-contig BAM with filtered reads:
    the same reads in the same order, halo reads carried."""
    from samtools_tpu.io.stream import BamStream as JBamStream
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.stream import BamStream
    _, b = _pairs(tags=True)
    b2 = b.take(np.arange(b.n))
    b2.tid[:] = 1
    both = ReadBatch.concat([b, b2])
    both.flag[::50] |= 0x400
    text = "@HD\tVN:1.6\n@SQ\tSN:a\tLN:20000\n@SQ\tSN:b\tLN:20000\n"
    path = str(tmp_path / "two.bam")
    write_bam(path, SamHeader.from_text(text), both)
    monkeypatch.setattr(mpileup_cmd, "WINDOW_COLS", 3000)
    monkeypatch.setattr(jmc, "WINDOW_COLS", 3000)
    conf = dict(rflag_require=0, rflag_filter=mpileup_cmd.DEFAULT_FF,
                all=0, rghash={"grpB"})
    with BamStream(path, window_bytes=1 << 16) as st, \
            JBamStream(path) as jst:
        mine = list(mpileup_cmd._stream_windows([st], conf, None,
                                                st.header))
        want = list(jmc._stream_windows([jst], conf, None, jst.header))
    assert len(mine) == len(want) > 10
    for (t, wb, we, subs), (jt, jwb, jwe, jsubs) in zip(mine, want):
        assert (t, wb, we) == (jt, jwb, jwe)
        _same(subs[0], jsubs[0])
