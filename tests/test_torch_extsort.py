"""The port's spill sorter, sort keys, minhash, sanitize and text
primitives against the JAX package's, on the CPU.

``io/extsort.py``: tests/test_extsort.py's cases against the port's
``merge_packed_iters`` and ``SpillSorter``, and the spilled runs of a
real batch (coordinate, name, tag and template-coordinate keys) equal to
the port's in-memory order and to the JAX ``SpillSorter``'s, with every
run file removed.  ``ops/sort_keys.py``: ``strnum_cmp``, ``name_ranks``
and ``coordinate_pack`` held to JAX's by hypothesis on names with
digits, leading zeros and ties; the other keys on the fixture's reads.
``ops/minhash.py``: ``minhash_order`` and the reverse complements on a
seeded batch, with and without a reference index.  ``core/sanitize.py``
and ``core/textutil.py`` on the fixture's faulty reads.  Integer outputs
must be equal.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_tool_fixtures import broken_batch, jbatch, make_view_inputs

from samtools_tpu.core import sanitize as jsanitize
from samtools_tpu.core import textutil as jtextutil
from samtools_tpu.io import extsort as jextsort
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu.ops import minhash as jminhash
from samtools_tpu.ops import sort_keys as jsk
from samtools_tpu_torch.core import sanitize, textutil
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io import extsort
from samtools_tpu_torch.io.extsort import SpillSorter, merge_packed_iters
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import minhash
from samtools_tpu_torch.ops import sort_keys as sk


def mkbatch(pos, tid=0):
    pos = np.asarray(pos, np.int64)
    n = len(pos)
    return ReadBatch(
        n=n, tid=np.full(n, tid, np.int32), pos=pos,
        mapq=np.zeros(n, np.uint8), flag=np.full(n, 4, np.uint16),
        mtid=np.full(n, -1, np.int32), mpos=np.full(n, -1, np.int64),
        tlen=np.zeros(n, np.int64),
        qname=np.frombuffer(b"r" * n, np.uint8).copy(),
        qname_off=np.arange(n + 1, dtype=np.int64),
        cigar_off=np.zeros(n + 1, np.int64),
        seq_off=np.zeros(n + 1, np.int64),
        aux_off=np.zeros(n + 1, np.int64))


def pack_pos(batch):
    return batch.pos.astype(np.uint64)


def batched(arr, size, mark=None):
    for s in range(0, len(arr), size):
        b = mkbatch(arr[s:s + size])
        if mark is not None:
            b.mapq = np.full(b.n, mark, np.uint8)
        yield b


def merged(iters, max_chunk=None):
    out = []
    for chunk in merge_packed_iters(iters, pack_pos):
        assert max_chunk is None or chunk.n <= max_chunk
        out.append(chunk)
    return ReadBatch.concat(out)


# ------------------------------------------------- tests/test_extsort.py
@pytest.mark.parametrize("name,a,b,size,bound", [
    ("interleaved", np.arange(0, 4000, 2), np.arange(1, 4000, 2), 128,
     None),
    # a disjoint source is not pooled whole: the pool cap is 4 batches
    ("disjoint", np.arange(0, 3000), np.arange(10000, 22000), 100, 1000),
    ("disjoint_reversed", np.arange(10000, 16000), np.arange(0, 3000), 100,
     1000),
    ("overlap", np.arange(0, 300), np.arange(150, 450), 50, None),
    ("single", np.arange(0, 1000), None, 100, None)])
def test_packed_merge_orders_and_streams(name, a, b, size, bound):
    iters = [batched(a, size)] + ([batched(b, size)] if b is not None
                                  else [])
    got = merged(iters, bound)
    want = np.sort(np.concatenate([a] + ([b] if b is not None else [])),
                   kind="stable")
    assert np.array_equal(got.pos, want)


def test_packed_merge_ties_by_source_then_sequence():
    """Equal keys come out in (source, record) order (bam_sort.c's
    heap_lt): every record of source 0 before any of source 1."""
    zeros = np.zeros(500, np.int64)
    got = merged([batched(zeros, 64, mark=0), batched(zeros, 64, mark=1)])
    assert np.array_equal(got.mapq, np.r_[np.zeros(500), np.ones(500)])


def test_packed_merge_skips_empty_batches():
    def with_empties(arr):
        for s in range(0, len(arr), 50):
            yield mkbatch(np.empty(0, np.int64))
            yield mkbatch(arr[s:s + 50])
        yield mkbatch(np.empty(0, np.int64))
    a, b = np.arange(0, 300), np.arange(150, 450)
    got = merged([with_empties(a), with_empties(b)])
    assert np.array_equal(got.pos, np.sort(np.concatenate([a, b])))


def test_packed_merge_without_a_key_raises():
    with pytest.raises(ValueError, match="packed sort key"):
        list(merge_packed_iters([batched(np.arange(10), 5)],
                                lambda b: None))


def test_generic_merge_of_disjoint_runs_streams(tmp_path):
    sorter = SpillSorter(lambda b: (b.pos,), "lex", mem_bytes=1 << 16,
                         tmpprefix=str(tmp_path / "t"))
    rng = np.random.default_rng(0)
    allpos = []
    for blk in range(6):
        pos = np.sort(rng.integers(blk * 100000, (blk + 1) * 100000, 2000))
        allpos.append(pos)
        sorter.add(mkbatch(pos))
    kind, it = sorter.finish()
    assert kind == "spill" and len(sorter.spills) >= 4
    chunks = list(it)
    assert max(c.n for c in chunks) < 11000
    assert np.array_equal(np.concatenate([c.pos for c in chunks]),
                          np.sort(np.concatenate(allpos)))
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------ spilled real runs
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    got = make_view_inputs(str(tmp_path_factory.mktemp("extsort")))
    got["batch"] = read_alignments(got["general"]).batch
    got["header"] = read_alignments(got["general"]).header
    return got


def _with_mc(b):
    """``b`` with an MC tag (its own cigar) on every paired read, as
    template-coordinate keys need."""
    from samtools_tpu_torch.io.sam_text import cigar_to_str
    b = b.take(np.arange(b.n))
    blobs = [bytes(b.aux_of(i)) + (b"MCZ" + cigar_to_str(b.cigar_of(i))
                                   .encode() + b"\0"
                                   if b.flag[i] & 1 else b"")
             for i in range(b.n)]
    b.aux = np.frombuffer(b"".join(blobs), np.uint8).copy()
    b.aux_off = np.concatenate([[0], np.cumsum([len(x) for x in blobs])])
    return b


ORDERS = {
    "coordinate": (lambda h: sk.coordinate_keys,
                   lambda h: jsk.coordinate_keys, "lex"),
    "queryname": (lambda h: (lambda b: sk.queryname_keys(b, True)),
                  lambda h: (lambda b: jsk.queryname_keys(b, True)),
                  "lex"),
    "lexicographical": (lambda h: (lambda b: sk.queryname_keys(b, False)),
                        lambda h: (lambda b: jsk.queryname_keys(b, False)),
                        "lex"),
    "tag": (lambda h: (lambda b: sk.tag_keys(b, "XI", False, True)),
            lambda h: (lambda b: jsk.tag_keys(b, "XI", False, True)),
            "lex"),
    "template": (lambda h: (lambda b: sk.template_coordinate_keys(b, h)),
                 lambda h: (lambda b: jsk.template_coordinate_keys(b, h)),
                 "py"),
}


def _sorted_chunks(sorter, batches):
    for b in batches:
        sorter.add(b)
    mode, result = sorter.finish()
    return mode, ReadBatch.concat([result] if mode == "mem"
                                  else list(result))


@pytest.mark.parametrize("order,packed", [(o, False) for o in sorted(ORDERS)]
                         + [("coordinate", True)])
def test_spilled_runs_equal_in_memory_and_jax(inputs, tmp_path, order,
                                              packed):
    """The port's spilled sort (in 7 batches, a 64 KiB arena) equals its
    in-memory sort and the JAX SpillSorter's spilled sort, column for
    column, and removes its runs."""
    mine, theirs, kind = ORDERS[order]
    b = inputs["batch"]
    if order == "template":
        b = _with_mc(b)
    h, jh = inputs["header"], JSamHeader.from_text(inputs["header"].text)
    parts = np.array_split(np.arange(b.n), 7)
    pack = sk.coordinate_pack if packed else None
    jpack = jsk.coordinate_pack if packed else None
    mode, whole = _sorted_chunks(
        SpillSorter(mine(h), kind, 1 << 30, str(tmp_path / "w")), [b])
    assert mode == "mem"
    spill = SpillSorter(mine(h), kind, 1 << 16, str(tmp_path / "s"),
                        pack_fn=pack)
    mode, got = _sorted_chunks(spill, [b.take(p) for p in parts])
    assert mode == "spill" and len(spill.spills) >= 4
    jspill = jextsort.SpillSorter(jh, theirs(jh), kind, 1 << 16,
                                  str(tmp_path / "j"), pack_fn=jpack)
    jb = jbatch(b)
    for p in parts:
        jspill.add(jb.take(p))
    jmode, jres = jspill.finish()
    want = jextsort.ReadBatch.concat(list(jres))
    for col in extsort._COLS:
        assert np.array_equal(getattr(got, col), getattr(whole, col)), col
        assert np.array_equal(getattr(got, col), getattr(want, col)), col
    assert os.listdir(tmp_path) == []


def test_run_files_round_trip(inputs, tmp_path):
    """write_run / read_run_chunks give back the batch, in row chunks,
    and JAX reads the port's run file the same."""
    b = inputs["batch"]
    fn = str(tmp_path / "x.run")
    extsort.write_run(fn, b)
    got = ReadBatch.concat(list(extsort.read_run_chunks(fn, rows=333)))
    want = jextsort.ReadBatch.concat(list(jextsort.read_run_chunks(fn,
                                                                   rows=500)))
    assert extsort.batch_nbytes(b) == jextsort.batch_nbytes(jbatch(b))
    for col in extsort._COLS:
        assert np.array_equal(getattr(got, col), getattr(b, col)), col
        assert np.array_equal(getattr(want, col), getattr(b, col)), col


# --------------------------------------------------------------- sort keys
NAME = st.lists(st.sampled_from(["r", "R", "_", ":", "0", "00", "1", "9",
                                 "10", "007", "42", "a", "z"]),
                min_size=0, max_size=6).map("".join)


@settings(max_examples=300, deadline=None)
@given(a=NAME, b=NAME)
def test_strnum_cmp_equals_jax(a, b):
    x, y = a.encode(), b.encode()
    assert np.sign(sk.strnum_cmp(x, y)) == np.sign(jsk.strnum_cmp(x, y))
    assert sk.strnum_cmp(x, x) == 0


def _name_batch(names, flags=None, tids=None, pos=None):
    n = len(names)
    enc = [s.encode() + b"\0" for s in names]
    b = mkbatch(np.zeros(n, np.int64) if pos is None else pos)
    b.qname = np.frombuffer(b"".join(enc), np.uint8).copy()
    b.qname_off = np.concatenate([[0], np.cumsum([len(e) for e in enc])])
    if flags is not None:
        b.flag = np.asarray(flags, np.uint16)
    if tids is not None:
        b.tid = np.asarray(tids, np.int32)
    return b


@settings(max_examples=60, deadline=None)
@given(names=st.lists(NAME, min_size=0, max_size=40),
       natural=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_name_ranks_and_order_equal_jax(names, natural, seed):
    """Ranks and the queryname order (name, then READ1 < READ2 < primary <
    supplementary < secondary), ties included."""
    rng = np.random.default_rng(seed)
    flags = rng.choice([0x40, 0x80, 0x41, 0x100, 0x800, 0x4], len(names))
    b = _name_batch(names, flags)
    jb = jbatch(b)
    # the port's and JAX's rank the same names: qnames end in NUL
    assert np.array_equal(sk.name_ranks(b, natural),
                          jsk.name_ranks(jb, natural))
    assert np.array_equal(sk.queryname_order(b, natural),
                          jsk.queryname_order(jb, natural))


@settings(max_examples=100, deadline=None)
@given(tids=st.lists(st.integers(-1, 5), min_size=1, max_size=50),
       seed=st.integers(0, 2 ** 16), big=st.booleans())
def test_coordinate_pack_equals_jax(tids, seed, big):
    rng = np.random.default_rng(seed)
    n = len(tids)
    hi = (1 << 32) if big else 1000
    pos = rng.integers(-1, hi, n)
    b = _name_batch(["r"] * n, rng.choice([0, 0x10, 0x4, 0x14], n),
                    tids, pos)
    got, want = sk.coordinate_pack(b), jsk.coordinate_pack(jbatch(b))
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got, want)
        assert np.array_equal(np.argsort(got, kind="stable"),
                              sk.coordinate_order(b))


def test_keys_of_real_reads_equal_jax(inputs):
    """Tag keys, the template-coordinate keys, the unclipped ends (soft
    and hard) and the mate's unclipped ends from MC on the fixture's
    reads."""
    b = _with_mc(inputs["batch"])
    jb = jbatch(b)
    h = inputs["header"]
    jh = JSamHeader.from_text(h.text)
    for tag in ("XI", "RG", "NM", "XB", "XD", "ZZ"):
        for qn in (False, True):
            for got, want in zip(sk.tag_keys(b, tag, qn),
                                 jsk.tag_keys(jb, tag, qn)):
                # a NaN value (XD) equals NaN
                assert np.array_equal(got, want, equal_nan=(
                    np.asarray(got).dtype.kind == "f")), tag
    assert sk.template_coordinate_keys(b, h) == \
        jsk.template_coordinate_keys(jb, jh)
    assert np.array_equal(sk.template_coordinate_order(b, h),
                          jsk.template_coordinate_order(jb, jh))
    for hard in (False, True):
        assert np.array_equal(sk.unclipped_start(b, hard),
                              jsk.unclipped_start(jb, hard))
        assert np.array_equal(sk.unclipped_end(b, hard),
                              jsk.unclipped_end(jb, hard))
    for cig in ("5H10S80M3I7M2S", "100M", "*", "3S4M5D6N7=8X9S1H"):
        for hard in (False, True):
            assert sk.unclipped_other_start(100, cig, hard) == \
                jsk.unclipped_other_start(100, cig, hard)
            assert sk.unclipped_other_end(100, cig, hard) == \
                jsk.unclipped_other_end(100, cig, hard)


def test_template_keys_need_mc(inputs):
    b = inputs["batch"]
    with pytest.raises(ValueError, match="no MC tag"):
        sk.template_coordinate_keys(b, inputs["header"])


# ----------------------------------------------------------------- minhash
@pytest.mark.parametrize("try_rev", [True, False])
@pytest.mark.parametrize("no_squash", [True, False])
@pytest.mark.parametrize("kmer,indexed", [(20, False), (12, False),
                                          (15, True)])
def test_minhash_order_equals_jax(inputs, try_rev, no_squash, kmer,
                                  indexed):
    """The permutation and the reverse-complemented records of a seeded
    batch, two reads in three unmapped (some shorter than k, some with N
    and homopolymer runs)."""
    b = inputs["batch"].take(np.arange(inputs["batch"].n))
    rng = np.random.default_rng(11)
    um = rng.random(b.n) < 0.66
    b.tid[um] = -1
    for i in rng.choice(b.n, 40, replace=False):
        s, e = b.seq_off[i], b.seq_off[i + 1]
        b.seq[s:min(e, s + 12)] = rng.choice([1, 15], 1)[0]
    jb = jbatch(b)
    fa = inputs["fa"] if indexed else None
    got = minhash.minhash_order(b, kmer, try_rev, no_squash, fa, 50)
    want = jminhash.minhash_order(jb, kmer, try_rev, no_squash, fa, 50)
    assert np.array_equal(got, want)
    for col in ("seq", "qual", "flag"):
        assert np.array_equal(getattr(b, col), getattr(jb, col)), col


def test_minhash_index_equals_jax(inputs):
    for no_squash in (True, False):
        got = minhash.MinhashIndex.from_fasta(inputs["fa"], 15, 100,
                                              no_squash)
        want = jminhash.MinhashIndex.from_fasta(inputs["fa"], 15, 100,
                                                no_squash)
        assert got.table == want.table and len(got.table) > 100


# -------------------------------------------------- sanitize and textutil
@pytest.mark.parametrize("words", ["all", "on", "on,cigarx", "pos",
                                   "pos,unmap", "cigar,unmap,pos",
                                   "mqual,aux,unmap", "cigdup", "off"])
def test_sanitize_batch_equals_jax(inputs, words):
    flags = sanitize.parse_sanitize_options(words)
    assert flags == jsanitize.parse_sanitize_options(words)
    b = broken_batch(inputs["batch"])
    jb = jbatch(b)
    h = inputs["header"]
    got = sanitize.sanitize_batch(b, h, flags)
    want = jsanitize.sanitize_batch(jb, JSamHeader.from_text(h.text), flags)
    for col in extsort._COLS:
        assert np.array_equal(getattr(got, col), getattr(want, col)), col


def test_sanitize_options_parse_as_jax():
    for words in ("", "bogus", "all,pos", "none,cigarx", "*", "on,aux",
                  "mqual,cigdup", "off,pos"):
        assert sanitize.parse_sanitize_options(words) == \
            jsanitize.parse_sanitize_options(words), words


def test_text_primitives_equal_jax(inputs):
    b = broken_batch(inputs["batch"])
    rows = np.arange(b.n)[::-1]
    for got, want in zip(textutil.cigar_strs(b.cigar, b.cigar_off, rows),
                         jtextutil.cigar_strs(b.cigar, b.cigar_off, rows)):
        assert np.array_equal(got, want)
    vals = np.array([0, 9, 10, 99, 100, 123456789, 7], np.int64)
    for got, want in zip(textutil.itoa(vals), jtextutil.itoa(vals)):
        assert np.array_equal(got, want)
