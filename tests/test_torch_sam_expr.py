"""view's filter language and record predicates against the JAX package,
on the CPU:

* ``compile_filter`` gives the JAX mask on a table of expressions (flag
  bits and ``flag.*`` names, mapq, pos, endpos, rlen, qlen, rname, mrname,
  qname regexes, cigar, seq and qual text, ``[TAG]`` lookups of every aux
  type, ``exists``, ``default``, ``length``, the maths functions, ``!``,
  ``&&``, ``||``, bit operators, strings against numbers, library) over
  the view inputs' reads, and the same ``ExprError`` on malformed ones;
* ``ops/filters`` equals the JAX functions: the X31, Wang and FNV-1a
  hashes with their uint32 wrap-around and glibc's first ``rand()`` on
  hypothesis-drawn inputs, ``subsample_keep``, ``qlen_from_cigar``,
  ``flag_mask`` and ``qnames_array`` on the reads.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_tool_fixtures import jbatch, make_view_inputs

from samtools_tpu.core import sam_expr as jexpr
from samtools_tpu.io.header import SamHeader as JSamHeader
from samtools_tpu.ops import filters as jfilters
from samtools_tpu_torch.core import sam_expr
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import filters

EXPRS = [
    "flag & 16", "flag.paired && !flag.reverse", "flag.read2 || flag.dup",
    "flag.unmap", "flag.proper_pair + flag.munmap * 2 == 1",
    "flag.secondary || flag.qcfail || flag.supplementary || flag.mreverse",
    "mapq >= 30", "mapq < 10 || mapq > 50", "pos > 10000 && pos <= 30000",
    "endpos - pos > 100", "rlen >= 100", "qlen != rlen", "pnext > pos",
    "mpos == 0", "tlen < 0", "abs(tlen) > 150", "hclen > 0", "sclen >= 8",
    'rname == "sim1"', 'rname != "*"', 'mrname == "sim2"', "rname < mrname",
    'qname =~ "p0*1[0-9]"', 'qname !~ "^p00"', 'cigar =~ "B"',
    'cigar == "*"', 'seq =~ "^ACG"', 'qual == "*"', "length(seq) >= 100",
    "length(qual) == 0", "length(-5) == 5", "[NM] > 1", "[NM] == 0",
    "exists([NM])", "!exists([XA])", '[RG] == "grpA"', '[RG] =~ "grp[BC]"',
    "exists([RG]) && [RG] != \"grpC\"", "[XC] < 0", "[XI] > 1000000",
    "[XF] > 1", "[XD] < 0", '[XZ] =~ "c=1"', '[XH] == "1AE3FF"',
    "exists([BC])", "[XA]", "default([NM], 9) > 3", 'default([RG], "z") == "z"',
    "min(mapq, 20) == 20", "max(mapq, pos) > 1000", "sqrt(mapq) > 5",
    "log(pos + 1) > 9", "exp(mapq / 20) > 4", "pow(mapq, 2) > 900",
    "(mapq | 1) == 31", "(mapq ^ 3) & 4", "~mapq & 1", "mapq << 2 > 100",
    "pos >> 12 == 3", "mapq % 7 == 0", "pos / 0 > 1", "-mapq < -40",
    '"2" == 2', 'mapq == "30"', "library == \"libB\"", 'library == ""',
    "ncigar > 1", "tid == 1 || mtid == 1", "1", "0", "2.5e1 > mapq",
    "32 & flag", "!(mapq > 20 && pos < 20000)",
]
# (a hex literal does not parse: the JAX tokenizer reads "0x10" as "0",
# "x10")
BAD = ["flag & 0x10", "pos >>> 3", "foo(1)", "(mapq > 3", "mapq >",
       "unknown_field > 1", "[NM", '"abc', "mapq $ 3", "mapq && ", "1 2",
       "seq - 1", "mapq =~ 3", 'qname & "x"']


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    got = make_view_inputs(str(tmp_path_factory.mktemp("expr")))
    af = read_alignments(got["general"])
    return af.header, af.batch


def _run(mod, text, header, batch):
    return mod.compile_filter(text)(header, batch)


@pytest.mark.parametrize("text", EXPRS)
def test_compile_filter_equals_jax(reads, text):
    h, b = reads
    mine = _run(sam_expr, text, h, b)
    theirs = _run(jexpr, text, JSamHeader.from_text(h.text), jbatch(b))
    assert mine.dtype == bool and mine.shape == (b.n,)
    np.testing.assert_array_equal(mine, theirs)


def test_expressions_select_some_reads(reads):
    """Most expressions of the table keep some reads and drop others."""
    h, b = reads
    mixed = sum(0 < _run(sam_expr, t, h, b).sum() < b.n for t in EXPRS)
    assert mixed > len(EXPRS) * 2 // 3


@pytest.mark.parametrize("text", BAD)
def test_malformed_expression_raises_the_jax_error(reads, text):
    h, b = reads
    with pytest.raises(Exception) as theirs:
        _run(jexpr, text, JSamHeader.from_text(h.text), jbatch(b))
    with pytest.raises(Exception) as mine:
        _run(sam_expr, text, h, b)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


def test_tokenizer_equals_jax():
    for text in EXPRS + BAD[:2] + BAD[4:6]:
        assert sam_expr.tokenize(text) == jexpr.tokenize(text)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.binary(min_size=0, max_size=40), min_size=0,
                max_size=30))
def test_x31_hash_equals_jax(names):
    flat = np.frombuffer(b"".join(names), np.uint8)
    off = np.concatenate([[0], np.cumsum([len(n) for n in names])]
                         ).astype(np.int64)
    mine = filters.x31_hash_ragged(flat, off)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, jfilters.x31_hash_ragged(flat, off))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=1, max_size=50),
       st.integers(0, 2 ** 32 - 1))
def test_wang_hash_equals_jax(keys, seed):
    k = np.array(keys, np.uint32) ^ np.uint32(seed)
    np.testing.assert_array_equal(filters.wang_hash(k), jfilters.wang_hash(k))


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=200), st.integers(-2 ** 40, 2 ** 40))
def test_fnv1a_and_glibc_rand_equal_jax(data, seed):
    assert filters.fnv1a_hash_bytes(data) == jfilters.fnv1a_hash_bytes(data)
    assert filters.glibc_rand_first(seed) == jfilters.glibc_rand_first(seed)


def test_glibc_rand_first_known_values():
    # glibc: srand(1); rand() == 1804289383; srand(0) seeds as srand(1)
    assert filters.glibc_rand_first(1) == 1804289383
    assert filters.glibc_rand_first(0) == 1804289383


@pytest.mark.parametrize("frac,seed", [(0.25, 7), (0.5, 0), (0.9, 12345),
                                       (0.1, 2 ** 32 - 1)])
def test_batch_filters_equal_jax(reads, frac, seed):
    _, b = reads
    jb = jbatch(b)
    np.testing.assert_array_equal(filters.subsample_keep(b, frac, seed),
                                  jfilters.subsample_keep(jb, frac, seed))
    np.testing.assert_array_equal(filters.qlen_from_cigar(b),
                                  jfilters.qlen_from_cigar(jb))
    for masks in ((0x40, 0, 0, 0), (0, 0x14, 0, 0), (0, 0, 0x180, 0),
                  (0, 0, 0, 0x50), (1, 4, 0x80, 0x30)):
        np.testing.assert_array_equal(filters.flag_mask(b, *masks),
                                      jfilters.flag_mask(jb, *masks))
    assert list(filters.qnames_array(b)) == list(jfilters.qnames_array(jb))
