"""K6's front and tail and K7 on the CPU: ``chunk_expand``,
``qual_deltas`` and ``census_checksum_dev`` (their plain versions, which
the wrappers take for CPU tensors) against numpy oracles and the JAX
package.

``chunk_expand`` equals ``chunk_expand_plain`` and a numpy walk of each
read's cigar (``torch_chunk_cases.expand_oracle``) on clean and messy
chunks, on reads of 8 ops of every kind the device path takes, at the
contig's two ends, at read lengths 37, 100 and 150;
tests/test_torch_segment.py holds the expansion with the census against
the JAX chunk step.  ``qual_deltas`` equals ``np.flatnonzero`` around its
capacity.  ``census_checksum_dev`` equals the JAX ``census_checksum`` at
window edges and on negative int32 lanes.  Each wrapper's argument checks
raise before anything launches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_chunk_cases as cc
from samtools_tpu.ops import mpileup_device as jmd
from samtools_tpu_torch import kernels
from samtools_tpu_torch.ops import mpileup_device as md

TABLE = torch.from_numpy(md.NT16_TO4)


def _expand_all(buf: np.ndarray, ref_int: np.ndarray, lq: int):
    b, r = torch.from_numpy(buf), torch.from_numpy(ref_int)
    before = dict(kernels.launches)
    got = md.chunk_expand(b, r, TABLE, lq)
    assert kernels.launches == before          # CPU tensors: plain
    return got, md.chunk_expand_plain(b, r, TABLE, lq), \
        cc.expand_oracle(buf, ref_int, lq)


def _assert_expand_equal(got, plain, want):
    assert set(got) == set(plain) == set(want)
    for k in want:
        assert got[k].dtype == plain[k].dtype, k
        assert got[k].is_contiguous(), k
        assert torch.equal(got[k], plain[k]), k
        w = torch.from_numpy(np.ascontiguousarray(want[k]))
        assert got[k].shape == w.shape, k
        if k in ("bMv", "bIv"):   # bit for bit
            assert torch.equal(got[k].view(torch.int32),
                               w.view(torch.int32)), k
        else:
            assert torch.equal(got[k], w.to(got[k].dtype)), k


@pytest.mark.parametrize("lq", [37, 100, 150])
@pytest.mark.parametrize("messy", [False, True])
def test_chunk_expand_equals_plain_and_cigar_walk(lq, messy):
    buf, ref_int = cc.simulated_chunk(lq, messy, 300)
    got, plain, want = _expand_all(buf, ref_int, lq)
    _assert_expand_equal(got, plain, want)
    seg = got["seg"].numpy()
    assert (seg >= 0).mean() > 0.9
    if messy:   # insertions and soft clips leave bases off M
        assert (seg < 0).any() and (seg.max(1) >= 1).any()


@pytest.mark.parametrize("lq", [37, 100, 150])
def test_chunk_expand_on_every_cigar_op_and_contig_end(lq):
    buf, ref_int = cc.synthetic_chunk(lq, 200, ref_len=1 << 14, seed=lq)
    got, plain, want = _expand_all(buf, ref_int, lq)
    _assert_expand_equal(got, plain, want)
    cig = buf[:, 16:md.HDR].copy().view("<u4")
    ops = set((cig & 0xF).ravel().tolist())
    assert ops == set(cc.DEVICE_OPS)
    # windows clamped at both ends of the contig, M ops of ordinal 7
    win = got["ref_win"].numpy()
    assert (win[0] == ref_int[0]).sum() > 1
    assert (win[-1] == ref_int[-1]).sum() > 1
    assert (got["seg"] == md.MAXOPS - 1).any()
    assert (got["lref"] == 300).any()


def test_chunk_expand_odd_row_stride():
    """37 bases: a row is 122 bytes, so most rows start off 4-byte
    alignment; one read alone too."""
    buf, ref_int = cc.synthetic_chunk(37, 33, ref_len=1 << 12, seed=5)
    _assert_expand_equal(*_expand_all(buf, ref_int, 37))
    _assert_expand_equal(*_expand_all(buf[:1], ref_int, 37))


@pytest.mark.parametrize("changed", ["none", "one", "cap-1", "cap", "cap+1",
                                     "all"])
def test_qual_deltas_equal_flatnonzero(changed):
    C, lq = 40, 100
    cap = C * lq // 16
    n = {"none": 0, "one": 1, "cap-1": cap - 1, "cap": cap,
         "cap+1": cap + 1, "all": C * lq}[changed]
    appq, qq = cc.changed_quals(C, lq, n, seed=n)
    want = cc.delta_oracle(appq, qq, cap)
    a, q = torch.from_numpy(appq), torch.from_numpy(qq)
    before = dict(kernels.launches)
    for got in (md.qual_deltas(a, q, cap), md.qual_deltas_plain(a, q, cap)):
        dcount, didx, dval = got
        assert dcount.dtype == torch.int32 and dcount.dim() == 0
        assert int(dcount) == want[0] == n
        assert didx.dtype == torch.int32 and dval.dtype == torch.uint8
        assert np.array_equal(didx.numpy(), want[1])
        assert np.array_equal(dval.numpy(), want[2])
    assert kernels.launches == before


@pytest.mark.parametrize("wlen", [0, 1, 4095, 4096])
@pytest.mark.parametrize("negative", [False, True])
def test_census_checksum_plain_equals_jax(wlen, negative):
    c = cc.census_with_pad(wlen, wlen + 37, seed=wlen, negative=negative)
    want = jmd.census_checksum(c[:wlen, :5].astype(np.int64),
                               c[:wlen, 5].astype(np.int64))
    t = torch.from_numpy(c)
    before = dict(kernels.launches)
    assert md.census_checksum_plain(t, wlen) == want
    assert md.census_checksum_dev(t, wlen) == want
    assert md.census_checksum(c[:wlen, :5], c[:wlen, 5]) == want
    assert kernels.launches == before
    if negative and wlen:
        assert (c[:wlen] < 0).any()


def _raises(exc, fn, *args):
    before = dict(kernels.launches)
    with pytest.raises(exc):
        fn(*args)
    assert kernels.launches == before


def test_wrappers_check_arguments_before_launch():
    meta = torch.device("meta")
    census = torch.zeros(16, 6, dtype=torch.int32)
    ck = md.census_checksum_dev
    _raises(TypeError, ck, census.float(), 4)
    _raises(ValueError, ck, torch.zeros(16, 5, dtype=torch.int32), 4)
    _raises(ValueError, ck, torch.zeros(6, 16, dtype=torch.int32).t(), 4)
    _raises(ValueError, ck, census, 17)
    _raises(ValueError, ck, census, -1)
    _raises(ValueError, ck, census.to(meta), 4)   # no card, no CPU

    buf = torch.zeros(4, md.HDR + 2 * 10, dtype=torch.uint8)
    ref = torch.zeros(64, dtype=torch.uint8)
    ex = md.chunk_expand
    _raises(TypeError, ex, buf.to(torch.int8), ref, TABLE, 10)
    _raises(ValueError, ex, buf, ref, TABLE, 11)            # row width
    _raises(ValueError, ex, buf, ref, TABLE, 0)
    _raises(ValueError, ex, torch.zeros(4, md.HDR + 21, dtype=torch.uint8)
            [:, :-1], ref, TABLE, 10)                      # not contiguous
    _raises(ValueError, ex, buf[:0], ref, TABLE, 10)        # no reads
    _raises(ValueError, ex, buf, ref[:0], TABLE, 10)        # no contig
    _raises(ValueError, ex, buf, ref.reshape(8, 8), TABLE, 10)
    _raises(ValueError, ex, buf, ref, TABLE[:15], 10)
    _raises(TypeError, ex, buf, ref.int(), TABLE, 10)
    _raises(ValueError, ex, buf, ref.to(meta), TABLE, 10)   # mixed

    q = torch.zeros(4, 10, dtype=torch.uint8)
    qd = md.qual_deltas
    _raises(TypeError, qd, q.int(), q, 2)
    _raises(ValueError, qd, q, q[:3], 2)
    _raises(ValueError, qd, q, torch.zeros(10, 4, dtype=torch.uint8).t(), 2)
    _raises(ValueError, qd, q[:0], q[:0], 0)
    _raises(ValueError, qd, q, q, -1)
    _raises(ValueError, qd, q, q.to(meta), 2)
