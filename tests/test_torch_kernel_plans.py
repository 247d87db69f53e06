"""The launch plans of K12 (``stats_kernels.hists_plan``) and K10
(``consensus_vec.segsum_plan``), on the CPU.

Each plan cuts a call's work over the card's blocks; the kernels trust
it.  Here: every read (K12) or column (K10) falls in exactly one block,
every cycle row in exactly one row tile, the per-block limits of the
kernels' sources hold (rows a tile, streams and columns a block), the
plan fills the card at the main path's shapes and keeps deep columns
side by side, and it is empty for empty input.  K10's walk
of a stream (``csrc/consensus_segsum.cu``: entries 8 at a time, a column
written when the next entry is past its end, the empty ones too, and an
entry that is not kept, or past the stream's end, adding +0.0) is
emulated in numpy and must give the host's f64 ``gap5_scores`` bit for
bit.
"""

from __future__ import annotations

import numpy as np
import pytest

from samtools_tpu_torch.ops import consensus_vec as cv
from samtools_tpu_torch.ops import stats_kernels as sk


@pytest.mark.parametrize("no,max_len,sms", [
    (65536, 100, 132), (65536, 300, 132), (1, 1, 132), (24576, 100, 132),
    (200, 20000, 132), (70000, 150, 132), (5, 1000, 4), (196608, 150, 1),
    (17, 201, 132)])
def test_hists_plan_puts_every_read_and_cycle_in_one_block(no, max_len,
                                                           sms):
    tiles, rt, groups, per_block = sk.hists_plan(no, max_len, sms)
    starts = np.arange(groups) * per_block
    sizes = np.minimum(no, starts + per_block) - starts
    assert (sizes > 0).all() and sizes.sum() == no
    assert groups <= 65535
    assert rt % 8 == 0 and 0 < rt <= sk.RT_MAX
    assert (tiles - 1) * rt < max_len <= tiles * rt


def test_hists_plan_fills_the_card_at_the_main_shape():
    # a stats chunk of 100-base reads: one row tile, a block an SM
    assert sk.hists_plan(65536, 100, 132) == (1, 104, 132, 497)
    # 150-base reads: two tiles of 80 rows, half the groups
    assert sk.hists_plan(65536, 150, 132) == (2, 80, 66, 993)
    # 20,000-base reads: 193 tiles of 104 rows, one group
    assert sk.hists_plan(200, 20000, 132) == (193, 104, 1, 200)


@pytest.mark.parametrize("no,max_len", [(0, 100), (10, 0), (0, 0)])
def test_hists_plan_is_empty_for_nothing_to_count(no, max_len):
    assert sk.hists_plan(no, max_len, 132) == (0, 0, 0, 0)


@pytest.mark.parametrize("ncols,sms", [
    (1_000_085, 132), (2000, 132), (3000, 132), (1, 132), (7, 132),
    (200_000, 132), (10_000_000, 132), (5000, 4)])
def test_segsum_plan_puts_every_column_in_one_stream(ncols, sms):
    streams, C, blocks = cv.segsum_plan(ncols, sms)
    lo, hi = cv.SEGSUM_STREAMS
    assert streams in (8, 16, 32, 64) and lo <= streams <= hi
    assert 1 <= C <= cv.SEGSUM_CMAX
    # stream s of block b: columns [(b * streams + s) * C, ... + C)
    first = np.arange(blocks * streams) * C
    sizes = np.clip(ncols - first, 0, C)
    assert sizes.sum() == ncols
    # no block without columns
    assert (blocks - 1) * streams * C < ncols


def test_segsum_plan_fills_the_card():
    # clean's 1 Mi window: 32 streams a block of 32 columns each
    assert cv.segsum_plan(1_000_085, 132) == (32, 32, 977)
    # amplicon columns 5,000 deep: one a stream, eight a block, so that
    # 250 blocks (three an SM fit) run the deep columns side by side
    assert cv.segsum_plan(2000, 132) == (8, 1, 250)


def test_segsum_plan_is_empty_for_no_columns():
    assert cv.segsum_plan(0, 132) == (0, 0, 0)


def _walk(T, b6, q, q2, keep, col_off, plan):
    """K10's walk in numpy: each stream's entries 8 at a time, a column
    emitted when the next entry is past its end; entries not kept, and
    the slots past the stream's last entry, add +0.0."""
    streams, C, blocks = plan
    ncols = col_off.size - 1
    S = np.full((ncols, 15), np.nan)
    depth = np.full(ncols, -1, np.int64)
    zero = np.zeros(15)
    for ca in range(0, ncols, C):
        cz = min(ncols, ca + C)
        sa, sz = col_off[ca], col_off[cz]
        c, acc, d = ca, np.zeros(15), 0
        for g in range(sa, sz, 8):
            for e in range(g, g + 8):
                while c < cz and e == col_off[c + 1]:
                    S[c], depth[c] = acc, d
                    c, acc, d = c + 1, np.zeros(15), 0
                kept = e < sz and keep[e]
                acc = acc + (T[b6[e], q[e], q2[e]] if kept else zero)
                d += int(kept)
        while c < cz:
            S[c], depth[c] = acc, d
            c, acc, d = c + 1, np.zeros(15), 0
    return S, depth


@pytest.mark.parametrize("case", ["ragged", "deep", "empty_tail"])
def test_segsum_walk_equals_gap5_scores(case):
    from samtools_tpu_torch.tools.consensus_cmd import ConsProbs, Opts
    rng = np.random.default_rng(8)
    depths = rng.integers(0, 60, 700)
    depths[::13] = 0
    if case == "deep":
        depths[300] = 9000
    elif case == "empty_tail":
        depths[-40:] = 0
    col_off = np.concatenate([[0], np.cumsum(depths)]).astype(np.int64)
    n = int(col_off[-1])
    b6, q, q2 = (rng.integers(0, 6, n), rng.integers(1, 101, n),
                 rng.integers(1, 101, n))
    keep = rng.random(n) < 0.9
    o = Opts()
    cp = ConsProbs(o.P_het, o.P_indel, o.het_scale, o.homopoly_redux,
                   o.qcal, o.mode)
    want, _, wdepth = cv.gap5_scores(col_off, b6, q, q2, keep, cp)
    # a small card, so that streams hold several columns
    plan = cv.segsum_plan(col_off.size - 1, 2)
    assert plan[1] > 1
    S, depth = _walk(cv.gap5_table9(cp), b6, q, q2, keep, col_off, plan)
    assert np.array_equal(S.view(np.uint64), want.view(np.uint64))
    assert np.array_equal(depth, wdepth)
