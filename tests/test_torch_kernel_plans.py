"""The launch plans of K12 (``stats_kernels.hists_plan``), K10
(``consensus_vec.segsum_plan``), K11 (``flagstat.flagstat_plan``), K7n
(``mpileup_device.narrow_plan``) and K14 (``pileup_device.scatter_chunk``),
on the CPU.

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
bit.  K11's bit-sliced counters (``csrc/flagstat.cu``: a carry-save add
of 8 masks a step, the ripple add of one, the drain by a 32 x 32 bit
transposition across a warp every 31 or 255 steps, the blocks' partials
summed by the last block) and K7n's tiling (``csrc/census_narrow.cu``:
each block's rows, the staged and unstaged split, the maxima folded as
16-byte vectors, ``q_off``/``end``, the 16-byte count stores and the
4-byte qual-sum stores) are emulated in numpy and must give their plain
versions' counts and bytes exactly.  K14's two entries
(``csrc/pileup_counts.cu``) are emulated too: the scatter's chunk walk
(chunk bounds from ``scatter_chunk``, each chunk's lowest and highest
adding row, the private or global path at ``SCATTER_BUDGET_ROWS``, the
two-slot run merge of each thread's items, the flush of the nonzero
cells) and the tiled walk (the per-thread runs of 16-item groups, the
skip of a group with no valid item, the warp fold, the swizzled row
stores); both must equal the plain versions and the JAX functions on
the hard shapes of ``tests/torch_k14_shapes.py``, with the threads a
block, stages and items a thread read from the kernel's source
(``torch_k14_shapes.CU``) and the chunk and budget from the constants
the wrapper passes.  K6's qual-delta tail (``mpileup_device.deltas_plan``,
csrc/qual_deltas.cu: each tile's count, then each thread's changes
written at its block's scanned ranks, the slots past the count filled)
and K7's grid-stride checksum (``mpileup_device.checksum_plan``,
csrc/census_checksum.cu: 16-byte vectors, then the odd words, per-block
sums mod 2^32) are emulated in numpy too, with the threads a block and
the quals a thread read from the sources, and must give their plain
versions' lists and sums exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_chunk_cases as cc
import torch_k14_shapes as k14
from samtools_tpu.ops import pileup_engine as jpe
from samtools_tpu_torch.core import flags as F
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import consensus_vec as cv
from samtools_tpu_torch.ops import flagstat as fs
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.ops import stats_kernels as sk

SCRIPT = cc.apply_depth_script()


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


# ------------------------------------------------------------------ K11
U32 = np.uint32


def _record_masks(flag, mapq, tid, mtid) -> np.ndarray:
    """record_mask of csrc/flagstat.cu: counter c's condition at bit
    2c + qcfail."""
    f = flag.astype(np.int64)
    conds = fs._conditions(f, mapq.astype(np.int64), tid, mtid,
                           np.ones(f.size, bool))
    qc = ((f & F.FQCFAIL) != 0).astype(np.int64)
    m = np.zeros(f.size, np.int64)
    for c, cond in enumerate(conds):
        m |= cond.astype(np.int64) << (2 * c + qc)
    return m.astype(U32)


def _lut_masks(flag, mapq, tid, mtid) -> np.ndarray:
    """The kernel's way to the same masks: a table of the 1,024 masks of
    flag bits 0-3 and 6-11 (tid == mtid, mapq 0), read at the record's
    10-bit index, with the n_diffchr and n_diffhigh bits set after."""
    i = np.arange(1024)
    lut_f = (i & 0xF) | ((i & 0x3F0) << 2)
    z = np.zeros(1024, np.int32)
    lut = _record_masks(lut_f.astype(np.uint16), z.astype(np.uint8), z, z)
    f = flag.astype(np.int64)
    m = lut[(f & 0xF) | ((f >> 2) & 0x3F0)].astype(np.int64)
    pair_map = (f & (F.FSECONDARY | F.FSUPPLEMENTARY | F.FPAIRED | F.FUNMAP
                     | F.FMUNMAP)) == F.FPAIRED
    d = np.where(pair_map & (tid != mtid),
                 np.where(mapq >= 5, 0x50000000, 0x10000000), 0)
    return (m | (d << ((f >> 9) & 1))).astype(U32)


def test_k11_table_masks_equal_record_masks():
    """Every flag (12 bits), tid == mtid or not, mapq on both sides of
    5: the table's masks are record_mask's."""
    f = np.repeat(np.arange(1 << 12), 4).astype(np.uint16)
    k = np.tile(np.arange(4), 1 << 12)
    tid = np.zeros(f.size, np.int32)
    mtid = (k & 1).astype(np.int32)
    mapq = np.where(k & 2, 5, 4).astype(np.uint8)
    assert np.array_equal(_lut_masks(f, mapq, tid, mtid),
                          _record_masks(f, mapq, tid, mtid))


def _full_add(a, b, c):
    u = a ^ b
    return u ^ c, (a & b) | (u & c)


def _add1(p, m):
    """One mask a thread into its 8 planes (p: [threads, 8]); the carry
    out of the last plane must be 0 (counts stay below 256)."""
    for j in range(8):
        t = p[:, j] & m
        p[:, j] ^= m
        m = t
    assert not m.any()


def _add8(p, m):
    """A step's 8 masks (m: [threads, 8]) by the kernel's carry-save tree,
    then one ripple."""
    sa, ca = _full_add(m[:, 0], m[:, 1], m[:, 2])
    sb, cb = _full_add(m[:, 3], m[:, 4], m[:, 5])
    s0, cc = _full_add(sa, sb, m[:, 6])
    b0, cd = s0 ^ m[:, 7], s0 & m[:, 7]
    s1, c4a = _full_add(ca, cb, cc)
    b1, c4b = s1 ^ cd, s1 & cd
    b2, b3 = c4a ^ c4b, c4a & c4b
    carry = p[:, 0] & b0
    p[:, 0] ^= b0
    for j, b in ((1, b1), (2, b2), (3, b3)):
        p[:, j], carry = _full_add(p[:, j], b, carry)
    for j in range(4, 8):
        t = p[:, j] & carry
        p[:, j] ^= carry
        carry = t
    assert not carry.any()


def _transpose32(v):
    """transpose32 across each warp (v: [warps, 32] lanes), stage by
    stage: shuffles by lane ^ s, the off-diagonal blocks swapped."""
    lane = np.arange(32)
    for s, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        m = U32(m)
        y = v[:, lane ^ s]
        hi = (lane & s) != 0
        v = np.where(hi, (v & ~m) | ((y >> U32(s)) & m),
                     (v & m) | ((y << U32(s)) & ~m))
    return v


def _popc(v):
    return np.unpackbits(v.view(np.uint8).reshape(*v.shape, 4),
                         axis=-1).sum(-1).astype(U32)


def _drain(p, total):
    """Each warp's planes into lane b's count of mask bit b."""
    warps = p.reshape(-1, 32, 8)
    for j in range(8):
        t = _transpose32(warps[:, :, j])
        total += (_popc(t) << U32(j)).reshape(-1)
    p[:] = 0


def _k11_emulated(flag, mapq, tid, mtid, sms, vec):
    n = flag.size
    blocks = fs.flagstat_plan(n, sms)
    threads = blocks * fs.TPB
    units = n // fs.VEC if vec else n
    masks = _lut_masks(flag, mapq, tid, mtid)
    p = np.zeros((threads, 8), U32)
    total = np.zeros(threads, U32)
    # csrc/flagstat.cu: a drain every 31 vector steps (248 records) or
    # 255 scalar ones; a lane past the end re-reads the last group and
    # counts nothing
    steps, base = 0, 0
    while base < units:
        u = base + np.arange(threads)
        ok = u < units
        if vec:
            idx = np.minimum(u, units - 1)[:, None] * 8 + np.arange(8)
            _add8(p, np.where(ok[:, None], masks[idx], U32(0)))
        else:
            _add1(p, np.where(ok, masks[np.where(ok, u, 0)], U32(0)))
        steps, base = steps + 1, base + threads
        if steps == (31 if vec else 255):
            _drain(p, total)
            steps = 0
    if vec:
        for i in range(units * 8, n):
            _add1(p[:1], masks[i:i + 1])
    _drain(p, total)
    # each block's 32 partials (uint32), summed by the last block in 64
    # bits
    partial = total.reshape(blocks, fs.TPB // 32, 32).sum(1, dtype=np.int64)
    assert partial.max() < 2 ** 32
    return partial.sum(0).reshape(fs.N_COUNTERS, 2), blocks


# (records, SMs, 16-byte loads): clean's 2.5 M reads and a stream batch
# on the H100; one or two SMs, so that the drains at 31 and 255 steps
# run; n % 8 tails; the scalar path taken without alignment
K11_CASES = [(2_516_582, 132, True), (360_000, 132, True),
             (200_003, 1, True), (5_000, 2, True), (7, 132, True),
             (8, 132, True), (200_003, 1, False), (360_001, 132, False),
             (13, 132, False)]


@pytest.mark.parametrize("n,sms,vec", K11_CASES)
def test_k11_bit_sliced_counters_equal_plain(n, sms, vec):
    rng = np.random.default_rng(n % 97)
    flag = rng.integers(0, 1 << 12, n).astype(np.uint16)
    mapq = rng.integers(0, 10, n).astype(np.uint8)
    tid = rng.integers(-1, 3, n).astype(np.int32)
    mtid = rng.integers(-1, 3, n).astype(np.int32)
    got, blocks = _k11_emulated(flag, mapq, tid, mtid, sms, vec)
    want = fs.flagstat_plain(*(torch.from_numpy(a)
                               for a in (flag, mapq, tid, mtid)))
    assert np.array_equal(got, want.numpy())
    assert 1 <= blocks <= sms * fs.BLOCKS_PER_SM


def test_k11_transposition_counts_each_bit_across_the_warp():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 2 ** 32, (3, 32), dtype=np.uint64).astype(U32)
    t = _transpose32(v)
    bits = (v[:, :, None] >> np.arange(32, dtype=U32)) & U32(1)
    # bit l of lane b is bit b of lane l
    assert np.array_equal((t[:, :, None] >> np.arange(32, dtype=U32))
                          & U32(1), bits.transpose(0, 2, 1))
    assert np.array_equal(_popc(t), bits.sum(1))


def test_k11_plan_is_one_wave():
    assert fs.flagstat_plan(2_516_582, 132) == 264
    # a stream batch of ~360 k reads: fewer blocks, a group each thread
    assert fs.flagstat_plan(360_000, 132) == 176
    assert fs.flagstat_plan(1, 132) == 1
    assert fs.flagstat_plan(0, 132) == 0


# ------------------------------------------------------------------ K7n
def _census(wlen, cmax, qmax, pad, seed, peak):
    """An int32 [wlen + pad, 6] census whose rows [0, wlen) reach cmax and
    qmax only in one row, ``peak``: the first (lanes 0 and 5: a block's
    staged rows where it stages any) or the last (lanes 4 and 5: the last
    ring tile's, and the odd tail's where wlen is odd); larger values in
    the pad rows, which must be ignored."""
    rng = np.random.default_rng(seed)
    c = np.zeros((wlen + pad, 6), np.int32)
    c[:, :5] = rng.integers(0, cmax, (wlen + pad, 5))
    c[:, 5] = rng.integers(0, qmax, wlen + pad)
    if peak == "first_row":
        c[0, 0], c[0, 5] = cmax, qmax
    else:
        c[wlen - 1, 4], c[wlen - 1, 5] = cmax, qmax
    c[wlen:, :5] += 100_000
    c[wlen:, 5] += 100_000
    return c


def _fold(words, cm, qm):
    """The maxima over rows [0, cnt) held as int32 words (a row pair is
    three 16-byte vectors; vector k's qual lane by k mod 3), and the
    last row's lanes 4 and 5 of an odd count."""
    cnt = words.size // 6
    nv = cnt * 3 // 2
    v = words[:4 * nv].reshape(nv, 4).astype(np.int64)
    k3 = np.arange(nv) % 3
    cm = max(cm, v[:, [0, 2]].max(initial=0), v[k3 != 1, 1].max(initial=0),
             v[k3 != 2, 3].max(initial=0))
    qm = max(qm, v[k3 == 1, 1].max(initial=0), v[k3 == 2, 3].max(initial=0))
    if cnt & 1:
        cm, qm = max(cm, int(words[-2])), max(qm, int(words[-1]))
    return cm, qm


def _cast(out, words, r, wlen, cdt, qdt):
    """cast_span: rows [r, r + cnt) (r a multiple of 16) into out, counts
    by whole 16-byte vectors and the tail, qual sums at q_off."""
    cs, qs = cdt.itemsize, qdt.itemsize
    cnp = torch.empty(0, dtype=cdt).numpy().dtype
    qnp = torch.empty(0, dtype=qdt).numpy().dtype
    cnt = words.size // 6
    rows = words.reshape(cnt, 6).view(np.int32).astype(np.int64)
    q_off = md._narrow_offsets(wlen, cdt, qdt)[0]
    start = r * 5 * cs
    assert r % 16 == 0 and start % 16 == 0 and (q_off + r * qs) % 4 == 0
    V = 16 // cs
    nvec = 5 * cnt // V
    e = np.arange(5 * cnt)
    # a vector never leaves its group of 16 rows
    group = (e[:nvec * V] // 5 // 16).reshape(nvec, V)
    assert (group == group[:, :1]).all()
    out[start:start + 5 * cnt * cs] = rows[e // 5, e % 5].astype(
        cnp).view(np.uint8)
    out[q_off + r * qs:q_off + (r + cnt) * qs] = rows[:, 5].astype(
        qnp).view(np.uint8)


def _k7n_emulated(census, wlen, sms, smem, ring=3 * 2048 * 24, tile=2048):
    """csrc/census_narrow.cu block by block: phase 1 stages each block's
    first rows and folds the rest through the ring; phase 2 casts the
    staged rows, then the rest again through the ring, last tile first.
    Returns (the narrowed bytes up to end, counts type, qual-sum type,
    staged rows)."""
    blocks, rows, staged_rows = md.narrow_plan(wlen, sms, smem, ring)
    assert staged_rows * 24 + (ring if staged_rows < rows else 0) \
        <= max(smem, ring)
    words = census.reshape(-1).view(np.uint32)
    out = np.full(wlen * 24 + 16, 0xAB, np.uint8)
    cm = qm = 0
    spans = []       # (block's first row, staged rows, tiles)
    for b in range(blocks):
        r0, r1 = b * rows, min((b + 1) * rows, wlen)
        n = r1 - r0
        assert n > 0 and r0 % 16 == 0
        staged = min(n, staged_rows)
        tiles = [(a, min(tile, n - a)) for a in range(staged, n, tile)]
        for a, cnt in tiles:
            cm, qm = _fold(words[(r0 + a) * 6:(r0 + a + cnt) * 6], cm, qm)
        cm, qm = _fold(words[r0 * 6:(r0 + staged) * 6], cm, qm)
        spans.append((r0, staged, tiles))
    cdt, qdt = md.narrow_types(cm, qm)
    for r0, staged, tiles in spans:
        _cast(out, words[r0 * 6:(r0 + staged) * 6], r0, wlen, cdt, qdt)
        for a, cnt in reversed(tiles):
            _cast(out, words[(r0 + a) * 6:(r0 + a + cnt) * 6], r0 + a,
                  wlen, cdt, qdt)
    q_off, end = md._narrow_offsets(wlen, cdt, qdt)
    assert q_off == (wlen * 5 * cdt.itemsize + 3) & ~3
    out[wlen * 5 * cdt.itemsize:q_off] = 0
    return out[:end], cdt, qdt, sum(s[1] for s in spans)


# counts u8, u16, int32 x qual sums u16, int32: (largest count, largest
# qual sum)
NARROW_TYPES = {"u8_u16": (255, 65535), "u8_i32": (200, 65536),
                "u16_u16": (256, 1000), "u16_i32": (65535, 70000),
                "i32_u16": (65536, 65535), "i32_i32": (100_000, 3_000_000)}


@pytest.mark.parametrize("types", sorted(NARROW_TYPES))
@pytest.mark.parametrize("wlen,sms,smem", [
    (1, 132, 232_000), (17, 4, 232_000), (1000, 7, 24 * 64),
    (4099, 5, 24 * 200), (4099, 132, 0), (65_536, 132, 232_000),
    (65_536, 3, 3 * 2048 * 24 + 24 * 100)])
@pytest.mark.parametrize("peak", ["first_row", "last_row"])
def test_k7n_tiling_equals_plain(types, wlen, sms, smem, peak):
    cmax, qmax = NARROW_TYPES[types]
    census = _census(wlen, cmax, qmax, 9, wlen + cmax % 7, peak)
    got, cdt, qdt, staged = _k7n_emulated(census, wlen, sms, smem)
    want, wcdt, wqdt = md.census_narrow_plain(torch.from_numpy(census),
                                              wlen)
    assert (cdt, qdt) == (wcdt, wqdt)
    assert str(cdt).endswith({"u8": "uint8", "u16": "uint16",
                              "i32": "int32"}[types[:types.index("_")]])
    assert np.array_equal(got, want.numpy())
    assert 0 <= staged <= wlen


def test_k7n_plan_stages_the_tool_window():
    # the tool's 1 Mi window: every row staged in 132 blocks' shared
    # memory (227 KB an SM less the kernel's own)
    smem = 232_448 - 1024
    ring = 3 * 2048 * 24
    blocks, rows, staged = md.narrow_plan(1 << 20, 132, smem, ring)
    assert (blocks, rows, staged) == (132, 7952, 7952)
    assert rows * 24 <= smem
    # the core's 8 Mi rows: about 5% staged, the ring of three 2,048-row
    # tiles behind them
    blocks, rows, staged = md.narrow_plan(8 << 20, 132, smem, ring)
    assert (blocks, rows, staged) == (132, 63_552, 3488)
    assert staged * 24 + ring <= smem
    assert 0.05 < blocks * staged / (8 << 20) < 0.06
    assert md.narrow_plan(1, 132, smem, ring) == (1, 16, 16)
    assert md.narrow_plan(0, 132, smem, ring) == (0, 0, 0)
    # no room for staged rows beside the ring: every row through it
    assert md.narrow_plan(4099, 132, 0, ring)[2] == 0


# K14 (csrc/pileup_counts.cu), emulated in numpy: the scatter's chunk walk
# and the tiled entry's per-thread runs, with the chunk size, the private
# budget and the thread counts the wrapper passes or the source fixes.

def _swz(row, lane):
    """The shared accumulator's word of cell (row, lane)."""
    return row * 32 + (lane ^ (row & 31))


def _run_merge(keys, weights, sink):
    """The kernel's two-slot run merge, every thread at once: keys and
    weights [steps, threads] (key -1: the item adds nothing); ``sink``
    takes (keys, sums) of evicted and final slots.  Returns the final
    slots (c0, n0, c1, n1)."""
    T = keys.shape[1]
    c0, c1 = np.full(T, -1, np.int64), np.full(T, -1, np.int64)
    n0, n1 = np.zeros(T, np.int64), np.zeros(T, np.int64)
    for k, w in zip(keys, weights):
        act = k >= 0
        h0 = act & (k == c0)
        h1 = act & ~h0 & (k == c1)
        miss = act & ~h0 & ~h1
        n0[h0] += w[h0]
        n1[h1] += w[h1]
        ev = miss & (n1 != 0)
        sink(c1[ev], n1[ev])
        c1[miss], n1[miss] = c0[miss], n0[miss]
        c0[miss], n0[miss] = k[miss], w[miss]
    return c0, n0, c1, n1


def _scatter_emulated(refpos, lane, valid, window, weight, sms):
    """K14's scatter chunk by chunk: chunk bounds (``scatter_chunk``),
    the lowest and highest row of the items that add, the private or
    global path at ``SCATTER_BUDGET_ROWS``, thread t's items t + j * NT
    merged in its two slots, the private accumulator flushed 4 words at a
    time (nonzero cells only) and zeroed.  Returns (out, stats)."""
    from samtools_tpu_torch.ops import pileup_device as pd
    n = refpos.size
    C = pd.scatter_chunk(n, sms)
    budget, NT = pd.SCATTER_BUDGET_ROWS, k14.CU["NT"]
    assert C % 16 == 0 and C <= k14.CU["MAX_IPT"] * NT
    ipt = -(-C // NT)
    out = np.zeros(window * 32, np.int64)
    acc = np.zeros(budget * 32, np.int64)
    ln = np.where(lane < 0, lane + 32, lane).astype(np.int64)
    adds = valid & (refpos >= 0) & (refpos < window) & (ln >= 0) & (ln < 32)
    w_all = np.ones(n, np.int64) if weight is None else weight.astype(
        np.int64)
    st = {"private": 0, "global": 0, "empty": 0, "global_adds": 0,
          "shared_adds": 0}
    for i0 in range(0, n, C):
        cn = min(C, n - i0)
        local = np.arange(ipt * NT).reshape(ipt, NT)
        idx = i0 + np.minimum(local, cn - 1)
        a = adds[idx] & (local < cn)
        if not a.any():
            st["empty"] += 1
            continue
        rows = refpos[idx].astype(np.int64)
        lo, hi = rows[a].min(), rows[a].max()
        if hi - lo < budget:
            st["private"] += 1
            span = hi - lo + 1
            assert not acc.any()

            def to_acc(k, v):
                np.add.at(acc, k, v)
                st["shared_adds"] += k.size
            slots = _run_merge(np.where(a, _swz(rows - lo, ln[idx]), -1),
                               w_all[idx], to_acc)
            to_acc(slots[0][slots[1] != 0], slots[1][slots[1] != 0])
            to_acc(slots[2][slots[3] != 0], slots[3][slots[3] != 0])
            quads = acc[:span * 32].reshape(span * 8, 4)
            q = np.arange(span * 8)
            row = q >> 3
            p = ((q & 7) * 4) ^ (row & 31)
            for j in range(4):
                nz = quads[:, j] != 0
                np.add.at(out, (lo + row[nz]) * 32 + (p[nz] ^ j),
                          quads[nz, j])
                st["global_adds"] += int(nz.sum())
            quads[quads.any(1)] = 0
        else:
            st["global"] += 1

            def to_out(k, v):
                np.add.at(out, k, v)
                st["global_adds"] += k.size
            slots = _run_merge(np.where(a, rows * 32 + ln[idx], -1),
                               w_all[idx], to_out)
            to_out(slots[0][slots[1] != 0], slots[1][slots[1] != 0])
            to_out(slots[2][slots[3] != 0], slots[3][slots[3] != 0])
    return out.reshape(window, 32), st


def _tiled_emulated(posrel, lane, valid, tile, n_tiles, aligned=True):
    """K14's tiled entry tile by tile: the tile's items before and after
    its whole 16-item groups (all of them when a pointer is not 16-byte
    aligned) strided over the threads, each thread's contiguous run of
    groups (a group with no valid item skipped whole), the two-slot run
    merge, the warp fold of the final slots, then the rows written 4
    lanes at a time from the swizzled accumulator.  Returns (out,
    stats)."""
    from samtools_tpu_torch.ops import pileup_device as pd
    B = posrel.shape[1]
    T = k14.CU["TNT"]
    P, L, V = posrel.ravel(), lane.ravel(), valid.ravel()
    out = np.full((n_tiles * tile, 32), -7, np.int64)
    st = {"groups": 0, "skipped": 0, "adds": 0, "folded": 0}
    for b in range(n_tiles):
        s, e = b * B, (b + 1) * B
        a0 = b0 = e
        if aligned:
            a0 = min(e, -(-s // 16) * 16)
            b0 = max(a0, e // 16 * 16)
        acc = np.zeros(tile * 32, np.int64)
        ga, G = a0 // 16, b0 // 16 - a0 // 16
        per = -(-G // T)
        keys = []
        for t in range(T):
            items = list(range(s + t, a0, T))
            for g in range(ga + t * per, min(ga + G, ga + (t + 1) * per)):
                st["groups"] += 1
                if not V[16 * g:16 * g + 16].any():
                    st["skipped"] += 1
                    continue
                items.extend(range(16 * g, 16 * g + 16))
            items.extend(range(b0 + t, e, T))
            keys.append([_swz(int(P[i]), int(L[i])) for i in items
                         if V[i] and 0 <= P[i] < tile and 0 <= L[i] < 32])
        steps = max(1, max(len(k) for k in keys))
        K = np.full((steps, T), -1, np.int64)
        for t, k in enumerate(keys):
            K[:len(k), t] = k

        def to_acc(k, v):
            np.add.at(acc, k, v)
            st["adds"] += k.size
        c0, n0, c1, n1 = _run_merge(K, np.ones_like(K), to_acc)
        for c, n in ((c0, n0), (c1, n1)):
            for w in range(T // 32):
                cw, nw = c[32 * w:32 * w + 32], n[32 * w:32 * w + 32]
                for cell in np.unique(cw[cw >= 0]):
                    total = nw[cw == cell].sum()
                    if total:
                        to_acc(np.array([cell]), np.array([total]))
                    st["folded"] += int((cw == cell).sum()) - 1
        q = np.arange(tile * 8)
        row, x = q >> 3, (q >> 3) & 31
        base = row * 32 + (((q & 7) * 4) ^ (x & 28))
        v = acc[base[:, None] + np.arange(4)]
        v = np.where((x & 1)[:, None] == 1, v[:, [1, 0, 3, 2]], v)
        v = np.where((x & 2)[:, None] == 2, v[:, [2, 3, 0, 1]], v)
        out[b * tile:(b + 1) * tile] = v.reshape(tile, 32)
    return out, st


def _jax_pileup():
    from samtools_tpu.ops import pileup_device as jpd
    return jpd


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("case", k14.SCATTER_CASES)
def test_k14_scatter_walk_equals_plain_and_jax(case, sms):
    from samtools_tpu_torch.ops import pileup_device as pd
    jpd = _jax_pileup()
    rp, ln, ok, q, window = k14.scatter_case(case, sms)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (rp, ln, ok, q)]
    for weight in (None, q):
        got, st = _scatter_emulated(rp, ln, ok, window, weight, sms)
        plain = pd.pileup_scatter_plain(*t[:3], window,
                                        None if weight is None else t[3])
        jax = np.asarray(jpd.pileup_counts(rp, ln, ok, window)
                         if weight is None else
                         jpd.pileup_qual_sums(rp, ln, q, ok, window))
        assert np.array_equal(got, plain.numpy())
        assert np.array_equal(got, jax)
        paths = k14.pileup_kernels_script().scatter_paths(
            *t[:3], window, pd.scatter_chunk(rp.size, sms))
        assert {k: st[k] for k in ("private", "global", "empty")} == {
            k: paths[k] for k in ("private", "global", "empty")}
    if case == "read_order":
        # every chunk private; the flushes a fifth of the items or fewer
        assert st["global"] == 0 and st["private"] > 100
        assert st["global_adds"] * 5 < rp.size
    if case == "budget_edge":
        # at the budget, one row over, at it with non-adding items beyond
        # both ends, nothing that adds, the ragged random chunk
        assert (st["private"], st["global"], st["empty"]) == (2, 2, 1)
    if case == "one_cell":
        # one add a thread a chunk at most, then one flushed cell a chunk
        chunks = -(-rp.size // pd.scatter_chunk(rp.size, sms))
        assert st["shared_adds"] <= chunks * k14.CU["NT"]
        assert st["global_adds"] == chunks


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", k14.TILED_CASES)
def test_k14_tiled_walk_equals_plain_and_jax(case, aligned):
    from samtools_tpu_torch.ops import pileup_device as pd
    jpd = _jax_pileup()
    posrel, lane, ok, tile, n_tiles = k14.tiled_case(case)
    got, st = _tiled_emulated(posrel, lane, ok, tile, n_tiles, aligned)
    plain = pd.pileup_tiled_plain(*(torch.from_numpy(a) for a in (
        posrel, lane, ok)), tile, n_tiles)
    jax = np.asarray(jpd.pileup_counts_tiled(posrel, lane, ok, tile,
                                             n_tiles))
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(got, jax)
    if aligned and case.startswith("read_order"):
        # the padded slots at each tile's end skipped 16 at a time; runs
        # of equal cells added once (sorted items: fewer adds than a
        # third of the items)
        assert st["skipped"] > 0
        assert st["adds"] * 3 < int(ok.sum())
    if not aligned:
        assert st["groups"] == 0


def test_k14_scatter_chunk_plan():
    from samtools_tpu_torch.ops import pileup_device as pd
    # clean's 1 Mbp: the largest chunk; entry()'s 65,536 items: the
    # smallest, 256 blocks' worth
    assert pd.scatter_chunk(31_515_500, 132) == pd.SCATTER_CHUNK == 2048
    assert pd.scatter_chunk(1 << 16, 132) == pd.SCATTER_CHUNK_MIN == 256
    assert pd.scatter_chunk(1, 132) == 256
    assert pd.scatter_chunk(1 << 16, 1) == 2048
    for n in (1, 1000, 70_000, 135_168, 540_672, 1 << 20, 1 << 25):
        c = pd.scatter_chunk(n, 132)
        assert c % 16 == 0 and 256 <= c <= k14.CU["MAX_IPT"] * k14.CU["NT"]
        # two chunks an SM, unless the chunk is already the smallest
        assert c == 256 or -(-n // c) >= 2 * 132
    # a chunk's two stages and the private rows fit the card's opt-in
    # shared memory with room for three (counts) or two (qual sums)
    # blocks an SM (228 KiB an SM, 1 KiB a block reserved)
    for weight, blocks in ((False, 3), (True, 2)):
        C = pd.SCATTER_CHUNK
        stage = 2 * (4 * C + 16) + C + 16 + (4 * C + 16 if weight else 0)
        smem = k14.CU["RING"] * stage + pd.SCATTER_BUDGET_ROWS * 128
        assert blocks * (smem + 1024 + 64) <= 233_472


# ------------------------------------------------- K6's tail, K7 (PR 24)
def _cu_constants(name: str) -> dict:
    """The ``constexpr int`` constants of a kernel source."""
    import pathlib
    import re
    src = (pathlib.Path(md.__file__).parent.parent / "csrc" / name) \
        .read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _deltas_walk(appq: np.ndarray, qq: np.ndarray, cap: int):
    """csrc/qual_deltas.cu in numpy: grid 1 counts each tile's changed
    quals; in grid 2 each block takes the counts of the tiles before its
    own and of all tiles, each thread its 32 quals' changes at the ranks
    its block's scan gives them while a rank is below cap, then the
    slots from min(total, cap) to cap get 0 and appq's first qual.
    Returns (total, didx, dval, writes a slot)."""
    cu = _cu_constants("qual_deltas.cu")
    tpb, per = cu["TPB"], cu["PER"]
    assert md.DELTA_TILE == tpb * per
    a, q = appq.reshape(-1), qq.reshape(-1)
    n = a.size
    blocks = md.deltas_plan(n)
    ch = np.zeros(blocks * md.DELTA_TILE, bool)
    ch[:n] = a != q
    runs = ch.reshape(blocks, tpb, per)
    counts = runs.sum((1, 2))
    total = int(counts.sum())
    didx = np.zeros(cap, np.int64)
    dval = np.zeros(cap, np.uint8)
    writes = np.zeros(cap, np.int64)
    for b in range(blocks):
        before = int(counts[:b].sum())
        if before >= cap:
            continue
        tc = runs[b].sum(1)
        pre = np.cumsum(tc) - tc
        for t in np.flatnonzero(tc):
            js = np.flatnonzero(runs[b, t])
            slots = before + pre[t] + np.arange(js.size)
            keep = slots < cap
            e = b * md.DELTA_TILE + t * per + js[keep]
            didx[slots[keep]] = e
            dval[slots[keep]] = a[e]
            writes[slots[keep]] += 1
    fill = np.arange(min(total, cap), cap)
    didx[fill] = 0
    dval[fill] = a[0]
    writes[fill] += 1
    return total, didx, dval, writes


@pytest.mark.parametrize("n_reads,lq,changed", [
    (300, 101, 0), (300, 101, 1), (300, 101, "cap-1"), (300, 101, "cap+1"),
    (300, 101, "all"), (7, 37, "cap"), (1, 8, 3), (200, 150, 2000)])
def test_k6_tail_walk_equals_plain(n_reads, lq, changed):
    n = n_reads * lq
    cap = n // 16
    d = {"cap-1": cap - 1, "cap": cap, "cap+1": cap + 1,
         "all": n}.get(changed, changed)
    appq, qq = cc.changed_quals(n_reads, lq, d, seed=n_reads + lq)
    total, didx, dval, writes = _deltas_walk(appq, qq, cap)
    assert (writes == 1).all()          # every slot written once
    want = md.qual_deltas_plain(torch.from_numpy(appq),
                                torch.from_numpy(qq), cap)
    assert total == int(want[0]) == d
    assert np.array_equal(didx, want[1].numpy())
    assert np.array_equal(dval, want[2].numpy())


def test_k6_tail_plan():
    # 65,536 reads of 100 bases: 800 tiles; a tile for anything up to one
    assert md.deltas_plan(65536 * 100) == 800
    assert md.deltas_plan(1) == md.deltas_plan(md.DELTA_TILE) == 1
    assert md.deltas_plan(md.DELTA_TILE + 1) == 2


def _checksum_walk(census: np.ndarray, wlen: int, sms: int):
    """csrc/census_checksum.cu in numpy: the flat words [0, 6 wlen) as
    16-byte vectors over a grid-stride loop of checksum_plan's blocks
    (vector k to thread k mod blocks x TPB), the odd words after them
    through the same stride, each word's index 5 r + k for a count and
    5 wlen + r for a qual sum; each block's two sums mod 2^32 added.
    Returns (s1, s2, the blocks)."""
    cu = _cu_constants("census_checksum.cu")
    tpb = cu["TPB"]
    assert tpb == md.CHECKSUM_THREADS
    blocks = md.checksum_plan(wlen, sms)
    v = census[:wlen].reshape(-1).astype(np.int64) & 0xFFFFFFFF
    e = np.arange(v.size, dtype=np.int64)
    r, k = e // 6, e % 6
    idx = np.where(k < 5, 5 * r + k, 5 * wlen + r)
    nv = v.size // 4
    stride = blocks * tpb
    thread = np.where(e < 4 * nv, (e // 4) % stride, (e - 4 * nv) % stride)
    block = thread // tpb
    w1 = (idx * 2654435761) & 0xFFFFFFFF
    w2 = (((idx + 0x9E3779B9) & 0xFFFFFFFF) * 40503) & 0xFFFFFFFF
    s1 = s2 = 0
    for b in range(blocks):
        m = block == b
        s1 = (s1 + int((v[m] * w1[m] & 0xFFFFFFFF).sum())) & 0xFFFFFFFF
        s2 = (s2 + int((v[m] * w2[m] & 0xFFFFFFFF).sum())) & 0xFFFFFFFF
    return s1, s2, blocks


@pytest.mark.parametrize("wlen,sms", [(1, 132), (2, 132), (3, 132),
                                      (4095, 132), (4096, 132),
                                      (100_003, 132), (100_003, 1)])
def test_k7_walk_equals_plain(wlen, sms):
    c = cc.census_with_pad(wlen, wlen + 5, seed=wlen, negative=sms == 1)
    s1, s2, blocks = _checksum_walk(c, wlen, sms)
    assert (s1, s2) == md.census_checksum_plain(torch.from_numpy(c), wlen)
    assert 1 <= blocks <= md.CHECKSUM_BLOCKS_PER_SM * sms


def test_k7_plan():
    # the census core's 8 Mi rows: 4 blocks an SM; a small window: a
    # block for every 256 vectors
    assert md.checksum_plan(8 << 20, 132) == 4 * 132
    assert md.checksum_plan(1, 132) == 1
    assert md.checksum_plan(4096, 132) == 24
    assert md.checksum_plan(1 << 20, 1) == 4


# ------------------------------------------- K8's front, K9's two kernels
def _apply_walk(buf: np.ndarray, ref_int: np.ndarray, L: int):
    """csrc/apply_expand.cu in numpy: blocks of ``apply_plan(L)`` reads,
    the rows staged whole, each thread writing the GROUP output bytes
    from GROUP (t + k TPB) of the block's span of sq and qq, then of
    ref_win (U groups a step), each group's read and column from one
    division and a carry.  Returns (ref_win, sq, qq, the thread that
    wrote each byte of each output, the writes a byte)."""
    cu = _cu_constants("apply_expand.cu")
    tpb, group, pad = cu["TPB"], cu["GROUP"], cu["PAD"]
    assert cu["MAX_READS"] == bd.APPLY_READS and pad == bd.APPLY_PAD
    B = buf.shape[0]
    W = L + pad
    reads = bd.apply_plan(L)
    assert reads * (4 + 2 * L) <= bd.APPLY_STAGE
    out = {"sq": np.zeros((B, L), np.uint8), "qq": np.zeros((B, L), np.uint8),
           "ref_win": np.zeros((B, W), np.uint8)}
    who = {k: np.full(v.shape, -1, np.int64) for k, v in out.items()}
    writes = {k: np.zeros(v.shape, np.int64) for k, v in out.items()}
    table = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4] +
                     [4] * 240, np.uint8)
    last = ref_int.size - 1
    for b0 in range(0, B, reads):
        nr = min(reads, B - b0)
        rows = buf[b0:b0 + nr].reshape(-1)          # the staged span
        rs = 4 + 2 * L
        start = np.minimum(rows.reshape(nr, rs)[:, :4].copy().view("<i4")
                           [:, 0].astype(np.int64), last)
        for name, width, n in (("sq", L, nr * L), ("qq", L, nr * L),
                               ("ref_win", W, nr * W)):
            for t in range(tpb):
                for e in range(group * t, n, group * tpb):
                    r, c = divmod(e, width)
                    for k in range(group):
                        if e + k >= n:
                            break
                        if name == "sq":
                            v = table[rows[r * rs + 4 + c]]
                        elif name == "qq":
                            v = rows[r * rs + 4 + L + c]
                        else:
                            v = ref_int[min(max(start[r] + c, 0), last)]
                        o = out[name].reshape(-1)
                        at = b0 * width + e + k
                        o[at] = v
                        who[name].reshape(-1)[at] = (b0 // reads) * tpb + t
                        writes[name].reshape(-1)[at] += 1
                        c += 1
                        if c == width:
                            r, c = r + 1, 0
    return out, who, writes


@pytest.mark.parametrize("L,n", [(37, 70), (100, 33), (151, 40), (9, 5),
                                 (2000, 20)])
def test_k8_front_walk_equals_plain(L, n):
    ref, ref_int = cc.reference(1 << 12, seed=L)
    rng = np.random.default_rng(L)
    pos = rng.integers(-10, ref_int.size + 10, n)
    pos[0] = ref_int.size - 1
    seq = rng.integers(0, 16, (n, L)).astype(np.uint8)
    qual = rng.integers(2, 42, (n, L)).astype(np.uint8)
    buf = cc.apply_buf(pos, seq, qual)
    out, who, writes = _apply_walk(buf, ref_int, L)
    want = bd.apply_expand_plain(torch.from_numpy(ref_int),
                                 torch.from_numpy(buf))
    for k, w in zip(("ref_win", "sq", "qq"), want):
        assert (writes[k] == 1).all(), k          # every byte once
        assert np.array_equal(out[k], w.numpy()), k
        # neighbouring threads write neighbouring words of one span
        flat = who[k].reshape(-1)
        reads = bd.apply_plan(L)
        width = out[k].shape[1]
        span = reads * width
        for b0 in range(0, flat.size, span):
            ids = flat[b0:b0 + span] % 256
            g = np.arange(ids.size) // 4
            assert np.array_equal(ids, g % 256)


def test_k8_front_plan():
    # 32 reads a block up to 510 bases (the rows fit 32 KB), then fewer;
    # past 16,382 bases not one row fits (K4 stops far below: apply_fits)
    assert bd.apply_plan(100) == bd.apply_plan(151) == 32
    assert bd.apply_plan(510) == 32 and bd.apply_plan(511) == 31
    assert bd.apply_plan(2000) == 8
    assert bd.apply_plan(16_382) == 1 and 4 + 2 * 16_382 <= bd.APPLY_STAGE
    for L in (1, 37, 100, 151, 500, 5000, 16_382):
        assert bd.apply_plan(L) * (4 + 2 * L) <= bd.APPLY_STAGE


def _depth_walk(diff, direct, L: int) -> np.ndarray:
    """csrc/depth_scan.cu in numpy: tiles of DEPTH_TILE rows, PER a
    thread; grid 1 the tiles' uint32 sums of diff; grid 2 each tile's
    carry (the sums of the tiles before it, mod 2^32), each thread's
    exclusive prefix from the threads before it, its rows' running sums
    plus direct mod 2^32, rows [0, L) written, and two words: the max of
    the rows below ``rows`` and the complement of the min of those below
    L, each over the values biased by 2^31, a thread's, a warp's, a
    block's; grid 3 rows [0, L) rewritten wrapped to the width of the
    max only where that width cannot hold the min.  Returns int32[L]."""
    cu = _cu_constants("depth_scan.cu")
    tpb, per = cu["TPB"], cu["PER"]
    assert pe.DEPTH_TILE == tpb * per
    rows = (diff if diff is not None else direct).size
    tiles = pe.depth_plan(rows)
    tile = pe.DEPTH_TILE

    def col(c):
        v = np.zeros(tiles * tile, np.uint64)
        if c is not None:
            v[:rows] = c.astype(np.int64).astype(np.uint32)
        return v
    v, w = col(diff), col(direct)
    tsum = v.reshape(tiles, -1).sum(1) % (1 << 32)
    out = np.zeros(tiles * tile, np.int32)
    ext = [0, 0]
    for b in range(tiles):
        carry = int(tsum[:b].sum()) % (1 << 32) if diff is not None else 0
        vt = v[b * tile:(b + 1) * tile].reshape(tpb, per)
        wt = w[b * tile:(b + 1) * tile].reshape(tpb, per)
        pre = np.concatenate([[0], np.cumsum(vt.sum(1))[:-1]])
        run = (carry + pre[:, None] + np.cumsum(vt, 1)) % (1 << 32)
        d = ((run + wt) % (1 << 32)).astype(np.uint32)
        row = (b * tile + np.arange(tile)).reshape(tpb, per)
        biased = d ^ np.uint32(1 << 31)
        for k, keep, word in ((0, row < rows, biased),
                              (1, row < L, ~biased)):
            warp = np.where(keep, word, 0).max(1).reshape(-1, 32).max(1)
            ext[k] = max(ext[k], int(warp.max()))
        out[b * tile:(b + 1) * tile] = d.view(np.int32).reshape(-1)
    out = out[:L]
    m = int(np.uint32(ext[0] ^ (1 << 31)).view(np.int32))
    lo = int(np.uint32(~np.uint32(ext[1]) ^ np.uint32(1 << 31)).view(
        np.int32))
    if m < 256 and lo < 0:
        return out & 0xFF
    if m < 1 << 15 and lo < -(1 << 15):
        return out.astype(np.int16).astype(np.int32)
    return out


@pytest.mark.parametrize("edge", range(len(SCRIPT.EDGES)))
@pytest.mark.parametrize("rows,L", [(3 * 8192 + 4100, 3 * 8192 + 2100),
                                    (8192, 8191), (8192 * 2, 8192 * 2),
                                    (50, 37)])
def test_k9_depth_walk_equals_plain_and_jax(edge, rows, L):
    top, where, cols = SCRIPT.EDGES[edge]
    if where == "pad" and L + 10 >= rows:
        where = "in"
    diff, direct = SCRIPT.edge_columns(rows, L, top, where, cols,
                                       np.random.default_rng(edge + rows))
    out = _depth_walk(diff, direct, L)
    args = [None if c is None else torch.from_numpy(c[:, None])
            for c in (diff, direct)]
    assert np.array_equal(out, pe.depth_scan_plain(*args, L))
    zero = np.zeros(rows, np.int32)
    jd, jmx = jpe._depth_cumsum_jit()(
        jnp.asarray((diff if diff is not None else zero)[:, None]),
        jnp.asarray((direct if direct is not None else zero)[:, None]))
    assert int(jmx) == top
    # the depths as they are, but for the negative ones a narrowing wraps
    assert np.array_equal(out, np.asarray(jd)[:L]) == (
        where != "neg" or top >= 1 << 15)
    assert np.array_equal(out, jpe._fetch_narrow(jd, int(jmx), L))


def test_k9_depth_plan():
    # clean's 8 Mi-row window: 1,024 tiles; a tile for up to 8,192 rows
    assert pe.depth_plan(8 << 20) == 1024
    assert pe.depth_plan(1) == pe.depth_plan(pe.DEPTH_TILE) == 1
    assert pe.depth_plan(pe.DEPTH_TILE + 1) == 2


def _cov_walk(census: np.ndarray, sub: int, min_depth: int, sms: int):
    """csrc/cov_reduce.cu in numpy: cov_plan's G blocks a subwindow,
    block (s, g) over rows [s sub + g chunk, min(s sub + (g + 1) chunk,
    (s + 1) sub, rows)), a thread's rows TPB apart, int64 partials of the
    gated (c0, c1 + 128 c3, 1), the blocks' sums written and added in
    order by the subwindow's last block.  Returns (out, the block of each
    row)."""
    cu = _cu_constants("cov_reduce.cu")
    tpb = cu["TPB"]
    rows = census.shape[0]
    nsub = -(-rows // sub)
    G, chunk = pe.cov_plan(rows, sub, sms)
    assert G * chunk >= min(sub, rows)
    c = census.astype(np.int64)
    ok = (c[:, 2] > 0) & (c[:, 0] > 0) & (c[:, 0] >= min_depth)
    lanes = np.stack([c[:, 0], c[:, 1] + 128 * c[:, 3], np.ones(rows,
                                                               np.int64)],
                     1) * ok[:, None]
    block = np.full(rows, -1, np.int64)
    partial = np.zeros((nsub * G, 3), np.int64)
    for s in range(nsub):
        for g in range(G):
            lo = s * sub + g * chunk
            hi = min(s * sub + min((g + 1) * chunk, sub), rows)
            if lo >= hi:
                continue
            assert (block[lo:hi] == -1).all()
            block[lo:hi] = s * G + g
            r = np.arange(lo, hi)
            per_thread = np.zeros((tpb, 3), np.int64)
            np.add.at(per_thread, (r - lo) % tpb, lanes[lo:hi])
            partial[s * G + g] = per_thread.sum(0)
    out = partial.reshape(nsub, G, 3).sum(1)
    return out, block


@pytest.mark.parametrize("rows,sub,min_depth,sms", [
    (SCRIPT.SUB * 3 + 17, SCRIPT.SUB, 1, 132), (20_000, 4096, 25, 132),
    (1, 4096, 1, 132), (5000, 1 << 16, 0, 132), (70_000, 65_536, 1, 1),
    (1 << 16, 1 << 16, 1, 132)])
def test_k9_cov_walk_equals_plain_and_jax(rows, sub, min_depth, sms):
    census = SCRIPT.cov_edge_census(rows, np.random.default_rng(rows))
    out, block = _cov_walk(census, sub, min_depth, sms)
    assert (block >= 0).all()                     # every row in a block
    want = pe.cov_reduce_plain(torch.from_numpy(census), sub, min_depth)
    assert np.array_equal(out, want.numpy())
    j = census[:, :3].copy()
    j[:, 1] += 128 * census[:, 3]
    jgot = np.asarray(jpe._cov_reduce_jit()(
        jnp.asarray(np.pad(j, ((0, (-rows) % sub), (0, 0)))), sub,
        min_depth)).astype(np.int64)
    # the JAX sums are int32: equal mod 2^32, and equal where below 2^31
    assert np.array_equal(jgot % (1 << 32), out % (1 << 32))
    if out.max() < 1 << 31:
        assert np.array_equal(jgot, out)


def test_k9_cov_plan():
    # the streamed window: 16 subwindows of 65,536 rows, 33 blocks each,
    # four blocks an SM; small inputs: a block per 1,024 rows at least
    assert pe.cov_plan(1 << 20, 1 << 16, 132) == (33, 1986)
    assert pe.cov_plan(1, 1 << 16, 132) == (1, 1)
    assert pe.cov_plan(5000, 1 << 16, 132) == (5, 1000)
    assert pe.cov_plan(8 << 20, 1 << 16, 132) == (5, 13108)
    for rows, sub, sms in ((1 << 20, 1 << 16, 132), (999, 7, 2),
                           (123_457, 4096, 132)):
        G, chunk = pe.cov_plan(rows, sub, sms)
        nsub = -(-rows // sub)
        assert G * chunk >= min(sub, rows)
        assert nsub * G <= max(nsub, pe.COV_BLOCKS_PER_SM * sms + nsub)
