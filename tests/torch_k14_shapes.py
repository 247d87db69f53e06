"""K14's adversarial inputs, shared by its CPU emulation tests
(tests/test_torch_kernel_plans.py) and its card tests
(tests/test_torch_cuda.py); numpy only, made from seeds.

Scatter items are (refpos, lane, valid, qual) int32/int32/bool/int32
arrays and a window:

* ``read_order``: a simulated 30x contig's M bases in read order, as
  every path hands them to the scatter (``expand_to_device_arrays``),
  the window starting 2,048 bases in (bases before and after it);
* ``reversed``: the same items back to front; ``random``: random rows
  and lanes;
* ``one_cell``: 100,000 items on one cell;
* ``budget_edge``: whole chunks whose adding items span exactly the
  private budget's rows, one row more, and the budget with items beyond
  both ends that add nothing (invalid, lane 32);
* ``ragged``: n not a multiple of the chunk; ``one_item``; ``one_row``
  (a window of 1);
* ``edge_lanes``: the lanes -1, 31, 32, 40 and -33, invalid items and
  rows on both sides of the window.

Tiled inputs are (posrel, lane, valid) [n_tiles, B] arrays and a tile:
``bucket_bases`` of read-order items (B a multiple of 16 or not), the
one-cell pile, a tile of one row, and random rows and lanes past both
ends with invalid items.

``CU`` holds the kernel source's compile-time constants (threads a
block, stages, items a thread), read from csrc/pileup_counts.cu itself,
so that the emulations model the kernel as it is built;
``pileup_kernels_script()`` loads scripts/torch_pileup_kernels.py (the
scatter's chunk paths in torch ops).
"""

from __future__ import annotations

import importlib.util
import os
import re

import numpy as np

from samtools_tpu_torch import build, sim
from samtools_tpu_torch.ops import pileup_device as pd


def cu_constants() -> dict:
    """``constexpr int NAME = value;`` of csrc/pileup_counts.cu."""
    with open(os.path.join(build.ROOT, "csrc", "pileup_counts.cu")) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(
        r"^constexpr int (\w+) = (\d+);", text, re.M)}


CU = cu_constants()


def pileup_kernels_script():
    """scripts/torch_pileup_kernels.py as a module."""
    path = os.path.join(os.path.dirname(build.ROOT), "scripts",
                        "torch_pileup_kernels.py")
    spec = importlib.util.spec_from_file_location("torch_pileup_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_order(ref_len: int = 1 << 14, seed: int = 5, wbeg: int = 2048,
               window: int = 1 << 13):
    """(refpos, lane, valid, qual, window): a 30x contig's M bases."""
    b = sim.simulate_batch(ref_len=ref_len, coverage=30.0, read_len=100,
                           seed=seed, paired=False,
                           ref=sim.simulate_reference(ref_len, seed=seed))
    rp, ln, q, ok = pd.expand_to_device_arrays(b, np.arange(b.n), wbeg,
                                               window)
    return rp, ln, ok, q, window


def random_items(seed: int, n: int, window: int):
    rng = np.random.default_rng(seed)
    rp = rng.integers(-window // 8, window + window // 8, n).astype(np.int32)
    ln = rng.integers(0, 32, n).astype(np.int32)
    ok = rng.random(n) > 0.1
    q = rng.integers(0, 61, n).astype(np.int32)
    return rp, ln, ok, q, window


def one_cell(n: int = 100_000):
    return (np.full(n, 5, np.int32), np.full(n, 3, np.int32),
            np.ones(n, bool), np.full(n, 37, np.int32), 16)


def budget_edge(chunk: int, budget: int = pd.SCATTER_BUDGET_ROWS,
                seed: int = 3):
    """Four chunks of ``chunk`` items and a ragged fifth: chunk 0's
    adding rows span ``budget`` rows, chunk 1's ``budget`` + 1, chunk 2's
    ``budget`` with items 50 rows beyond each end that add nothing, chunk
    3 none that add."""
    rng = np.random.default_rng(seed)
    window = 4 * budget + 400
    rows, lanes, oks = [], [], []
    for k, span in enumerate((budget, budget + 1, budget, 1)):
        lo = 100 + k * budget // 2
        r = rng.integers(lo, lo + span, chunk)
        r[rng.choice(chunk, 2, replace=False)] = (lo, lo + span - 1)
        ln = rng.integers(0, 32, chunk)
        ok = np.ones(chunk, bool)
        if k == 2:
            r[:4] = (lo - 50, lo - 50, lo + span + 49, lo + span + 49)
            ok[:2] = False
            ln[2:4] = 32
        if k == 3:
            ok[:] = False
        rows.append(r)
        lanes.append(ln)
        oks.append(ok)
    rows.append(rng.integers(0, window, chunk // 3))
    lanes.append(rng.integers(0, 32, chunk // 3))
    oks.append(np.ones(chunk // 3, bool))
    rp = np.concatenate(rows).astype(np.int32)
    q = rng.integers(0, 61, rp.size).astype(np.int32)
    return (rp, np.concatenate(lanes).astype(np.int32), np.concatenate(oks),
            q, window)


def edge_lanes(seed: int = 9, n: int = 5000, window: int = 700):
    rp, ln, ok, q, window = random_items(seed, n, window)
    rng = np.random.default_rng(seed + 1)
    ln[rng.choice(n, 50, replace=False)] = np.repeat(
        np.array([-1, 31, 32, 40, -33], np.int32), 10)
    return rp, ln, ok, q, window


def scatter_case(name: str, sms: int = 132):
    """The scatter input ``name`` (chunks sized for a card of ``sms``
    SMs where the case is cut at chunk boundaries)."""
    if name == "read_order":
        return read_order()
    if name == "reversed":
        rp, ln, ok, q, w = read_order()
        return rp[::-1].copy(), ln[::-1].copy(), ok[::-1].copy(), \
            q[::-1].copy(), w
    if name == "random":
        return random_items(7, 60_000, 1 << 12)
    if name == "one_cell":
        return one_cell()
    if name == "budget_edge":
        # the chunk the wrapper takes for the case's own item count
        for c in (2048, 1024, 512, 256):
            if pd.scatter_chunk(4 * c + c // 3, sms) == c:
                return budget_edge(c)
    if name == "ragged":
        return random_items(11, 3 * 256 + 17, 300)
    if name == "one_item":
        return (np.array([3], np.int32), np.array([-1], np.int32),
                np.ones(1, bool), np.array([30], np.int32), 8)
    if name == "one_row":
        return random_items(13, 4000, 1)
    if name == "edge_lanes":
        return edge_lanes()
    raise KeyError(name)


SCATTER_CASES = ("read_order", "reversed", "random", "one_cell",
                 "budget_edge", "ragged", "one_item", "one_row",
                 "edge_lanes")


def tiled_case(name: str):
    """(posrel, lane, valid, tile, n_tiles) for the tiled input
    ``name``."""
    if name in ("read_order", "read_order_b16"):
        rp, ln, ok, _, window = read_order(ref_len=1 << 13, wbeg=0,
                                           window=1 << 13)
        inwin = ok & (rp >= 0) & (rp < window)
        posrel, lanes, valid = pd.bucket_bases(rp[inwin], ln[inwin], window,
                                               128)
        if name == "read_order_b16":
            B = -(-posrel.shape[1] // 16) * 16 + 16
            grow = B - posrel.shape[1]
            posrel = np.pad(posrel, ((0, 0), (0, grow)), constant_values=-1)
            lanes = np.pad(lanes, ((0, 0), (0, grow)))
            valid = np.pad(valid, ((0, 0), (0, grow)))
        return posrel, lanes, valid, 128, posrel.shape[0]
    if name == "one_cell":
        rp, ln, ok, _, _ = one_cell()
        return rp[None] % 8, ln[None], ok[None], 8, 1
    if name == "one_row":
        rng = np.random.default_rng(4)
        return (rng.integers(-1, 2, (5, 333)).astype(np.int32),
                rng.integers(0, 32, (5, 333)).astype(np.int32),
                rng.random((5, 333)) > 0.2, 1, 5)
    if name == "edges":
        rng = np.random.default_rng(6)
        shape = (9, 1001)
        return (rng.integers(-3, 67, shape).astype(np.int32),
                rng.integers(-34, 35, shape).astype(np.int32),
                rng.random(shape) > 0.3, 64, 9)
    raise KeyError(name)


TILED_CASES = ("read_order", "read_order_b16", "one_cell", "one_row",
               "edges")
