"""Entry points of the port for a quick check: the single-device pileup
step and a dry run of the sharded path (twins of the repository's
``__graft_entry__.py``: ``entry`` :14, ``dryrun_multichip`` :31).

``entry()`` gives the flagship device step -- K14's dense pileup scatter
(``ops/pileup_device.pileup_counts``) -- with example inputs.
``dryrun_multichip(n)`` builds a (data, region) mesh of n shards and runs
the sharded pileup, the flagstat reduction and a sharded depth window end
to end on small shapes, each against its unsharded twin.  (The JAX twin
also runs the ``depth`` and ``flagstat`` commands on its mesh; the port's
commands mesh over distinct cards only, and the tests reach their mesh
branch on CPU shards, tests/test_torch_sharded_tools.py.)
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): K14 ``pileup_counts`` over a 16,384-row window
    and its 65,536 items, the items as tensors on ``device`` (None: the
    CUDA card)."""
    from .device import resolve
    from .ops.pileup_device import pileup_counts

    dev = resolve(device)
    rng = np.random.RandomState(0)
    n = 1 << 16
    window = 1 << 14
    refpos = torch.from_numpy(rng.randint(0, window, n).astype(np.int32))
    lane = torch.from_numpy(rng.randint(0, 32, n).astype(np.int32))
    valid = torch.ones(n, dtype=torch.bool)

    def fn(refpos, lane, valid):
        return pileup_counts(refpos, lane, valid, window)

    return fn, tuple(t.to(dev) for t in (refpos, lane, valid))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded step over an n_devices mesh (data x region): the
    data-sharded reads and region-sharded window of the pileup with the
    data shards' sum, the flagstat sum, and a sharded depth, each equal
    to its unsharded run.  The shards are n CPU shards when ``device`` is
    the CPU, else n shards of the card."""
    from .core import flags as F
    from .device import resolve
    from .ops import depth as hd
    from .ops.flagstat import flagstat_census
    from .ops.pileup_device import make_sharded_pileup, pileup_counts
    from .parallel.mesh import (depth_window_sharded, flagstat_sharded,
                                make_mesh)
    from .sim import simulate_batch

    dev = resolve(device)
    n_region = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_region
    mesh = make_mesh(n_data=n_data, n_region=n_region,
                     devices=[dev] * n_devices)

    rng = np.random.RandomState(0)
    window_per_shard = 256
    n = 1024
    total_window = window_per_shard * n_region
    refpos = rng.randint(0, total_window, n).astype(np.int32)
    lane = rng.randint(0, 32, n).astype(np.int32)
    valid = np.ones(n, bool)
    fn, total = make_sharded_pileup(mesh, window_per_shard)
    counts = fn(refpos, lane, valid)
    assert counts.shape == (total, 32)
    assert int(counts.sum()) == n
    whole = pileup_counts(*(torch.from_numpy(a).to(dev) for a in (
        refpos, lane, valid)), total_window)
    assert torch.equal(counts, whole), "sharded pileup mismatch"

    m = 4096
    flag = rng.randint(0, 1 << 12, m).astype(np.uint16)
    mapq = rng.randint(0, 60, m).astype(np.uint8)
    tid = rng.randint(0, 3, m).astype(np.int32)
    mtid = rng.randint(0, 3, m).astype(np.int32)
    out = flagstat_sharded(mesh, flag, mapq, tid, mtid, np.ones(m, bool))
    assert out.shape == (16, 2)
    assert int(out[0].sum()) == m
    single = flagstat_census(*(torch.from_numpy(a).to(dev) for a in (
        flag, mapq, tid, mtid)))
    assert torch.equal(out, single), "sharded flagstat mismatch"

    b = simulate_batch(ref_len=1 << 14, coverage=8.0, read_len=50, seed=7,
                       paired=False)
    excl = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
    sel = np.nonzero(((b.flag & excl) == 0) & (b.tid == 0))[0]
    got = depth_window_sharded(mesh, b, sel, 0, 1 << 14, 0, False)
    want = hd.depth_window(b, sel, 0, 1 << 14, 0, False)
    assert np.array_equal(np.asarray(got, np.int64),
                          want.astype(np.int64)), "sharded depth mismatch"
