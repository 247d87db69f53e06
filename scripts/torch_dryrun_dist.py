"""Two-process ``torch.distributed`` dry run of the port's mesh on CPU
shards (the twin of scripts/dryrun_dist.py).

Each process joins a gloo process group from the SAMTPU_DIST_*
environment and meshes over 4 CPU shards, so the data axis has 8 shards
in all.  Every process builds the same input; each takes its shards; the
reductions add (``all_reduce``) or join (``all_gather``) the processes'
parts.  Checked on every process: a global 16-bin histogram of 4,096
values (the sharded pileup, K14's plain version, on a 16-row window)
against ``np.bincount``; the flag census (K11's plain version) against
the numpy one; and a sharded depth window (K1's plain version, tiles
over all 8 shards) against the host depth.  Prints ``DIST_DRYRUN
proc=<id> OK`` or ``MISMATCH``.

Launch (tests/test_torch_dist.py does this):
  SAMTPU_DIST_COORD=localhost:PORT SAMTPU_DIST_NPROCS=2 \\
  SAMTPU_DIST_PROC_ID={0,1} python scripts/torch_dryrun_dist.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    from samtools_tpu_torch import sim
    from samtools_tpu_torch.core import flags as F
    from samtools_tpu_torch.ops import depth as hd
    from samtools_tpu_torch.ops import flagstat as fs
    from samtools_tpu_torch.ops.pileup_device import make_sharded_pileup
    from samtools_tpu_torch.parallel import mesh as M
    from samtools_tpu_torch.parallel.dist import (maybe_init_distributed,
                                                  process_info)

    torch.set_num_threads(1)
    assert maybe_init_distributed("cpu"), "SAMTPU_DIST_* env not set"
    pid, nprocs = process_info()
    mesh = M.make_mesh(n_data=4, devices=[torch.device("cpu")] * 4)

    rng = np.random.RandomState(0)
    vals = rng.randint(0, 16, 1 << 12).astype(np.int32)
    fn, _ = make_sharded_pileup(mesh, 16)
    hist = fn(vals, np.zeros(vals.size, np.int32),
              np.ones(vals.size, bool))[:, 0]
    ok = np.array_equal(hist.numpy(), np.bincount(vals, minlength=16))

    m = 5001
    b = type("Flags", (), dict(
        n=m, flag=rng.randint(0, 1 << 12, m).astype(np.uint16),
        mapq=rng.randint(0, 60, m).astype(np.uint8),
        tid=rng.randint(-1, 3, m).astype(np.int32),
        mtid=rng.randint(-1, 3, m).astype(np.int32)))
    ok &= M.flagstat_counts_sharded(mesh, b) == fs.flagstat_numpy(b)

    L = 1 << 14
    batch = sim.simulate_batch(ref_len=L, coverage=8.0, read_len=50,
                               seed=7, paired=False)
    excl = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP
    sel = np.nonzero(((batch.flag & excl) == 0) & (batch.tid == 0))[0]
    got = M.depth_window_sharded(mesh, batch, sel, 0, L, 0, False)
    ok &= np.array_equal(got, hd.depth_window(batch, sel, 0, L, 0, False))

    print(f"DIST_DRYRUN proc={pid}", "OK" if ok else "MISMATCH",
          f"procs={nprocs}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
