"""Several processes: ``torch.distributed`` from the SAMTPU_DIST_*
environment.

Counterpart of samtools_tpu/parallel/dist.py (:28-62), where each host
runs one process and ``jax.distributed`` joins their devices into one
global mesh.  Here each process meshes over its own devices
(parallel/mesh.py) and the mesh's reductions add or gather the processes'
parts over the process group, so the data axis spans every process.

Environment contract (set by the launcher for every process):
  SAMTPU_DIST_COORD    address host:port of process 0 (the switch)
  SAMTPU_DIST_NPROCS   number of processes
  SAMTPU_DIST_PROC_ID  this process's id (0-based)

``maybe_init_distributed()`` is called once from ``cli.main`` before any
command runs; without SAMTPU_DIST_COORD it does nothing.  The backend is
``gloo`` when the caller asked for the CPU and ``nccl`` for the CUDA
cards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as tdist


def maybe_init_distributed(device=None) -> bool:
    """Join the process group the SAMTPU_DIST_* environment names:
    ``init_process_group`` at ``tcp://<SAMTPU_DIST_COORD>``.  ``device``
    is the caller's (None: the CUDA cards, backend nccl; a CPU device:
    gloo).  True when running distributed (after the join), False
    without SAMTPU_DIST_COORD.  Idempotent."""
    if tdist.is_available() and tdist.is_initialized():
        return True
    coord = os.environ.get("SAMTPU_DIST_COORD")
    if not coord:
        return False
    nprocs = int(os.environ["SAMTPU_DIST_NPROCS"])
    proc_id = int(os.environ["SAMTPU_DIST_PROC_ID"])
    cpu = device is not None and torch.device(device).type == "cpu"
    tdist.init_process_group("gloo" if cpu else "nccl",
                             init_method=f"tcp://{coord}",
                             world_size=nprocs, rank=proc_id)
    return True


def process_info() -> tuple[int, int]:
    """(process_id, num_processes): (0, 1) when not distributed."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def host_shard_ranges(total: int) -> tuple[int, int]:
    """This process's contiguous slice of ``total`` work items (a block
    partition)."""
    pid, n = process_info()
    per = (total + n - 1) // n
    lo = min(pid * per, total)
    return lo, min(lo + per, total)
