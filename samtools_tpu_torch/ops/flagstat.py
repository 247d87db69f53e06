"""The flag census of samtools flagstat, on the card (K11) or the host.

Counterpart of samtools_tpu/ops/flagstat.py: ``COUNTERS`` (:22-28), the
condition rules (:31-64; bam_stat.c:48-79's chain of flag tests), the
numpy host branch ``flagstat_numpy`` (:118-147) and ``flagstat_counts``
(:84-107), which here calls K11 (``csrc/flagstat.cu``) once per batch in
place of JAX's padded-chunk einsum.  The counts are integers: the card,
the plain torch version and numpy agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core import flags as F
from ..device import h2d

# counter row order (the output order of bam_stat.c:129-146)
COUNTERS = [
    "n_reads", "n_primary", "n_secondary", "n_supp", "n_dup", "n_pdup",
    "n_mapped", "n_pmapped", "n_pair_all", "n_read1", "n_read2",
    "n_pair_good", "n_pair_map", "n_sgltn", "n_diffchr", "n_diffhigh",
]
N_COUNTERS = len(COUNTERS)


def _conditions(f, mapq, tid, mtid, ones):
    """The 16 per-record conditions (int arrays or tensors), in COUNTERS
    order."""
    secondary = (f & F.FSECONDARY) != 0
    supp = (f & F.FSUPPLEMENTARY) != 0
    primary = ~secondary & ~supp
    unmap = (f & F.FUNMAP) != 0
    munmap = (f & F.FMUNMAP) != 0
    paired = (f & F.FPAIRED) != 0
    dup = (f & F.FDUP) != 0
    ppair = (f & F.FPROPER_PAIR) != 0
    pair_all = primary & paired
    pair_map = pair_all & ~unmap & ~munmap
    diffchr = pair_map & (mtid != tid)
    return [
        ones, primary, secondary, supp, dup, primary & dup,
        ~unmap, primary & ~unmap, pair_all,
        pair_all & ((f & F.FREAD1) != 0), pair_all & ((f & F.FREAD2) != 0),
        pair_all & ppair & ~unmap, pair_map, pair_all & munmap & ~unmap,
        diffchr, diffchr & (mapq >= 5),
    ]


def flagstat_plain(flag: torch.Tensor, mapq: torch.Tensor, tid: torch.Tensor,
                   mtid: torch.Tensor) -> torch.Tensor:
    """K11's plain version: int64[16, 2] counts (QC-pass, QC-fail) from
    flag uint16[n], mapq uint8[n], tid/mtid int32[n], as torch integer
    ops."""
    f = flag.to(torch.int32)
    conds = _conditions(f, mapq.to(torch.int32), tid, mtid,
                        torch.ones_like(f, dtype=torch.bool))
    qcfail = (f & F.FQCFAIL) != 0
    c = torch.stack(conds, 1).to(torch.int64)
    return torch.stack([(c * (~qcfail)[:, None]).sum(0),
                        (c * qcfail[:, None]).sum(0)], 1)


# K11's launch plan (csrc/flagstat.cu): 256-thread blocks, 8 records a
# thread a step, at most this many blocks an SM (one wave)
TPB = 256
VEC = 8
BLOCKS_PER_SM = 2


def flagstat_plan(n: int, sms: int) -> int:
    """K11's grid for ``n`` records on a card of ``sms`` SMs: one wave of
    at most BLOCKS_PER_SM blocks an SM, fewer when the records' groups of
    8 do not give every thread one (0 for no records)."""
    if n <= 0:
        return 0
    groups = -(-n // VEC)
    return max(1, min(sms * BLOCKS_PER_SM, -(-groups // TPB)))


_LAUNCH: dict = {}


def _launch_state(device: torch.device, stream: int) -> tuple[int, int]:
    """(SM count, scratch pointer) of K11's launches on ``stream`` of
    ``device``, found once: a call at the command's batch size spends
    little more on the host than the launch itself."""
    key = (device.index, stream)
    got = _LAUNCH.get(key)
    if got is None:
        sms = kernels.sm_count(device)
        got = _LAUNCH[key] = (sms, kernels.scratch(
            "flagstat", device, stream,
            32 + 32 * sms * BLOCKS_PER_SM).data_ptr())
    return got


def flagstat_census(flag: torch.Tensor, mapq: torch.Tensor,
                    tid: torch.Tensor, mtid: torch.Tensor) -> torch.Tensor:
    """K11: int64[16, 2] counts from flag uint16[n], mapq uint8[n],
    tid/mtid int32[n].  CPU tensors take the plain version; CUDA tensors
    launch the kernel, which writes every count (the last block to finish
    sums the blocks' partials), so ``out`` is not zeroed first."""
    n = flag.numel()
    kernels.check(flag, "flag", torch.uint16, (n,))
    kernels.check(mapq, "mapq", torch.uint8, (n,))
    kernels.check(tid, "tid", torch.int32, (n,))
    kernels.check(mtid, "mtid", torch.int32, (n,))
    if not kernels.on_card(flag, mapq, tid, mtid):
        return flagstat_plain(flag, mapq, tid, mtid)
    if not n:
        return torch.zeros(N_COUNTERS, 2, dtype=torch.int64,
                           device=flag.device)
    stream = kernels.stream_of(flag)
    sms, scratch = _launch_state(flag.device, stream)
    out = torch.empty(N_COUNTERS, 2, dtype=torch.int64, device=flag.device)
    kernels.launch("flagstat", "samtpu_flagstat", flag.data_ptr(),
                   mapq.data_ptr(), tid.data_ptr(), mtid.data_ptr(), n,
                   flagstat_plan(n, sms), scratch, out.data_ptr(), stream,
                   device=flag.device)
    return out


def _as_dict(counts) -> dict[str, tuple[int, int]]:
    return {name: (int(counts[i, 0]), int(counts[i, 1]))
            for i, name in enumerate(COUNTERS)}


def flagstat_counts(batch, device) -> dict[str, tuple[int, int]]:
    """{counter: (qc_pass, qc_fail)} of a ReadBatch through K11 on
    ``device`` (a torch device; the CPU takes the plain version)."""
    args = [h2d(np.ascontiguousarray(a, dt), device) for a, dt in (
        (batch.flag, np.uint16), (batch.mapq, np.uint8),
        (batch.tid, np.int32), (batch.mtid, np.int32))]
    return _as_dict(flagstat_census(*args).cpu().numpy())


def flagstat_numpy(batch) -> dict[str, tuple[int, int]]:
    """The host branch (``SAMTPU_DEVICE=0``) and the oracle: numpy."""
    f = batch.flag.astype(np.int32)
    conds = _conditions(f, batch.mapq.astype(np.int32),
                        batch.tid.astype(np.int32),
                        batch.mtid.astype(np.int32), np.ones(f.size, bool))
    qcfail = (f & F.FQCFAIL) != 0
    w = np.stack([~qcfail, qcfail], axis=1)
    counts = np.stack(conds, axis=1).astype(np.int64).T @ w.astype(np.int64)
    return _as_dict(counts)
