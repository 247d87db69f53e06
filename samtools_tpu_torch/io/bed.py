"""BED interval index with vectorized overlap queries (samtools' bedidx.c,
as mpileup's ``-l`` uses it).

Counterpart of samtools_tpu/io/bed.py (:18-98): per chromosome, intervals
sorted by start with a prefix maximum of their ends, so one searchsorted
answers "does [b, e) overlap any interval" for a whole batch at once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BedIndex:
    # per chromosome: (starts sorted ascending, prefix max of ends)
    chroms: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    def add(self, chrom: str, beg: int, end: int):
        self.raw.setdefault(chrom, []).append((beg, end))

    def finalize(self) -> "BedIndex":
        for chrom, ivals in self.raw.items():
            arr = np.array(ivals, np.int64).reshape(-1, 2)
            order = np.argsort(arr[:, 0], kind="stable")
            self.chroms[chrom] = (arr[order, 0],
                                  np.maximum.accumulate(arr[order, 1]))
        return self

    def overlap(self, chrom: str, beg: np.ndarray,
                end: np.ndarray) -> np.ndarray:
        """Does each [beg, end) overlap any interval of ``chrom``?"""
        got = self.chroms.get(chrom)
        if got is None:
            return np.zeros(np.shape(beg), bool)
        starts, maxends = got
        idx = np.searchsorted(starts, end, side="left")  # starts < end
        hit = idx > 0
        out = np.zeros(np.shape(beg), bool)
        out[hit] = maxends[idx[hit] - 1] > np.asarray(beg)[hit]
        return out

    def overlap_one(self, chrom: str, beg: int, end: int) -> bool:
        return bool(self.overlap(chrom, np.array([beg]), np.array([end]))[0])


def read_bed(path: str) -> BedIndex:
    """Parse a BED (3+ columns) or a 2-column "chrom pos" file (1-based
    single positions): the formats bedidx.c's bed_read accepts."""
    idx = BedIndex()
    with open(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n\r")
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) == 1:
                fields = line.split()
            if not fields or fields[0].startswith(("track", "browser", "#")):
                continue
            try:
                if len(fields) >= 3:
                    beg, end = int(fields[1]), int(fields[2])
                elif len(fields) == 2:
                    beg = int(fields[1]) - 1
                    end = beg + 1
                else:
                    continue
            except ValueError:
                continue
            beg = max(beg, 0)
            if end >= beg:
                idx.add(fields[0], beg, end)
    return idx.finalize()
