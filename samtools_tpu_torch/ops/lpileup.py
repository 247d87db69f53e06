"""Level pileup: tview's display row of each read.

Counterpart of samtools_tpu/ops/lpileup.py (``assign_levels`` :17), the
free-slot walk of samtools' bam_lpileup.c:103-192: in each column a read
that continues keeps its level; a new read takes the best free slot (the
lowest (cooldown, level); a recycled slot cools down for ``TV_GAP``
columns) or opens a new level.  The list's tail sentinel and its pool of
recycled nodes are kept as the C code keeps them, since a sentinel's
cooldown decides which slot a later read takes.
"""

from __future__ import annotations

import numpy as np

TV_GAP = 2


def assign_levels(pileup, n_reads: int) -> np.ndarray:
    """Walk the pileup columns and return one display level per read.

    ``pileup`` is an ``ops.pileup.Pileup`` (entries in (pos, file order),
    with its col_off column boundaries and is_head/is_tail flags).
    """
    levels = np.zeros(n_reads, np.int64)
    # free-slot list: list of [level, cnt]; "pool" recycles nodes with
    # cnt reset to TV_GAP (bam_lpileup.c:66-74); fresh nodes have cnt=0.
    free_list: list[list[int]] = []
    pool: list[list[int]] = []
    # the tail sentinel of the C list is the next node a terminating read
    # will write its level into; its cnt is whatever mp_alloc returned
    tail_cnt = 0  # first sentinel comes from calloc => cnt 0

    max_level = 0
    pre_level: list[int] = []

    ncols = len(pileup.col_pos)
    for ci in range(ncols):
        s = int(pileup.col_off[ci])
        e = int(pileup.col_off[ci + 1])
        # update cooldowns
        for node in free_list:
            if node[1] > 0:
                node[1] -= 1
        cur_level = []
        l = 0
        col_max = 0
        for idx in range(s, e):
            rid = int(pileup.rid[idx])
            if pileup.is_head[idx]:
                if free_list and free_list[0][1] == 0:
                    node = free_list.pop(0)
                    lvl = node[0]
                    node[1] = TV_GAP
                    pool.append(node)
                else:
                    max_level += 1
                    lvl = max_level
            else:
                lvl = pre_level[l]
                l += 1
                if pileup.is_tail[idx]:
                    # tail sentinel becomes a real free node with this
                    # level and its pre-existing cnt; new sentinel from
                    # the pool (cnt TV_GAP) or fresh (cnt 0)
                    free_list.append([lvl, tail_cnt])
                    if pool:
                        pool.pop()
                        tail_cnt = TV_GAP
                    else:
                        tail_cnt = 0
            cur_level.append(lvl)
            levels[rid] = lvl
            if lvl > col_max:
                col_max = lvl
        # discard free slots above the column max (recycled into the
        # pool), sort the rest by (cnt, level)
        kept = []
        for nd in free_list:
            if nd[0] > col_max:
                nd[1] = TV_GAP
                pool.append(nd)
            else:
                kept.append(nd)
        free_list = kept
        free_list.sort(key=lambda nd: (nd[1], nd[0]))
        max_level = col_max
        # levels surviving to next column (non-tail entries, in order)
        pre_level = [cur_level[i - s] for i in range(s, e)
                     if not pileup.is_tail[i]]
    return levels
