"""External merge sort: a bounded-memory arena, sorted spill runs, and a
batched k-way merge.

Counterpart of samtools_tpu/io/extsort.py (:1-356); samtools'
bam_sort.c:3385-3702 reads into a ``-m`` arena and spills sorted,
numbered temporary BAMs when it overflows, and bam_merge_simple (:1849)
merges them with a heap, ties broken by file index then record index.

No heap a record: each merge round tops up one decoded batch a run,
orders the pooled rows by one stable sort over (order keys, run id,
sequence within the run), and emits the prefix that no row still on disk
can precede (every run is sorted, so the last pooled row of a run bounds
what it still holds).  Run ids ascend in input order, so the tie-break is
samtools' (file index, record index) rule and a spilled sort writes the
in-memory sort's bytes.  A spill run holds the batch's raw columns, not
BAM: the columns are what the merge reads back.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core import metrics
from ..core.batch import ReadBatch

# the columns of a spill run, in file order
_COLS = ["tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen",
         "qname", "qname_off", "cigar", "cigar_off", "seq", "seq_off",
         "qual", "aux", "aux_off"]


def write_run(fn: str, batch: ReadBatch) -> None:
    """Write one sorted spill run as length-prefixed raw arrays."""
    with open(fn, "wb") as f:
        f.write(struct.pack("<q", batch.n))
        for name in _COLS:
            arr = np.ascontiguousarray(getattr(batch, name))
            hdr = (arr.dtype.str + ":" + str(arr.size)).encode()
            f.write(struct.pack("<h", len(hdr)))
            f.write(hdr)
            arr.tofile(f)


def read_run_chunks(fn: str, rows: int = 1 << 16):
    """Yield ReadBatch chunks of a spill run via memmap row slices."""
    with open(fn, "rb") as f:
        n = struct.unpack("<q", f.read(8))[0]
        arrays = {}
        off = 8
        for name in _COLS:
            hl = struct.unpack("<h", f.read(2))[0]
            dts, size = f.read(hl).decode().split(":")
            size = int(size)
            off += 2 + hl
            dt = np.dtype(dts)
            arrays[name] = np.memmap(fn, dtype=dt, mode="r",
                                     offset=off, shape=(size,))
            off += size * dt.itemsize
            f.seek(off)
    for r0 in range(0, max(n, 1), rows):
        r1 = min(r0 + rows, n)
        if r1 <= r0:
            break
        kw = {"n": r1 - r0}
        for name in _COLS:
            a = arrays[name]
            if name.endswith("_off"):
                off_sl = np.asarray(a[r0:r1 + 1], np.int64)
                kw[name] = off_sl - off_sl[0]
            elif name in ("qname", "cigar", "seq", "qual", "aux"):
                offa = arrays[name + "_off"] if name != "qual" \
                    else arrays["seq_off"]
                lo, hi = int(offa[r0]), int(offa[r1])
                kw[name] = np.array(a[lo:hi])
            else:
                kw[name] = np.array(a[r0:r1])
        yield ReadBatch(**kw)


def batch_nbytes(b: ReadBatch) -> int:
    """Approximate decoded arena footprint of a batch."""
    return sum(getattr(b, name).nbytes for name in _COLS)


def order_batch(batch: ReadBatch, key_fn, kind: str,
                sid=None, seq=None) -> np.ndarray:
    """Stable permutation under the order keys (+ optional run-stability
    columns for the merge pool)."""
    if kind == "lex":
        keys = key_fn(batch)
        if sid is not None:
            keys = (seq, sid) + keys
        return np.lexsort(keys)
    keys = key_fn(batch)
    if sid is not None:
        idx = sorted(range(batch.n),
                     key=lambda i: (keys[i], sid[i], seq[i]))
    else:
        idx = sorted(range(batch.n), key=lambda i: keys[i])
    return (np.array(idx, np.int64) if idx else np.empty(0, np.int64))


def merge_packed_iters(iters, pack_fn):
    """Incremental k-way merge on single packed radix keys over
    per-source iterators of sorted ReadBatch chunks.

    Each source's leftover pool stays sorted and is never re-keyed:
    per round the pieces [pool_s, fresh batch_s] are concatenated in
    source order and one stable integer argsort (numpy radix for ints)
    restores the global (key, source, sequence) order — ties collapse
    into concatenation order, which IS samtools' (file index,
    record index) rule because every piece holds one source and pieces
    are concatenated by source id (bam_sort.c:227-273 heap_lt).
    Carried rows keep their packed keys, so the per-round work is one
    radix pass over the pool instead of a multi-column lexsort.

    Memory is bounded heap-style: a live source whose pooled leftover
    already exceeds a few batches' worth of rows lies sorted *ahead* of
    the merge frontier (e.g. a per-chromosome input, or a spill run
    from nearly-sorted data) and is NOT advanced again until emission
    drains its pool; the last row of its pool remains a valid lower
    bound for everything it still holds on disk.  The frontier source's
    pool drains to ~one row per round, so it always refills, which
    guarantees progress."""
    k = len(iters)
    live = [True] * k
    pools: list = [None] * k       # (batch, keys) per source, sorted
    max_batch = 1                  # largest fresh batch seen (rows)
    while True:
        pieces, keys, owners = [], [], []
        bound_at = [-1] * k        # abs row index of source s's bound
        off = 0
        cap = 4 * max_batch
        for s in range(k):
            pooled = 0
            if pools[s] is not None:
                pb, pk = pools[s]
                pieces.append(pb)
                keys.append(pk)
                owners.append(np.full(pb.n, s, np.int32))
                pools[s] = None
                off += pb.n
                bound_at[s] = off - 1
                pooled = pb.n
            if live[s] and pooled < cap:
                nb = next(iters[s], None)
                while nb is not None and nb.n == 0:
                    nb = next(iters[s], None)
                if nb is None:
                    live[s] = False
                else:
                    kb = pack_fn(nb)
                    if kb is None:
                        raise ValueError(
                            "merge: packed sort key unavailable for a "
                            "batch (tid/pos outside the packable "
                            "range; input may be corrupt)")
                    max_batch = max(max_batch, nb.n)
                    pieces.append(nb)
                    keys.append(kb)
                    owners.append(np.full(nb.n, s, np.int32))
                    off += nb.n
                    bound_at[s] = off - 1
        if not pieces:
            return
        big = (ReadBatch.concat(pieces) if len(pieces) > 1
               else pieces[0])
        key = np.concatenate(keys) if len(keys) > 1 else keys[0]
        own = np.concatenate(owners) if len(owners) > 1 else owners[0]
        order = np.argsort(key, kind="stable")
        inv = np.empty(big.n, np.int64)
        inv[order] = np.arange(big.n)
        # emit everything provably before each still-reading source's
        # largest pooled key (the last row of its last piece)
        cut = big.n
        for s in range(k):
            if live[s] and bound_at[s] >= 0:
                cut = min(cut, int(inv[bound_at[s]]))
        if cut > 0:
            yield big.take(order[:cut])
        keep = order[cut:]
        if keep.size:
            ko = own[keep]
            for s in range(k):
                rows = keep[ko == s]
                if rows.size:
                    pools[s] = (big.take(rows), key[rows])


class SpillSorter:
    """Accumulate batches under a memory budget; spill sorted runs.
    ``key_fn`` gives a batch's key columns (``kind`` "lex") or one
    sortable key a record ("py"); ``pack_fn``, when given, one uint64 a
    record, on which the runs merge."""

    def __init__(self, key_fn, kind: str, mem_bytes: int, tmpprefix: str,
                 pack_fn=None):
        self.key_fn = key_fn
        self.kind = kind
        self.pack_fn = pack_fn
        self.mem_bytes = max(mem_bytes, 1 << 16)
        self.tmpprefix = tmpprefix
        self.spills: list[str] = []
        self._acc: list[ReadBatch] = []
        self._acc_bytes = 0

    def add(self, batch: ReadBatch) -> None:
        if batch.n == 0:
            return
        nbytes = batch_nbytes(batch)
        if nbytes > self.mem_bytes and batch.n > 1:
            # one decoded window larger than the arena: slice it into
            # budget-sized row ranges (samtools reads a record at a time,
            # so its arena fills to within one record)
            parts = max(2, int(np.ceil(nbytes / self.mem_bytes)))
            rows = max(1, batch.n // parts)
            for s in range(0, batch.n, rows):
                self.add(batch.take(np.arange(
                    s, min(s + rows, batch.n), dtype=np.int64)))
            return
        self._acc.append(batch)
        self._acc_bytes += nbytes
        if self._acc_bytes >= self.mem_bytes:
            self._flush()

    def _take_acc(self) -> ReadBatch | None:
        if not self._acc:
            return None
        chunk = (ReadBatch.concat(self._acc) if len(self._acc) > 1
                 else self._acc[0])
        self._acc = []
        self._acc_bytes = 0
        return chunk

    def _flush(self) -> None:
        chunk = self._take_acc()
        if chunk is None:
            return
        run = chunk.take(order_batch(chunk, self.key_fn, self.kind))
        fn = f"{self.tmpprefix}.{len(self.spills):04d}.run"
        write_run(fn, run)
        self.spills.append(fn)

    def finish(self):
        """Returns either ("mem", sorted_batch) when everything fit, or
        ("spill", iterator_of_ordered_batches)."""
        if not self.spills:
            chunk = self._take_acc()
            if chunk is None:
                chunk = ReadBatch()
            return "mem", chunk.take(
                order_batch(chunk, self.key_fn, self.kind))
        self._flush()
        return "spill", self._merge()

    def _merge(self):
        if self.pack_fn is not None:
            return self._merge_packed()
        return self._merge_generic()

    def _merge_packed(self):
        spills = self.spills
        metrics.log(4, "sort", "merging from %d files...", len(spills))
        streams = [read_run_chunks(fn) for fn in spills]
        try:
            yield from merge_packed_iters(streams, self.pack_fn)
        finally:
            for fn in spills:
                try:
                    os.remove(fn)
                except OSError:
                    pass

    def _merge_generic(self):
        spills = self.spills
        k = len(spills)
        metrics.log(4, "sort", "merging from %d files...", k)
        streams = [read_run_chunks(fn) for fn in spills]
        live = [True] * k
        seq_next = [0] * k
        pools: list = [None] * k   # (batch, seq) per source, ordered
        max_batch = 1
        try:
            while True:
                parts, sids, seqs = [], [], []
                bound_at = [-1] * k
                off = 0
                cap = 4 * max_batch
                for s in range(k):
                    pooled = 0
                    if pools[s] is not None:
                        pb, pq = pools[s]
                        parts.append(pb)
                        sids.append(np.full(pb.n, s, np.int64))
                        seqs.append(pq)
                        pools[s] = None
                        off += pb.n
                        bound_at[s] = off - 1
                        pooled = pb.n
                    if live[s] and pooled < cap:
                        nb = next(streams[s], None)
                        while nb is not None and nb.n == 0:
                            nb = next(streams[s], None)
                        if nb is None:
                            live[s] = False
                        else:
                            max_batch = max(max_batch, nb.n)
                            parts.append(nb)
                            sids.append(np.full(nb.n, s, np.int64))
                            seqs.append(np.arange(
                                seq_next[s], seq_next[s] + nb.n,
                                dtype=np.int64))
                            seq_next[s] += nb.n
                            off += nb.n
                            bound_at[s] = off - 1
                if not parts:
                    break
                big = (ReadBatch.concat(parts) if len(parts) > 1
                       else parts[0])
                sid = np.concatenate(sids)
                seq = np.concatenate(seqs)
                order = order_batch(big, self.key_fn, self.kind, sid, seq)
                inv = np.empty(big.n, np.int64)
                inv[order] = np.arange(big.n)
                cut = big.n
                for s in range(k):
                    if live[s] and bound_at[s] >= 0:
                        cut = min(cut, int(inv[bound_at[s]]))
                if cut > 0:
                    yield big.take(order[:cut])
                keep = order[cut:]
                if keep.size:
                    ks = sid[keep]
                    for s in range(k):
                        rows = keep[ks == s]
                        if rows.size:
                            pools[s] = (big.take(rows), seq[rows])
        finally:
            for fn in spills:
                try:
                    os.remove(fn)
                except OSError:
                    pass
