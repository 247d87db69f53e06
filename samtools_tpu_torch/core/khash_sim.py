"""The bucket order of an htslib khash table.

Counterpart of samtools_tpu/core/khash_sim.py.  Some samtools outputs walk
a khash table in bucket order (``cram-size -e`` prints a container's tag
encodings so, through htslib's cram_describe_encodings).  This replays
khash's inserts and resizes of int keys: the identity hash, the probe
step ``((k >> 3 ^ k << 3) | 1) & mask`` and the in-place kick-out rehash
at each resize, so the walk gives samtools' order.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF


def _inc(k: int, mask: int) -> int:
    return ((((k >> 3) ^ (k << 3)) | 1) & mask) & M32


def _roundup32(x: int) -> int:
    x -= 1
    for s in (1, 2, 4, 8, 16):
        x |= x >> s
    return x + 1


class KHash:
    """An insert-only khash set of int keys."""

    def __init__(self):
        self.n_buckets = 0
        self.size = 0
        self.upper = 0
        self.keys: list = []
        self.used: list = []

    def _resize(self, new_n: int):
        new_n = max(_roundup32(new_n), 4)
        if self.size >= int(new_n * 0.77 + 0.5):
            return
        old_n = self.n_buckets
        old_used = self.used
        mask = new_n - 1
        # the old buckets keep their keys until each is moved; a key that
        # lands on a bucket not yet moved kicks that bucket's key out
        keys = self.keys + [None] * (new_n - old_n)
        new_used = [False] * new_n
        for j in range(old_n):
            if not old_used[j]:
                continue
            key = keys[j]
            old_used[j] = False
            while True:
                k = key & M32
                i = k & mask
                inc = _inc(k, mask)
                while new_used[i]:
                    i = (i + inc) & mask
                new_used[i] = True
                if i < old_n and old_used[i]:
                    keys[i], key = key, keys[i]
                    old_used[i] = False
                else:
                    keys[i] = key
                    break
        self.keys = keys
        self.used = new_used
        self.n_buckets = new_n
        self.upper = int(new_n * 0.77 + 0.5)

    def put(self, key) -> int:
        """Insert ``key`` (a key already there stays); returns its
        bucket."""
        if self.size >= self.upper:
            if self.n_buckets > (self.size << 1):
                self._resize(self.n_buckets - 1)
            else:
                self._resize(self.n_buckets + 1)
        mask = self.n_buckets - 1
        k = key & M32
        i = k & mask
        if self.used[i] and self.keys[i] != key:
            inc = _inc(k, mask)
            while self.used[i] and self.keys[i] != key:
                i = (i + inc) & mask
        if not self.used[i]:
            self.keys[i] = key
            self.used[i] = True
            self.size += 1
        return i

    def iter_keys(self):
        """The keys in bucket order (kh_begin to kh_end)."""
        for i in range(self.n_buckets):
            if self.used[i]:
                yield self.keys[i]


def khash_order(keys) -> list:
    """The order in which a khash built by inserting ``keys`` in turn
    walks them."""
    h = KHash()
    for k in keys:
        h.put(k)
    return list(h.iter_keys())
