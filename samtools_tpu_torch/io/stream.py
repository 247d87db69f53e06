"""Streaming and index-driven BAM access.

Counterpart of samtools_tpu/io/stream.py (:72-342).  ``batches`` reads
the compressed file in fixed windows, inflates the BGZF blocks of each
window, decodes its complete records and carries a partial tail record
into the next one, so memory stays O(window_bytes) for any file size.
``query`` reads only the BAI/CSI chunks of a region (htslib's sam_itr
with the linear-index lower bound): each chunk [vbeg, vend) is read and
inflated from vbeg's block through vend's, however many blocks it spans,
and exactly its records are decoded.  After each batch, the stream's
``next_record_voffset`` is the virtual offset (``coffset << 16 |
uoffset``) of the first record not yet yielded, and ``batches`` resumes
from such an offset (``mpileup --checkpoint``).  ``SAMTPU_STREAM_WINDOW``
overrides the window's byte size, as in the JAX package.
``WindowedReader`` walks one or more coordinate-sorted streams in genomic
windows (the streamed ``coverage`` and ``consensus``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core import metrics
from ..core.batch import ReadBatch
from . import bgzf, hfile, native
from .bam import BamError, decode_header, decode_records
from .header import SamHeader
from .index import BamIndex, find_index_file, load_index


class BamStream:
    """Streaming BAM reader with index queries (use as a context
    manager); a URL path is fetched once (``io/hfile.py``).  Raises
    BgzfError or BamError for a file that is not a BGZF-compressed
    BAM."""

    def __init__(self, path: str, threads: int = 2,
                 window_bytes: int = 32 << 20):
        path = hfile.resolve(path)
        self.path = path
        self.threads = threads
        env_win = os.environ.get("SAMTPU_STREAM_WINDOW")
        self.window_bytes = int(env_win) if env_win else window_bytes
        self._f = open(path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        self._index: BamIndex | None = None
        self._index_tried = False
        try:
            if not bgzf.is_bgzf(self._f.read(1 << 10)):
                raise bgzf.BgzfError(f"{path} is not BGZF-compressed")
            self.header, self._hdr_voffset = self._read_header()
        except BaseException:
            self._f.close()
            raise

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _inflate_span(self, cbeg: int, cend_hint: int):
        """Inflate the complete BGZF blocks in [cbeg, ~cend_hint); returns
        (data, uoffs, coffs, cend)."""
        self._f.seek(cbeg)
        raw = self._f.read(max(cend_hint - cbeg, 1 << 16))
        coffs, bsizes = bgzf.scan_blocks_partial(raw)
        if coffs.size == 0:
            return np.empty(0, np.uint8), np.zeros(1, np.int64), coffs, cbeg
        data, uoffs = bgzf.inflate_blocks(raw, coffs, bsizes, self.threads)
        return data, uoffs, coffs + cbeg, cbeg + int(coffs[-1] + bsizes[-1])

    def _read_header(self) -> tuple[SamHeader, int]:
        """Decode the SAM header, growing the inflated prefix as needed.
        Returns (header, virtual offset of the first record)."""
        want = 1 << 16
        while True:
            data, uoffs, coffs, cend = self._inflate_span(0, want)
            try:
                header, off = decode_header(data)
            except (IndexError, ValueError, struct.error):
                header, off = None, data.size + 1
            if header is not None and off <= data.size:
                blk = min(int(np.searchsorted(uoffs, off, "right") - 1),
                          coffs.size - 1)
                return header, (int(coffs[blk]) << 16) | (off - int(uoffs[blk]))
            if cend >= self._size:
                raise BamError("truncated BAM header")
            want *= 4

    def batches(self, fields: int = native.FIELD_ALL,
                start_voffset: int | None = None):
        """Yield ReadBatch chunks of the file in file order, from the first
        record or from the record-aligned virtual offset
        ``start_voffset``; before each yield ``next_record_voffset`` is set
        to the offset of the first record after the chunk."""
        voff = self._hdr_voffset if start_voffset is None else start_voffset
        cpos = voff >> 16
        skip = voff & 0xFFFF
        leftover = np.empty(0, np.uint8)
        self.next_record_voffset = voff
        while cpos < self._size:
            wdata, uoffs, coffs, cend = self._inflate_span(
                cpos, cpos + self.window_bytes)
            if coffs.size == 0:
                break
            data = wdata[skip:] if skip else wdata
            if leftover.size:
                data = np.concatenate([leftover, data])
            offs, consumed = native.bam_scan_partial(data, 0)
            lsize = leftover.size
            leftover = data[consumed:].copy()
            if offs.size:
                # the first byte after the consumed records, in this
                # window's inflated data
                rel = consumed - lsize + skip
                if rel >= wdata.size and uoffs.size > 1:
                    nxt = cend << 16
                else:
                    blk = int(np.searchsorted(uoffs, rel, "right") - 1)
                    blk = max(0, min(blk, coffs.size - 1))
                    nxt = (int(coffs[blk]) << 16) | int(rel - uoffs[blk])
                self.next_record_voffset = nxt
                yield _decode(data, offs, self.threads, fields)
            cpos = cend
            skip = 0
        if leftover.size:
            raise BamError("truncated BAM record at end of stream")

    def index(self) -> BamIndex | None:
        """The file's BAI/CSI (``find_index_file``), or None when there is
        none or it cannot be read."""
        if not self._index_tried:
            self._index_tried = True
            self._index = load_index(find_index_file(self.path))
        return self._index

    def query(self, tid: int, beg: int, end: int,
              fields: int = native.FIELD_ALL) -> ReadBatch | None:
        """The reads of tid that overlap [beg, end), read through the
        index; None when the file has no index (the caller scans the
        whole file)."""
        idx = self.index()
        if idx is None:
            return None
        batch = ReadBatch.concat([
            self._chunk_records(int(vb), int(ve), fields)
            for vb, ve in idx.query_chunks(tid, beg, end)])
        # the index's bins are a superset: the exact overlap filter
        keep = (batch.tid == tid) & (batch.pos < end) & (batch.end_pos() > beg)
        return batch.take(np.nonzero(keep)[0])

    def _chunk_records(self, vbeg: int, vend: int, fields: int) -> ReadBatch:
        """Decode exactly the records of the index chunk [vbeg, vend): the
        blocks from vbeg's through the one before vend's, plus vend's
        own block when vend points inside it."""
        cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        span = cend - cbeg
        self._f.seek(cbeg)
        # a BGZF block holds at most 64 KiB
        raw = self._f.read(span + ((1 << 16) if uend else 0))
        coffs, bsizes = bgzf.scan_blocks_partial(raw)
        nblk = int(np.searchsorted(coffs, span))
        whole = (int(coffs[nblk - 1] + bsizes[nblk - 1]) if nblk else 0)
        if whole != span or (uend and (nblk == coffs.size
                                       or coffs[nblk] != span)):
            raise BamError(f"index chunk {vbeg:#x}-{vend:#x} does not "
                           "match the file's BGZF blocks")
        if uend:
            nblk += 1
        data, uoffs = bgzf.inflate_blocks(raw, coffs[:nblk], bsizes[:nblk],
                                          self.threads)
        stop = int(uoffs[nblk - 1]) + uend if uend else data.size
        data = data[ubeg:stop]
        offs, consumed = native.bam_scan_partial(data, 0)
        if consumed != data.size:
            raise BamError("index chunk does not end on a record boundary")
        if not offs.size:
            return decode_records(data, offs, self.threads, fields)
        return _decode(data, offs, self.threads, fields)


def _decode(data: np.ndarray, offs: np.ndarray, threads: int,
            fields: int) -> ReadBatch:
    """decode_records of one stream window or index chunk, counted as
    the ``stream.decode`` stage."""
    with metrics.stage("stream.decode", offs.size, "reads"):
        return decode_records(data, offs, threads, fields)


class WindowedReader:
    """Genomic windows over one or more coordinate-sorted streams: yields
    (tid, wb, we, [the reads of each stream that overlap [wb, we)]), reads
    that cross a window's end carried into the next window, memory
    bounded by the window."""

    def __init__(self, streams, window_cols: int = 1 << 20,
                 filter_fn=None, fields: int = native.FIELD_ALL):
        self.streams = streams
        self.window = window_cols
        self.filter_fn = filter_fn
        self.fields = fields

    def __iter__(self):
        fns = (self.filter_fn if isinstance(self.filter_fn, list)
               else [self.filter_fn] * len(self.streams))
        cursors = [_Cursor(st, fn, self.fields)
                   for st, fn in zip(self.streams, fns)]
        while True:
            fronts = [c.front() for c in cursors]
            live = [f for f in fronts if f is not None]
            if not live:
                return
            tid = min(f[0] for f in live)
            wb = min(f[1] for f in live if f[0] == tid)
            while True:
                we = wb + self.window
                subs = [c.take(tid, wb, we) for c in cursors]
                yield tid, wb, we, subs
                if not any(c.more_on(tid) for c in cursors):
                    break
                wb = we


class _Cursor:
    """One stream's read cursor: filtered batches not yet consumed, and
    the reads carried over from the last window."""

    def __init__(self, stream, filter_fn, fields):
        self.gen = stream.batches(fields=fields)
        self.filter_fn = filter_fn
        self.pending: list = []
        self.carry = None

    def _pull(self) -> bool:
        nb = next(self.gen, None)
        if nb is None:
            return False
        if self.filter_fn is not None:
            sel = np.nonzero(self.filter_fn(nb))[0]
            if sel.size == 0:
                return True
            nb = nb.take(sel)
        if nb.n:
            self.pending.append(nb)
        return True

    def front(self):
        """(tid, pos) of the next unconsumed read, or None at the end."""
        while not self.pending:
            if not self._pull():
                return None
        b = self.pending[0]
        return int(b.tid[0]), int(b.pos[0])

    def take(self, tid: int, wb: int, we: int) -> ReadBatch:
        """The reads of [wb, we) on tid: the carried reads that end past
        wb, then the unconsumed reads with pos < we; those ending past we
        are carried into the next window."""
        parts = []
        if self.carry is not None:
            cb, ctid = self.carry
            if ctid == tid:
                parts.append(cb.take(np.nonzero(cb.end_pos() > wb)[0]))
            self.carry = None
        while True:
            fr = self.front()
            if fr is None or fr[0] > tid or (fr[0] == tid and fr[1] >= we):
                break
            b = self.pending[0]
            m = (b.tid == tid) & (b.pos < we)
            parts.append(b.take(np.nonzero(m)[0]))
            rest = np.nonzero(~m)[0]
            if rest.size:
                self.pending[0] = b.take(rest)
                break
            self.pending.pop(0)
        sub = (ReadBatch.concat(parts) if len(parts) > 1 else
               parts[0] if parts else ReadBatch())
        if sub.n:
            hal = np.nonzero(sub.end_pos() > we)[0]
            if hal.size:
                self.carry = (sub.take(hal), tid)
        return sub

    def more_on(self, tid: int) -> bool:
        if self.carry is not None and self.carry[1] == tid:
            return True
        fr = self.front()
        return fr is not None and fr[0] == tid
