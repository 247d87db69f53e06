"""BGZF blocked-gzip codec on Python's zlib (SAM spec 4.1).

Counterpart of samtools_tpu/io/bgzf.py (:35-157, :199-336).
The port's host library carries no compression code: blocks are
inflated and deflated by ``zlib`` on a thread pool (zlib releases the
GIL), giving one contiguous uncompressed buffer per call — the shape the
columnar BAM decoder wants.  ``BgzfWriter`` cuts a stream into the same
``0xFF00``-byte blocks as ``compress`` cuts one buffer, so a file written
either way has the same bytes.
"""

from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_BLOCK = 0xFF00  # BGZF payload maximum per block

_HDR = struct.Struct("<4BI2BH")  # id1,id2,cm,flg,mtime,xfl,os,xlen


class BgzfError(RuntimeError):
    pass


def _block_size(data, off: int, n: int):
    """Compressed size of the block at ``off``; None when its header is
    cut off by the end of ``data``."""
    if data[off] != 0x1F or data[off + 1] != 0x8B:
        raise BgzfError(f"bad gzip magic at offset {off}")
    xlen = int.from_bytes(data[off + 10:off + 12], "little")
    if off + 12 + xlen > n:
        return None
    extra = data[off + 12:off + 12 + xlen]
    i = 0
    while i + 4 <= len(extra):
        slen = int.from_bytes(extra[i + 2:i + 4], "little")
        if extra[i] == 66 and extra[i + 1] == 67 and slen == 2:
            return int.from_bytes(extra[i + 4:i + 6], "little") + 1
        i += 4 + slen
    raise BgzfError(f"no BC subfield at offset {off}")


def scan_blocks_partial(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(coffsets, bsizes) of every COMPLETE block in ``data``; a truncated
    trailing block is left out (streaming windows cut mid-block)."""
    coffs, bsizes = [], []
    off, n = 0, len(data)
    while off + 18 <= n:
        bsize = _block_size(data, off, n)
        if bsize is None or off + bsize > n:
            break
        coffs.append(off)
        bsizes.append(bsize)
        off += bsize
    return np.array(coffs, np.int64), np.array(bsizes, np.int64)


def scan_blocks(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(coffsets, bsizes) of every block; a truncated block is an error."""
    coffs, bsizes = scan_blocks_partial(data)
    end = int(coffs[-1] + bsizes[-1]) if coffs.size else 0
    if end != len(data):
        raise BgzfError(f"truncated BGZF block at offset {end}")
    return coffs, bsizes


def _inflate_block(data: bytes, off: int, bsize: int) -> bytes:
    xlen = int.from_bytes(data[off + 10:off + 12], "little")
    isize = int.from_bytes(data[off + bsize - 4:off + bsize], "little")
    out = zlib.decompress(data[off + 12 + xlen:off + bsize - 8], -15,
                          isize or 1)
    if len(out) != isize:
        raise BgzfError("BGZF ISIZE mismatch")
    return out


def inflate_blocks(data: bytes, coffs: np.ndarray, bsizes: np.ndarray,
                   threads: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Inflate the given blocks on ``threads`` zlib workers; returns
    (uint8 array, uoffsets[nblk+1])."""
    jobs = list(zip(coffs.tolist(), bsizes.tolist()))
    if threads > 1 and len(jobs) > 4:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(lambda t: _inflate_block(data, *t), jobs))
    else:
        parts = [_inflate_block(data, o, b) for o, b in jobs]
    uoffs = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=uoffs[1:])
    return np.frombuffer(b"".join(parts), np.uint8), uoffs


def decompress(data: bytes, threads: int = 2) -> np.ndarray:
    """Inflate a whole BGZF buffer to one uint8 array."""
    coffs, bsizes = scan_blocks(data)
    return inflate_blocks(data, coffs, bsizes, threads)[0]


def decompress_with_index(data: bytes, threads: int = 2):
    """Inflate a whole BGZF buffer; also returns the blocks' compressed
    offsets and their uncompressed offsets (``uoffs[nblk+1]``), the table
    that maps uncompressed positions to virtual offsets."""
    coffs, bsizes = scan_blocks(data)
    out, uoffs = inflate_blocks(data, coffs, bsizes, threads)
    return out, coffs, uoffs


def is_bgzf(data: bytes) -> bool:
    """True if the buffer starts with a BGZF block (gzip, FEXTRA, a BC
    subfield)."""
    if len(data) < 18 or data[0] != 0x1F or data[1] != 0x8B \
            or not data[3] & 4:
        return False
    extra = data[12:12 + int.from_bytes(data[10:12], "little")]
    i = 0
    while i + 4 <= len(extra):
        slen = int.from_bytes(extra[i + 2:i + 4], "little")
        if extra[i] == 66 and extra[i + 1] == 67 and slen == 2:
            return True
        i += 4 + slen
    return False


def is_gzip(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B


def read_file(path: str, threads: int = 2) -> bytes:
    """The uncompressed content of a BGZF, plain gzip or uncompressed
    file."""
    with open(path, "rb") as f:
        data = f.read()
    if is_bgzf(data):
        return decompress(data, threads).tobytes()
    if is_gzip(data):
        return zlib.decompress(data, 47)
    return data


def _deflate_block(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 18 + 8
    if bsize > 0x10000:
        raise BgzfError("BGZF block too large after compression")
    hdr = _HDR.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    extra = b"BC" + struct.pack("<HH", 2, bsize - 1)
    crc = zlib.crc32(chunk) & 0xFFFFFFFF
    return hdr + extra + cdata + struct.pack("<II", crc, len(chunk))


def compress(data: bytes, level: int = 6, threads: int = 2,
             append_eof: bool = True) -> bytes:
    """Compress a buffer into BGZF blocks of ``0xFF00`` bytes, plus the
    EOF marker; empty input gives the marker alone (htslib)."""
    if not data:
        return BGZF_EOF if append_eof else b""
    view = memoryview(data)
    chunks = [view[i:i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    if threads > 1 and len(chunks) > 4:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(lambda c: _deflate_block(c, level), chunks))
    else:
        parts = [_deflate_block(c, level) for c in chunks]
    if append_eof:
        parts.append(BGZF_EOF)
    return b"".join(parts)


class BgzfWriter:
    """Streaming BGZF writer: buffers up to ``0xFF00`` bytes, then
    deflates the block, on a pool of ``threads`` workers drained every 64
    blocks when ``threads`` > 1."""

    def __init__(self, fileobj: io.RawIOBase, level: int = 6,
                 threads: int = 0):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()
        self._pool = (ThreadPoolExecutor(max_workers=threads)
                      if threads > 1 else None)
        self._pending = []

    def write(self, data: bytes):
        self._buf += data
        if len(self._buf) < MAX_BLOCK:
            return
        n = len(self._buf) // MAX_BLOCK * MAX_BLOCK
        view = memoryview(self._buf)
        for i in range(0, n, MAX_BLOCK):
            self._emit(bytes(view[i:i + MAX_BLOCK]))
        view.release()
        del self._buf[:n]

    def _emit(self, chunk: bytes):
        if self._pool is None:
            self._f.write(_deflate_block(chunk, self._level))
            return
        self._pending.append(self._pool.submit(_deflate_block, chunk,
                                               self._level))
        if len(self._pending) >= 64:
            self._drain()

    def _drain(self):
        for fut in self._pending:
            self._f.write(fut.result())
        self._pending = []

    def close(self, write_eof: bool = True):
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf = bytearray()
        if self._pool is not None:
            self._drain()
            self._pool.shutdown()
            self._pool = None
        if write_eof:
            self._f.write(BGZF_EOF)


def has_eof_block(path: str) -> bool:
    """True if the file ends with the 28-byte BGZF EOF marker (what
    samtools quickcheck checks)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < 28:
                return False
            f.seek(size - 28)
            return f.read(28) == BGZF_EOF
    except OSError:
        return False
