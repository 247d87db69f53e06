"""BGZF blocked-gzip codec on Python's zlib (SAM spec 4.1).

Counterpart of samtools_tpu/io/bgzf.py (:56-157, :199-222, :236-275).
The port's host library carries no compression code: blocks are
inflated and deflated by ``zlib`` on a thread pool (zlib releases the
GIL), giving one contiguous uncompressed buffer per call — the shape the
columnar BAM decoder wants.
"""

from __future__ import annotations

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


def read_file(path: str, threads: int = 2) -> bytes:
    """The uncompressed content of a BGZF, plain gzip or uncompressed
    file."""
    with open(path, "rb") as f:
        data = f.read()
    if is_bgzf(data):
        return decompress(data, threads).tobytes()
    if data[:2] == b"\x1f\x8b":
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


def compress(data: bytes, level: int = 6, threads: int = 2) -> bytes:
    """Compress a buffer into BGZF blocks plus the EOF marker."""
    if not data:
        return BGZF_EOF
    view = memoryview(data)
    chunks = [view[i:i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    if threads > 1 and len(chunks) > 4:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(lambda c: _deflate_block(c, level), chunks))
    else:
        parts = [_deflate_block(c, level) for c in chunks]
    parts.append(BGZF_EOF)
    return b"".join(parts)
