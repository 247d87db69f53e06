"""CRAM container format (read path).

Re-derivation of the CRAM 3.0/3.1 container structures from the
published CRAM specification: file definition, containers with ITF8/
LTF8 integers and landmarks, compression headers (preservation map,
data-series encodings, tag encodings), slice headers and blocks.
Counterpart of samtools_tpu/io/cram.py, copied so that the port
imports nothing of the JAX package.  Record decode
(``io/cram_decode.py``) produces the port's columnar ReadBatch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import cram_codecs as cc

CORE = -1

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5


class CramError(RuntimeError):
    pass


def itf8(data, i: int):
    b0 = data[i]
    if b0 < 0x80:
        return b0, i + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | data[i + 1], i + 2
    if b0 < 0xE0:
        return ((b0 & 0x3F) << 16) | (data[i + 1] << 8) | data[i + 2], i + 3
    if b0 < 0xF0:
        return ((b0 & 0x1F) << 24) | (data[i + 1] << 16) \
            | (data[i + 2] << 8) | data[i + 3], i + 4
    v = ((b0 & 0x0F) << 28) | (data[i + 1] << 20) | (data[i + 2] << 12) \
        | (data[i + 3] << 4) | (data[i + 4] & 0x0F)
    # sign: itf8 stores int32
    if v & 0x80000000:
        v -= 1 << 32
    return v, i + 5


def ltf8(data, i: int):
    b0 = data[i]
    n = 0
    while n < 8 and (b0 & (0x80 >> n)):
        n += 1
    v = b0 & (0xFF >> n) if n < 8 else 0
    for k in range(n):
        v = (v << 8) | data[i + 1 + k]
    if n == 8:
        v = int.from_bytes(data[i + 1:i + 9], "big")
        if v & (1 << 63):
            v -= 1 << 64
    return v, i + 1 + n


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    comp_size: int
    usize: int
    raw: bytes
    _data: bytes | None = None

    def data(self) -> bytes:
        if self._data is None:
            self._data = cc.uncompress(self.method, self.raw, self.usize)
        return self._data


@dataclass
class Container:
    length: int
    ref_seq_id: int
    ref_start: int
    ref_span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: list
    offset: int          # file offset of container payload start
    header_end: int      # offset just past container header


@dataclass
class SliceHeader:
    ref_seq_id: int
    ref_start: int
    ref_span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list
    embedded_ref_id: int
    md5: bytes


@dataclass
class Encoding:
    codec: int
    # codec-specific params
    content_id: int = -1
    stop_byte: int = 0
    alphabet: list = field(default_factory=list)
    bitlens: list = field(default_factory=list)
    sub_len: "Encoding" = None
    sub_val: "Encoding" = None
    offset: int = 0
    nbits: int = 0


@dataclass
class CompressionHeader:
    read_names_included: bool = True
    ap_delta: bool = True
    rr: bool = True
    subst_matrix: bytes = b""
    tag_dict: list = field(default_factory=list)
    data_series: dict = field(default_factory=dict)
    tag_encodings: dict = field(default_factory=dict)


def parse_file_definition(data: bytes):
    if data[:4] != b"CRAM":
        raise CramError("not a CRAM file")
    major, minor = data[4], data[5]
    return major, minor, 26


def parse_container(data: bytes, i: int, version: int):
    start = i
    length = struct.unpack_from("<i", data, i)[0]
    i += 4
    ref_seq_id, i = itf8(data, i)
    ref_start, i = itf8(data, i)
    ref_span, i = itf8(data, i)
    n_records, i = itf8(data, i)
    if version >= 3:
        record_counter, i = ltf8(data, i)
    else:
        record_counter, i = itf8(data, i)
    n_bases, i = ltf8(data, i)
    n_blocks, i = itf8(data, i)
    nl, i = itf8(data, i)
    landmarks = []
    for _ in range(nl):
        v, i = itf8(data, i)
        landmarks.append(v)
    if version >= 3:
        i += 4  # CRC32
    return Container(length, ref_seq_id, ref_start, ref_span, n_records,
                     record_counter, n_bases, n_blocks, landmarks,
                     i, i), i


def parse_block(data: bytes, i: int, version: int):
    method = data[i]
    ctype = data[i + 1]
    i += 2
    content_id, i = itf8(data, i)
    comp_size, i = itf8(data, i)
    usize, i = itf8(data, i)
    raw = bytes(data[i:i + comp_size])
    i += comp_size
    if version >= 3:
        i += 4  # CRC32
    return Block(method, ctype, content_id, comp_size, usize, raw), i


def parse_encoding(data: bytes, i: int):
    codec, i = itf8(data, i)
    plen, i = itf8(data, i)
    end = i + plen
    e = Encoding(codec)
    if codec == 1:      # EXTERNAL
        e.content_id, i = itf8(data, i)
    elif codec == 3:    # HUFFMAN
        n, i = itf8(data, i)
        for _ in range(n):
            v, i = itf8(data, i)
            e.alphabet.append(v)
        n, i = itf8(data, i)
        for _ in range(n):
            v, i = itf8(data, i)
            e.bitlens.append(v)
    elif codec == 4:    # BYTE_ARRAY_LEN
        e.sub_len, i = parse_encoding(data, i)
        e.sub_val, i = parse_encoding(data, i)
    elif codec == 5:    # BYTE_ARRAY_STOP
        e.stop_byte = data[i]
        i += 1
        e.content_id, i = itf8(data, i)
    elif codec == 6:    # BETA
        e.offset, i = itf8(data, i)
        e.nbits, i = itf8(data, i)
    elif codec == 9:    # GAMMA
        e.offset, i = itf8(data, i)
    # others: leave params unparsed
    return e, end


def parse_compression_header(data: bytes) -> CompressionHeader:
    h = CompressionHeader()
    i = 0
    # preservation map
    _sz, i = itf8(data, i)
    nmap, i = itf8(data, i)
    for _ in range(nmap):
        key = bytes(data[i:i + 2]).decode("latin-1")
        i += 2
        if key in ("RN", "AP", "RR"):
            val = data[i]
            i += 1
            if key == "RN":
                h.read_names_included = bool(val)
            elif key == "AP":
                h.ap_delta = bool(val)
            else:
                h.rr = bool(val)
        elif key == "SM":
            h.subst_matrix = bytes(data[i:i + 5])
            i += 5
        elif key == "TD":
            tdlen, i = itf8(data, i)
            td = bytes(data[i:i + tdlen])
            i += tdlen
            h.tag_dict = [[(line[k:k + 2].decode("latin-1"),
                            chr(line[k + 2]))
                           for k in range(0, len(line), 3)]
                          for line in td.split(b"\x00")[:-1]] \
                if td else [[]]
            if td == b"":
                h.tag_dict = [[]]
        else:
            raise CramError("unknown preservation key %r" % key)
    # data series encodings
    _sz, i = itf8(data, i)
    nmap, i = itf8(data, i)
    for _ in range(nmap):
        key = bytes(data[i:i + 2]).decode("latin-1")
        i += 2
        enc, i = parse_encoding(data, i)
        h.data_series[key] = enc
    # tag encodings
    _sz, i = itf8(data, i)
    nmap, i = itf8(data, i)
    for _ in range(nmap):
        key, i = itf8(data, i)
        enc, i = parse_encoding(data, i)
        h.tag_encodings[key] = enc
    return h


def parse_slice_header(data: bytes, version: int) -> SliceHeader:
    i = 0
    ref_seq_id, i = itf8(data, i)
    ref_start, i = ltf8(data, i) if version >= 4 else itf8(data, i)
    ref_span, i = itf8(data, i)
    n_records, i = itf8(data, i)
    record_counter, i = (ltf8(data, i) if version >= 3
                         else itf8(data, i))
    n_blocks, i = itf8(data, i)
    nids, i = itf8(data, i)
    content_ids = []
    for _ in range(nids):
        v, i = itf8(data, i)
        content_ids.append(v)
    embedded_ref_id, i = itf8(data, i)
    md5 = bytes(data[i:i + 16])
    return SliceHeader(ref_seq_id, ref_start, ref_span, n_records,
                       record_counter, n_blocks, content_ids,
                       embedded_ref_id, md5)


class CramReader:
    """Sequential container/block walker over a whole in-memory file."""

    def __init__(self, data: bytes):
        self.data = data
        self.major, self.minor, self.pos = parse_file_definition(data)

    def containers(self):
        """Yield (container, blocks_generator_fn) until EOF."""
        data = self.data
        n = len(data)
        while self.pos < n:
            cont, i = parse_container(data, self.pos, self.major)
            payload_end = i + cont.length
            # EOF container: ref_seq_id == -1 and n_records/blocks special
            yield cont, i
            self.pos = payload_end

    def is_eof_container(self, cont: Container) -> bool:
        return (cont.ref_seq_id == -1 and cont.ref_start == 0x454F46) or \
            (cont.ref_seq_id == -1 and cont.n_records == 0
             and cont.n_blocks == 1 and cont.ref_start == 4542278)
