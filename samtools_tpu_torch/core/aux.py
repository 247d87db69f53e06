"""BAM aux fields (SAM spec 4.2.4; counterpart of
samtools_tpu/core/aux.py): the walk the long-CIGAR fixup, mpileup's
read-group filter, its extra tag columns, the stored BAQ tags and tview's
``-s`` filter need; the SAM text of a field (htslib's ``%g`` floats) and a
SAM text field's BAM bytes; view's tag edits (``-x``, ``--keep-tag``); and
the updaters markdup and its kin splice a Z or integer field with."""

from __future__ import annotations

import struct

import numpy as np

_FIXED = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
          ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("d"): 8}
_B_SIZES = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
            ord("i"): 4, ord("I"): 4, ord("f"): 4}
_B_FMTS = {ord("c"): "b", ord("C"): "B", ord("s"): "h", ord("S"): "H",
           ord("i"): "i", ord("I"): "I", ord("f"): "f"}
_INT_FMTS = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
             ord("i"): "<i", ord("I"): "<I"}


class AuxError(ValueError):
    pass


def skip_one(buf: np.ndarray, i: int) -> int:
    """Offset just past the aux field starting at i (at its tag)."""
    t = int(buf[i + 2])
    j = i + 3
    if t in _FIXED:
        return j + _FIXED[t]
    if t in (ord("Z"), ord("H")):
        while j < len(buf) and buf[j] != 0:
            j += 1
        return j + 1
    if t == ord("B"):
        n = int.from_bytes(bytes(buf[j + 1:j + 5]), "little")
        return j + 5 + n * _B_SIZES[buf[j]]
    raise AuxError(f"unknown aux type {chr(t)!r}")


def iter_tags(buf):
    """(tag, type char, start, end) of each aux field."""
    i = 0
    while i + 3 <= len(buf):
        end = skip_one(buf, i)
        yield chr(buf[i]) + chr(buf[i + 1]), chr(buf[i + 2]), i, end
        i = end


def find_tag(buf, tag: str):
    """(start, end) of ``tag``'s field, or None."""
    return _find(buf, tag.encode())


def _find(buf: np.ndarray, tag: bytes):
    i = 0
    while i + 3 <= len(buf):
        end = skip_one(buf, i)
        if bytes(buf[i:i + 2]) == tag:
            return i, end
        i = end
    return None


def cg_cigar(buf: np.ndarray) -> np.ndarray | None:
    """The real CIGAR held in a ``CG:B,I`` tag, or None."""
    got = _find(buf, b"CG")
    if got is None:
        return None
    i, end = got
    if buf[i + 2] != ord("B") or buf[i + 3] != ord("I"):
        return None
    return np.frombuffer(bytes(buf[i + 8:end]), "<u4").astype(np.uint32)


def delete_tag(buf: np.ndarray, tag: bytes) -> np.ndarray:
    got = _find(buf, tag)
    if got is None:
        return buf
    return np.concatenate([buf[:got[0]], buf[got[1]:]])


def _select_tags(buf: np.ndarray, tags: set[str], keep: bool) -> np.ndarray:
    parts = [buf[s:e] for tag, _t, s, e in iter_tags(buf)
             if (tag in tags) == keep]
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)


def delete_tags(buf: np.ndarray, tags: set[str]) -> np.ndarray:
    """The aux bytes without the fields whose tag is in ``tags``."""
    return _select_tags(buf, tags, False)


def keep_tags(buf: np.ndarray, tags: set[str]) -> np.ndarray:
    """The aux bytes with only the fields whose tag is in ``tags``."""
    return _select_tags(buf, tags, True)


def _update(buf: np.ndarray, tag: str, blob: bytes) -> np.ndarray:
    """``buf`` with ``tag``'s field replaced by ``blob`` where it stood, or
    ``blob`` appended (htslib's bam_aux_update_*)."""
    blob = np.frombuffer(blob, np.uint8)
    buf = np.asarray(buf, np.uint8)
    got = find_tag(buf, tag)
    if got is None:
        return np.concatenate([buf, blob])
    return np.concatenate([buf[:got[0]], blob, buf[got[1]:]])


def update_str_tag(buf: np.ndarray, tag: str, value: str) -> np.ndarray:
    """Set ``tag`` to the Z string ``value`` (bam_aux_update_str)."""
    return _update(buf, tag, tag.encode() + b"Z" + value.encode("latin-1")
                   + b"\0")


def update_int_tag(buf: np.ndarray, tag: str, value: int) -> np.ndarray:
    """Set ``tag`` to ``value`` in the smallest integer type that holds it
    (bam_aux_update_int)."""
    tc, fmt = _best_int_type(int(value))
    return _update(buf, tag, tag.encode() + tc.encode()
                   + struct.pack(fmt, int(value)))


def batch_adjust_tags(batch, keep: set[str] | None = None,
                      remove: set[str] | None = None):
    """Rewrite the batch's aux columns in place, keeping only the tags in
    ``keep`` or else dropping those in ``remove`` (view's ``-x`` and
    ``--keep-tag``, sam_view.c adjust_tags)."""
    parts = []
    new_off = np.zeros(batch.n + 1, np.int64)
    for i in range(batch.n):
        sub = batch.aux_of(i)
        if keep is not None:
            sub = keep_tags(sub, keep)
        elif remove:
            sub = delete_tags(sub, remove)
        parts.append(sub)
        new_off[i + 1] = new_off[i] + len(sub)
    batch.aux = (np.concatenate(parts).astype(np.uint8)
                 if parts else np.empty(0, np.uint8))
    batch.aux_off = new_off


def decode_value(buf: np.ndarray, i: int):
    """The value of the aux field starting at i (at its tag)."""
    b = bytes(buf[i:skip_one(buf, i)])
    t, body = b[2], b[3:]
    if t == ord("A"):
        return chr(body[0])
    if t in _INT_FMTS:
        return struct.unpack(_INT_FMTS[t], body)[0]
    if t == ord("f"):
        return struct.unpack("<f", body)[0]
    if t == ord("d"):
        return struct.unpack("<d", body)[0]
    if t in (ord("Z"), ord("H")):
        return body[:-1].decode("latin-1")
    if t == ord("B"):
        n = struct.unpack("<I", body[1:5])[0]
        return (chr(body[0]), list(struct.unpack(
            "<" + _B_FMTS[body[0]] * n, body[5:5 + n * _B_SIZES[body[0]]])))
    raise AuxError(f"unknown aux type {chr(t)!r}")


def get_value(buf: np.ndarray, tag: str):
    """(type char, decoded value) of ``tag``, or None if absent."""
    got = _find(buf, tag.encode())
    if got is None:
        return None
    return chr(buf[got[0] + 2]), decode_value(buf, got[0])


def batch_tag_values(batch, tag: str) -> np.ndarray:
    """Object array: the decoded value of ``tag`` per record (None where
    absent)."""
    out = np.empty(batch.n, object)
    for i in range(batch.n):
        got = get_value(batch.aux_of(i), tag)
        out[i] = None if got is None else got[1]
    return out


def batch_tag_str_values(batch, tag: str) -> np.ndarray:
    """Object array: ``tag``'s value per record as a string, the way
    samtools compares tag values (sam_view.c:189-208): integers by %d, A
    as its character, Z and H as the string; None where the tag is absent
    or is a float or an array (tview's ``-s`` filter)."""
    out = np.empty(batch.n, object)
    for i in range(batch.n):
        got = get_value(batch.aux_of(i), tag)
        if got is None:
            out[i] = None
            continue
        t, v = got
        if t in "cCsSiI":
            out[i] = str(v)
        elif t in "AZH":
            out[i] = v
        else:
            out[i] = None
    return out


def _fmt_float(x: float) -> str:
    """htslib renders floats with %g."""
    return "%g" % x


def field_to_sam(buf, i: int) -> str:
    """The aux field at i as SAM text ``TG:T:value`` (every integer type
    as ``i``)."""
    tag = chr(buf[i]) + chr(buf[i + 1])
    t = int(buf[i + 2])
    v = decode_value(buf, i)
    if t in _INT_FMTS:
        return f"{tag}:i:{v}"
    if t in (ord("f"), ord("d")):
        return f"{tag}:{chr(t)}:{_fmt_float(v)}"
    if t == ord("B"):
        sub, vals = v
        fmt = _fmt_float if sub == "f" else str
        return f"{tag}:B:{sub}" + "".join("," + fmt(x) for x in vals)
    return f"{tag}:{chr(t)}:{v}"


def aux_to_sam_fields(buf) -> list[str]:
    out = []
    i = 0
    while i + 3 <= len(buf):
        out.append(field_to_sam(buf, i))
        i = skip_one(buf, i)
    return out


def has_tag(buf: np.ndarray, tag: bytes) -> bool:
    return _find(buf, tag) is not None


def _best_int_type(v: int) -> tuple[str, str]:
    """The smallest BAM integer type that holds a SAM ``i`` value, as
    htslib picks it: (type char, struct format)."""
    if v >= 0:
        for tc, fmt, top in (("C", "<B", 0xFF), ("S", "<H", 0xFFFF),
                             ("I", "<I", 0xFFFFFFFF)):
            if v <= top:
                return tc, fmt
    else:
        for tc, fmt, low in (("c", "<b", -0x80), ("s", "<h", -0x8000),
                             ("i", "<i", -0x80000000)):
            if v >= low:
                return tc, fmt
    raise AuxError(f"integer aux value out of range: {v}")


def sam_field_to_aux(field: str) -> bytes:
    """One SAM text aux field (``TG:T:value``) as BAM bytes."""
    if len(field) < 5 or field[2] != ":" or field[4] != ":":
        raise AuxError(f"malformed aux field: {field!r}")
    tag = field[:2].encode("latin-1")
    t = field[3]
    val = field[5:]
    if t == "A":
        return tag + b"A" + val[:1].encode("latin-1")
    if t in "iIcCsS":
        # any integer letter: htslib stores the smallest fitting type
        tc, fmt = _best_int_type(int(val))
        return tag + tc.encode() + struct.pack(fmt, int(val))
    if t == "f":
        return tag + b"f" + struct.pack("<f", float(val))
    if t == "d":
        return tag + b"d" + struct.pack("<d", float(val))
    if t in "ZH":
        return tag + t.encode() + val.encode("latin-1") + b"\0"
    if t == "B":
        sub, *vals = val.split(",")
        if sub == "f":
            data = struct.pack("<%df" % len(vals), *[float(x) for x in vals])
        else:
            data = struct.pack("<%d%s" % (len(vals), _B_FMTS[ord(sub)]),
                               *[int(x) for x in vals])
        return tag + b"B" + sub.encode() + struct.pack("<I", len(vals)) + data
    raise AuxError(f"unknown SAM aux type {t!r}")
