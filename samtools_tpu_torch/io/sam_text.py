"""SAM text codec: parse SAM into (SamHeader, ReadBatch), format back.

Counterpart of samtools_tpu/io/sam_text.py.  A SAM without @SQ lines
takes its reference names from the records, in order of first appearance,
with length 0 (the permissive analog of ``samtools view -t``).
Formatting prints htslib's sam_format1 bytes: ``=`` for a mate on the
same contig, ``*`` placeholders, ``%g`` floats in aux fields, the nt16
sequence letters.  ``format_records`` runs the host library's batch
formatter and takes the per-record Python path, which prints the same
bytes, when the library refuses a record (malformed aux), so that the
Python path raises its errors.
"""

from __future__ import annotations

import re

import numpy as np

from ..core import aux as auxmod
from ..core.batch import ReadBatch
from ..core.flags import SEQ_NT16_STR
from .header import SamHeader

CIGAR_CHARS = "MIDNSHP=XB"

# ASCII -> nt16 code
NT16_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(SEQ_NT16_STR):
    NT16_LUT[ord(_c)] = _i
    NT16_LUT[ord(_c.lower())] = _i
NT16_LUT[ord("u")] = 8
NT16_LUT[ord("U")] = 8

NT16_CHARS = np.frombuffer(SEQ_NT16_STR.encode(), np.uint8)

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=XB])")
_CIGAR_OP_NUM = {c: i for i, c in enumerate(CIGAR_CHARS)}


class SamParseError(ValueError):
    pass


def parse_cigar(s: str) -> np.ndarray:
    """A CIGAR string as BAM's ``len << 4 | op`` words."""
    if s == "*":
        return np.empty(0, np.uint32)
    out = []
    pos = 0
    for m in _CIGAR_RE.finditer(s):
        if m.start() != pos:
            raise SamParseError(f"bad CIGAR: {s!r}")
        out.append((int(m.group(1)) << 4) | _CIGAR_OP_NUM[m.group(2)])
        pos = m.end()
    if pos != len(s):
        raise SamParseError(f"bad CIGAR: {s!r}")
    return np.array(out, np.uint32)


def cigar_to_str(cig: np.ndarray) -> str:
    if cig.size == 0:
        return "*"
    return "".join(f"{int(c) >> 4}{CIGAR_CHARS[int(c) & 0xF]}" for c in cig)


def _offsets(parts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum([len(p) for p in parts],
                                          dtype=np.int64)])


def _flat(parts, dtype) -> np.ndarray:
    return (np.concatenate(parts).astype(dtype) if parts
            else np.empty(0, dtype))


def parse_sam(text: bytes | str,
              ref_names: list[str] | None = None,
              ref_lens: list[int] | None = None
              ) -> tuple[SamHeader, ReadBatch]:
    """Parse SAM text into a header and one batch of its records."""
    if isinstance(text, bytes):
        text = text.decode("latin-1")
    header_lines, rows = [], []
    for line in text.split("\n"):
        if line:
            (header_lines if line[0] == "@" else rows).append(line)
    header_text = "\n".join(header_lines)
    if header_text:
        header_text += "\n"
    header = SamHeader.from_text(header_text, ref_names, ref_lens)
    tid_map = dict(header.name2tid())
    infer = not tid_map

    def ref_tid(name: str, what: str) -> int:
        if name not in tid_map:
            if not infer:
                raise SamParseError(f"unknown {what} {name!r}")
            tid_map[name] = len(tid_map)
        return tid_map[name]

    n = len(rows)
    tid = np.empty(n, np.int32)
    pos = np.empty(n, np.int64)
    mapq = np.empty(n, np.uint8)
    flag = np.empty(n, np.uint16)
    mtid = np.empty(n, np.int32)
    mpos = np.empty(n, np.int64)
    tlen = np.empty(n, np.int64)
    qnames, cigars, seqs, quals, auxs = [], [], [], [], []
    for i, line in enumerate(rows):
        f = line.split("\t")
        if len(f) < 11:
            raise SamParseError(f"SAM record with {len(f)} fields")
        qnames.append(f[0].encode("latin-1"))
        flag[i] = int(f[1])
        tid[i] = -1 if f[2] == "*" else ref_tid(f[2], "reference")
        pos[i] = int(f[3]) - 1
        mapq[i] = int(f[4])
        cigars.append(parse_cigar(f[5]))
        if f[6] == "*":
            mtid[i] = -1
        elif f[6] == "=":
            mtid[i] = tid[i]
        else:
            mtid[i] = ref_tid(f[6], "mate reference")
        mpos[i] = int(f[7]) - 1
        tlen[i] = int(f[8])
        seqs.append(np.empty(0, np.uint8) if f[9] == "*" else
                    NT16_LUT[np.frombuffer(f[9].encode("latin-1"),
                                           np.uint8)])
        if f[10] == "*":
            quals.append(np.full(len(seqs[-1]), 0xFF, np.uint8))
        else:
            q = np.frombuffer(f[10].encode("latin-1"), np.uint8) - 33
            if len(seqs[-1]) == 0 and len(q) > 0:
                raise SamParseError("QUAL without SEQ")
            quals.append(q.astype(np.uint8))
        if len(seqs[-1]) and len(quals[-1]) != len(seqs[-1]):
            raise SamParseError("SEQ and QUAL length mismatch")
        auxs.append(np.frombuffer(
            b"".join(auxmod.sam_field_to_aux(x) for x in f[11:]), np.uint8))

    b = ReadBatch(n=n, tid=tid, pos=pos, mapq=mapq, flag=flag, mtid=mtid,
                  mpos=mpos, tlen=tlen,
                  qname=(np.frombuffer(b"".join(qnames), np.uint8)
                         if qnames else np.empty(0, np.uint8)),
                  qname_off=_offsets(qnames),
                  cigar=_flat(cigars, np.uint32), cigar_off=_offsets(cigars),
                  seq=_flat(seqs, np.uint8), seq_off=_offsets(seqs),
                  qual=_flat(quals, np.uint8),
                  aux=_flat(auxs, np.uint8), aux_off=_offsets(auxs))
    if infer and tid_map:
        names = list(tid_map)
        header = SamHeader.from_text(header.text, names, [0] * len(names))
    return header, b


def format_record(header: SamHeader, b: ReadBatch, i: int) -> str:
    """One record as a SAM text line (no trailing newline)."""
    rname = header.ref_name(int(b.tid[i])) if b.tid[i] >= 0 else "*"
    if b.mtid[i] < 0:
        rnext = "*"
    elif b.mtid[i] == b.tid[i]:
        rnext = "="
    else:
        rnext = header.ref_name(int(b.mtid[i]))
    seq = b.seq_of(i)
    seq_s = bytes(NT16_CHARS[seq]).decode("latin-1") if seq.size else "*"
    qual = b.qual_of(i)
    if qual.size == 0 or (qual == 0xFF).all():
        qual_s = "*"
    else:
        qual_s = bytes((qual + 33).astype(np.uint8)).decode("latin-1")
    fields = [b.qname_str(i), str(int(b.flag[i])), rname,
              str(int(b.pos[i]) + 1), str(int(b.mapq[i])),
              cigar_to_str(b.cigar_of(i)), rnext, str(int(b.mpos[i]) + 1),
              str(int(b.tlen[i])), seq_s, qual_s]
    ab = b.aux_of(i)
    if ab.size:
        fields.extend(auxmod.aux_to_sam_fields(ab))
    return "\t".join(fields)


def format_records(header: SamHeader, b: ReadBatch,
                   idx: np.ndarray | None = None) -> str:
    """Records b[idx] (all by default) as SAM text, each line ending in a
    newline: the host library's formatter, or ``format_record`` when it
    finds a malformed aux field (which then raises the error)."""
    from . import native
    if b.n:
        names, names_off = header.names_blob()
        ind = (np.arange(b.n, dtype=np.int64) if idx is None
               else np.asarray(idx, np.int64))
        got = native.sam_format(b, ind, names, names_off)
        if got is not None:
            return got
    rng = range(b.n) if idx is None else [int(x) for x in idx]
    return "".join(format_record(header, b, i) + "\n" for i in rng)
