"""FASTA/FASTQ and their FAI index (htslib faidx.c: fai_build_core,
fai_load, fai_fetch), for ``-f ref.fa`` and for ``faidx``/``fqidx``.

Counterpart of samtools_tpu/io/fasta.py (:19-219).  A bgzipped or gzipped
file goes through the port's own ``io.bgzf``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import bgzf


@dataclass
class FaiRecord:
    name: str
    length: int
    offset: int
    linebases: int
    linewidth: int
    qualoffset: int = -1  # FASTQ only


@dataclass
class FastaIndex:
    records: dict = field(default_factory=dict)  # name -> FaiRecord
    order: list = field(default_factory=list)
    path: str = ""
    _data: bytes | None = None

    def nseq(self) -> int:
        return len(self.order)

    def has(self, name: str) -> bool:
        return name in self.records

    def length(self, name: str) -> int:
        return self.records[name].length if name in self.records else -1

    def _load_data(self) -> bytes:
        if self._data is None:
            self._data = bgzf.read_file(self.path)
        return self._data

    def _span(self, start: int, r: FaiRecord, beg: int, end: int) -> bytes:
        """The bytes of [beg, end) of the lines that start at ``start``
        (r.offset or r.qualoffset), line ends dropped."""
        data = self._load_data()
        raw = data[start + (beg // r.linebases) * r.linewidth
                   + beg % r.linebases:start
                   + ((end - 1) // r.linebases) * r.linewidth
                   + ((end - 1) % r.linebases) + 1]
        arr = np.frombuffer(raw, np.uint8)
        return arr[(arr != 0x0A) & (arr != 0x0D)][:end - beg].tobytes()

    def fetch(self, name: str, beg: int = 0, end: int | None = None) -> bytes:
        """Sequence bytes of [beg, end) (0-based), newline-free, case
        preserved (htslib faidx_fetch_seq)."""
        r = self.records.get(name)
        if r is None:
            return b""
        if end is None or end > r.length:
            end = r.length
        beg = max(0, beg)
        if beg >= end:
            return b""
        if r.linewidth == r.linebases:  # no newlines (unusual)
            data = self._load_data()
            start = r.offset + (beg // r.linebases) * r.linewidth \
                + beg % r.linebases
            return data[start:start + end - beg]
        return self._span(r.offset, r, beg, end)

    def fetch_qual(self, name: str, beg: int = 0,
                   end: int | None = None) -> bytes:
        """FASTQ quality string of [beg, end)."""
        r = self.records.get(name)
        if r is None or r.qualoffset < 0:
            return b""
        if end is None or end > r.length:
            end = r.length
        beg = max(0, beg)
        if beg >= end:
            return b""
        return self._span(r.qualoffset, r, beg, end)


def parse_fai(text: str, path: str) -> FastaIndex:
    idx = FastaIndex(path=path)
    for line in text.splitlines():
        if not line:
            continue
        f = line.split("\t")
        rec = FaiRecord(name=f[0], length=int(f[1]), offset=int(f[2]),
                        linebases=int(f[3]), linewidth=int(f[4]),
                        qualoffset=int(f[5]) if len(f) > 5 else -1)
        idx.records[rec.name] = rec
        idx.order.append(rec.name)
    return idx


def build_fai(path: str) -> FastaIndex:
    """Scan a FASTA or FASTQ and build its index (htslib fai_build_core):
    a record starts at '>' or '@', and an '@' record's quality lines
    give its ``qualoffset``."""
    data = bgzf.read_file(path)
    idx = FastaIndex(path=path, _data=data)
    n = len(data)
    i = 0
    while i < n:
        c = data[i]
        if c in (0x0A, 0x0D):
            i += 1
            continue
        if c in (ord(">"), ord("@")):
            is_fq = c == ord("@")
            # name = up to the first whitespace; skip the rest of the line
            j = i + 1
            while j < n and data[j] not in (0x20, 0x09, 0x0A, 0x0D):
                j += 1
            name = data[i + 1:j].decode("latin-1")
            while j < n and data[j] != 0x0A:
                j += 1
            j += 1
            seq_off = j
            length = linebases = linewidth = 0
            first = True
            while j < n and data[j] not in (ord(">"), ord("@"), ord("+")):
                line_start = j
                while j < n and data[j] != 0x0A:
                    j += 1
                lb = j - line_start
                if j < n and data[j - 1] == 0x0D:
                    lb -= 1
                lw = j - line_start + 1
                j += 1
                if lb == 0:
                    break
                if first:
                    linebases, linewidth = lb, lw
                    first = False
                length += lb
            qualoffset = -1
            if is_fq and j < n and data[j] == ord("+"):
                while j < n and data[j] != 0x0A:
                    j += 1
                j += 1
                qualoffset = j
                qlen = 0
                while j < n and qlen < length:
                    line_start = j
                    while j < n and data[j] != 0x0A:
                        j += 1
                    lb = j - line_start
                    if j < n and data[j - 1] == 0x0D:
                        lb -= 1
                    qlen += lb
                    j += 1
            idx.records[name] = FaiRecord(
                name=name, length=length, offset=seq_off,
                linebases=linebases or length or 1,
                linewidth=linewidth or (length + 1) or 1,
                qualoffset=qualoffset)
            idx.order.append(name)
            i = j
        else:
            i += 1
    return idx


def fai_text(idx: FastaIndex, fastq: bool = False) -> str:
    """The .fai's text: five columns a sequence, six (with the quality
    offset) for a FASTQ record or when ``fastq``."""
    out = []
    for name in idx.order:
        r = idx.records[name]
        line = f"{name}\t{r.length}\t{r.offset}\t{r.linebases}\t{r.linewidth}"
        if fastq or r.qualoffset >= 0:
            line += f"\t{r.qualoffset}"
        out.append(line)
    return "\n".join(out) + ("\n" if out else "")


def load_fasta(path: str) -> FastaIndex:
    """fai_load: ``<path>.fai`` when present, else an index built in
    memory (nothing is written)."""
    fai_path = path + ".fai"
    if os.path.exists(fai_path):
        with open(fai_path) as f:
            return parse_fai(f.read(), path)
    return build_fai(path)
