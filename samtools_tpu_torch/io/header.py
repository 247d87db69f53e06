"""SAM header model (counterpart of samtools_tpu/io/header.py, only what
``decode_header``, the simulated ``@HD``/``@SQ`` header, mpileup's sample
count and RNAME/RNEXT columns, the name lookups of ``-r`` and
``bedcov``, CRAM's read-group list, the @PG line of ``phase -b``, ``view``
and ``cat``, view's ``@CO`` line, and the sort order that ``sort``,
``collate`` and ``fixmate`` read and stamp need).

Keeps the raw header text verbatim plus the @SQ (name, length) list.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SamHeader:
    text: str = ""
    ref_names: list[str] = field(default_factory=list)
    ref_lens: list[int] = field(default_factory=list)
    _name2tid: dict | None = field(default=None, repr=False, compare=False)
    _names_blob: tuple | None = field(default=None, repr=False,
                                      compare=False)

    @classmethod
    def from_text(cls, text: str, ref_names: list[str] | None = None,
                  ref_lens: list[int] | None = None) -> "SamHeader":
        """Parse header text; a BAM binary reference list, when given, is
        authoritative (the text's @SQ lines may be absent or differ)."""
        h = cls(text=text)
        if ref_names is not None:
            h.ref_names = list(ref_names)
            h.ref_lens = list(ref_lens or [0] * len(ref_names))
            return h
        for line in text.splitlines():
            if not line.startswith("@SQ"):
                continue
            name, ln = None, 0
            for f in line.split("\t")[1:]:
                if f.startswith("SN:"):
                    name = f[3:]
                elif f.startswith("LN:"):
                    try:
                        ln = int(f[3:])
                    except ValueError:
                        ln = 0
            if name is not None:
                h.ref_names.append(name)
                h.ref_lens.append(ln)
        return h

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    def tid(self, name: str) -> int:
        """The tid of a contig name, or -1 (htslib's sam_hdr_name2tid:
        an @SQ AN alternative name resolves to its contig; primary names
        take precedence)."""
        return self.name2tid().get(name, -1)

    def name2tid(self) -> dict:
        """Contig name (or @SQ AN alternative name) -> tid."""
        if self._name2tid is None:
            m = {n: i for i, n in enumerate(self.ref_names)}
            for line in self.text.splitlines():
                if not line.startswith("@SQ"):
                    continue
                sn, alts = None, []
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        sn = f[3:]
                    elif f.startswith("AN:"):
                        alts = f[3:].split(",")
                if sn in m:
                    for a in alts:
                        m.setdefault(a, m[sn])
            self._name2tid = m
        return self._name2tid

    def names_blob(self) -> tuple[np.ndarray, np.ndarray]:
        """The contig names as one uint8 array and its int64 offsets (the
        host SAM formatter's RNAME/RNEXT table)."""
        if self._names_blob is None:
            raw = "".join(self.ref_names).encode("latin-1")
            self._names_blob = (
                np.frombuffer(raw, np.uint8),
                np.concatenate([[0], np.cumsum(
                    [len(n) for n in self.ref_names])]).astype(np.int64))
        return self._names_blob

    def ref_name(self, tid: int) -> str:
        return self.ref_names[tid] if 0 <= tid < len(self.ref_names) else "*"

    def lines(self) -> list[str]:
        return [ln for ln in self.text.split("\n") if ln]

    def find_tag_values(self, rec_type: str, tag: str) -> list[str]:
        """Every value of ``tag`` on the header's @``rec_type`` lines, in
        header order."""
        out = []
        for line in self.lines():
            if line.startswith("@" + rec_type):
                for f in line.split("\t")[1:]:
                    if f.startswith(tag + ":"):
                        out.append(f[len(tag) + 1:])
        return out

    def sort_order(self) -> str:
        """The @HD line's SO value, or "unknown"."""
        m = re.search(r"^@HD\t.*\bSO:(\S+)", self.text, re.M)
        return m.group(1) if m else "unknown"

    def with_text(self, text: str) -> "SamHeader":
        return SamHeader.from_text(text, self.ref_names or None,
                                   self.ref_lens or None)

    def ensure_hd_so(self, so: str, subsort: str | None = None) -> "SamHeader":
        """A copy whose @HD line has SO:``so`` (and SS:``subsort``), its
        other fields kept and any old SO/SS dropped; a header without @HD
        gets ``@HD VN:1.6`` first (bam_sort.c's set_sort_order)."""
        lines = self.text.split("\n")
        hd = next((i for i, line in enumerate(lines)
                   if line.startswith("@HD")), None)
        tail = [f"SO:{so}"] + ([f"SS:{subsort}"] if subsort else [])
        if hd is None:
            lines = ["\t".join(["@HD", "VN:1.6"] + tail)] + lines
        else:
            lines[hd] = "\t".join(
                [f for f in lines[hd].split("\t")
                 if not (f.startswith("SO:") or f.startswith("SS:"))]
                + tail)
        return self.with_text("\n".join(lines))

    def add_pg_line(self, id_: str, pn: str, cl: str, vn: str) -> "SamHeader":
        """A copy with a @PG line appended: its ID made unique (``id_``,
        then ``id_.1``, ...) and its PP the last existing @PG's ID."""
        existing = self.find_tag_values("PG", "ID")
        uid = id_
        k = 1
        while uid in existing:
            uid = f"{id_}.{k}"
            k += 1
        pp = existing[-1] if existing else None
        line = f"@PG\tID:{uid}\tPN:{pn}"
        if pp:
            line += f"\tPP:{pp}"
        line += f"\tVN:{vn}\tCL:{cl}"
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        return SamHeader.from_text(text + line + "\n", self.ref_names or None,
                                   self.ref_lens or None)

    def rg_ids(self) -> list[str]:
        """The ID of each @RG line, in header order (a CRAM record's RG
        series indexes this list)."""
        out = []
        for line in self.text.split("\n"):
            if line.startswith("@RG"):
                out += [f[3:] for f in line.split("\t")[1:]
                        if f.startswith("ID:")]
        return out

    def rg_to_sample(self) -> dict[str, str]:
        """RG ID -> SM map (samtools' sample.c bam_smpl_add); a read group
        without SM is its own sample."""
        out = {}
        for line in self.text.split("\n"):
            if not line.startswith("@RG"):
                continue
            rid, sm = None, None
            for f in line.split("\t")[1:]:
                if f.startswith("ID:"):
                    rid = f[3:]
                elif f.startswith("SM:"):
                    sm = f[3:]
            if rid is not None:
                out[rid] = sm if sm is not None else rid
        return out
