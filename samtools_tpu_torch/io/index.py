"""BAI/CSI indexes: building, reading, writing and region queries.

Counterpart of samtools_tpu/io/index.py (formats of SAM spec 5.2 and
CSIv1; samtools' bam_index.c builds them through htslib's hts_idx_*).
The index is columnar: each contig's (bin, chunk) rows are parallel
numpy arrays, so a region query is an ``isin`` and a sort, and the
builder is one vectorised pass over a whole batch's (tid, pos, end,
voffset) columns.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..core.batch import ragged_gather_indices
from . import bgzf

BAI_MAGIC = b"BAI\1"
CSI_MAGIC = b"CSI\1"
PSEUDO_BIN = 37450
MAX_BIN = 37450  # ((1<<18)-1)/7 + 1 region bins for 14-bit min_shift


@dataclass
class RefIndex:
    """Index data for one reference sequence."""
    # parallel arrays: one row per (bin, chunk)
    bin_ids: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))
    chunk_beg: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    chunk_end: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    # 16 KiB linear index of min virtual offsets
    ioffset: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    # pseudo-bin stats
    off_beg: int = 0
    off_end: int = 0
    n_mapped: int = 0
    n_unmapped: int = 0


@dataclass
class BamIndex:
    refs: list[RefIndex] = field(default_factory=list)
    n_no_coor: int = 0
    min_shift: int = 14
    depth: int = 5

    # ------------------------------------------------------------ queries
    def query_chunks(self, tid: int, beg: int, end: int) -> np.ndarray:
        """[k, 2] (voffset_beg, voffset_end) chunks possibly overlapping
        [beg, end); merged and clipped by the linear index."""
        if tid < 0 or tid >= len(self.refs):
            return np.empty((0, 2), np.uint64)
        r = self.refs[tid]
        if r.bin_ids.size == 0:
            return np.empty((0, 2), np.uint64)
        bins = reg2bins(beg, end, self.min_shift, self.depth)
        sel = np.isin(r.bin_ids, bins)
        if not sel.any():
            return np.empty((0, 2), np.uint64)
        cb = r.chunk_beg[sel]
        ce = r.chunk_end[sel]
        # linear-index lower bound
        w = beg >> self.min_shift
        if r.ioffset.size:
            min_off = r.ioffset[min(w, r.ioffset.size - 1)]
            keep = ce > min_off
            cb = np.maximum(cb[keep], min_off)
            ce = ce[keep]
        order = np.argsort(cb, kind="stable")
        cb, ce = cb[order], ce[order]
        # merge overlapping/adjacent
        out_b, out_e = [], []
        for b, e in zip(cb, ce):
            if out_e and b <= out_e[-1]:
                out_e[-1] = max(out_e[-1], e)
            else:
                out_b.append(b)
                out_e.append(e)
        return np.stack([np.array(out_b, np.uint64),
                         np.array(out_e, np.uint64)], axis=1)

    def stat(self, tid: int) -> tuple[int, int]:
        if 0 <= tid < len(self.refs):
            return self.refs[tid].n_mapped, self.refs[tid].n_unmapped
        return 0, 0


def reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> np.ndarray:
    """All bins overlapping [beg, end) (SAM spec §5.3).  Open-ended
    regions clamp to the scheme's maximum span (htslib hts_bin_bot)."""
    max_pos = 1 << (min_shift + 3 * depth)
    end = min(end, max_pos)
    beg = min(beg, max_pos - 1)
    if end <= beg:
        return np.zeros(1, np.uint32)
    end -= 1
    out = [0]
    t = 0
    s = min_shift + depth * 3
    for level in range(1, depth + 1):
        t += 1 << ((level - 1) * 3)
        s -= 3
        out.extend(range(t + (beg >> s), t + (end >> s) + 1))
    return np.array(out, np.uint32)


# --------------------------------------------------------------- building

def build_index(tid, pos, end, vstart, vend, bins, mapped, n_ref,
                    min_shift=14, depth=5) -> BamIndex:
    """Build a BamIndex from columnar record data (file order) — fully
    vectorized (no per-record loops).

    ``vstart``/``vend`` are per-record virtual offsets; ``bins`` the
    per-record reg2bin values; ``mapped`` = not FUNMAP.
    """
    idx = BamIndex(min_shift=min_shift, depth=depth)
    placed = tid >= 0
    idx.n_no_coor = int((~placed).sum())
    sel_all = np.nonzero(placed)[0]
    tids = tid[sel_all].astype(np.int64)
    for t in range(n_ref):
        r = RefIndex()
        sel = sel_all[tids == t]
        if sel.size:
            rb = bins[sel].astype(np.int64)
            vs = vstart[sel].astype(np.uint64)
            ve = vend[sel].astype(np.uint64)
            order = np.argsort(rb, kind="stable")
            rb_s, vs_s, ve_s = rb[order], vs[order], ve[order]
            new_bin = np.empty(rb_s.size, bool)
            new_bin[0] = True
            new_bin[1:] = rb_s[1:] != rb_s[:-1]
            contiguous = np.empty(rb_s.size, bool)
            contiguous[0] = False
            contiguous[1:] = (~new_bin[1:]) & (vs_s[1:] == ve_s[:-1])
            starts = np.nonzero(~contiguous)[0]
            ends = np.append(starts[1:], rb_s.size) - 1
            r.bin_ids = rb_s[starts].astype(np.uint32)
            r.chunk_beg = vs_s[starts]
            r.chunk_end = ve_s[ends]
            p = pos[sel].astype(np.int64)
            e = np.maximum(end[sel].astype(np.int64), p + 1)
            wbeg = (p >> min_shift).astype(np.int64)
            wend = ((e - 1) >> min_shift).astype(np.int64)
            nwin = int(wend.max()) + 1
            # per-window min(vstart) over the records overlapping it:
            # records overlap few windows, so expand them and take the
            # minimum per window
            spans = wend - wbeg + 1
            widx = ragged_gather_indices(wbeg, spans)
            vrep = np.repeat(vs, spans)
            ioff = np.full(nwin, np.iinfo(np.uint64).max, np.uint64)
            np.minimum.at(ioff, widx, vrep)
            unset = ioff == np.iinfo(np.uint64).max
            ioff[unset] = 0
            # forward-fill zeros with previous nonzero
            nz = np.nonzero(~unset)[0]
            if nz.size:
                fill = np.zeros(nwin, np.uint64)
                fidx = np.searchsorted(nz, np.arange(nwin), "right") - 1
                have = fidx >= 0
                fill[have] = ioff[nz[fidx[have]]]
                ioff = np.where(unset, fill, ioff)
            r.ioffset = ioff
            r.off_beg = int(vs.min())
            r.off_end = int(ve.max())
            r.n_mapped = int(mapped[sel].sum())
            r.n_unmapped = int((~mapped[sel]).sum())
        idx.refs.append(r)
    return idx


# ------------------------------------------------------------ serialization

def write_bai(path: str, idx: BamIndex) -> None:
    out = [BAI_MAGIC, struct.pack("<i", len(idx.refs))]
    for r in idx.refs:
        # group chunk rows by bin id for emission
        if r.bin_ids.size:
            uniq, starts = np.unique(r.bin_ids, return_index=True)
            # np.unique sorts; regroup chunks per bin preserving chunk order
            order = np.argsort(r.bin_ids, kind="stable")
            b_sorted = r.bin_ids[order]
            cb = r.chunk_beg[order]
            ce = r.chunk_end[order]
            bin_edges = np.nonzero(np.concatenate(
                [[True], b_sorted[1:] != b_sorted[:-1]]))[0]
            n_bin = bin_edges.size + 1  # + pseudo bin
            out.append(struct.pack("<i", n_bin))
            edges = np.append(bin_edges, b_sorted.size)
            for k in range(bin_edges.size):
                s, e = edges[k], edges[k + 1]
                out.append(struct.pack("<Ii", int(b_sorted[s]), e - s))
                pairs = np.stack([cb[s:e], ce[s:e]], axis=1).astype("<u8")
                out.append(pairs.tobytes())
            # pseudo bin
            out.append(struct.pack("<Ii", PSEUDO_BIN, 2))
            out.append(struct.pack("<QQQQ", r.off_beg, r.off_end,
                                   r.n_mapped, r.n_unmapped))
        else:
            out.append(struct.pack("<i", 0))
        out.append(struct.pack("<i", r.ioffset.size))
        out.append(r.ioffset.astype("<u8").tobytes())
    out.append(struct.pack("<Q", idx.n_no_coor))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_csi(path: str, idx: BamIndex) -> None:
    """CSI v1 writer (BGZF-compressed, as htslib writes it)."""
    depth = idx.depth
    pseudo = ((1 << (3 * depth + 3)) - 1) // 7 + 1
    out = [CSI_MAGIC, struct.pack("<iii", idx.min_shift, depth, 0),
           struct.pack("<i", len(idx.refs))]
    for r in idx.refs:
        if r.bin_ids.size:
            order = np.argsort(r.bin_ids, kind="stable")
            b_sorted = r.bin_ids[order]
            cb = r.chunk_beg[order]
            ce = r.chunk_end[order]
            bin_edges = np.nonzero(np.concatenate(
                [[True], b_sorted[1:] != b_sorted[:-1]]))[0]
            out.append(struct.pack("<i", bin_edges.size + 1))
            edges = np.append(bin_edges, b_sorted.size)
            for k in range(bin_edges.size):
                s, e = edges[k], edges[k + 1]
                # loffset: linear-index lower bound for this bin's window
                bin_id = int(b_sorted[s])
                loff = int(cb[s])
                out.append(struct.pack("<IQi", bin_id, loff, e - s))
                pairs = np.stack([cb[s:e], ce[s:e]], axis=1).astype("<u8")
                out.append(pairs.tobytes())
            out.append(struct.pack("<IQi", pseudo, 0, 2))
            out.append(struct.pack("<QQQQ", r.off_beg, r.off_end,
                                   r.n_mapped, r.n_unmapped))
        else:
            out.append(struct.pack("<i", 0))
    out.append(struct.pack("<Q", idx.n_no_coor))
    payload = bgzf.compress(b"".join(out))
    with open(path, "wb") as f:
        f.write(payload)


def read_bai(path: str) -> BamIndex:
    """Read a BAI, or a CSI (BGZF-compressed or not)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":  # CSI files are BGZF-compressed
        data = bgzf.read_file(path)
    if data[:4] == CSI_MAGIC:
        return _parse_csi(data)
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI index")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    idx = BamIndex()
    for _ in range(n_ref):
        r = RefIndex()
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins_l, cb_l, ce_l = [], [], []
        for _b in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            arr = np.frombuffer(data, "<u8", n_chunk * 2, off).reshape(-1, 2)
            off += n_chunk * 16
            if bin_id == PSEUDO_BIN:
                if n_chunk >= 2:
                    r.off_beg, r.off_end = int(arr[0, 0]), int(arr[0, 1])
                    r.n_mapped, r.n_unmapped = int(arr[1, 0]), int(arr[1, 1])
                continue
            bins_l.append(np.full(n_chunk, bin_id, np.uint32))
            cb_l.append(arr[:, 0].copy())
            ce_l.append(arr[:, 1].copy())
        if bins_l:
            r.bin_ids = np.concatenate(bins_l)
            r.chunk_beg = np.concatenate(cb_l)
            r.chunk_end = np.concatenate(ce_l)
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        r.ioffset = np.frombuffer(data, "<u8", n_intv, off).copy()
        off += n_intv * 8
        idx.refs.append(r)
    if off + 8 <= len(data):
        (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
    return idx


def _parse_csi(data: bytes) -> BamIndex:
    off = 4
    min_shift, depth, l_aux = struct.unpack_from("<iii", data, off)
    off += 12 + l_aux
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    idx = BamIndex(min_shift=min_shift, depth=depth)
    pseudo = ((1 << (3 * depth + 3)) - 1) // 7 + 1
    for _ in range(n_ref):
        r = RefIndex()
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins_l, cb_l, ce_l = [], [], []
        loffs = {}
        for _b in range(n_bin):
            bin_id, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
            off += 16
            arr = np.frombuffer(data, "<u8", n_chunk * 2, off).reshape(-1, 2)
            off += n_chunk * 16
            if bin_id == pseudo:
                if n_chunk >= 2:
                    r.off_beg, r.off_end = int(arr[0, 0]), int(arr[0, 1])
                    r.n_mapped, r.n_unmapped = int(arr[1, 0]), int(arr[1, 1])
                continue
            loffs[bin_id] = loffset
            bins_l.append(np.full(n_chunk, bin_id, np.uint32))
            cb_l.append(arr[:, 0].copy())
            ce_l.append(arr[:, 1].copy())
        if bins_l:
            r.bin_ids = np.concatenate(bins_l)
            r.chunk_beg = np.concatenate(cb_l)
            r.chunk_end = np.concatenate(ce_l)
        idx.refs.append(r)
    if off + 8 <= len(data):
        (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
    return idx


def find_index_file(bam_path: str) -> str | None:
    """The index beside a BAM: ``x.bam.bai``, ``x.bai``, ``x.bam.csi``
    or ``x.csi``, the first that exists."""
    for suffix in (".bai", ".csi"):
        for cand in (bam_path + suffix,
                     bam_path.rsplit(".", 1)[0] + suffix):
            if os.path.exists(cand):
                return cand
    return None


def load_index(path: str | None) -> BamIndex | None:
    """``read_bai(path)``, or None without a path or when the file cannot
    be read as an index."""
    if not path:
        return None
    try:
        return read_bai(path)
    except (OSError, RuntimeError, ValueError, struct.error, zlib.error):
        return None
