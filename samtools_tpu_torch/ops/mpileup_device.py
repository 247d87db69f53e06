"""Streamed mpileup core on the card: BAQ + base census.

Counterpart of samtools_tpu/ops/mpileup_device.py (its census path):

  BamStream batch -> columnar decode (C++) -> classify reads -> one packed
  host->device buffer per chunk -> buffer parse, cigar expansion and
  ref-window gather (K6's front, ``chunk_expand``), banded pair-HMM BAQ
  (K4), finalize (K5) -> census contraction (K1's
  census form: quality and ownership gate, one-hot and qual lane built
  in its load step) added in place into a resident int32 [pad_len, 6]
  census -> ONE device->host fetch at the end, narrowed on the card to
  the smallest lossless types first (K7n, ``census_narrow``).

Reads the device path cannot take (N/B cigar ops, more than MAXOPS ops,
indels past the band, contig-edge windows, 0xFF qual sentinels) and the
reads the f32 HMM flags ``risky`` go through the f64 host HMM and a host
census, merged at the end; the census equals the single-core f64 oracle
(``io.native.bench_baq_census``) exactly.

Two consumers (as in the JAX package):

* ``add_batch`` -- the census core: BAQ'd quals never leave the device;
  only the risky flags and the final census do.
* ``begin_window``/``finish_window``/``apply_window`` -- the mpileup
  tool's engine: the text must print the BAQ'd quals, so each chunk also
  compacts the quals BAQ changed into a fixed-capacity sparse list
  (count, flat index, value) on the device, without a host sync (K6's
  tail, ``qual_deltas``), and the host fetches those and writes them
  into the window's reads; the census of the window's owned columns
  rides along for ``--census-out`` as its two-lane checksum (K7,
  ``census_checksum_dev``).
"""

from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch

from .. import kernels
from ..core import flags as F
from ..core.aux import has_tag
from ..core.batch import ragged_gather_indices
from ..device import h2d, resolve
from ..io import native
from .baq_device import baq_finalize, baq_hmm
from .pileup_engine import padded_tiles, tile_plan
from .segment_kernel import CENSUS_K, segment_census

DEFAULT_EXCL = F.FUNMAP | F.FSECONDARY | F.FQCFAIL | F.FDUP

# nt16 -> 0-4 code (A,C,G,T,other)
NT16_TO4 = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                    np.uint8)
_NT16_OF4 = np.array([1, 2, 4, 8, 15], np.uint8)

MAXOPS = 8         # cigar ops shipped per read (beyond -> host)
LREF_PAD = 8       # l_ref_max = l_query + LREF_PAD (|lref-LQ| <= bw=7)
HDR = 48           # per-read buffer header bytes (pos|lead|lref|bM|bI|cig8)
_BIGC = 1 << 20    # expected-diagonal sentinel for non-M bases
NATIVE_CLASSIFY_MIN = 4096   # reads from which classify_reads goes native
HOST_THREADS = max(1, min(8, os.cpu_count() or 1))
_DUMP = 1024       # dump slots behind the sparse qual-delta list


def classify_reads_np(b, sel: np.ndarray, l_query: int, ref_len: int,
                      bw: int = 7):
    """Vectorized device eligibility + per-read HMM window parameters
    (baq_one's alignment-extent walk over a padded [n, MAXOPS] cigar
    matrix).  Returns (elig bool[n], lead int64[n], lref int64[n],
    cig8 uint32[n, MAXOPS]); lead/lref are valid only where elig."""
    n = sel.size
    if n == 0:
        z = np.zeros(0, np.int64)
        return (np.zeros(0, bool), z, z, np.zeros((0, MAXOPS), np.uint32))
    nc = b.cigar_off[sel + 1] - b.cigar_off[sel]
    lq = b.seq_off[sel + 1] - b.seq_off[sel]
    pos = b.pos[sel].astype(np.int64)
    elig = (nc >= 1) & (nc <= MAXOPS) & (lq == l_query) & (pos >= 0) \
        & (pos + l_query + 16 < (1 << 31))
    valid = np.arange(MAXOPS)[None, :] < nc[:, None]
    idx = b.cigar_off[sel][:, None] + np.arange(MAXOPS)[None, :]
    idx = np.where(valid, idx, 0)
    cig8 = np.where(valid, b.cigar[np.minimum(idx, b.cigar.size - 1)],
                    np.uint32(0))
    ops = (cig8 & 0xF).astype(np.int64)
    ln = np.where(valid, (cig8 >> 4).astype(np.int64), 0)
    # allowed op set: M I D S H P =/X (N=3 and B=9 route to the host)
    allowed = (ops != 3) & (ops <= 8)
    elig &= np.where(valid, allowed, True).all(1)
    is_m = ((ops == 0) | (ops == 7) | (ops == 8)) & valid & (ln > 0)
    consq = is_m | (((ops == 1) | (ops == 4)) & valid)
    consr = is_m | ((ops == 2) & valid)
    qlen = ln * consq
    rlen = ln * consr
    qstart = np.cumsum(qlen, 1) - qlen
    rstart = np.cumsum(rlen, 1) - rlen
    elig &= is_m.any(1)
    fm = np.argmax(is_m, 1)
    lm = MAXOPS - 1 - np.argmax(is_m[:, ::-1], 1)
    r_ = np.arange(n)
    yb = qstart[r_, fm]
    xbM = pos + rstart[r_, fm]
    ye = qstart[r_, lm] + ln[r_, lm]
    xeM = pos + rstart[r_, lm] + ln[r_, lm]
    # htslib widens the band when the M-extent spans differ by more than
    # bw, or |l_ref - l_query| exceeds it: both must stay at bw here
    elig &= np.abs((xeM - xbM) - (ye - yb)) <= bw
    lead = np.minimum(yb, xbM)
    xb = xbM - lead
    xe = xeM + (l_query - ye) + bw // 2
    lref = xe - xb
    elig &= (xe <= ref_len) & (xb >= 0) & (np.abs(lref - l_query) <= bw)
    # qual[0] == 0xFF sentinel -> host
    if b.seq_off[-1]:
        elig &= b.qual[np.minimum(b.seq_off[sel],
                                  b.seq_off[-1] - 1)] != 0xFF
    return elig, lead, lref, cig8


def classify_reads(b, sel: np.ndarray, l_query: int, ref_len: int,
                   bw: int = 7):
    """``classify_reads_np`` semantics; large selections take the
    thread-parallel host-library walk."""
    if sel.size >= NATIVE_CLASSIFY_MIN:
        return native.classify_reads(
            b.pos, b.cigar, b.cigar_off, b.seq_off, b.qual, sel, l_query,
            ref_len, bw, MAXOPS, threads=HOST_THREADS)
    return classify_reads_np(b, sel, l_query, ref_len, bw)


def seq4_to_nt16(seq4: np.ndarray) -> np.ndarray:
    return _NT16_OF4[seq4]


def _expand_m_events(pos, cigar, cigar_off, seq_off):
    """(absolute refpos int64[nev], flat seq index int64[nev]) of every
    M/=/X base over ragged cigars."""
    ops = (cigar & 0xF).astype(np.int64)
    lens = (cigar >> 4).astype(np.int64)
    rid_op = np.repeat(np.arange(cigar_off.size - 1), np.diff(cigar_off))
    rl = lens * np.array(F.CIGAR_CONSUMES_REF, np.int64)[ops]
    ql = lens * np.array(F.CIGAR_CONSUMES_QUERY, np.int64)[ops]
    cr = np.concatenate([[0], np.cumsum(rl)[:-1]])
    cq = np.concatenate([[0], np.cumsum(ql)[:-1]])
    op_rpos = pos[rid_op] + (cr - cr[cigar_off[:-1]][rid_op])
    op_qpos = cq - cq[cigar_off[:-1]][rid_op]
    m = (ops == F.CMATCH) | (ops == F.CEQUAL) | (ops == F.CDIFF)
    mlens = lens[m]
    rp = ragged_gather_indices(op_rpos[m], mlens)
    qp = ragged_gather_indices(op_qpos[m], mlens)
    return rp, seq_off[np.repeat(rid_op[m], mlens)] + qp


def _host_census(census, qsum, pos, cigar, cigar_off, seq4, qual, seq_off,
                 ref_int, min_baseq, baq_flag, base=0, threads=2,
                 gate_lo=0, gate_hi=None, newq=None):
    """Host path: f64 BAQ (host library) + census accumulate for the reads
    the device path routes away; any cigar.  ``census``/``qsum`` are
    indexed relative to ``base``; bases outside [gate_lo, gate_hi)
    (relative) belong to another window.  ``newq``: quals already BAQ'd."""
    if pos.size == 0:
        return
    if newq is None and baq_flag:
        newq, _ = native.baq_batch(pos, cigar, cigar_off,
                                   seq4_to_nt16(seq4), qual, seq_off,
                                   ref_int, flag=baq_flag, threads=threads)
    elif newq is None:
        newq = qual
    rp, qoff = _expand_m_events(pos, cigar, cigar_off, seq_off)
    rp = rp - base
    q = newq[qoff]
    hi = qsum.size if gate_hi is None else min(gate_hi, qsum.size)
    ok = (q >= min_baseq) & (rp >= max(gate_lo, 0)) & (rp < hi)
    rp, qoff, q = rp[ok], qoff[ok], q[ok]
    np.add.at(census, (rp, seq4[qoff].astype(np.int64)), 1)
    np.add.at(qsum, rp, q.astype(np.int64))


def stored_baq_tags(b, rows: np.ndarray | None = None) -> bool:
    """Does any read of ``b`` (or of its ``rows``) carry a BQ or ZQ tag?
    A byte search over the aux column first; only a hit walks the tags."""
    raw = b.aux.tobytes()
    if b"BQZ" not in raw and b"ZQZ" not in raw:
        return False
    return any(has_tag(b.aux_of(i), b"BQ") or has_tag(b.aux_of(i), b"ZQ")
               for i in (range(b.n) if rows is None else rows.tolist()))


def qual_deltas_plain(appq: torch.Tensor, qq: torch.Tensor, cap: int):
    """The quals BAQ changed, compacted on the device without a host
    sync: (dcount int32 scalar, didx int32[cap] flat index into [C, LQ],
    dval uint8[cap] new qual), in flat order.  Past dcount, didx is 0
    and dval its qual; when dcount exceeds ``cap``, the list holds the
    first ``cap``.  Each changed qual's slot is its rank (a cumsum);
    unchanged quals and those past the capacity are scattered into a dump
    region behind the list, spread so no one address takes them all."""
    flat = (appq != qq).reshape(-1)
    n = flat.numel()
    rank = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    ar = torch.arange(n, dtype=torch.int32, device=flat.device)
    slot = torch.where(flat & (rank < cap), rank, cap + (ar & (_DUMP - 1)))
    didx = torch.zeros(cap + _DUMP, dtype=torch.int32, device=flat.device)
    didx.scatter_(0, slot.long(), ar)
    didx = didx[:cap]
    return rank[-1] + 1, didx, appq.reshape(-1)[didx.long()]


# the qual-delta kernel's tile (csrc/qual_deltas.cu): flat quals a block
DELTA_TILE = 8192


def deltas_plan(n: int) -> int:
    """Blocks of both grids of the qual-delta kernel over ``n`` flat
    quals: one a tile of DELTA_TILE."""
    return -(-n // DELTA_TILE)


def qual_deltas(appq: torch.Tensor, qq: torch.Tensor, cap: int):
    """K6's tail: ``qual_deltas_plain``'s (dcount, didx, dval) of the
    applied quals ``appq`` against the read's ``qq`` (uint8 [C, LQ]), at
    capacity ``cap``.  CPU tensors take the plain version; CUDA tensors
    launch csrc/qual_deltas.cu (two grids behind one entry: the changed
    count a tile, then each tile's changes written at their ranks), with
    no host sync."""
    kernels.check(appq, "appq", torch.uint8, (None, None))
    kernels.check(qq, "qq", torch.uint8, tuple(appq.shape))
    n = appq.numel()
    if not 0 < n < (1 << 31):
        raise ValueError(f"qual_deltas takes 1 to 2^31 - 1 quals, got {n}")
    if not 0 <= cap < (1 << 31):
        raise ValueError(f"cap {cap} out of range")
    if not kernels.on_card(appq, qq):
        return qual_deltas_plain(appq, qq, cap)
    if appq.data_ptr() % 16 or qq.data_ptr() % 16:
        raise ValueError("qual_deltas needs 16-byte aligned quals")
    dev = appq.device
    blocks = deltas_plan(n)
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    dcount = torch.empty((), dtype=torch.int32, device=dev)
    didx = torch.empty(cap, dtype=torch.int32, device=dev)
    dval = torch.empty(cap, dtype=torch.uint8, device=dev)
    kernels.launch("qual_deltas", "samtpu_qual_deltas", appq.data_ptr(),
                   qq.data_ptr(), n, cap, blocks, counts.data_ptr(),
                   dcount.data_ptr(), didx.data_ptr(), dval.data_ptr(),
                   kernels.stream_of(appq), device=dev)
    return dcount, didx, dval


def census_checksum(census: np.ndarray, qsum: np.ndarray):
    """Order-independent weighted checksum of (census, qsum): two uint32
    lanes, wrapping mod 2^32; equal to
    ``DeviceCensusPipeline.finish_checksum``'s."""
    if qsum.size >= 4096:
        return native.census_checksum(census, qsum)
    c = np.ascontiguousarray(census, np.int64).astype(np.uint32).ravel()
    q = np.ascontiguousarray(qsum, np.int64).astype(np.uint32).ravel()
    v = np.concatenate([c, q])
    idx = np.arange(v.size, dtype=np.uint32)
    with np.errstate(over="ignore"):
        w1 = idx * np.uint32(2654435761)
        w2 = (idx + np.uint32(0x9E3779B9)) * np.uint32(40503)
        s1 = int((v * w1).sum(dtype=np.uint64) & 0xFFFFFFFF)
        s2 = int((v * w2).sum(dtype=np.uint64) & 0xFFFFFFFF)
    return s1, s2


_M32 = 0xFFFFFFFF


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32):
    b is split into 16-bit halves so no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def census_checksum_plain(census_dev: torch.Tensor, wlen: int):
    """K7's plain version: ``census_checksum`` of rows [0, wlen) of the
    resident [pad_len, 6] census, in int64 tensor ops on its device."""
    c = census_dev[:wlen]
    v = torch.cat([c[:, :5].reshape(-1), c[:, 5]]).to(torch.int64) & _M32
    idx = torch.arange(v.numel(), dtype=torch.int64, device=v.device)
    w1 = _mulmod32(idx, torch.full_like(idx, 2654435761))
    w2 = _mulmod32((idx + 0x9E3779B9) & _M32, torch.full_like(idx, 40503))
    s1 = int(_mulmod32(v, w1).sum()) & _M32
    s2 = int(_mulmod32(v, w2).sum()) & _M32
    return s1, s2


# K7's grid (csrc/census_checksum.cu): threads a block, blocks an SM at most
CHECKSUM_THREADS = 256
CHECKSUM_BLOCKS_PER_SM = 4


def checksum_plan(wlen: int, sms: int) -> int:
    """K7's blocks for rows [0, wlen) on a card of ``sms`` SMs: enough
    for a 16-byte vector (4 words) a thread, at most
    CHECKSUM_BLOCKS_PER_SM an SM (a grid-stride loop takes the rest)."""
    vectors = -(-6 * wlen // 4)
    return max(1, min(-(-vectors // CHECKSUM_THREADS),
                      CHECKSUM_BLOCKS_PER_SM * sms))


def census_checksum_dev(census_dev: torch.Tensor, wlen: int):
    """K7: ``census_checksum`` of rows [0, wlen) of the resident
    [pad_len, 6] census, computed on its device (the counterpart of the
    JAX package's ``_ck_jit``).  A CPU tensor takes the plain version; a
    CUDA tensor launches csrc/census_checksum.cu into a zeroed 2-word
    output, fetched once."""
    kernels.check(census_dev, "census", torch.int32, (None, CENSUS_K))
    if not 0 <= wlen <= census_dev.shape[0]:
        raise ValueError(f"wlen {wlen} outside the census's "
                         f"{census_dev.shape[0]} rows")
    if 6 * wlen >= (1 << 32):
        raise ValueError(f"wlen {wlen}: the checksum's index is 32-bit")
    if not kernels.on_card(census_dev):
        return census_checksum_plain(census_dev, wlen)
    if census_dev.data_ptr() % 16:
        raise ValueError("census: K7 needs a 16-byte aligned census")
    if wlen == 0:
        return 0, 0
    dev = census_dev.device
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    kernels.launch("census_checksum", "samtpu_census_checksum",
                   census_dev.data_ptr(), wlen,
                   checksum_plan(wlen, kernels.sm_count(dev)),
                   out.data_ptr(), kernels.stream_of(census_dev),
                   device=dev)
    s1, s2 = out.tolist()
    return s1 & _M32, s2 & _M32


def narrow_types(cmax: int, qmax: int) -> tuple[torch.dtype, torch.dtype]:
    """The smallest lossless types of the fetched counts and qual sums
    (the JAX package's thresholds, samtools_tpu/ops/mpileup_device.py:
    868-870)."""
    cdt = (torch.uint8 if cmax < 256 else
           torch.uint16 if cmax < 65536 else torch.int32)
    qdt = torch.uint16 if qmax < 65536 else torch.int32
    return cdt, qdt


def _narrow_offsets(wlen: int, cdt: torch.dtype,
                    qdt: torch.dtype) -> tuple[int, int]:
    """(byte offset of the qual sums, total bytes) of a narrowed fetch:
    counts [wlen, 5] first, the qual sums at the next 4-byte boundary."""
    q_off = (wlen * 5 * cdt.itemsize + 3) & ~3
    return q_off, q_off + wlen * qdt.itemsize


def narrow_split(buf, wlen: int, cdt: torch.dtype, qdt: torch.dtype):
    """(counts [wlen, 5], qual sums [wlen]) of a narrowed fetch's bytes
    (a tensor, or a numpy array of the host copy), as views."""
    q_off, end = _narrow_offsets(wlen, cdt, qdt)
    if isinstance(buf, np.ndarray):
        cn = torch.empty(0, dtype=cdt).numpy().dtype
        qn = torch.empty(0, dtype=qdt).numpy().dtype
        return (buf[:wlen * 5 * cdt.itemsize].view(cn).reshape(wlen, 5),
                buf[q_off:end].view(qn))
    return (buf[:wlen * 5 * cdt.itemsize].view(cdt).reshape(wlen, 5),
            buf[q_off:end].view(qdt))


def census_narrow_plain(census: torch.Tensor, wlen: int):
    """K7n's plain version: rows [0, wlen) of the int32 [pad_len, 6]
    census narrowed by their maxima (``amax``, then ``.to``), as one byte
    buffer; returns (buffer, counts type, qual-sum type)."""
    c = census[:wlen]
    cmax = int(c[:, :5].amax()) if wlen else 0
    qmax = int(c[:, 5].amax()) if wlen else 0
    cdt, qdt = narrow_types(cmax, qmax)
    q_off, end = _narrow_offsets(wlen, cdt, qdt)
    buf = torch.zeros(end, dtype=torch.uint8, device=census.device)
    counts, qsum = narrow_split(buf, wlen, cdt, qdt)
    counts.copy_(c[:, :5].to(cdt))
    qsum.copy_(c[:, 5].to(qdt))
    return buf, cdt, qdt


# K7n's launch plan (csrc/census_narrow.cu): a block an SM, each a run of
# rows that starts at a multiple of ROW_GRAIN
ROW_GRAIN = 16
ROW_BYTES = 24


@functools.lru_cache(maxsize=64)
def narrow_plan(wlen: int, sms: int, smem: int,
                ring: int) -> tuple[int, int, int]:
    """K7n's plan for rows [0, wlen) on a card of ``sms`` SMs whose
    blocks may take ``smem`` bytes of dynamic shared memory: (blocks,
    rows a block, rows a block stages in shared memory).  Block b takes
    rows [b * rows, min((b + 1) * rows, wlen)); rows and staged rows are
    multiples of ROW_GRAIN, every block has rows, at most one a SM.  A
    block that cannot stage all its rows keeps a ring of ``ring`` bytes
    of tiles behind the staged ones for the rest.  All zero for no
    rows."""
    if wlen <= 0:
        return 0, 0, 0
    grains = -(-wlen // ROW_GRAIN)
    rows = -(-grains // min(sms, grains)) * ROW_GRAIN
    if rows * ROW_BYTES > smem:
        staged = max(0, smem - ring) // ROW_BYTES // ROW_GRAIN * ROW_GRAIN
    else:
        staged = rows
    return -(-wlen // rows), rows, staged


_NARROW: dict = {}
_NARROW_HOST: dict = {}
_NARROW_LOCK = threading.Lock()


def _narrow_limits(device: torch.device) -> tuple[int, int, int]:
    """(SM count, dynamic shared memory a block, bytes of the phase-2
    ring) of ``device``, found once: ``narrow_plan``'s inputs."""
    got = _NARROW.get(device.index)
    if got is None:
        got = _NARROW[device.index] = kernels.query(
            "samtpu_census_narrow_limits", 3, device)
    return got


def _narrow_host(device: torch.device, stream: int):
    """(a pinned int32[2] for the maxima, a lock) of K7n's launches on
    ``stream`` of ``device``, made once: a call holds the lock from its
    launch to its read of the maxima, so calls from two threads on one
    stream each read their own."""
    key = (device.index, stream)
    got = _NARROW_HOST.get(key)
    if got is None:
        with _NARROW_LOCK:
            got = _NARROW_HOST.setdefault(key, (
                torch.empty(2, dtype=torch.int32, pin_memory=True),
                threading.Lock()))
    return got


def census_narrow(census: torch.Tensor, wlen: int):
    """K7n: ``census_narrow_plain``'s result, on the card by one
    cooperative kernel launch (csrc/census_narrow.cu: the maxima and the
    cast around a grid-wide barrier, the types chosen on the card) into a
    buffer of the worst case's size; the kernel writes the maxima into a
    pinned int32[2] kept for the stream, which the host reads after one
    stream sync.  The buffer returned is the ``[:end]`` view of the
    narrowed bytes.  A CPU tensor takes the plain version."""
    kernels.check(census, "census", torch.int32, (None, CENSUS_K))
    if wlen > census.shape[0]:
        raise ValueError(f"wlen {wlen} exceeds the census's "
                         f"{census.shape[0]} rows")
    if not kernels.on_card(census):
        return census_narrow_plain(census, wlen)
    if census.data_ptr() % 16:
        raise ValueError("census: K7n needs a 16-byte aligned census")
    if wlen <= 0:
        return (torch.empty(0, dtype=torch.uint8, device=census.device),
                *narrow_types(0, 0))
    stream = torch.cuda.current_stream(census.device)
    maxima, lock = _narrow_host(census.device, stream.cuda_stream)
    buf = torch.empty(wlen * ROW_BYTES + 16, dtype=torch.uint8,
                      device=census.device)
    with lock:
        kernels.launch("census_narrow", "samtpu_census_narrow",
                       census.data_ptr(), wlen,
                       *narrow_plan(wlen, *_narrow_limits(census.device)),
                       buf.data_ptr(),
                       kernels.scratch("census_narrow", census.device,
                                       stream.cuda_stream, 3).data_ptr(),
                       maxima.data_ptr(), stream.cuda_stream,
                       device=census.device)
        stream.synchronize()
        cdt, qdt = narrow_types(*maxima.tolist())
    return buf[:_narrow_offsets(wlen, cdt, qdt)[1]], cdt, qdt


def chunk_expand_plain(buf: torch.Tensor, ref_dev: torch.Tensor,
                       nt16_to4: torch.Tensor, l_query: int) -> dict:
    """Parse one chunk's device buffer and expand its cigars.  Returns
    device tensors: the HMM inputs (ref_win, sq, qq, cdT, lref, bMv,
    bIv), the M-op ordinal of each base (seg, -1 off M) and each
    base's absolute reference position (refpos, valid on M bases)."""
    LQ = l_query
    LRM = LQ + LREF_PAD
    dev = buf.device
    i32 = torch.int32
    # a copy with its own row stride: a one-read chunk's slice counts as
    # contiguous and would keep the buffer's stride, which is not a
    # multiple of 4 for an odd l_query
    hdr = buf[:, :HDR].clone(memory_format=torch.contiguous_format)
    pc = hdr[:, 0:4].view(i32)[:, 0]
    lead = hdr[:, 4:6].view(torch.int16)[:, 0].to(i32) & 0xFFFF
    lref = (hdr[:, 6:8].view(torch.int16)[:, 0].to(i32) & 0xFFFF) \
        .contiguous()
    cig = hdr[:, 16:HDR].view(i32)

    # cigar expansion (consensus_pileup.c:81 walk): per base, whether
    # it is an M base, its expected diagonal and its M-op ordinal
    ops = cig & 0xF
    ln = (cig >> 4) & 0x0FFFFFFF
    is_m_op = (ops == 0) | (ops == 7) | (ops == 8)
    qlen = ln * (is_m_op | (ops == 1) | (ops == 4))
    rlen = ln * (is_m_op | (ops == 2))
    qstart = torch.cumsum(qlen, 1, dtype=i32) - qlen
    rstart = torch.cumsum(rlen, 1, dtype=i32) - rlen
    qi = torch.arange(LQ, dtype=i32, device=dev)
    inm = (is_m_op[:, :, None] & (qi >= qstart[:, :, None])
           & (qi < (qstart + qlen)[:, :, None]))          # [C, 8, LQ]
    is_m = inm.any(1)
    cd_op = rstart - qstart + lead[:, None]
    cdelta = (inm * cd_op[:, :, None]).sum(1, dtype=i32)
    opid = torch.arange(MAXOPS, dtype=i32, device=dev)
    segid = (inm * opid[None, :, None]).sum(1, dtype=i32)

    xb = pc - lead
    idx = xb[:, None] + torch.arange(LRM, dtype=i32, device=dev)
    return dict(
        ref_win=ref_dev[idx.clamp(0, ref_dev.numel() - 1).long()],
        sq=nt16_to4[buf[:, HDR:HDR + LQ].long()],
        qq=buf[:, HDR + LQ:HDR + 2 * LQ].contiguous(),
        cdT=torch.where(is_m, cdelta, _BIGC).t().contiguous(),
        lref=lref,
        bMv=hdr[:, 8:12].view(torch.float32)[:, 0].contiguous(),
        bIv=hdr[:, 12:16].view(torch.float32)[:, 0].contiguous(),
        seg=torch.where(is_m, segid, -1).contiguous(),
        refpos=xb[:, None] + qi[None, :] + cdelta)


# chunk_expand's tensors, in the order of the kernel's output arguments
EXPAND_KEYS = ("ref_win", "sq", "qq", "cdT", "lref", "bMv", "bIv", "seg",
               "refpos")


def chunk_expand(buf: torch.Tensor, ref_dev: torch.Tensor,
                 nt16_to4: torch.Tensor, l_query: int) -> dict:
    """K6's front: ``chunk_expand_plain``'s tensors from one chunk's
    packed buffer (uint8 [C, HDR + 2 l_query], C >= 1), the contig's 0-4
    codes ``ref_dev`` and the nt16 -> 0-4 table.  CPU tensors take the
    plain version; CUDA tensors launch csrc/chunk_expand.cu (a block of
    32 reads, each base's op found from the read's 8 cigar words, cdT
    transposed through shared memory), which allocates nothing of
    [C, 8, l_query]."""
    if l_query < 1:
        raise ValueError(f"l_query {l_query} < 1")
    kernels.check(buf, "buf", torch.uint8, (None, HDR + 2 * l_query))
    kernels.check(ref_dev, "ref_dev", torch.uint8, (None,))
    kernels.check(nt16_to4, "nt16_to4", torch.uint8, (16,))
    C = buf.shape[0]
    if not 0 < C < (1 << 31) or ref_dev.numel() == 0:
        raise ValueError(f"chunk_expand takes 1 to 2^31 - 1 reads and a "
                         f"contig, got {C} reads, {ref_dev.numel()} bases")
    if not kernels.on_card(buf, ref_dev, nt16_to4):
        return chunk_expand_plain(buf, ref_dev, nt16_to4, l_query)
    dev = buf.device
    LQ = l_query

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    x = dict(ref_win=out((C, LQ + LREF_PAD), torch.uint8),
             sq=out((C, LQ), torch.uint8), qq=out((C, LQ), torch.uint8),
             cdT=out((LQ, C), torch.int32), lref=out(C, torch.int32),
             bMv=out(C, torch.float32), bIv=out(C, torch.float32),
             seg=out((C, LQ), torch.int32), refpos=out((C, LQ), torch.int32))
    kernels.launch("chunk_expand", "samtpu_chunk_expand", buf.data_ptr(), C,
                   LQ, ref_dev.data_ptr(), ref_dev.numel(),
                   nt16_to4.data_ptr(),
                   *(x[k].data_ptr() for k in EXPAND_KEYS),
                   kernels.stream_of(buf), device=dev)
    return x


class DeviceCensusPipeline:
    """Accumulates the BAQ'd base census of one window [base, base+wlen)
    of contig ``ref_int`` (0-4 codes) on the device across streamed
    batches.  ``device=None`` means the CUDA card; ``device="cpu"`` runs
    the plain PyTorch versions of the kernels.  ``ref_dev``: the contig's
    codes already on the device (the tool uploads a contig once, not once
    per window)."""

    def __init__(self, ref_int: np.ndarray, wlen: int, min_baseq: int = 13,
                 baq_flag: int = 3, tile: int = 256, bw: int = 7,
                 l_query: int = 100, chunk_reads: int = 1 << 16,
                 base: int = 0, device=None, ref_dev=None):
        self.device = resolve(device)
        self.ref_int = np.ascontiguousarray(ref_int, np.uint8)
        self.wlen = wlen
        self.base = base
        self.min_baseq = min_baseq
        self.baq_flag = baq_flag
        self.tile = tile
        self.bw = bw
        self.l_query = l_query
        self.chunk = chunk_reads
        self.n_tiles = (wlen + tile - 1) // tile
        self.total_tiles = max(padded_tiles(self.n_tiles), 512)
        self.census_dev = torch.zeros(self.total_tiles * tile, CENSUS_K,
                                      dtype=torch.int32, device=self.device)
        if ref_dev is None:
            ref_dev = torch.from_numpy(self.ref_int).to(self.device)
        elif ref_dev.device.type != self.device.type \
                or ref_dev.numel() != self.ref_int.size:
            raise ValueError("ref_dev must hold the contig on the device")
        self.ref_dev = ref_dev
        self._nt16_to4 = torch.from_numpy(NT16_TO4).to(self.device)
        self.host_census = np.zeros((wlen, 5), np.int64)
        self.host_qsum = np.zeros(wlen, np.int64)
        self.n_reads = 0
        self.n_host_reads = 0
        self.n_risky = 0
        self._pending = None  # deferred risky masks of the last batch

    # ------------------------------------------------------------------
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """``device.h2d`` to this pipeline's device (a stage the profile
        script times)."""
        return h2d(arr, self.device)

    def _gather_rows(self, b, dsel):
        """[n, l_query] seq/qual matrices of the selected reads; a
        contiguous selection reshapes the flat arrays without a copy."""
        LQ = self.l_query
        off0 = b.seq_off[dsel]
        if dsel.size and int(off0[-1]) - int(off0[0]) \
                == (dsel.size - 1) * LQ \
                and int(b.seq_off[dsel[-1] + 1]) - int(off0[-1]) == LQ:
            s0 = int(off0[0])
            return (b.seq[s0:s0 + dsel.size * LQ].reshape(-1, LQ),
                    b.qual[s0:s0 + dsel.size * LQ].reshape(-1, LQ))
        idx2 = off0[:, None] + np.arange(LQ)[None, :]
        return b.seq[idx2], b.qual[idx2]

    def _make_buf(self, pos, lead, lref, cig8, seqm, qual, lo, hi):
        """Pack one chunk's host->device buffer, one row per read:
        LE i32 pos | LE u16 lead | LE u16 lref | f32 bM | f32 bI |
        LE u32 cig8[8] | seq nt16 | qual."""
        LQ = self.l_query
        n = hi - lo
        buf = np.empty((n, HDR + 2 * LQ), np.uint8)
        buf[:, 0:4] = pos[lo:hi].astype("<i4").view(np.uint8).reshape(n, 4)
        buf[:, 4:6] = lead[lo:hi].astype("<u2").view(np.uint8).reshape(n, 2)
        lr = lref[lo:hi]
        buf[:, 6:8] = lr.astype("<u2").view(np.uint8).reshape(n, 2)
        lr64 = lr.astype(np.float64)
        buf[:, 8:12] = ((1.0 - 0.001) / lr64).astype("<f4") \
            .view(np.uint8).reshape(n, 4)
        buf[:, 12:16] = (0.001 / lr64).astype("<f4") \
            .view(np.uint8).reshape(n, 4)
        buf[:, 16:HDR] = cig8[lo:hi].astype("<u4").view(np.uint8) \
            .reshape(n, MAXOPS * 4)
        buf[:, HDR:HDR + LQ] = seqm[lo:hi]
        buf[:, HDR + LQ:] = qual[lo:hi]
        return buf

    def _plan(self, pos_n: np.ndarray):
        """Tile slices of one chunk (items read-major, LQ per read; pos_n
        window-relative).  Returns (lo, hi, wbeg, n_tiles): at least 512
        tiles, kept inside the padded census."""
        tile = self.tile
        span = self.l_query + LREF_PAD
        t0 = max(int(pos_n[0]) // tile, 0)
        t1 = (int(pos_n[-1]) + span + tile - 1) // tile
        ntp = min(max(512, padded_tiles(max(1, t1 - t0))), self.total_tiles)
        t0 = max(min(t0, self.total_tiles - ntp), 0)
        item_off = np.arange(pos_n.size + 1, dtype=np.int64) * self.l_query
        plan = tile_plan(pos_n, pos_n + span + 1, item_off, t0 * tile,
                         ntp * tile, tile=tile)
        return plan.lo, plan.hi, t0 * tile, ntp

    def _expand(self, buf: torch.Tensor) -> dict:
        """``chunk_expand`` of one chunk's device buffer with this
        pipeline's contig, table and read length."""
        return chunk_expand(buf, self.ref_dev, self._nt16_to4,
                            self.l_query)

    def _chunk_step(self, buf, lo, hi, wbeg: int, ntp: int,
                    gate_lo: int, gate_hi: int, collect: bool = False):
        """Device work of one chunk; adds into the resident census and
        returns the chunk's risky mask (bool[n], still on the device).
        With ``collect`` (the tool), returns (risky, appq, dcount, didx,
        dval): the applied quals and their sparse deltas
        (``qual_deltas`` at capacity n * l_query / 16), all on the
        device."""
        LQ = self.l_query
        x = self._expand(buf)
        bq, good, risky = baq_hmm(x["ref_win"], x["sq"], x["qq"], x["cdT"],
                                  x["lref"], x["bMv"], x["bIv"], LQ,
                                  LQ + LREF_PAD, self.bw)
        appq = baq_finalize(bq, good, x["qq"], x["seg"])
        if not self.baq_flag:
            appq = x["qq"]
            risky = torch.zeros_like(risky)
        segment_census(x["refpos"], x["seg"], x["sq"], appq, risky,
                       self.base, gate_lo, gate_hi, self.min_baseq, lo, hi,
                       wbeg, self.tile,
                       self.census_dev[wbeg:wbeg + ntp * self.tile])
        if not collect:
            return risky
        return (risky, appq,
                *qual_deltas(appq, x["qq"], appq.numel() // 16))

    # ------------------------------------------------------------------
    def add_batch(self, batch, excl_flags: int = DEFAULT_EXCL,
                  min_mapq: int = 0, want_tid: int = 0):
        """Census-only ingestion: BAQ'd quals never leave the device."""
        b = batch
        keep = ((b.tid == want_tid)
                & ((b.flag.astype(np.int64) & excl_flags) == 0)
                & (b.mapq >= min_mapq))
        sel = np.nonzero(keep)[0]
        if sel.size == 0:
            return
        self.n_reads += sel.size
        elig, lead_s, lref_s, cig8_s = classify_reads(
            b, sel, self.l_query, self.ref_int.size, self.bw)
        dsel = sel[elig]
        hsel = sel[~elig]
        if hsel.size:
            self._host_reads(b, hsel)
        if dsel.size == 0:
            return
        pos = b.pos[dsel].astype(np.int64)
        lead, lref, cig8 = lead_s[elig], lref_s[elig], cig8_s[elig]
        seqm, qual = self._gather_rows(b, dsel)
        # the census adds BAQ'd quals as int8 weights; they never exceed
        # the read's own quals
        if int(qual.max(initial=0)) > 127:
            raise ValueError("base quality above 127 on a device read")
        risky_parts = []
        for lo in range(0, dsel.size, self.chunk):
            hi = min(lo + self.chunk, dsel.size)
            buf = self._make_buf(pos, lead, lref, cig8, seqm, qual, lo, hi)
            plo, phi, wbeg, ntp = self._plan(pos[lo:hi] - self.base)
            risky_parts.append((self._chunk_step(
                self._h2d(buf), self._h2d(plo), self._h2d(phi), wbeg, ntp,
                0, self.wlen), lo, hi))
        # drain the PREVIOUS batch's risky masks now: the fetch waits for
        # that batch's device work, which overlaps this batch's launches
        prev = self._pending
        self._pending = (risky_parts, b, dsel)
        if prev is not None:
            self._drain(prev)

    # ------------------------------------------------------------------
    def begin_window(self, sub, gate_lo: int, gate_hi: int):
        """Tool engine, launch half: classify one prepared window's reads
        and launch the chunk steps of those the device takes (no host
        sync).  The census counts the owned columns [gate_lo, gate_hi)
        (absolute).  Returns the handle ``finish_window`` takes."""
        z = np.zeros(0, np.int64)
        if sub.n == 0:
            return (sub, z, [], gate_lo, gate_hi, z)
        self.n_reads += sub.n
        elig, lead, lref, cig8 = classify_reads(
            sub, np.arange(sub.n, dtype=np.int64), self.l_query,
            self.ref_int.size, self.bw)
        if elig.any() and stored_baq_tags(sub):
            elig[:] = False        # tag conversions are the host's
        dsel = np.nonzero(elig)[0]
        handles = []
        if dsel.size:
            seqm, qual = self._gather_rows(sub, dsel)
            if int(qual.max()) > 127:
                # the census adds applied quals as int8 weights
                ok = qual.max(1) <= 127
                elig[dsel[~ok]] = False
                dsel, seqm, qual = dsel[ok], seqm[ok], qual[ok]
            pos = sub.pos[dsel].astype(np.int64)
            lead, lref, cig8 = lead[dsel], lref[dsel], cig8[dsel]
            for lo in range(0, dsel.size, self.chunk):
                hi = min(lo + self.chunk, dsel.size)
                buf = self._make_buf(pos, lead, lref, cig8, seqm, qual, lo,
                                     hi)
                plo, phi, wbeg, ntp = self._plan(pos[lo:hi] - self.base)
                handles.append((*self._chunk_step(
                    self._h2d(buf), self._h2d(plo), self._h2d(phi), wbeg,
                    ntp, gate_lo - self.base, gate_hi - self.base,
                    collect=True), lo, hi - lo))
        return (sub, dsel, handles, gate_lo, gate_hi,
                np.nonzero(~elig)[0])

    def finish_window(self, handle, threads: int = HOST_THREADS) -> int:
        """Tool engine, fetch half: wait for the window's device work,
        write the BAQ'd quals into ``sub.qual``, and BAQ the risky and
        ineligible reads on the host (their window-gated census rides
        along).  Returns the number of host-path reads."""
        sub, dsel, handles, gate_lo, gate_hi, hsel = handle
        host_rows = [hsel]
        if handles:
            LQ = self.l_query
            # one fetch of every chunk's risky mask and delta count, then
            # each chunk's delta slice
            rk_all = torch.cat([h[0] for h in handles]).cpu().numpy()
            counts = torch.stack([h[2] for h in handles]).cpu().numpy()
            for (_, appq, _, didx, dval, lo, cn), cnt in zip(
                    handles, counts.tolist()):
                rk = rk_all[lo:lo + cn]
                rows = dsel[lo:lo + cn]
                # risky reads are recomputed whole on the host from their
                # original quals: no delta may touch them
                if cnt <= didx.numel():
                    di = didx[:cnt].cpu().numpy().astype(np.int64)
                    dv = dval[:cnt].cpu().numpy()
                    ri, qp = di // LQ, di % LQ
                    keep = ~rk[ri]
                    sub.qual[sub.seq_off[rows[ri[keep]]] + qp[keep]] = \
                        dv[keep]
                elif not rk.all():
                    # over capacity: fetch that chunk's non-risky rows
                    okr = np.nonzero(~rk)[0]
                    aq = appq[torch.from_numpy(okr).to(appq.device)]
                    idx2 = sub.seq_off[rows[okr]][:, None] + np.arange(LQ)
                    sub.qual[idx2.ravel()] = aq.cpu().numpy().ravel()
                if rk.any():
                    self.n_risky += int(rk.sum())
                    host_rows.append(rows[rk])
        hr = np.sort(np.concatenate(host_rows))
        if hr.size:
            self._host_apply(sub, hr, gate_lo, gate_hi, threads)
        self.n_host_reads += hr.size
        return int(hr.size)

    def apply_window(self, sub, gate_lo: int, gate_hi: int,
                     threads: int = HOST_THREADS) -> int:
        """BAQ every read of a prepared window in place (device chunks for
        the eligible reads, the host HMM for the rest) and count the
        census of the owned columns [gate_lo, gate_hi).  The census holds
        post-filter, pre-overlap-tweak quals (the sam_prob_realn stage)."""
        return self.finish_window(self.begin_window(sub, gate_lo, gate_hi),
                                  threads)

    def _host_apply(self, sub, rows, gate_lo, gate_hi, threads):
        """Host BAQ in place + window-gated host census of the host-routed
        reads of one window."""
        clens = sub.cigar_off[rows + 1] - sub.cigar_off[rows]
        coff = np.zeros(rows.size + 1, np.int64)
        np.cumsum(clens, out=coff[1:])
        cig = sub.cigar[ragged_gather_indices(sub.cigar_off[rows], clens)]
        slens = sub.seq_off[rows + 1] - sub.seq_off[rows]
        soff = np.zeros(rows.size + 1, np.int64)
        np.cumsum(slens, out=soff[1:])
        gidx = ragged_gather_indices(sub.seq_off[rows], slens)
        seq_nt16 = sub.seq[gidx]
        spos = sub.pos[rows].astype(np.int64)
        newq = sub.qual[gidx]
        if self.baq_flag:
            if stored_baq_tags(sub, rows):
                raise ValueError("reads with stored BQ/ZQ tags: their "
                                 "conversion is ops.baq.apply_baq_batch's")
            newq, _ = native.baq_batch(spos, cig, coff, seq_nt16, newq,
                                       soff, self.ref_int, flag=3,
                                       threads=threads)
            sub.qual[gidx] = newq
        _host_census(self.host_census, self.host_qsum, spos, cig, coff,
                     NT16_TO4[seq_nt16], newq, soff, self.ref_int,
                     self.min_baseq, 0, base=self.base,
                     gate_lo=gate_lo - self.base,
                     gate_hi=gate_hi - self.base, newq=newq)

    def _drain(self, pending):
        risky_parts, b, dsel = pending
        allr = torch.cat([r for r, _, _ in risky_parts]).cpu().numpy()
        if allr.any():
            gsel = dsel[allr]
            self.n_risky += gsel.size
            self._host_reads(b, gsel)

    def _flush(self):
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._drain(prev)

    def _host_reads(self, b, gsel):
        self.n_host_reads += gsel.size
        clens = b.cigar_off[gsel + 1] - b.cigar_off[gsel]
        coff = np.zeros(gsel.size + 1, np.int64)
        np.cumsum(clens, out=coff[1:])
        cig = b.cigar[ragged_gather_indices(b.cigar_off[gsel], clens)]
        slens = b.seq_off[gsel + 1] - b.seq_off[gsel]
        soff = np.zeros(gsel.size + 1, np.int64)
        np.cumsum(slens, out=soff[1:])
        gidx = ragged_gather_indices(b.seq_off[gsel], slens)
        _host_census(self.host_census, self.host_qsum,
                     b.pos[gsel].astype(np.int64), cig, coff,
                     NT16_TO4[b.seq[gidx]], b.qual[gidx], soff,
                     self.ref_int, self.min_baseq, self.baq_flag,
                     base=self.base, threads=HOST_THREADS)

    # ------------------------------------------------------------------
    def finish_checksum(self):
        """Two-lane weighted checksum of (census, qsum), computed on the
        device and fetched as two scalars.  The checksum is linear, so
        the device and host parts add mod 2^32."""
        self._flush()
        s1, s2 = census_checksum_dev(self.census_dev, self.wlen)
        h1, h2 = census_checksum(self.host_census, self.host_qsum)
        return (s1 + h1) & _M32, (s2 + h2) & _M32

    def finish(self):
        """One device->host fetch, host contributions merged.  Returns
        (census int64[wlen, 5], qsum int64[wlen]).  The census is narrowed
        on its device first (K7n ``census_narrow``) and fetched in one
        copy (into pinned memory from the card), then widened here."""
        self._flush()
        buf, cdt, qdt = census_narrow(self.census_dev, self.wlen)
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(buf)
            buf = host
        counts, qsum = narrow_split(buf.numpy(), self.wlen, cdt, qdt)
        # int64 + the narrow type widens in the one pass of the add
        return self.host_census + counts, self.host_qsum + qsum
