"""Inputs of K6's front and tail and of K7 (``chunk_expand``,
``qual_deltas``, ``census_checksum_dev`` in
samtools_tpu_torch/ops/mpileup_device.py): chunks of simulated reads
packed as the census pipeline packs them, chunks of synthetic reads with
every cigar op the device path takes, and a numpy walk of each read's
cigar that gives ``chunk_expand``'s tensors without torch.  K8's
buffers (``apply_buf``) and scripts/torch_apply_depth_kernels.py, which
holds K9's edge cases (``apply_depth_script``).  No JAX here: the card's
tests use it too."""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from samtools_tpu_torch import build, sim
from samtools_tpu_torch.core import flags as F
from samtools_tpu_torch.ops import mpileup_device as md

BIGC = 1 << 20
M_OPS = (F.CMATCH, F.CEQUAL, F.CDIFF)
QUERY_OPS = (F.CMATCH, F.CINS, F.CSOFT_CLIP, F.CEQUAL, F.CDIFF)
REF_OPS = (F.CMATCH, F.CDEL, F.CEQUAL, F.CDIFF)
# the ops a device read may hold (N and B route to the host)
DEVICE_OPS = (F.CMATCH, F.CINS, F.CDEL, F.CSOFT_CLIP, F.CHARD_CLIP,
              F.CPAD, F.CEQUAL, F.CDIFF)


def reference(ref_len: int, seed: int = 4):
    """(bases as ASCII, 0-4 codes) of a simulated contig."""
    ref = sim.simulate_reference(ref_len, seed=seed)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return ref, lut[ref]


def _pack(ref_int, lq, pos, lead, lref, cig8, seq, qual) -> np.ndarray:
    pipe = md.DeviceCensusPipeline(ref_int, min(ref_int.size, 1 << 16),
                                   l_query=lq, device="cpu")
    return pipe._make_buf(pos, lead, lref, cig8, seq, qual, 0, pos.size)


def simulated_chunk(lq: int, messy: bool, n: int, ref_len: int = 1 << 16,
                    seed: int = 9):
    """(buf uint8[n, HDR + 2 lq], contig codes): the first ``n``
    device-eligible reads of a 30x simulation (messy: 3 bp insertions,
    2 bp deletions, 8 bp soft clips)."""
    ref, ref_int = reference(ref_len)
    b = sim.simulate_batch(ref_len=ref_len, coverage=1.2 * n * lq / ref_len,
                           read_len=lq, seed=seed + messy, paired=False,
                           err_rate=0.01, ref=ref)
    if messy:
        sim.simulate_messy(b, seed)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, lq, ref_len)
    k = np.nonzero(elig)[0][:n]
    assert k.size == n, f"{k.size} eligible reads, wanted {n}"
    pipe = md.DeviceCensusPipeline(ref_int, ref_len, l_query=lq,
                                   device="cpu")
    seq, qual = pipe._gather_rows(b, k)
    return pipe._make_buf(b.pos[k].astype(np.int64), lead[k], lref[k],
                          cig8[k], seq, qual, 0, k.size), ref_int


def synthetic_chunk(lq: int, n: int, ref_len: int = 1 << 16,
                    seed: int = 3):
    """(buf, contig codes): ``n`` reads of exactly 8 cigar ops drawn from
    M I D S H P = X (at least one M), their query ops' lengths a random
    split of ``lq`` (some 0); leads up to 400 and reference window
    lengths past 255 (both bytes of the u16 fields); the first reads at
    the contig's start with leads past their positions, the last past its
    end (clamped windows); every nt16 code 0-15 among the bases."""
    rng = np.random.default_rng(seed)
    _, ref_int = reference(ref_len)
    ops = rng.choice(np.array(DEVICE_OPS), (n, md.MAXOPS))
    ops[np.arange(n), rng.integers(0, md.MAXOPS, n)] = rng.choice(
        np.array(M_OPS), n)
    lens = np.zeros((n, md.MAXOPS), np.int64)
    for i in range(n):
        qk = np.nonzero(np.isin(ops[i], QUERY_OPS))[0]
        cuts = np.sort(rng.integers(0, lq + 1, qk.size - 1))
        lens[i, qk] = np.diff(np.concatenate([[0], cuts, [lq]]))
        other = ~np.isin(ops[i], QUERY_OPS)
        lens[i, other] = rng.integers(1, 6, int(other.sum()))
    cig8 = ((lens << 4) | ops).astype(np.uint32)
    pos = rng.integers(0, ref_len, n)
    edge = min(4, n // 4)
    pos[:edge] = np.arange(edge)
    pos[n - edge:] = ref_len - 1 - np.arange(edge)
    lead = rng.integers(0, 21, n)
    lead[rng.random(n) < 0.1] = 400
    lref = lq + rng.integers(-7, 8, n)
    lref[rng.random(n) < 0.1] = 300
    seq = rng.integers(0, 16, (n, lq)).astype(np.uint8)
    qual = rng.integers(0, 94, (n, lq)).astype(np.uint8)
    return _pack(ref_int, lq, pos, lead, lref, cig8, seq, qual), ref_int


def expand_oracle(buf: np.ndarray, ref_int: np.ndarray, lq: int) -> dict:
    """``chunk_expand``'s tensors as numpy arrays, from a walk of each
    read's 8 cigar words: an M, = or X op gives its bases the op's ordinal,
    their reference positions and the diagonal (reference position less
    the window start pos - lead and the base's query position); I and S
    advance the query, D the reference, H and P neither."""
    C = buf.shape[0]
    hdr = buf[:, :md.HDR].copy()
    pos = hdr[:, 0:4].view("<i4")[:, 0].astype(np.int64)
    lead = hdr[:, 4:6].view("<u2")[:, 0].astype(np.int64)
    cig = hdr[:, 16:md.HDR].view("<u4")
    xb = pos - lead
    q_all = np.arange(lq)
    seg = np.full((C, lq), -1, np.int32)
    refpos = xb[:, None] + q_all[None, :]
    diag = np.full((C, lq), BIGC, np.int64)
    for i in range(C):
        q, r = 0, int(pos[i])
        for k in range(md.MAXOPS):
            op, ln = int(cig[i, k] & 0xF), int(cig[i, k] >> 4)
            if op in M_OPS and q < lq:
                j = np.arange(q, min(q + ln, lq))
                seg[i, j] = k
                refpos[i, j] = r + (j - q)
                diag[i, j] = r + (j - q) - xb[i] - j
            q += ln if op in QUERY_OPS else 0
            r += ln if op in REF_OPS else 0
    win = np.clip(xb[:, None] + np.arange(lq + md.LREF_PAD)[None, :], 0,
                  ref_int.size - 1)
    return dict(
        ref_win=ref_int[win], sq=md.NT16_TO4[buf[:, md.HDR:md.HDR + lq]],
        qq=buf[:, md.HDR + lq:md.HDR + 2 * lq],
        cdT=diag.T.astype(np.int32),
        lref=hdr[:, 6:8].view("<u2")[:, 0].astype(np.int32),
        bMv=hdr[:, 8:12].view("<f4")[:, 0],
        bIv=hdr[:, 12:16].view("<f4")[:, 0],
        seg=seg, refpos=refpos.astype(np.int32))


def changed_quals(n_reads: int, lq: int, n_changed: int, seed: int = 0):
    """(appq, qq) uint8[n_reads, lq] that differ at exactly ``n_changed``
    flat positions, drawn at random."""
    rng = np.random.default_rng(seed)
    qq = rng.integers(0, 94, (n_reads, lq)).astype(np.uint8)
    appq = qq.copy()
    flat = appq.reshape(-1)
    at = rng.choice(flat.size, n_changed, replace=False)
    flat[at] = (flat[at] + rng.integers(1, 256, n_changed)).astype(np.uint8)
    return appq, qq


def delta_oracle(appq: np.ndarray, qq: np.ndarray, cap: int):
    """(dcount, didx, dval) of ``qual_deltas`` from np.flatnonzero."""
    nz = np.flatnonzero(appq != qq)
    didx = np.zeros(cap, np.int32)
    didx[:min(nz.size, cap)] = nz[:cap]
    return nz.size, didx, appq.reshape(-1)[didx]


def census_with_pad(wlen: int, rows: int, seed: int = 0,
                    negative: bool = False) -> np.ndarray:
    """An int32 [rows, 6] census of random counts and qual sums (with
    ``negative``, lanes anywhere in int32); the rows past ``wlen`` hold
    values too, which a checksum of wlen rows must not read."""
    rng = np.random.default_rng(seed)
    lo = -(1 << 31) if negative else 0
    c = rng.integers(lo, 1 << 31, (rows, 6), dtype=np.int64)
    if not negative:
        c[:, :5] %= 200
        c[:, 5] %= 6000
    return c.astype(np.int32)


def apply_buf(pos: np.ndarray, seq: np.ndarray, qual: np.ndarray
              ) -> np.ndarray:
    """K8's buffer of a uniform group: uint8[B, 4 + 2L], a row a read (LE
    int32 pos | L nt16 bases | L quals)."""
    B, L = qual.shape
    buf = np.empty((B, 4 + 2 * L), np.uint8)
    buf[:, :4] = pos.astype("<i4").view(np.uint8).reshape(-1, 4)
    buf[:, 4:4 + L] = seq
    buf[:, 4 + L:] = qual
    return buf


def apply_depth_script():
    """scripts/torch_apply_depth_kernels.py as a module."""
    path = os.path.join(os.path.dirname(build.ROOT), "scripts",
                        "torch_apply_depth_kernels.py")
    spec = importlib.util.spec_from_file_location(
        "torch_apply_depth_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
