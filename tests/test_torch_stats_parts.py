"""The parts of the port's ``stats`` against the JAX package, on the CPU:

* K12's plain version (``stats_hists_plain``, and the wrapper on CPU
  tensors) equals the JAX ``base_hists_device`` (jitted on the JAX CPU
  backend) and ``base_hists_numpy`` exactly, on seeded random streams at
  nbases 1, 100, 300 and 1,000 with quals up to 255, every read order and
  both strands; its per-read GC counts, qual sums and largest qual (and
  its histograms) equal the host library's ``stats_orig_hists`` on the
  same chunk of a BAM;
* the host library's CRC32 sums equal ``zlib.crc32`` record by record
  and the JAX library's on the same batch; ``aux_find_batch`` and
  ``stats_cov_gcd`` equal the JAX library's calls on the same inputs and
  state;
* K7n: ``census_narrow_plain`` picks the JAX ``_split``/``_cast`` types
  and values on censuses whose maxima sit on each side of 255 and
  65,535, and ``DeviceCensusPipeline.finish`` returns the int32 census
  widened, as before."""

import zlib

import numpy as np
import pytest
import torch
from torch_tool_fixtures import make_stats_inputs

from samtools_tpu.io import native as jnative
from samtools_tpu.ops import mpileup_device as jmd
from samtools_tpu.ops import stats_kernels as jsk
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.io import native
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.ops import stats_kernels as sk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_stats_inputs(str(tmp_path_factory.mktemp("stats_parts")))


def _random_reads(nbases: int, seed: int, total: int = 40_000):
    """Reads of 1..nbases bases: nt16 codes of every kind, quals 0-255
    (0xFF among them), orders 0/1/2, both strands; as a batch's flat
    columns with a few unselected reads between the selected ones."""
    rng = np.random.default_rng(seed)
    n = max(total // max(nbases // 2, 1), 8)
    lens = rng.integers(1, nbases + 1, n)
    lens[0] = nbases
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    seq = rng.choice(np.array([1, 2, 4, 8, 15, 3, 0, 9], np.uint8),
                     int(off[-1]), p=[.2, .2, .2, .2, .1, .04, .03, .03])
    qual = rng.integers(0, 256, int(off[-1])).astype(np.uint8)
    qual[rng.random(qual.size) < 0.05] = 255
    oidx = np.flatnonzero(rng.random(n) < 0.9).astype(np.int64)
    order = rng.integers(0, 3, oidx.size).astype(np.uint8)
    rev = rng.integers(0, 2, oidx.size).astype(np.uint8)
    return seq, qual, off, oidx, order, rev


def _jax_streams(seq, qual, off, oidx, order, rev):
    """The flat per-base stream the JAX device branch takes."""
    lens = off[oidx + 1] - off[oidx]
    seg = np.repeat(np.arange(oidx.size), lens)
    local = np.arange(seg.size) - (np.cumsum(lens) - lens)[seg]
    fi = off[oidx][seg] + local
    rv = rev[seg].astype(bool)
    cycle = np.where(rv, lens[seg] - 1 - local, local).astype(np.int32)
    return (cycle, qual[fi], sk.ACGTNO_COL[seq[fi]].astype(np.uint8),
            order[seg].astype(np.int8), rv), seg, fi


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("nbases", [1, 100, 300, 1000])
def test_plain_k12_equals_jax_device_and_numpy(nbases):
    seq, qual, off, oidx, order, rev = _random_reads(nbases, nbases)
    streams, seg, fi = _jax_streams(seq, qual, off, oidx, order, rev)
    want_dev = jsk.base_hists_device(nbases, *streams)
    want_np = jsk.base_hists_numpy(nbases, *streams)
    for qrows in (nbases, nbases + 1):
        flat = sk.stats_hists_plain(*_t(seq, qual, off, oidx, order, rev),
                                    nbases, qrows)
        assert flat.dtype == torch.int64
        h = sk.split_hists(flat.numpy(), oidx.size, nbases, qrows)
        for k, wd, wn in zip(("q1", "q2", "a1", "a2", "ar"), want_dev,
                             want_np):
            assert np.array_equal(wd, wn), k
            rows = qrows if k[0] == "q" else nbases
            assert np.array_equal(h[k], wd[:rows]), (k, qrows)
        assert h["q1"].sum() > 0 and h["q2"].sum() > 0
        assert h["q1"][:, 255].sum() > 0
        # per read: GC over every base; qual sum and max over first and
        # last fragments only
        gc = np.bincount(seg, (seq[fi] == 2) | (seq[fi] == 4),
                         minlength=oidx.size)
        q12 = (order == 1) | (order == 2)
        qs = np.bincount(seg, qual[fi].astype(np.float64),
                         minlength=oidx.size) * q12
        assert np.array_equal(h["gc"], gc.astype(np.int64))
        assert np.array_equal(h["qsum"], qs.astype(np.int64))
        assert int(h["maxq"][0]) == int(qual[fi][q12[seg]].max())
    got = sk.stats_hists(*_t(seq, qual, off, oidx, order, rev), nbases,
                         nbases + 1, int((off[1:] - off[:-1]).max()))
    assert torch.equal(got, sk.stats_hists_plain(
        *_t(seq, qual, off, oidx, order, rev), nbases, nbases + 1))


def test_k12_rejects_reads_longer_than_nbases_and_bad_args():
    seq, qual, off, oidx, order, rev = _random_reads(50, 3)
    args = _t(seq, qual, off, oidx, order, rev)
    with pytest.raises(ValueError):
        sk.stats_hists(*args, 40, 41, 50)
    with pytest.raises(ValueError):
        sk.stats_hists_plain(*args, 40, 41)
    with pytest.raises(ValueError):
        sk.stats_hists(*args, 50, 52, 50)
    with pytest.raises(TypeError):
        sk.stats_hists(args[0].to(torch.int32), *args[1:], 50, 51, 50)


@pytest.mark.parametrize("which,nbases", [("realloc", 1000),
                                          ("pairs", 300),
                                          ("qualless", 300)])
def test_k12_chunk_equals_host_library(inputs, which, nbases):
    """K12 through ``orig_hists`` (the plain version here, one copy of
    the chunk's bases) against the host library's pass on the same
    reads of a BAM: every histogram, GC count, qual sum and the max."""
    b = read_alignments(inputs[which]).batch
    rng = np.random.default_rng(4)
    oidx = np.flatnonzero(rng.random(b.n) < 0.8).astype(np.int64)[5:]
    flag = b.flag[oidx].astype(np.int64)
    order = np.where(flag & 1, ((flag & 64) != 0) + 2 * ((flag & 128) != 0),
                     1).astype(np.uint8)
    rev = ((flag & 16) != 0).astype(np.uint8)
    qrows = nbases + 1
    h = sk.orig_hists(b.seq, b.qual, b.seq_off, oidx, order, rev, nbases,
                      qrows, torch.device("cpu"))
    want = [np.zeros((qrows, 257), np.int64) for _ in range(2)] + [
        np.zeros((nbases, 6), np.int64) for _ in range(3)]
    gc, qsum, mq = native.stats_orig_hists(b.seq, b.qual, b.seq_off, oidx,
                                           order, rev, nbases, *want)
    for k, w in zip(("q1", "q2", "a1", "a2", "ar"), want):
        assert np.array_equal(h[k], w), k
    assert np.array_equal(h["gc"], gc) and np.array_equal(h["qsum"], qsum)
    assert int(h["maxq"][0]) == mq
    assert want[0].sum() > 0
    # the JAX library's pass on the same reads
    jwant = [np.zeros_like(w) for w in want]
    jgc, jqsum, jmq = jnative.stats_orig_hists(
        b.seq, b.qual, b.seq_off, oidx, order, rev, nbases, *jwant)
    assert all(np.array_equal(a, c) for a, c in zip(want, jwant))
    assert np.array_equal(gc, jgc) and np.array_equal(qsum, jqsum)
    assert mq == jmq


def _packed(s: np.ndarray) -> bytes:
    if s.size % 2:
        s = np.concatenate([s, np.zeros(1, np.uint8)])
    return ((s[0::2] << 4) | s[1::2]).astype(np.uint8).tobytes()


@pytest.mark.parametrize("which", ["realloc", "qualless", "pairs"])
def test_crc32_equals_zlib_and_jax(inputs, which):
    b = read_alignments(inputs[which]).batch
    for i in range(b.n):
        got = native.stats_crc32_batch(b.qname, b.qname_off, b.seq, b.qual,
                                       b.seq_off, np.array([i]))
        s = b.seq_of(i)
        want = (zlib.crc32(b.qname[b.qname_off[i]:b.qname_off[i + 1]]
                           .tobytes()),
                zlib.crc32(_packed(s)) if s.size else 0,
                zlib.crc32(b.qual_of(i).tobytes()) if s.size else 0)
        assert got == want, i
    idx = np.arange(b.n)
    assert native.stats_crc32_batch(
        b.qname, b.qname_off, b.seq, b.qual, b.seq_off, idx) == \
        jnative.stats_crc32_batch(b.qname, b.qname_off, b.seq, b.qual,
                                  b.seq_off, idx)


def test_crc32_on_every_length_and_alignment():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 4200).astype(np.uint8)
    for start in range(9):
        for n in list(range(40)) + [1000, 4096]:
            name = data[start:start + n]
            off = np.array([0, name.size], np.int64)
            got = native.stats_crc32_batch(
                name, off, np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                np.zeros(2, np.int64), np.array([0]))
            assert got[0] == zlib.crc32(name.tobytes()), (start, n)


def test_aux_find_equals_jax(inputs):
    b = read_alignments(inputs["realloc"]).batch
    idx = np.arange(b.n)[::-1].copy()
    for tag in ("NM", "RG", "XX", "BC"):
        got = native.aux_find_batch(b.aux, b.aux_off, idx, tag)
        want = jnative.aux_find_batch(b.aux, b.aux_off, idx, tag)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                                  want[1])
    assert (got[0] == -1).all()
    assert (native.aux_find_batch(b.aux, b.aux_off, idx, "NM")[0] >= 0).all()


def _drive_cov_gcd(lib, args, gcd_cap: int, fai_mode: int):
    """Run ``lib.stats_cov_gcd`` to its end as stats_batch drives it (a
    full GC-depth array grows; a fai pause resumes), from copies of the
    state; returns the codes seen and every array it wrote."""
    (n, state, tid, pos, rl, active, gc_term, span_off, sp_beg, sp_end,
     rbuf, cov) = [a.copy() if isinstance(a, np.ndarray) else a
                   for a in args]
    gcd_gc = np.zeros(gcd_cap, np.float32)
    gcd_depth = np.zeros(gcd_cap, np.int64)
    codes = []
    while True:
        rc = lib.stats_cov_gcd(n, state, tid, pos, rl, active, gc_term,
                               span_off, sp_beg, sp_end, fai_mode, 500,
                               rbuf, cov, 1, 50, 1, gcd_gc, gcd_depth)
        codes.append(rc)
        if rc == 3:
            gcd_gc = np.concatenate([gcd_gc, np.zeros_like(gcd_gc)])
            gcd_depth = np.concatenate([gcd_depth, np.zeros_like(gcd_depth)])
        elif rc == 1:
            # the inc_ref/inc_gcd branch, as stats_batch services it: a
            # new bin at the record and a reference window from it
            i = int(state[9])
            state[8] = i
            state[4] += 1
            if state[4] + 1 >= gcd_gc.size:
                gcd_gc = np.concatenate([gcd_gc, np.zeros_like(gcd_gc)])
                gcd_depth = np.concatenate([gcd_depth,
                                            np.zeros_like(gcd_depth)])
            state[2], state[3] = tid[i], pos[i]
            state[13], state[14] = pos[i], 100_000
        else:
            return codes, state, rbuf, cov, gcd_gc, gcd_depth


@pytest.mark.parametrize("unsorted,fai_mode", [(False, 0), (True, 0),
                                               (False, 1)])
def test_cov_gcd_equals_jax(unsorted, fai_mode):
    rng = np.random.default_rng(5 + unsorted)
    n = 3000
    pos = np.cumsum(rng.integers(0, 40, n)).astype(np.int64)
    if unsorted:
        pos[2000] = pos[1000]
    tid = np.where(np.arange(n) < 2500, 0, 1).astype(np.int32)
    rl = rng.integers(20, 150, n).astype(np.int64)
    active = (rng.random(n) < 0.9).astype(np.uint8)
    gc_term = rng.random(n).astype(np.float32)
    nsp = np.where(active == 1, rng.integers(1, 3, n), 0)
    span_off = np.concatenate([[0], np.cumsum(nsp)]).astype(np.int64)
    owner = np.repeat(np.arange(n), nsp)
    sp_beg = pos[owner] + rng.integers(0, 10, owner.size)
    sp_end = np.minimum(sp_beg + rng.integers(5, 60, owner.size),
                        pos[owner] + rl[owner])
    state = np.zeros(16, np.int64)
    state[2], state[3], state[5] = -1, -1, 1
    state[8], state[12], state[13] = -1, -1, -1
    args = (n, state, tid, pos, rl, active, gc_term, span_off, sp_beg,
            sp_end, np.zeros(750, np.int32), np.zeros(53, np.int64))
    got = _drive_cov_gcd(native, args, 4, fai_mode)
    want = _drive_cov_gcd(jnative, args, 4, fai_mode)
    assert got[0] == want[0]
    assert got[0][-1] == 0 and (3 in got[0]) != bool(fai_mode)
    for a, w in zip(got[1:], want[1:]):
        assert np.array_equal(a, w)
    assert got[3].sum() > 0
    assert (got[1][12] >= 0) == unsorted


# --------------------------------------------------------------- K7n
@pytest.mark.parametrize("cmax,qmax", [(255, 65535), (256, 65536),
                                       (65535, 100), (65536, 65535),
                                       (0, 0)])
def test_census_narrow_plain_equals_jax_split(cmax, qmax):
    rng = np.random.default_rng(cmax + qmax)
    pad, wlen = 1 << 17, 100_000
    c = np.zeros((pad, 6), np.int32)
    c[:wlen, :5] = rng.integers(0, cmax + 1, (wlen, 5))
    c[:wlen, 5] = rng.integers(0, qmax + 1, wlen)
    c[7, 2], c[9, 5] = cmax, qmax
    buf, cdt, qdt = md.census_narrow_plain(torch.from_numpy(c), wlen)
    counts, qsum = md.narrow_split(buf.numpy(), wlen, cdt, qdt)
    # the JAX package's narrowing (DeviceCensusPipeline.finish, :855-873)
    import jax.numpy as jnp
    split, cast = jmd._split_jit()
    jc, jq, jcounts, jqsum = split(jnp.asarray(c))
    jc, jq = int(jc), int(jq)
    jcdt = (jnp.uint8 if jc < 256 else jnp.uint16 if jc < 65536
            else jnp.int32)
    jqdt = jnp.uint16 if jq < 65536 else jnp.int32
    want_c = np.asarray(cast(jcounts, jcdt))[:wlen]
    want_q = np.asarray(cast(jqsum, jqdt))[:wlen]
    assert counts.dtype == want_c.dtype and qsum.dtype == want_q.dtype
    assert np.array_equal(counts, want_c) and np.array_equal(qsum, want_q)
    assert np.array_equal(counts.astype(np.int64), c[:wlen, :5])
    # the wrapper on a CPU tensor is the plain version
    kernels.reset_launches()
    b2, c2, q2 = md.census_narrow(torch.from_numpy(c), wlen)
    assert torch.equal(b2, buf) and (c2, q2) == (cdt, qdt)
    assert kernels.launches["census_narrow"] == 0


@pytest.mark.parametrize("deep", [False, True])
def test_finish_returns_the_widened_census(tmp_path, deep):
    """finish() through K7n's plain version returns the int32 census
    widened and the host part added, as the fetch did before; 300x
    reads narrow the counts to u16."""
    L = 2048 if deep else 1 << 15
    ref = sim.simulate_reference(L, seed=3)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    b = sim.simulate_batch(ref_len=L, coverage=300.0 if deep else 6.0,
                           read_len=100, seed=3, paired=False, ref=ref)
    pipe = md.DeviceCensusPipeline(lut[ref], L, device="cpu",
                                   chunk_reads=512)
    pipe.add_batch(b)
    pipe._flush()
    c = pipe.census_dev[:L].numpy().astype(np.int64)
    want = (c[:, :5] + pipe.host_census, c[:, 5] + pipe.host_qsum)
    _, cdt, qdt = md.census_narrow_plain(pipe.census_dev, L)
    assert cdt == (torch.uint16 if deep else torch.uint8)
    assert qdt == torch.uint16
    census, qsum = pipe.finish()
    assert census.dtype == np.int64 and qsum.dtype == np.int64
    assert np.array_equal(census, want[0]) and np.array_equal(qsum, want[1])
    assert census.sum() > 0
