"""The modules of mpileup's general path against their JAX package
counterparts, on the CPU: the pileup table (``build_pileup``, every field,
the insertion map included) and the entry pieces; K13's plain version
and ``torch.sort`` against the JAX ``_device_stable_order`` and
``np.lexsort``; K8's plain version against the JAX
``baq_apply_device_nt16`` under K4's contract; ``apply_baq_batch``
through K8 against the host library's f64 HMM, exactly; the per-read
BAQ with stored tags, ``-C``'s cap, the base-modification parser and the
aux tag deletion; and the cut of a window at K1's item limit, whose
output is the JAX host branch's."""

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (make_general_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu.core import aux as jaux
from samtools_tpu.io.files import read_alignments as jread
from samtools_tpu.ops import baq as jbaq
from samtools_tpu.ops import baq_device as jbd
from samtools_tpu.ops import basemods as jbm
from samtools_tpu.ops import pileup as jpl
from samtools_tpu.tools import mpileup_cmd as jmc
from samtools_tpu_torch import kernels
from samtools_tpu_torch.core import aux
from samtools_tpu_torch.io import native
from samtools_tpu_torch.io.fasta import load_fasta
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import baq
from samtools_tpu_torch.ops import baq_device as bd
from samtools_tpu_torch.ops import basemods, pileup
from samtools_tpu_torch.ops import pileup_engine as pe
from samtools_tpu_torch.tools import mpileup_cmd as mc

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("pos", "rid", "qpos", "is_del", "is_refskip", "is_head", "is_tail",
          "indel", "col_pos", "col_off", "order")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_general_inputs(str(tmp_path_factory.mktemp("pileup")))


def _window(path, lo, hi, j=False):
    b = (jread(path) if j else read_alignments(path)).batch
    return b.take(np.nonzero((b.pos >= lo) & (b.pos < hi))[0])


@pytest.mark.parametrize("which,jdev", [("messy", "0"), ("pairs", "0"),
                                        ("mods", "1")])
def test_build_pileup_equals_jax(inputs, monkeypatch, which, jdev):
    """Every field of the table, the insertion map re-keyed through the
    order included; the JAX table from its host sort, or from its device
    sort (``SAMTPU_DEVICE=1``)."""
    monkeypatch.setenv("SAMTPU_DEVICE", jdev)
    sub = _window(inputs[which], 20000, 60000)
    jsub = _window(inputs[which], 20000, 60000, j=True)
    want = jpl.build_pileup(jsub)
    for dev in (CPU, None):
        got = pileup.build_pileup(sub, dev)
        assert got.n_entries == want.n_entries > 10000
        for f in FIELDS:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.ins == want.ins
    if which != "pairs":
        assert (got.indel > 0).any() and (got.indel < 0).any()


@pytest.mark.parametrize("conf", [
    dict(rev_del=0, no_ends=0, no_ins=0, no_del=0, no_ins_mods=0,
         flag_cols=0),
    dict(rev_del=1, no_ends=1, no_ins=1, no_del=2, no_ins_mods=0,
         flag_cols=0),
    dict(rev_del=1, no_ends=0, no_ins=0, no_del=0, no_ins_mods=0,
         flag_cols=mc.COL_MODS),
    dict(rev_del=0, no_ends=0, no_ins=0, no_del=1, no_ins_mods=1,
         flag_cols=mc.COL_MODS)])
def test_entry_pieces_equal_jax(inputs, conf):
    ref = load_fasta(inputs["fa"]).fetch("sim1")
    conf = dict(conf, min_baseQ=13, auxtags=[])
    for which in ("messy", "pairs", "mods"):
        sub = _window(inputs[which], 28000, 40000)
        jsub = _window(inputs[which], 28000, 40000, j=True)
        got = mc.build_entry_pieces(sub, pileup.build_pileup(sub, CPU), ref,
                                    len(ref), conf)
        want = jmc.build_entry_pieces(jsub, jpl.build_pileup(jsub), ref,
                                      len(ref), conf)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_stable_order_equals_jax_and_lexsort(monkeypatch):
    """K13: its plain version and torch.sort (stable) on the CPU against
    the JAX device sort and np.lexsort over positions with many ties, and
    the host fallback where the span passes int32."""
    rng = np.random.default_rng(3)
    pos = 7_000_000 + rng.integers(0, 50_000, 400_000)
    keys = (pos - pos.min()).astype(np.int32)
    want = np.lexsort((np.arange(pos.size), pos))
    assert np.array_equal(jpl._device_stable_order(pos), want)
    assert np.array_equal(pileup.stable_order_plain(keys), want)
    assert np.array_equal(pileup.stable_order(torch.from_numpy(keys)), want)
    assert np.array_equal(torch.sort(torch.from_numpy(keys),
                                     stable=True).indices.numpy(), want)
    assert np.array_equal(pileup.entry_order(pos, CPU), want)
    assert np.array_equal(pileup.entry_order(pos, None), want)
    wide = pos * 100_000
    assert np.array_equal(pileup.entry_order(wide, CPU),
                          np.lexsort((np.arange(pos.size), wide)))
    assert np.array_equal(jpl._device_stable_order(wide),
                          pileup.entry_order(wide, CPU))
    with pytest.raises(TypeError):
        pileup.stable_order(torch.from_numpy(pos))


def _group(path, L=100, n=700):
    b = read_alignments(path).batch
    allm = (b.n_cigar == 1) & (b.l_qseq == L)
    k = np.nonzero(allm)[0][:n]
    idx = b.seq_off[k][:, None] + np.arange(L)[None, :]
    return b.pos[k].astype(np.int64), b.seq[idx], b.qual[idx]


def test_baq_apply_plain_equals_jax(inputs):
    """K8's plain version against the JAX fused apply on its CPU backend:
    the applied quals equal on every read neither flags risky, at most 1%
    of the reads in the symmetric difference of the risky sets."""
    ref_int = baq._ref_ints(load_fasta(inputs["fa"]).fetch("sim1"))
    pos, seq, qual = _group(inputs["messy"])
    got, risky = bd.baq_apply_nt16(torch.from_numpy(ref_int), pos, seq, qual,
                                   chunk=256)
    want, jrisky = jbd.baq_apply_device_nt16(ref_int, pos, seq, qual, 100)
    ok = ~(risky | jrisky)
    assert (risky ^ jrisky).sum() <= 7 and ok.sum() > 600
    assert np.array_equal(got[ok], want[ok])
    assert (got != qual).any()
    buf = np.zeros((3, 4 + 2 * 100), np.uint8)
    with pytest.raises(ValueError):     # contig codes on another device
        bd.baq_apply(torch.zeros(10, dtype=torch.uint8).to("meta"),
                     torch.from_numpy(buf))


@pytest.mark.parametrize("which", ["messy", "pairs"])
def test_apply_baq_batch_through_k8_equals_host_hmm(inputs, monkeypatch,
                                                    which):
    """apply_baq_batch with the group minimum at 64: K8's plain version
    takes the all-M groups, the host HMM the rest and the risky reads;
    the quals equal the host library's f64 HMM byte for byte."""
    monkeypatch.setattr(baq, "DEVICE_GROUP_MIN", 64)
    ref_int = baq._ref_ints(load_fasta(inputs["fa"]).fetch("sim1"))
    b = _window(inputs[which], 0, 40000)
    want, _ = native.baq_batch(b.pos, b.cigar, b.cigar_off, b.seq, b.qual,
                               b.seq_off, ref_int, flag=3)
    seen = []
    real = bd.baq_apply_nt16

    def spy(ref_dev, pos, *a, **k):
        seen.append(pos.size)
        return real(ref_dev, pos, *a, **k)
    monkeypatch.setattr(bd, "baq_apply_nt16", spy)
    baq.apply_baq_batch(b, ref_int, device=CPU)
    assert seen and sum(seen) > 0.3 * b.n
    assert np.array_equal(b.qual, want)


@pytest.mark.parametrize("tag,redo", [("bq", False), ("bq", True),
                                      ("zq", False), ("zq", True)])
def test_stored_tags_equal_jax(inputs, tag, redo):
    """The per-read path of reads with stored BQ/ZQ tags: quals and aux
    bytes equal the JAX package's."""
    ref = load_fasta(inputs["fa"]).fetch("sim1")
    b = read_alignments(inputs[tag]).batch
    jb = jread(inputs[tag]).batch
    baq.apply_baq_batch(b, baq._ref_ints(ref), redo, CPU)
    jbaq.apply_baq_batch(jb, ref, len(ref), redo=redo)
    assert np.array_equal(b.qual, jb.qual)
    assert np.array_equal(b.aux, jb.aux)
    assert np.array_equal(b.aux_off, jb.aux_off)


def test_cap_mapq_equals_jax(inputs):
    ref = load_fasta(inputs["fa"]).fetch("sim1")
    b, jb = _window(inputs["messy"], 0, 20000), _window(inputs["messy"], 0,
                                                        20000, j=True)
    for thres in (20, 50, 90):
        got = baq.cap_mapq_batch(b, baq._ref_ints(ref), thres)
        assert np.array_equal(got, jbaq.cap_mapq_batch(jb, ref, len(ref),
                                                       thres))
    assert (got >= 0).any() and (got < 60).any()


def test_basemods_and_delete_tags_equal_jax(inputs):
    sub = _window(inputs["mods"], 0, 1 << 20)
    jsub = _window(inputs["mods"], 0, 1 << 20, j=True)
    got = basemods.batch_mods(sub, np.arange(sub.n))
    assert got == jbm.batch_mods(jsub, np.arange(sub.n)) and len(got) > 20
    lst = next(iter(next(iter(got.values())).values()))
    assert basemods.format_mods(lst) == jbm.format_mods(lst)
    for i in range(0, sub.n, 7):
        for tags in ({"MM"}, {"ML", "XY"}, {"MM", "ML"}, set()):
            assert np.array_equal(aux.delete_tags(sub.aux_of(i), tags),
                                  jaux.delete_tags(sub.aux_of(i), tags))


def test_item_cuts_bound_each_sub_window(monkeypatch):
    monkeypatch.setattr(pe, "MAX_ITEMS", 5000)
    rng = np.random.default_rng(1)
    pos = np.sort(rng.integers(0, 50_000, 2000))
    end = pos + rng.integers(1, 300, pos.size)
    items = end - pos
    cuts = pe.item_cuts([(pos, end, items)], 100, 50_100, 128)
    assert cuts[0][0] == 100 and cuts[-1][1] == 50_100
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all((a - 100) % 128 == 0 for a, _ in cuts)
    for a, b in cuts:
        n = int(items[(pos < b) & (end > a)].sum())
        assert 3000 < n < 5000 or b == 50_100
    assert len(cuts) > 10
    pile = np.full(30, 500)
    with pytest.raises(ValueError, match="tile"):
        pe.item_cuts([(pile, pile + 200, np.full(30, 200))], 0, 5000, 128)


@pytest.mark.parametrize("cmd,argv", [
    ("depth", ["-a", "-q", "13", "{messy}"]),
    ("depth", ["-a", "-q", "13", "-J", "{deep}"]),
    ("depth", ["-q", "13", "-J", "{messy}", "{pairs}"]),
    ("coverage", ["-r", "sim1:20001-60000", "{messy}", "{pairs}"]),
    ("coverage", ["-r", "sim1", "{deep}"])])
def test_item_limit_cut_equals_jax_host_branch(inputs, monkeypatch, cmd,
                                               argv):
    """K1's item limit patched to 50,000: depth and coverage cut each
    window into sub-windows, K1 runs more than once in it, and the bytes
    are the JAX host branch's."""
    monkeypatch.setattr(pe, "MAX_ITEMS", 50_000)
    calls = []
    real = pe.segment_matmul

    def spy(refpos, *a, **k):
        assert refpos.size <= 50_000
        calls.append(refpos.size)
        return real(refpos, *a, **k)
    monkeypatch.setattr(pe, "segment_matmul", spy)
    args = [a.format(**inputs) for a in argv]
    port = run_port_stdout(cmd, args)
    assert len(calls) > 2
    assert port == run_jax_tool(cmd, args, "0")
    assert kernels.launches["segment_contract"] == 0
