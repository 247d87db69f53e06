"""The parts of the port's ``consensus`` against the JAX package, on the
CPU:

* the bit tricks (``fast_log2``, ``ph_log``, ``fast_exp`` and their
  vector forms) and the gap5 table equal the JAX package's bit for bit;
* K10's plain version (the kept rows gathered, ``index_add_`` in f64)
  equals the exact ``gap5_scores`` bit for bit, on a column of 20,000
  entries too, on empty columns and with nothing kept; the JAX
  ``gap5_scores_device`` (f32, on its CPU backend) agrees with it within
  2^-20 of each column's sum of |contributions|;
* the host library's ``nm_init_batch`` equals the JAX host library's and
  the port's own per-read Python ``nm_init``;
* the scalar engine (``SAMTPU_CONSENSUS_VEC=0``) prints the vectorised
  engine's bytes on long insertions;
* the vectorised engine's insertion sites, all scored at once, equal the
  JAX package's per-site engine site by site;
* SAMTPU_SHARDS on an unindexed BAM (span workers that exit 3, then the
  serial run), the SAMTPU_CONSENSUS_SPAN worker protocol and CRAM input
  print the JAX tool's bytes; with SAMTPU_SHARDS unset or 1, an indexed
  BAM of two contigs (two spans) runs serially and starts no worker;
  without CUDA the command fails before any output."""

import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_tool_fixtures import (REPO, make_consensus_inputs, run_jax_tool,
                                 run_port_stdout)

from samtools_tpu.io import native as jnative
from samtools_tpu.ops import consensus_vec as JV
from samtools_tpu.tools import consensus_cmd as JC
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.io import native
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.ops import consensus_vec as V
from samtools_tpu_torch.tools import consensus_cmd as C
from samtools_tpu_torch.tools.index_cmd import main_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_consensus_inputs(str(tmp_path_factory.mktemp("cons_parts")))


def make_opts(mode=None):
    o = C.Opts()
    if mode is not None:
        o.mode = mode
    o.cp_recall = C.ConsProbs(o.P_het, o.P_indel, o.het_scale,
                              o.homopoly_redux * 10, o.qcal, o.mode)
    return o


def test_bit_tricks_equal_jax():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.random(2000) * 10.0 ** rng.integers(-300, 300,
                                                                2000),
                        [2.2250738585072014e-308, 1.0, 0.5, 1e-3]])
    y = np.concatenate([rng.uniform(-800, 800, 3000),
                        np.arange(-60, 61, 0.1)])
    for x in v[:400]:
        assert struct.pack("<d", C.fast_log2(x)) == \
            struct.pack("<d", JC.fast_log2(x))
        assert C.ph_log(x) == JC.ph_log(x)
    for x in y[:600]:
        assert C.fast_exp(x) == JC.fast_exp(x)
    assert np.array_equal(V.fast_log2_vec(v).view(np.uint64),
                          JV.fast_log2_vec(v).view(np.uint64))
    assert np.array_equal(V.ph_log_vec(v), JV.ph_log_vec(v))
    assert np.array_equal(V.fast_exp_vec(y), JV.fast_exp_vec(y))
    assert np.array_equal(V.fast_log2_vec(v), [C.fast_log2(x) for x in v])


@pytest.mark.parametrize("mode", [C.MODE_RECALL, C.MODE_BAYES_116])
def test_gap5_table_equals_jax(mode):
    o = make_opts(mode)
    jo = JC.Opts()
    jcp = JC.ConsProbs(jo.P_het, jo.P_indel, jo.het_scale,
                       jo.homopoly_redux * 10, jo.qcal, mode)
    T, JT = V.gap5_table9(o.cp_recall), JV.gap5_table9(jcp)
    assert T.shape == (6, 101, 101, 15)
    assert np.array_equal(T.view(np.uint64), JT.view(np.uint64))
    dev = V.segsum_table(o.cp_recall, torch.device("cpu"))
    assert torch.equal(dev[:, :15], torch.from_numpy(T.reshape(-1, 15)))
    assert not dev[:, 15].any()


def random_entries(rng, ncols, max_depth=40, deep=None):
    """Columns of random entries: (col_off, b6, q, q2, keep) through the
    port's entry_quals, and the same through the JAX package's."""
    depth = rng.integers(0, max_depth, ncols)
    if deep is not None:
        depth[ncols // 2] = deep
    col_off = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    n = int(col_off[-1])
    base4 = rng.choice([1, 2, 4, 8, 15, 16, 16], n)
    qual = rng.choice([0, 1, 5, 13, 30, 40, 93, 255], n)
    mapq = rng.integers(0, 61, n)
    nm = rng.integers(0, 300, n) / 10.0
    poly = rng.integers(0, 8, n)
    td = np.repeat(depth, depth)
    q0 = (rng.random(n) < 0.05) & (qual == 0)
    keep = (qual >= 0) & (rng.random(n) >= 0.05)
    opts = make_opts()
    got = V.entry_quals(qual, base4, mapq, nm, poly, td, opts, True, q0)
    jo = JC.Opts()
    jo.cp_recall = JC.ConsProbs(jo.P_het, jo.P_indel, jo.het_scale,
                                jo.homopoly_redux * 10, jo.qcal, jo.mode)
    want = JV.entry_quals(qual, base4, mapq, nm, poly, td, jo, True, q0)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    return opts, col_off, (*got, keep)


@pytest.mark.parametrize("seed", [21, 22])
def test_plain_k10_equals_gap5_scores_and_jax_device_scorer(seed):
    """K10's plain version gives gap5_scores' S, counts and depth bit for
    bit (f64, entry order), so the five output fields are the host
    branch's; the JAX device scorer's f32 sums are within 2^-20 of each
    column's sum of |contributions| of it, its counts and depth equal."""
    rng = np.random.default_rng(seed)
    opts, col_off, (b6, q, q2, keep) = random_entries(rng, 600)
    cp = opts.cp_recall
    S, counts, depth = V.gap5_scores_device(col_off, b6, q, q2, keep, cp,
                                            torch.device("cpu"))
    XS, xcounts, xdepth = V.gap5_scores(col_off, b6, q, q2, keep, cp)
    assert np.array_equal(S.view(np.uint64), XS.view(np.uint64))
    assert np.array_equal(counts, xcounts) and np.array_equal(depth, xdepth)
    for a, b in zip(V.gap5_finalize(S, counts, depth, cp),
                    V.gap5_finalize(XS, xcounts, xdepth, cp)):
        assert np.array_equal(a, b)
    jcp = JC.ConsProbs(opts.P_het, opts.P_indel, opts.het_scale,
                       opts.homopoly_redux * 10, opts.qcal, opts.mode)
    JS, jcounts, jdepth = JV.gap5_scores_device(col_off, b6, q, q2, keep,
                                                jcp)
    assert np.array_equal(counts, jcounts) and np.array_equal(depth, jdepth)
    T = np.abs(V.gap5_table9(cp))
    absc = np.zeros((col_off.size - 1, 15))
    np.add.at(absc, np.repeat(np.arange(col_off.size - 1),
                              np.diff(col_off)), T[b6, q, q2] * keep[:, None])
    assert (np.abs(S - JS) <= 2.0 ** -20 * absc).all()
    assert kernels.launches["consensus_segsum"] == 0


def test_plain_k10_on_a_20000_entry_column_equals_exact():
    """A column of 20,000 entries among ordinary ones, one-base and mixed:
    K10's plain version still gives gap5_scores' S bit for bit."""
    rng = np.random.default_rng(25)
    opts, col_off, (b6, q, q2, keep) = random_entries(rng, 200, deep=20000)
    lo, hi = col_off[100], col_off[101]
    assert hi - lo == 20000
    cp = opts.cp_recall
    for col in ("mixed", "read_like"):
        if col == "read_like":
            b6[lo:hi] = 2
            q[lo:hi] = rng.integers(20, 41, hi - lo)
            q2[lo:hi] = q[lo:hi]
            keep[lo:hi] = True
        S, counts, depth = V.gap5_scores_device(
            col_off, b6, q, q2, keep, cp, torch.device("cpu"))
        XS, xc, xd = V.gap5_scores(col_off, b6, q, q2, keep, cp)
        assert np.array_equal(S.view(np.uint64), XS.view(np.uint64)), col
        assert np.array_equal(counts, xc) and np.array_equal(depth, xd)


def test_plain_k10_empty_columns_and_nothing_kept():
    cp = make_opts().cp_recall
    col_off = np.array([0, 0, 3, 3, 5, 5], np.int64)
    b6 = np.array([0, 1, 5, 4, 2])
    q = np.array([30, 20, 10, 40, 1])
    for keep in (np.ones(5, bool), np.zeros(5, bool)):
        got = V.gap5_scores_device(col_off, b6, q, q.copy(), keep, cp,
                                   torch.device("cpu"))
        want = V.gap5_scores(col_off, b6, q, q.copy(), keep, cp)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert not got[0][[0, 2, 4]].any()
    assert not got[0].any() and not got[2].any()


def test_k10_checks_its_arguments():
    T = torch.zeros(6 * 101 * 101, 16, dtype=torch.float64)
    ent = torch.zeros(4, 4, dtype=torch.uint8)
    off = torch.tensor([0, 4])
    with pytest.raises(TypeError):
        V.consensus_segsum(T.float(), ent, off)
    with pytest.raises(ValueError):
        V.consensus_segsum(T[:, :15].contiguous(), ent, off)
    with pytest.raises(ValueError):
        V.consensus_segsum(T, ent[:, :3].contiguous(), off)


def _reads_flat(b):
    from samtools_tpu_torch.core import aux
    mds = [(v.encode() if isinstance(v, str) else b"")
           for v in aux.batch_tag_values(b, "MD")]
    md_off = np.concatenate([[0], np.cumsum([len(m) for m in mds])]
                            ).astype(np.int64)
    return np.frombuffer(b"".join(mds), np.uint8).copy(), md_off


@pytest.mark.parametrize("which", ["messy", "padins"])
@pytest.mark.parametrize("variant", ["default", "bayes116", "homopoly",
                                     "no_adj"])
def test_nm_init_batch_equals_jax_and_python(inputs, which, variant):
    b = read_alignments(inputs[which]).batch
    b = b.take(np.arange(min(b.n, 400)))
    md, md_off = _reads_flat(b)
    opts = make_opts(C.MODE_BAYES_116 if variant == "bayes116" else None)
    opts.homopoly_fix = 0.3 if variant == "homopoly" else 0.0
    opts.adj_qual = 0 if variant == "no_adj" else 1
    args = (b.seq, b.seq_off, b.cigar, b.cigar_off, md, md_off, 1,
            opts.adj_qual, 1 if variant == "bayes116" else 0,
            opts.homopoly_fix, opts.nm_halo, opts.sc_cost)
    nm, qual = native.nm_init_batch(b.qual.copy(), *args)
    if jnative.has_nm_init():
        jnm, jqual = jnative.nm_init_batch(b.qual.copy(), *args)
        assert np.array_equal(nm, jnm) and np.array_equal(qual, jqual)
    cl = type("cl", (), {"opts": opts})()
    for i in range(b.n):
        p = C.PRead(b, i)
        p.qual_arr = p.qual_arr.copy()
        C.nm_init(cl, p)
        s0, s1 = b.seq_off[i], b.seq_off[i + 1]
        want = np.asarray(p.cd, np.int64).astype(np.uint64).astype(np.int32)
        assert np.array_equal(nm[s0:s1], want), i
        assert np.array_equal(qual[s0:s1], p.qual_arr), i
    if variant == "homopoly":
        assert not np.array_equal(qual, b.qual)


def test_scalar_engine_equals_vectorised(inputs, monkeypatch):
    args = ["-a", "--show-del", "yes", inputs["longins"]]
    vec = run_port_stdout("consensus", args)
    monkeypatch.setenv("SAMTPU_CONSENSUS_VEC", "0")
    assert run_port_stdout("consensus", args) == vec


INS_SITE_CASES = {
    "longins": ([], "longins"),
    "longins_use_mq": (["--use-MQ", "--NM-halo", "20", "--SC-cost", "40",
                        "-m", "bayesian_m"], "longins"),
    "messy": (["-a", "--show-del", "yes"], "small"),
    "messy_bayesian_m": (["-m", "bayesian_m"], "small"),
}


@pytest.mark.parametrize("case", sorted(INS_SITE_CASES))
def test_insertion_sites_equal_jax_per_site_engine(inputs, monkeypatch,
                                                   case):
    """The port scores every insertion site of a window at once
    (``_ins_sites_vec``), the JAX package one site at a time
    (``_ins_columns_vec``): on the port's own window state, each site's
    sub-columns (nth, base, quality) are the JAX engine's."""
    args, bam = INS_SITE_CASES[case]
    batched = C._ins_sites_vec
    sites_seen = []

    def twin(opts, sub, p, sites, ins_by_col, qual_flat, nm_flat, rawq,
             so_ent, cps, use_mq):
        off, cb, cq = batched(opts, sub, p, sites, ins_by_col, qual_flat,
                              nm_flat, rawq, so_ent, cps, use_mq)
        for k, ci in enumerate(sites.tolist()):
            got = []
            monkeypatch.setattr(
                JC, "_fasta_emit",
                lambda c, tid, pos1, nth, b, q: got.append((nth, b, q)) or 0)
            assert JC._ins_columns_vec(opts, sub, p, ci, ins_by_col[ci],
                                       qual_flat, nm_flat, rawq, so_ent,
                                       cps, None, 0, 0, use_mq) == 0
            want = [(j - int(off[k]) + 1, int(cb[j]), int(cq[j]))
                    for j in range(int(off[k]), int(off[k + 1]))]
            assert got == want, (case, ci)
        sites_seen.append(sites.size)
        return off, cb, cq

    monkeypatch.setattr(C, "_ins_sites_vec", twin)
    run_port_stdout("consensus", [*args, inputs[bam]])
    assert sum(sites_seen) > 50, sites_seen


def test_shards_over_one_span_run_serially(inputs, monkeypatch):
    """SAMTPU_SHARDS=2 on a single contig under 1 Mi: the JAX tool's
    sharded run makes one span and runs serially, and so does the port."""
    monkeypatch.setenv("SAMTPU_SHARDS", "2")
    args = [inputs["small"]]
    assert run_port_stdout("consensus", args) == \
        run_jax_tool("consensus", args, "0")


# What ran "not ported yet" runs now, each case against the JAX tool.
# SAM is read (tests/test_torch_sam_input.py), and CRAM now: the
# "sam_input" cases run the CRAM fixture, whole and with -r (a whole-file
# filter, as in the JAX tool).  "shards": SAMTPU_SHARDS=2 on two contigs
# (two spans) of an unindexed BAM: the span workers exit 3 (no index) and
# the run is serial, as the JAX tool's.  "span_worker": the
# SAMTPU_CONSENSUS_SPAN worker protocol on an indexed BAM (the JAX index
# query reads its two BGZF blocks): the raw #SPANMETA records.
NOT_PORTED = {
    "shards": ("small2", {"SAMTPU_SHARDS": "2"}),
    "span_worker": ("indexed", {"SAMTPU_CONSENSUS_SPAN": "0:16000:21000"}),
    "sam_input": ("cram", {}),
    "sam_input_region": ("cram", {}),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_exits_1_with_one_line(inputs, monkeypatch, case):
    which, env = NOT_PORTED[case]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    extra = ["-r", "sim1:1-3000"] if case.endswith("region") else []
    if case == "span_worker":
        outs = [os.path.join(inputs["dir"], f"span_{k}.raw")
                for k in ("port", "jax")]
        assert cli.main(["consensus", "-o", outs[0], inputs[which]],
                        device="cpu") == 0
        run_jax_tool("consensus", ["-o", outs[1], inputs[which]], "0")
        mine, theirs = (open(o, "rb").read() for o in outs)
        assert mine == theirs
        assert mine.startswith(b"#SPANMETA 160") and mine.count(b"\n") == 3
        return
    args = [*extra, inputs[which]]
    port = run_port_stdout("consensus", args)
    assert port.count(b"\n") >= 2
    assert port == run_jax_tool("consensus", args, "0")
    if case == "shards":
        monkeypatch.delenv("SAMTPU_SHARDS")
        assert port == run_port_stdout("consensus", args)


@pytest.mark.parametrize("shards", [None, "1"])
def test_one_shard_starts_no_span_worker(inputs, tmp_path, monkeypatch,
                                         shards):
    """SAMTPU_SHARDS unset or 1 on an indexed BAM of two contigs: one
    span a contig, but the JAX tool runs span workers only for more than
    one shard, so the run is serial there and here, and starts no
    worker."""
    if shards is None:
        monkeypatch.delenv("SAMTPU_SHARDS", raising=False)
    else:
        monkeypatch.setenv("SAMTPU_SHARDS", shards)
    bam = str(tmp_path / "small2.bam")
    shutil.copy(inputs["small2"], bam)
    assert main_index([bam]) == 0

    def no_workers(*a, **k):
        raise AssertionError("span workers started")
    monkeypatch.setattr(C, "run_span_workers", no_workers)
    port = run_port_stdout("consensus", [bam])
    assert port.count(b"\n") >= 2
    assert port == run_jax_tool("consensus", [bam], "0")


def test_consensus_without_cuda_fails_before_any_output(inputs):
    env = {k: v for k, v in os.environ.items() if k != "SAMTPU_DEVICE"}
    env["PYTHONPATH"] = REPO
    p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                        "consensus", inputs["small"]], capture_output=True,
                       env=env, cwd=REPO, timeout=300)
    assert p.returncode != 0
    assert p.stdout == b""
    assert b"CUDA" in p.stderr
