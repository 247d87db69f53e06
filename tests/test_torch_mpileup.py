"""``python -m samtools_tpu_torch mpileup`` against ``python -m samtools_tpu
mpileup``: the port on the CPU (the plain versions of its kernels) prints
the JAX tool's bytes, whichever engine the JAX tool runs, whatever the
window size; its ``--census-out`` equals the single-core f64 oracle
window by window; its chunk step's sparse qual deltas equal the JAX chunk
step's; the overflow path gives the same bytes; without CUDA the command
fails before it prints a row; under SAMTPU_SHARDS it runs serially where
the JAX tool does, and span workers where the JAX tool does, with its
bytes either way; on a CRAM it prints the JAX tool's bytes
(``--checkpoint``: tests/test_torch_mpileup_checkpoint.py; larger span
runs: tests/test_torch_sharded_tools.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_tool_fixtures import (REF_LEN, REPO, make_inputs, oracle_census,
                                 ref_codes, run_jax, run_port)

from samtools_tpu.ops import mpileup_device as jmd
from samtools_tpu_torch import kernels, sim
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader
from samtools_tpu_torch.ops import mpileup_device as md
from samtools_tpu_torch.tools import mpileup_cmd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("tool")))


@pytest.fixture(scope="module")
def jax_out(inputs):
    """The JAX tool's default output per BAM, device engine forced."""
    got = {}

    def get(which):
        if which not in got:
            got[which] = run_jax(["-f", inputs["fa"], inputs[which]], "1")
        return got[which]
    return get


def _census_equals_oracle(census_json, bam, ref):
    rec = json.load(open(census_json))
    cb, qb, nrec = oracle_census(bam, ref)
    assert sum(w["reads_starting"] for w in rec["windows"]) == nrec
    assert sum(w["reads"] for w in rec["windows"]) == rec["reads"] >= nrec
    for w in rec["windows"]:
        want = md.census_checksum(cb[w["beg"]:w["end"]].astype(np.int64),
                                  qb[w["beg"]:w["end"]])
        assert tuple(w["checksum"]) == want, w
    return rec


@pytest.mark.parametrize("which", ["messy", "pairs"])
def test_tool_equals_jax_tool(inputs, jax_out, which):
    bam, d = inputs[which], inputs["dir"]
    census = os.path.join(d, f"{which}.census.json")
    kernels.reset_launches()
    port = run_port(["-f", inputs["fa"], bam, "--census-out", census],
                    os.path.join(d, f"{which}.txt"))
    assert kernels.launches == {k: 0 for k in kernels.launches}
    assert port.count(b"\n") > REF_LEN // 2
    assert port == jax_out(which)
    assert port == run_jax(["-f", inputs["fa"], bam], "0")
    rec = _census_equals_oracle(census, bam, inputs["ref"])
    assert rec["device_windows"] == 1
    assert 0 < rec["host_reads"] < 0.12 * rec["reads"]
    if which == "pairs":
        # the overlap tweak changed the text
        assert port != run_port(["-x", "-f", inputs["fa"], bam],
                                os.path.join(d, "pairs_x.txt"))


@pytest.mark.parametrize("which", ["messy", "pairs"])
def test_tool_text_does_not_depend_on_window_size(inputs, jax_out,
                                                  monkeypatch, which):
    """16 Kbp windows (the JAX tool keeps 1 Mbp): halo reads carried across
    eight window edges, each window's census gated to its own columns."""
    monkeypatch.setattr(mpileup_cmd, "WINDOW_COLS", 1 << 14)
    bam, d = inputs[which], inputs["dir"]
    census = os.path.join(d, f"{which}.w16k.json")
    port = run_port(["-f", inputs["fa"], bam, "--census-out", census],
                    os.path.join(d, f"{which}.w16k.txt"))
    assert port == jax_out(which)
    rec = _census_equals_oracle(census, bam, inputs["ref"])
    assert rec["device_windows"] == len(rec["windows"]) == 8
    assert rec["reads"] > 0


def test_tool_overflow_path_keeps_bytes(inputs, jax_out, monkeypatch):
    """A sparse-delta capacity of 4 overflows on every chunk: each chunk's
    non-risky rows are fetched whole instead; the text is the same."""
    full = md.qual_deltas
    seen = []

    def tiny(appq, qq, cap):
        got = full(appq, qq, 4)
        seen.append(int(got[0]))
        return got
    monkeypatch.setattr(md, "qual_deltas", tiny)
    monkeypatch.setattr(md.DeviceCensusPipeline, "__init__",
                        _small_chunks(md.DeviceCensusPipeline.__init__))
    port = run_port(["-f", inputs["fa"], inputs["pairs"]],
                    os.path.join(inputs["dir"], "overflow.txt"))
    assert len(seen) > 1 and min(seen) > 4
    assert port == jax_out("pairs")


def _small_chunks(init):
    def wrapped(self, *a, **k):
        init(self, *a, **{**k, "chunk_reads": 2048})
    return wrapped


@pytest.mark.parametrize("messy", [False, True])
def test_chunk_deltas_equal_jax_chunk_step(messy):
    """The tool branch of one chunk of 512 reads: (dcount, didx, dval)
    against the JAX chunk step's (collect_quals), as sets over the rows
    neither flags risky.  BAQ changes ~0.5% of the clean reads' quals,
    under the capacity (1/16); on the messy reads ~24%, so both lists
    hold their first ``cap`` deltas only."""
    L = 1 << 14
    ref = sim.simulate_reference(L, seed=11)
    ref_int = ref_codes(ref)
    b = sim.simulate_batch(ref_len=L, coverage=4.0, read_len=100, seed=33,
                           paired=False, err_rate=0.01, ref=ref)
    if messy:
        sim.simulate_messy(b, 7)
    sel = np.arange(b.n)
    elig, lead, lref, cig8 = md.classify_reads(b, sel, 100, L)
    k = np.nonzero(elig)[0][:512]
    n = k.size
    pos = b.pos[k].astype(np.int64)
    pipe = md.DeviceCensusPipeline(ref_int, L, device="cpu", chunk_reads=n)
    seqm, qual = pipe._gather_rows(b, k)
    buf = pipe._make_buf(pos, lead[k], lref[k], cig8[k], seqm, qual, 0, n)
    lo, hi, wbeg, ntp = pipe._plan(pos)
    risky, appq, dcount, didx, dval = pipe._chunk_step(
        torch.from_numpy(buf), torch.from_numpy(lo), torch.from_numpy(hi),
        wbeg, ntp, 0, L, collect=True)

    jpipe = jmd.DeviceCensusPipeline(ref_int, L, chunk_reads=n)
    jbuf, pc = jpipe._make_buf(pos, lead[k], lref[k], cig8[k], seqm, qual,
                               0, n, n)
    jlo, jhi, jwbeg, jntp, B, passes = jpipe._plan(pc[:n], n, n)
    _, jrisky, jappq, jcount, jdidx, jdval = jmd._get_chunk_step()(
        jpipe.census_dev, jpipe.ref_dev, jax.device_put(jbuf), np.int32(n),
        jlo, jhi, jnp.int32(jwbeg), jnp.int32(0), jnp.int32(0),
        jnp.int32(L), 100, 100 + md.LREF_PAD, 7, jntp, B, 256, 16, passes,
        13, 1, True, False)
    cap = n * 100 // 16
    jdidx, jdval = np.asarray(jdidx), np.asarray(jdval)
    assert didx.numel() == jdidx.size == cap
    changed = (appq.numpy() != qual).reshape(-1)
    cnt, jcnt = int(dcount), int(jcount)
    assert cnt == changed.sum() and jcnt == (np.asarray(jappq) != qual).sum()
    assert (cnt > cap) == messy and (jcnt > cap) == messy
    # the list: the first changed quals in flat order, with their values
    c, jc = min(cnt, cap), min(jcnt, cap)
    assert np.array_equal(didx.numpy()[:c], np.nonzero(changed)[0][:c])
    assert np.array_equal(dval.numpy()[:c],
                          appq.reshape(-1).numpy()[didx.numpy()[:c]])
    if not messy:
        # past the count: index 0 and its qual, as the JAX fill
        assert not didx[c:].any() and bool((dval[c:] == appq[0, 0]).all())
    ok = ~(risky.numpy() | np.asarray(jrisky))
    assert ok.sum() > 0.9 * n
    lim = min(int(didx[c - 1]), int(jdidx[jc - 1]))

    def pairs(idx, val, m):
        idx, val = idx[:m], val[:m]
        keep = ok[idx // 100] & (idx <= lim)
        return set(zip(idx[keep].tolist(), val[keep].tolist()))
    mine = pairs(didx.numpy(), dval.numpy(), c)
    assert mine == pairs(jdidx, jdval, jc) and len(mine) > 100


def test_tool_without_cuda_fails_before_any_row(inputs):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                        "mpileup", "-f", inputs["fa"], inputs["messy"]],
                       capture_output=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode != 0
    assert p.stdout == b""
    assert b"CUDA" in p.stderr


# what ran "not ported yet" runs now: (extra arguments), each case against
# the JAX tool.  "shards": on one 128 kbp contig the JAX tool makes one
# span under SAMTPU_SHARDS=2 and runs serially, and so does the port;
# "shards_2mi": a 2 Mi contig, two spans, two span workers in both
# packages (the port's on the CPU), equal to the port's serial run too.
# SAM is read (tests/test_torch_sam_input.py) and CRAM too now: the
# "sam_input" cases run the CRAM fixture, whole and with -r (a whole-file
# filter, as in the JAX tool), and print the JAX tool's bytes.
NOT_PORTED = {
    "shards": [],
    "shards_2mi": [],
    "sam_input": [],
    "sam_input_region": ["-r", "sim1:1-50"],
}


def _on_2mi_contig(src: str, dst: str) -> None:
    """The first 50 reads of ``src`` under a header whose contig is 2 Mi
    long."""
    got = read_alignments(src)
    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{2 << 20}\n"
    write_bam(dst, SamHeader.from_text(text),
              got.batch.take(np.arange(50)))


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_exits_1_with_one_line(inputs, monkeypatch, case):
    bam = inputs["messy"]
    if case.startswith("shards"):
        monkeypatch.setenv("SAMTPU_SHARDS", "2")
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        # the JAX tool on one device, as the port runs on one card
        monkeypatch.setenv("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=1")
    if case == "shards":
        out = os.path.join(inputs["dir"], "shards.txt")
        port = run_port(["-f", inputs["fa"], bam], out)
        assert port.count(b"\n") > REF_LEN // 2
        assert port == run_jax(["-f", inputs["fa"], bam], "1")
        return
    if case == "shards_2mi":
        bam = os.path.join(inputs["dir"], "contig_2mi.bam")
        _on_2mi_contig(inputs["messy"], bam)
        args = ["-f", inputs["fa"], bam]
        port = run_port(args, os.path.join(inputs["dir"], "shards_2mi.txt"))
        assert port.count(b"\n") > 1000
        assert port == run_jax(args, "0")
        monkeypatch.delenv("SAMTPU_SHARDS")
        assert port == run_port(args, os.path.join(inputs["dir"],
                                                   "serial_2mi.txt"))
        return
    args = ["-f", inputs["fa"], inputs["cram"], *NOT_PORTED[case]]
    port = run_port(args, os.path.join(inputs["dir"], f"{case}.txt"))
    assert port.count(b"\n") > (40 if NOT_PORTED[case] else 2000)
    assert port == run_jax(args, "1")


def test_window_routes_quals_above_127_to_host():
    """K1's census form adds applied quals as int8 weights: a read with a
    qual above 127 goes to the host HMM, and the window's census still
    equals the host census of the same reads."""
    L = 1 << 14
    ref = sim.simulate_reference(L, seed=2)
    ref_int = ref_codes(ref)
    b = sim.simulate_batch(ref_len=L, coverage=3.0, read_len=100, seed=4,
                           paired=False, err_rate=0.01, ref=ref)
    b.qual[b.seq_off[5]:b.seq_off[6]] = 150
    want = b.take(np.arange(b.n))
    pipe = md.DeviceCensusPipeline(ref_int, L, device="cpu", chunk_reads=256)
    handle = pipe.begin_window(b, 0, L)
    assert 5 in handle[5] and 5 not in handle[1]
    pipe.finish_window(handle)
    host = md.DeviceCensusPipeline(ref_int, L, device="cpu")
    host._host_apply(want, np.arange(want.n), 0, L, 2)
    assert np.array_equal(b.qual, want.qual)
    assert pipe.finish_checksum() == md.census_checksum(host.host_census,
                                                        host.host_qsum)
