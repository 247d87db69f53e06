"""Inputs and runners shared by the port's tool tests
(tests/test_torch_mpileup*.py, tests/test_torch_depth.py,
tests/test_torch_coverage.py).

Two BAMs over one 128 kbp simulated contig (FASTA with 60-column lines):

* ``messy``: single-end 6x with indels and soft clips,
  ``tests/test_mpileup_device_tool.py::_messy_batch``, written by the JAX
  package;
* ``pairs``: 6x properly paired reads whose mates overlap (the port's
  ``sim.simulate_overlapping_pairs``, so the overlap tweak runs), two read
  groups (``RG:Z:grpA``/``grpB``), written by the port;

and ``cram``, the first 200 messy reads as CRAM (written by the JAX
package), the input the port does not read yet.

``make_general_inputs`` adds mpileup's general-path inputs (a BAM list,
reads with base-modification tags, reads with stored BQ / ZQ tags);
``make_pileup_inputs`` adds, for depth, coverage and bedcov: ``messy2``
(the messy reads under a header with a second, unused contig),
``indexed`` (the messy reads starting in [16000, 21000), with a
``.bai``; ``unindexed`` the same without), ``qualless`` (a 5 kbp
contig at 2x, one read stored without qualities), ``deep`` (a 20 kbp
contig at 6x with 400 reads piled at one position: over 16,384 items in
one tile, which takes several passes in the JAX plan) and a BED of 40
intervals.  ``make_consensus_inputs`` adds
consensus's: ``small`` (the messy reads starting before 40,000;
``small2`` the same under the two-contig header of ``messy2``;
``pairs_small`` the pairs starting there), ``padins`` (a 12 kbp contig at
8x whose reads carry insertions of 1-12 bases, some with a deletion or
pads beside them, pads alone in the first 4 kbp, and MD tags;
``longins`` the same reads without their pads) and a BED of regions.
``make_prep_inputs`` adds the inputs of
sort, merge, collate and fixmate, ``make_dup_inputs`` those of markdup,
rmdup, calmd and addreplacerg, ``make_fastq_inputs`` those of fastq,
fasta, import, reset, split, faidx, fqidx and dict, ``make_header_inputs``
those of reheader, samples, checksum and cram-size, ``make_md_inputs``
those of reference, ``make_padded_inputs`` those of depad and
``make_amplicon_inputs`` those of ampliconclip, ampliconstats,
plot-ampliconstats and plot-bamstats, ``make_misc_inputs`` those of
md5fa, md5sum-lite and seq_cache_populate, ``make_converter_inputs``
those of the aligner converters, fasta-sanitize, interpolate_sam and
ace2sam, and ``make_wgsim_inputs`` those of wgsim and wgsim_eval (their
docs; these commands run in both packages in-process:
``check_ancillary``).
``make_stats_inputs`` adds stats's: ``realloc`` (reads of 30-500 bases,
so the histograms grow past 300 cycles mid-file, with hard clips,
indels, every flag stats counts and NM tags: the JAX stats tests'
``_messy_sam``), ``unsorted`` (the same kind of reads at random
positions) and a targets file for ``-t``.

The JAX tool runs as ``python -m samtools_tpu <command>`` in a subprocess
on the JAX CPU backend; the port runs in-process through
``cli.main([...], device="cpu")``.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import struct
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from samtools_tpu_torch import cli, sim
from samtools_tpu_torch.core.batch import ReadBatch
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.io.files import read_alignments
from samtools_tpu_torch.io.header import SamHeader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LEN = 1 << 17


def write_fasta(path: str, ref: np.ndarray) -> None:
    s = ref.tobytes().decode()
    with open(path, "w") as f:
        f.write(">sim1\n")
        for i in range(0, len(s), 60):
            f.write(s[i:i + 60] + "\n")


def make_inputs(d: str) -> dict:
    from samtools_tpu.io.bam import write_bam as jwrite_bam
    from samtools_tpu.io.files import write_alignments as jwrite
    from samtools_tpu.sim import make_header as jmake_header
    from test_mpileup_device_tool import _messy_batch
    ref = sim.simulate_reference(REF_LEN, seed=7)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, ref)
    messy = os.path.join(d, "messy.bam")
    mb = _messy_batch(ref, REF_LEN)
    jwrite_bam(messy, jmake_header(REF_LEN), mb, threads=2)
    cram = os.path.join(d, "messy200.cram")
    jwrite(cram, jmake_header(REF_LEN), mb.take(np.arange(200)), fmt="cram",
           reference=fa)

    b = sim.simulate_overlapping_pairs(REF_LEN, coverage=6.0, ref=ref,
                                       seed=5)
    tags = [b"RGZgrpA\0", b"RGZgrpB\0"]
    pick = np.arange(b.n) % 3 == 0
    b.aux = np.frombuffer(b"".join(tags[int(k)] for k in pick), np.uint8)
    b.aux_off = np.concatenate([[0], np.cumsum([len(tags[int(k)])
                                                for k in pick])])
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{REF_LEN}\n"
            "@RG\tID:grpA\tSM:s1\n@RG\tID:grpB\tSM:s2\n")
    pairs = os.path.join(d, "pairs.bam")
    write_bam(pairs, SamHeader.from_text(text), b)
    return {"dir": d, "ref": ref, "fa": fa, "messy": messy, "pairs": pairs,
            "cram": cram}


def make_pileup_inputs(d: str) -> dict:
    """make_inputs plus the depth/coverage/bedcov inputs (module doc)."""
    from samtools_tpu.tools.index_cmd import main_index
    got = make_inputs(d)
    messy = read_alignments(got["messy"])
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{REF_LEN}\n"
            "@SQ\tSN:sim2\tLN:5000\n")
    got["messy2"] = os.path.join(d, "messy2.bam")
    write_bam(got["messy2"], SamHeader.from_text(text), messy.batch)
    # the JAX index query fails on BAMs of more than a few BGZF blocks
    # ("BAI chunk does not end on a record boundary"): two blocks here
    b = messy.batch
    got["indexed"] = os.path.join(d, "indexed.bam")
    write_bam(got["indexed"], messy.header,
              b.take(np.nonzero((b.pos >= 16000) & (b.pos < 21000))[0]))
    got["unindexed"] = os.path.join(d, "unindexed.bam")
    shutil.copy(got["indexed"], got["unindexed"])
    assert main_index([got["indexed"]]) == 0
    assert os.path.exists(got["indexed"] + ".bai")

    ref = sim.simulate_reference(5000, seed=11)
    b = sim.simulate_messy(sim.simulate_batch(
        ref_len=5000, coverage=2.0, paired=False, seed=12, ref=ref), 12)
    b.qual[b.seq_off[40]:b.seq_off[41]] = 0xFF
    got["qualless"] = os.path.join(d, "qualless.bam")
    write_bam(got["qualless"], sim.make_header(5000), b)

    ref = sim.simulate_reference(20000, seed=13)
    b = sim.simulate_messy(sim.simulate_batch(
        ref_len=20000, coverage=6.0, paired=False, seed=14, ref=ref), 14)
    mid = b.n // 2
    b.pos[mid:mid + 400] = b.pos[mid]
    got["deep"] = os.path.join(d, "deep.bam")
    write_bam(got["deep"], sim.make_header(20000), b)

    rng = np.random.default_rng(15)
    starts = np.sort(rng.integers(0, REF_LEN - 3000, 40))
    got["bed"] = os.path.join(d, "regions.bed")
    with open(got["bed"], "w") as f:
        for i, s0 in enumerate(starts):
            f.write(f"sim1\t{s0}\t{s0 + rng.integers(100, 3000)}\tr{i}\n")
    return got


def run_jax_tool(cmd: str, args: list[str], engine: str,
                 stdin: str | None = None) -> bytes:
    """stdout of ``python -m samtools_tpu <cmd>``; ``engine``:
    SAMTPU_DEVICE ("1" forces its device branch, "0" its host branch);
    ``stdin``: a file given as standard input."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SAMTPU_DEVICE=engine)
    with open(stdin or os.devnull, "rb") as fin:
        p = subprocess.run([sys.executable, "-m", "samtools_tpu", cmd]
                           + args, capture_output=True, env=env, cwd=REPO,
                           stdin=fin, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    return p.stdout


def run_jax(args: list[str], engine: str) -> bytes:
    """stdout of the JAX mpileup; ``engine``: SAMTPU_DEVICE ("1" forces
    its device engine, "0" the host HMM)."""
    return run_jax_tool("mpileup", args, engine)


def run_port(args: list[str], out: str) -> bytes:
    """The port's mpileup output file, run in-process on the CPU."""
    assert cli.main(["mpileup", *args, "-o", out], device="cpu") == 0
    with open(out, "rb") as f:
        return f.read()


def run_port_stdout(cmd: str, args: list[str], stdin: str | None = None,
                    device="cpu") -> bytes:
    """What the port's command writes to standard output, run in-process
    (``stdin``: a file given as standard input)."""
    buf = io.StringIO()
    old_in = sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.TextIOWrapper(open(stdin, "rb"))
        with contextlib.redirect_stdout(buf):
            rc = cli.main([cmd, *args], device=device)
    finally:
        if sys.stdin is not old_in:
            sys.stdin.close()
            sys.stdin = old_in
    assert rc == 0, rc
    return buf.getvalue().encode()


def ref_codes(ref: np.ndarray) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    return lut[ref]


def oracle_census(bam: str, ref: np.ndarray):
    """bench_baq_census (the single-core f64 BAQ + census) over a BAM."""
    from samtools_tpu_torch.io import bgzf, native
    from samtools_tpu_torch.io.bam import decode_header
    with open(bam, "rb") as f:
        body = bgzf.decompress(f.read())
    _, off = decode_header(body)
    return native.bench_baq_census(body[off:], 0, ref_codes(ref))


def _set_aux(b, blobs) -> None:
    """Give read i of ``b`` the aux bytes blobs[i]."""
    b.aux = np.frombuffer(b"".join(blobs), np.uint8).copy()
    b.aux_off = np.concatenate([[0], np.cumsum([len(x) for x in blobs])]
                               ).astype(np.int64)


def _mods_blob(rng, L: int) -> bytes:
    """MM/ML tags of one read: C+m (and sometimes C+h and A+a, a ChEBI
    code, or an ML array shorter than MM asks for)."""
    items, quals = [], []
    for base, codes in (("C", "m"), ("C", "mh"), ("A", "a"), ("T", "17802")):
        if rng.random() < 0.4:
            continue
        deltas = rng.integers(0, 4, int(rng.integers(1, 6)))
        items.append(f"{base}+{codes}{'.' if rng.random() < 0.3 else ''},"
                     + ",".join(str(int(x)) for x in deltas))
        ncodes = 1 if codes.isdigit() else len(codes)
        quals += rng.integers(0, 256, deltas.size * ncodes).tolist()
    if rng.random() < 0.2:
        quals = quals[:len(quals) // 2]
    mm = ("".join(it + ";" for it in items)).encode()
    ml = struct.pack("<I", len(quals)) + bytes(quals)
    return b"MMZ" + mm + b"\0" + b"MLBC" + ml


def make_general_inputs(d: str) -> dict:
    """make_pileup_inputs plus mpileup's general-path inputs: ``list``
    (a -b list of messy and pairs), ``mods`` (the messy reads starting in
    [30000, 36000) with MM/ML tags), and ``bq`` / ``zq`` (those starting
    in [40000, 43000), every other one with a stored BQ / ZQ tag, one
    with both)."""
    got = make_pileup_inputs(d)
    got["list"] = os.path.join(d, "bams.txt")
    with open(got["list"], "w") as f:
        f.write(f"{got['messy']}\n\n{got['pairs']}\n")
    messy = read_alignments(got["messy"])
    b = messy.batch
    rng = np.random.default_rng(17)
    mods = b.take(np.nonzero((b.pos >= 30000) & (b.pos < 36000))[0])
    _set_aux(mods, [_mods_blob(rng, int(n)) for n in mods.l_qseq])
    got["mods"] = os.path.join(d, "mods.bam")
    write_bam(got["mods"], messy.header, mods)
    for tag in ("BQ", "ZQ"):
        t = b.take(np.nonzero((b.pos >= 40000) & (b.pos < 43000))[0])
        blobs = []
        for i, n in enumerate(t.l_qseq):
            vals = bytes(rng.integers(64, 84, int(n)).astype(np.uint8))
            blob = tag.encode() + b"Z" + vals + b"\0" if i % 2 == 0 else b""
            if i == 4:
                blob += b"ZQZ" + vals + b"\0" if tag == "BQ" else b""
            blobs.append(blob + b"XYZx\0")
        _set_aux(t, blobs)
        got[tag.lower()] = os.path.join(d, f"{tag.lower()}.bam")
        write_bam(got[tag.lower()], messy.header, t)
    return got


def _cigar_batch(b, cigars: list[list[tuple[int, int]]]) -> None:
    """Give read i of ``b`` the cigar cigars[i], as (op, len) pairs."""
    flat = [(n << 4) | op for ops in cigars for op, n in ops]
    b.cigar = np.array(flat, np.uint32)
    b.cigar_off = np.concatenate([[0], np.cumsum([len(c) for c in cigars])]
                                 ).astype(np.int64)


def make_consensus_inputs(d: str) -> dict:
    """make_pileup_inputs plus consensus's inputs (module doc)."""
    got = make_pileup_inputs(d)
    messy = read_alignments(got["messy"])
    b = messy.batch
    small = b.take(np.nonzero(b.pos < 40000)[0])
    got["small"] = os.path.join(d, "small.bam")
    write_bam(got["small"], messy.header, small)
    got["small2"] = os.path.join(d, "small2.bam")
    write_bam(got["small2"], read_alignments(got["messy2"]).header, small)
    pairs = read_alignments(got["pairs"])
    b = pairs.batch
    got["pairs_small"] = os.path.join(d, "pairs_small.bam")
    write_bam(got["pairs_small"], pairs.header,
              b.take(np.nonzero(b.pos < 40000)[0]))

    L = 12000
    ref = sim.simulate_reference(L, seed=31)
    b = sim.simulate_batch(ref_len=L, coverage=8.0, paired=False, seed=32,
                           ref=ref)
    rng = np.random.default_rng(33)
    cigars, mds = [], []
    for i in range(b.n):
        n = int(b.l_qseq[i])
        k = int(rng.integers(1, 13))
        r = rng.random()
        pads = int(b.pos[i]) < 4000
        if r < 0.3:
            ops = [(0, 40), (1, k), (0, n - 40 - k)]
        elif r < 0.4:
            ops = [(0, 30), (1, k), (2, 2), (0, n - 30 - k)]
        elif r < 0.5 and pads:
            ops = [(0, 35), (1, k), (6, 2), (0, n - 35 - k)]
        elif r < 0.6 and pads:
            ops = [(0, 50), (6, 1), (0, n - 50)]
        elif r < 0.7:
            ops = [(4, 5), (0, n - 5 - k), (1, k)]
        else:
            ops = [(0, n)]
        cigars.append(ops)
        mds.append(f"{int(rng.integers(0, 40))}A{int(rng.integers(0, 30))}"
                   f"^C{int(rng.integers(0, 20))}".encode()
                   if rng.random() < 0.5 else None)
    _set_aux(b, [b"MDZ" + m + b"\0" if m else b"" for m in mds])
    # padins: with the pads; longins: the same reads without them (one
    # window of either: pads send the whole window to the scalar engine)
    for name, keep_pads in (("padins", True), ("longins", False)):
        _cigar_batch(b, [[(op, n) for op, n in ops if keep_pads or op != 6]
                         for ops in cigars])
        got[name] = os.path.join(d, f"{name}.bam")
        write_bam(got[name], sim.make_header(L), b)
    got["padins_fa"] = os.path.join(d, "padins.fa")
    with open(got["padins_fa"], "w") as f:
        f.write(">sim1\n" + ref.tobytes().decode() + "\n")

    got["cons_bed"] = os.path.join(d, "cons.bed")
    with open(got["cons_bed"], "w") as f:
        f.write("sim1\t30000\t36000\n#x\nsim1\t1000\t4500\n"
                "sim2\t10\t20\nsim1\t35000\t37000\n")
    return got


def check_consensus_case(inputs, extra: list[str], which: str,
                         monkeypatch) -> None:
    """consensus with arguments ``extra`` ({x}: an input of ``inputs``) on
    ``inputs[which]``: the port on the CPU prints the JAX tool's bytes on
    both of its branches (run side by side), launches no kernel, and its
    host branch (``SAMTPU_DEVICE=0``) prints the same."""
    from samtools_tpu_torch import kernels
    args = [a.format(**inputs) for a in extra] + [inputs[which]]
    kernels.reset_launches()
    mine = run_port_stdout("consensus", args)
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert mine.count(b"\n") > 1
    with ThreadPoolExecutor(2) as ex:
        dev, host = ex.map(lambda e: run_jax_tool("consensus", args, e),
                           ("1", "0"))
    assert mine == dev
    assert mine == host
    monkeypatch.setenv("SAMTPU_DEVICE", "0")
    assert run_port_stdout("consensus", args) == mine


def _sam_as_bam(sam: str, bam: str) -> None:
    """A SAM file written as BAM by the port's writer (read by the JAX
    package, which reads SAM text)."""
    from samtools_tpu.io.files import read_alignments as jread
    got = jread(sam)
    h = got.header
    write_bam(bam, SamHeader.from_text(h.text, h.ref_names, h.ref_lens),
              ReadBatch.from_columns(vars(got.batch)))


def make_stats_inputs(d: str) -> dict:
    """make_pileup_inputs plus stats's inputs (module doc)."""
    import pathlib

    from test_stats_batch import _messy_sam
    got = make_pileup_inputs(d)
    tmp = pathlib.Path(d)
    for name, seed, unsorted, long_reads in (("realloc", 2, False, True),
                                             ("unsorted", 3, True, False)):
        got[name] = os.path.join(d, f"{name}.bam")
        _sam_as_bam(_messy_sam(tmp, seed=seed, n=600, unsorted=unsorted,
                               long_reads=long_reads), got[name])
    got["targets"] = os.path.join(d, "targets.txt")
    with open(got["targets"], "w") as f:
        f.write("# name beg end\nsim1 1000 20000\nsim1 30000 30500\n"
                "sim1 60001 90000\n")
    return got


def check_stats_case(inputs, extra: list[str], which: str, monkeypatch,
                     scalar: bool = True, split: str | None = None) -> bytes:
    """stats with arguments ``extra`` ({x}: an input of ``inputs``) on
    ``inputs[which]``: the port on the CPU (K12's plain version) prints
    the JAX tool's bytes (its default host branch), launches no kernel,
    and so do its host branch (``SAMTPU_DEVICE=0``) and, with ``scalar``,
    its per-record path (``SAMTPU_STATS_SCALAR=1``).  ``split``: the
    ``-P`` prefix of a ``-S`` run, whose .bamstat files must be the JAX
    tool's too.  Returns the port's bytes."""
    import glob

    from samtools_tpu_torch import kernels

    def bamstats():
        got = {}
        for p in sorted(glob.glob(f"{split}_*.bamstat")):
            with open(p, "rb") as f:
                got[os.path.basename(p)] = f.read()
            os.remove(p)
        return got
    args = [a.format(**inputs) for a in extra] + [inputs[which]]
    want = run_jax_tool("stats", args, "0")
    want_files = bamstats() if split else None
    kernels.reset_launches()
    mine = run_port_stdout("stats", args)
    assert not any(kernels.launches.values())   # CPU tensors never count
    assert mine.count(b"\n") > 40
    assert mine == want
    if split:
        assert bamstats() == want_files and want_files
    envs = [("SAMTPU_DEVICE", "0")] + (
        [("SAMTPU_STATS_SCALAR", "1")] if scalar else [])
    for var, val in envs:
        with monkeypatch.context() as m:
            m.setenv(var, val)
            assert run_port_stdout("stats", args) == want, var
        if split:
            assert bamstats() == want_files, var
    return mine


def _prefix_qnames(b, prefix: bytes) -> None:
    """Put ``prefix`` before every qname of ``b``."""
    names = [prefix + bytes(b.qname[b.qname_off[i]:b.qname_off[i + 1]])
             for i in range(b.n)]
    b.qname = np.frombuffer(b"".join(names), np.uint8).copy()
    b.qname_off = np.concatenate([[0], np.cumsum([len(x) for x in names])]
                                 ).astype(np.int64)


def _edit_reads(b, hap: np.ndarray, rng) -> None:
    """Give about 17% of the reads of ``b`` (100 bp, one M op, drawn from
    ``hap``) an alignment event their bases agree with: a 3 bp insertion,
    a 2 bp deletion, an 8 bp leading soft clip, or a 200 bp ref skip."""
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.array([1, 2, 4, 8], np.uint8)
    kind = rng.random(b.n)
    cigars = []
    for i in range(b.n):
        p, s0, k = int(b.pos[i]), int(b.seq_off[i]), kind[i]
        a = 20 + int(rng.integers(0, 60))
        new = None
        if k < 0.05:
            ops = [(0, a), (1, 3), (0, 97 - a)]
            new = np.concatenate([hap[p:p + a], np.frombuffer(b"TAG", np.uint8),
                                  hap[p + a:p + 97]])
        elif k < 0.09 and p + 102 <= hap.size:
            ops = [(0, a), (2, 2), (0, 100 - a)]
            new = np.concatenate([hap[p:p + a], hap[p + a + 2:p + 102]])
        elif k < 0.15:
            ops = [(4, 8), (0, 92)]
            new = np.concatenate([np.frombuffer(b"GATTACAG", np.uint8),
                                  hap[p:p + 92]])
        elif k < 0.17 and p + 300 <= hap.size:
            ops = [(0, 50), (3, 200), (0, 50)]
            new = np.concatenate([hap[p:p + 50], hap[p + 250:p + 300]])
        else:
            ops = [(0, 100)]
        if new is not None:
            b.seq[s0:s0 + 100] = lut[new]
        cigars.append(ops)
    _cigar_batch(b, cigars)


def diploid_batch(ref: np.ndarray, islands, seed: int, het_gap: int = 1000,
                  dense=(), coverage: float = 30.0, edits: bool = False):
    """Reads of a diploid sample over ``islands`` ((beg, end) spans of
    ``ref``) at ``coverage``, 100 bp single-end, half from ``ref`` and
    half from a second haplotype that differs from it at seeded het SNPs:
    one every ``het_gap`` bases on average, and one every ``gap`` in each
    (beg, end, gap) of ``dense``.  With ``edits``, ``_edit_reads``' indels,
    clips and skips.  Qnames are distinct (``h<hap>i<island>_`` before the
    simulator's name); the reads are merged by position.  Returns (batch,
    the second haplotype)."""
    rng = np.random.default_rng(seed)
    L = ref.size
    het = [np.cumsum(rng.integers(het_gap // 2, 3 * het_gap // 2,
                                  L // (het_gap // 2) + 1))]
    for beg, end, gap in dense:
        d = beg + np.cumsum(rng.integers(gap // 2, 3 * gap // 2,
                                         (end - beg) // (gap // 2)))
        het.append(d[d < end])
    het = np.unique(np.concatenate(het))
    het = het[het < L]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    code = ref_codes(ref[het]).astype(np.int64)
    hap2 = ref.copy()
    hap2[het] = acgt[(code + rng.integers(1, 4, het.size)) % 4]
    parts = []
    for k, (beg, end) in enumerate(islands):
        for h, hap in enumerate((ref, hap2)):
            b = sim.simulate_batch(ref_len=end - beg, coverage=coverage / 2,
                                   paired=False, seed=seed * 100 + 2 * k + h,
                                   ref=np.ascontiguousarray(hap[beg:end]))
            b.pos = b.pos + beg
            if edits:
                _edit_reads(b, hap, rng)
            _prefix_qnames(b, b"h%di%d_" % (h, k))
            parts.append(b)
    b = ReadBatch.concat(parts)
    return b.take(np.argsort(b.pos, kind="stable")), hap2


DIP_LEN = 24000
DIP2_LEN = 8000


def make_diploid_inputs(d: str) -> dict:
    """The inputs of targetcut, phase and tview: ``dip``, a 24 kbp contig
    (sim1) with reads at 30x over two islands, [1000, 7000) and [12000,
    18000), of a diploid sample (``diploid_batch``): het SNPs every ~1
    kbp, every ~50 bp in [2000, 3000) and every ~8 bp in [3000, 3600);
    indels, soft clips and ref skips on about 17% of the reads; chimeric
    reads (hap 1 up to base 50, hap 2 after it: every third all-M read
    that starts in [3000, 3400), so phase masks and flips); mapq 0 on every
    40th read; read groups grpA (sample s1) and grpB (sample s2).  With
    it ``dip_fa`` (sim1), ``other_fa`` (a FASTA that lacks sim1),
    ``dip2`` (a second contig, sim2 of 8 kbp, whose reads come first in
    the file, then sim1's; header SO:unsorted) and ``dip2_fa`` (both
    contigs)."""
    ref = sim.simulate_reference(DIP_LEN, seed=41)
    b, hap2 = diploid_batch(ref, ((1000, 7000), (12000, 18000)), 42,
                            dense=((2000, 3000, 50), (3000, 3600, 8)),
                            edits=True)
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.array([1, 2, 4, 8], np.uint8)
    chim = np.nonzero((b.pos >= 3000) & (b.pos < 3400)
                      & (b.n_cigar == 1))[0][::3]
    for i in chim:
        p, s0 = int(b.pos[i]), int(b.seq_off[i])
        b.seq[s0 + 50:s0 + 100] = lut[hap2[p + 50:p + 100]]
    b.mapq[::40] = 0
    _set_aux(b, [(b"RGZgrpA\0", b"RGZgrpB\0")[i % 3 == 0]
                 for i in range(b.n)])
    rg = "@RG\tID:grpA\tSM:s1\n@RG\tID:grpB\tSM:s2\n"
    got = {"dir": d, "dip": os.path.join(d, "dip.bam"),
           "dip_fa": os.path.join(d, "dip.fa"),
           "other_fa": os.path.join(d, "other.fa"),
           "dip2": os.path.join(d, "dip2.bam"),
           "dip2_fa": os.path.join(d, "dip2.fa")}
    write_bam(got["dip"], SamHeader.from_text(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{DIP_LEN}\n" + rg), b)
    write_fasta(got["dip_fa"], ref)
    with open(got["other_fa"], "w") as f:
        f.write(">other\n" + ref[:5000].tobytes().decode() + "\n")
    ref2 = sim.simulate_reference(DIP2_LEN, seed=44)
    b2, _ = diploid_batch(ref2, ((500, 6500),), 45, het_gap=300)
    b2.tid[:] = 1
    _set_aux(b2, [b""] * b2.n)
    write_bam(got["dip2"], SamHeader.from_text(
        f"@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:sim1\tLN:{DIP_LEN}\n"
        f"@SQ\tSN:sim2\tLN:{DIP2_LEN}\n" + rg),
        ReadBatch.concat([b2, b]))
    with open(got["dip2_fa"], "w") as f:
        f.write(">sim1\n" + ref.tobytes().decode() + "\n>sim2\n"
                + ref2.tobytes().decode() + "\n")
    return got


def run_port_full(cmd: str, args: list[str], device="cpu"):
    """(exit code, standard output bytes, standard error text) of the
    port's command, run in-process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([cmd, *args], device=device)
    return rc, out.getvalue().encode(), err.getvalue()


def run_jax_full(cmd: str, args: list[str], env: dict | None = None):
    """(exit code, standard output bytes, standard error text) of ``python
    -m samtools_tpu <cmd>`` on its host branch, with ``env`` added to the
    environment (its SAMTPU_DEVICE picks another branch)."""
    full = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
            "SAMTPU_DEVICE": "0", **(env or {})}
    p = subprocess.run([sys.executable, "-m", "samtools_tpu", cmd] + args,
                       capture_output=True, env=full, cwd=REPO,
                       stdin=subprocess.DEVNULL, timeout=600)
    return p.returncode, p.stdout, p.stderr.decode()


def run_jax_cases(cmd: str, cases: dict, workers: int = 2) -> dict:
    """run_jax_full of ``cmd`` for each case of ``cases`` (name ->
    (arguments, env)), ``workers`` subprocesses at a time."""
    with ThreadPoolExecutor(workers) as ex:
        futs = {k: ex.submit(run_jax_full, cmd, a, e)
                for k, (a, e) in cases.items()}
        return {k: f.result() for k, f in futs.items()}


def check_no_card(cmd: str, args: list[str], monkeypatch) -> None:
    """The port's command with no card (``device=None`` on a host without
    CUDA, ``SAMTPU_DEVICE`` unset): exit 1, one ``no_card`` line, nothing
    on standard output."""
    import torch
    assert not torch.cuda.is_available()
    monkeypatch.delenv("SAMTPU_DEVICE", raising=False)
    rc, out, err = run_port_full(cmd, args, device=None)
    assert (rc, out) == (1, b"")
    assert err == (f"[{cmd}] CUDA is not available; pass device='cpu' to "
                   "run the plain PyTorch versions on the CPU "
                   "(SAMTPU_DEVICE=0 runs the host branch)\n")


VIEW_LEN2 = 5000
VIEW_TEXT = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{REF_LEN}\n"
             f"@SQ\tSN:sim2\tLN:{VIEW_LEN2}\n"
             "@RG\tID:grpA\tSM:s1\tLB:libA\n@RG\tID:grpB\tSM:s2\tLB:libB\n"
             "@RG\tID:grpC\tSM:s3\n@CO\tview inputs\n")
# f and d values whose %g text is tricky (no negative NaN: htslib's
# printf and Python's % print it differently, tests/test_torch_sam_text.py)
AUX_FLOATS = [0.0, -0.0, 1.5, 3.14159274, 1e-5, 2.5e-8, 123456789.0, 1e20,
              -7.25, float("nan"), float("inf"), float("-inf")]


def aux_blob(rng) -> bytes:
    """A random pick of aux fields of every BAM type, B arrays of every
    subtype (empty ones too)."""
    out = []
    if rng.random() < 0.5:
        out.append(b"XAA" + bytes([int(rng.integers(33, 127))]))
    for t, fmt, lo, hi in (("c", "<b", -128, 128), ("C", "<B", 0, 256),
                           ("s", "<h", -32768, 32768), ("S", "<H", 0, 65536),
                           ("i", "<i", -2 ** 31, 2 ** 31),
                           ("I", "<I", 0, 2 ** 32)):
        if rng.random() < 0.4:
            out.append(b"X" + t.encode() + t.encode()
                       + struct.pack(fmt, int(rng.integers(lo, hi))))
    if rng.random() < 0.4:
        out.append(b"XFf" + struct.pack("<f", AUX_FLOATS[
            int(rng.integers(len(AUX_FLOATS)))]))
    if rng.random() < 0.3:
        out.append(b"XDd" + struct.pack("<d", AUX_FLOATS[
            int(rng.integers(len(AUX_FLOATS)))] * 1.1))
    if rng.random() < 0.5:
        out.append(b"XZZ" + b"a b;c=%d" % int(rng.integers(100)) + b"\0")
    if rng.random() < 0.3:
        out.append(b"XHH" + b"1AE3%02X" % int(rng.integers(256)) + b"\0")
    for sub, fmt, lo, hi in (("c", "b", -128, 128), ("C", "B", 0, 256),
                             ("s", "h", -32768, 32768),
                             ("S", "H", 0, 65536),
                             ("i", "i", -2 ** 31, 2 ** 31),
                             ("I", "I", 0, 2 ** 32), ("f", "f", 0, 1)):
        if rng.random() < 0.25:
            k = int(rng.integers(0, 5))
            vals = ([AUX_FLOATS[int(x)] for x in
                     rng.integers(len(AUX_FLOATS), size=k)] if sub == "f"
                    else [int(x) for x in rng.integers(lo, hi, k)])
            out.append(b"B" + sub.encode() + b"B" + sub.encode()
                       + struct.pack("<I", k)
                       + struct.pack("<%d%s" % (k, fmt), *vals))
    if rng.random() < 0.5:
        out.append(b"NMC" + bytes([int(rng.integers(0, 6))]))
    return b"".join(out)


def _view_batch(ref: np.ndarray) -> ReadBatch:
    """The view inputs' reads (make_view_inputs)."""
    b = sim.simulate_overlapping_pairs(REF_LEN, coverage=6.0, ref=ref,
                                       seed=41)
    b = b.take(np.nonzero(b.pos < 40000)[0])
    rng = np.random.default_rng(43)
    n = b.n
    rgs = [b"grpA", b"grpB", b"grpC", None]
    blobs = []
    for i in range(n):
        rg = rgs[int(rng.choice(4, p=[0.45, 0.45, 0.05, 0.05]))]
        blobs.append((b"RGZ" + rg + b"\0" if rg else b"") + aux_blob(rng))
    _set_aux(b, blobs)
    b.mapq = rng.integers(0, 61, n).astype(np.uint8)
    # records without qualities, one without a sequence
    for i in rng.choice(n, 20, replace=False):
        b.qual[b.seq_off[i]:b.seq_off[i + 1]] = 0xFF
    # mates on the second contig
    far = rng.choice(n, 12, replace=False)
    b.mtid[far] = 1
    b.mpos[far] = rng.integers(0, VIEW_LEN2 - 200, far.size)
    b.tlen[far] = 0
    cig = [[(int(c) & 0xF, int(c) >> 4) for c in b.cigar_of(i)]
           for i in range(n)]
    for i in rng.choice(n, 15, replace=False):
        ln = int(b.l_qseq[i])
        cig[i] = [(5, 7), (0, ln)] if i % 2 else [(0, ln - 40), (9, 10),
                                                  (0, 40)]
    _cigar_batch(b, cig)
    # unmapped reads at the end, and one read with no sequence
    um = b.take(np.arange(10))
    um.tid[:] = -1
    um.pos[:] = -1
    um.mtid[:] = -1
    um.mpos[:] = -1
    um.tlen[:] = 0
    um.mapq[:] = 0
    um.flag = (um.flag & 0xC1) | 0x4 | 0x8
    _cigar_batch(um, [[] for _ in range(um.n)])
    out = ReadBatch.concat([b, um])
    k = 3
    keep = np.ones(out.seq.size, bool)
    keep[out.seq_off[k]:out.seq_off[k + 1]] = False
    ln = out.l_qseq.copy()
    ln[k] = 0
    out.seq, out.qual = out.seq[keep], out.qual[keep]
    out.seq_off = np.concatenate([[0], np.cumsum(ln)]).astype(np.int64)
    return out


def jbatch(b: ReadBatch):
    """A copy of a port batch as the JAX package's ReadBatch."""
    from samtools_tpu.core.batch import ReadBatch as JReadBatch
    return JReadBatch(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                         for k, v in vars(b).items()})


def make_view_inputs(d: str) -> dict:
    """make_inputs plus the view/head/cat/quickcheck inputs: ``general``
    (the pairs reads starting before 40,000, a 2-contig header with three
    read groups, two with a library, and a @CO line; each read with a
    random pick of aux fields of every type, random MAPQs, some without
    qualities, one without a sequence, mates on the second contig, hard
    clips, B ops, reads without a read group or in grpC, ten unmapped
    reads at the end; ``general_sam``, ``general_samgz`` (BGZF'd SAM) and
    ``general_cram``: its reads on sim1 without their ``d`` tags, as CRAM
3.0 with ``fa``), ``indexed`` (its
    reads starting in [16000, 21000), with a ``.bai``: a few BGZF blocks,
    as the JAX tool's index query needs), ``bigidx`` (``general`` indexed,
    many blocks) and ``unidx`` (an unindexed copy), a qname file, a
    read-group file, a tag-value file, BED files and a header SAM."""
    from samtools_tpu.io.files import write_alignments as jwrite
    from samtools_tpu.io.header import SamHeader as JSamHeader
    got = make_inputs(d)
    b = _view_batch(got["ref"])
    header = SamHeader.from_text(VIEW_TEXT)
    p = os.path.join
    got["general"] = p(d, "general.bam")
    write_bam(got["general"], header, b)
    jb = read_alignments(got["general"]).batch
    got["general_sam"] = p(d, "general.sam")
    jwrite(got["general_sam"], JSamHeader.from_text(VIEW_TEXT), jb)
    got["general_samgz"] = p(d, "general.sam.gz")
    jwrite(got["general_samgz"], JSamHeader.from_text(VIEW_TEXT), jb,
           fmt="sam.gz")
    # the CRAM writer has no ``d`` aux type (view -C of general fails)
    from samtools_tpu_torch.core.aux import batch_adjust_tags
    mapped = b.take(np.nonzero(b.tid == 0)[0])
    batch_adjust_tags(mapped, remove={"XD"})
    mapped = ReadBatch.from_columns(vars(mapped))
    got["general_cram"] = p(d, "general.cram")
    jwrite(got["general_cram"], JSamHeader.from_text(VIEW_TEXT), mapped,
           fmt="cram", reference=got["fa"])
    got["indexed"] = p(d, "indexed.bam")
    write_bam(got["indexed"], header,
              b.take(np.nonzero((b.pos >= 16000) & (b.pos < 21000))[0]))
    got["bigidx"] = p(d, "bigidx.bam")
    shutil.copy(got["general"], got["bigidx"])
    got["unidx"] = p(d, "unidx.bam")
    shutil.copy(got["general"], got["unidx"])
    for k in ("indexed", "bigidx"):
        assert cli.main(["index", got[k]]) == 0
    names = [b.qname_str(i) for i in range(0, b.n, 37)]
    for key, lines in (("qnames", names), ("rgfile", ["grpB", "grpC"]),
                       ("tagvals", ["0", "2", "5"])):
        got[key] = p(d, key + ".txt")
        with open(got[key], "w") as f:
            f.write("".join(x + "\n" for x in lines))
    got["bed"] = p(d, "view.bed")
    with open(got["bed"], "w") as f:
        f.write("sim1\t1000\t3000\nsim1\t17500\t18200\nsim2\t0\t100\n")
    got["bed2"] = p(d, "view2.bed")
    with open(got["bed2"], "w") as f:
        f.write("sim1\t16500\t17000\nsim1\t20000\t20400\n")
    got["hdr"] = p(d, "hdr.sam")
    with open(got["hdr"], "w") as f:
        f.write(VIEW_TEXT.replace("view inputs", "another header"))
    return got


def make_prep_inputs(d: str) -> dict:
    """make_view_inputs plus the inputs of sort, merge, collate and
    fixmate, each derived by the JAX package's commands in-process:
    ``ha``/``hb`` (``general`` coordinate-sorted, split at 20,000 on sim1,
    the unmapped reads in ``hb``; both carry the same @RG and @PG IDs;
    ``norg`` is ``ha`` under a header without its @RG lines),
    ``na``/``nb`` (the halves name-sorted), ``gname`` (``general``
    name-sorted), ``grouped`` (the pairs collated; ``grouped_sam`` the
    same as SAM, ``grouped_cram`` and ``grouped2k`` its first 2,000 reads
    as CRAM 3.0 on ``fa`` and as BAM), ``mc`` (``grouped`` through
    ``fixmate -m``, coordinate-sorted: reads with MC tags for
    ``--template-coordinate``), ``unplaced`` (the
    pairs, two reads in three unmapped, for ``sort -M``), ``broken``
    (``gname`` with the faults ``fixmate -z`` repairs, ``broken_batch``)
    and ``list`` (a file naming ``ha`` and ``hb``)."""
    from samtools_tpu.io.files import read_alignments as jread
    from samtools_tpu.io.files import write_alignments as jwrite
    from samtools_tpu.tools.collate_cmd import main_collate as jcollate
    from samtools_tpu.tools.fixmate_cmd import main_fixmate as jfixmate
    from samtools_tpu.tools.sort_cmd import main_sort as jsort
    got = make_view_inputs(d)
    p = os.path.join
    for k in ("gsorted", "ha", "hb", "na", "nb", "gname", "grouped",
              "grouped_sam", "grouped_cram", "mc", "unplaced"):
        got[k] = p(d, k + (".sam" if k.endswith("_sam") else ".cram"
                           if k.endswith("_cram") else ".bam"))
    fm = p(d, "fixmate.bam")
    for argv, run in ((["-o", got["gsorted"], got["general"]], jsort),
                      (["-n", "-o", got["gname"], got["general"]], jsort),
                      (["-o", got["grouped"], got["pairs"]], jcollate),
                      (["-m", got["grouped"], fm], jfixmate),
                      (["-o", got["mc"], fm], jsort)):
        assert run(argv) == 0, argv
    gs = jread(got["gsorted"])
    first = (gs.batch.tid == 0) & (gs.batch.pos < 20000)
    for k, m in (("ha", first), ("hb", ~first)):
        jwrite(got[k], gs.header, gs.batch.take(np.nonzero(m)[0]),
               fmt="bam")
    for k in ("a", "b"):
        assert jsort(["-n", "-o", got["n" + k], got["h" + k]]) == 0
    got["norg"] = p(d, "norg.bam")
    jwrite(got["norg"], gs.header.with_text("".join(
        ln + "\n" for ln in gs.header.lines() if not ln.startswith("@RG"))),
        gs.batch.take(np.nonzero(first)[0]), fmt="bam")
    grp = jread(got["grouped"])
    jwrite(got["grouped_sam"], grp.header, grp.batch)
    first = grp.batch.take(np.arange(2000))
    jwrite(got["grouped_cram"], grp.header, first, fmt="cram",
           reference=got["fa"])
    got["grouped2k"] = p(d, "grouped2k.bam")
    jwrite(got["grouped2k"], grp.header, first, fmt="bam")
    gn = read_alignments(got["gname"])
    got["broken"] = p(d, "broken.bam")
    write_bam(got["broken"], gn.header, broken_batch(gn.batch))
    pairs = jread(got["pairs"])
    b = pairs.batch
    um = np.arange(b.n) % 3 != 0
    b.tid[um] = -1
    b.pos[um] = -1
    b.flag[um] |= 0x4
    jwrite(got["unplaced"], pairs.header, b, fmt="bam")
    got["list"] = p(d, "list.txt")
    with open(got["list"], "w") as f:
        f.write(got["ha"] + "\n" + got["hb"] + "\n")
    return got


DUP_TILES = (1101, 1102, 2101)
DUP_UMIS = ("ACGTACGT", "TTGGCCAA")
DUP_BCS = (b"AAAACCCC", b"GGGGTTTT")
# the calmd inputs' FASTA: sim1's first MD_FA_LEN bases (the reads that
# start before MD_READS_END, some running past the slice's end)
MD_FA_LEN = 40000
MD_READS_END = 39950


def _rows(b: ReadBatch) -> list[dict]:
    """The records of ``b`` as one dict each (the fields _batch_of takes)."""
    return [{"name": b.qname_str(i), "flag": int(b.flag[i]),
             "tid": int(b.tid[i]), "pos": int(b.pos[i]),
             "mapq": int(b.mapq[i]),
             "cigar": [(int(c) & 0xF, int(c) >> 4) for c in b.cigar_of(i)],
             "mtid": int(b.mtid[i]), "mpos": int(b.mpos[i]),
             "tlen": int(b.tlen[i]), "seq": b.seq_of(i).copy(),
             "qual": b.qual_of(i).copy(), "aux": bytes(b.aux_of(i))}
            for i in range(b.n)]


def _batch_of(rows: list[dict]) -> ReadBatch:
    """A batch of the records ``rows`` (_rows's dicts), in order."""
    b = ReadBatch(n=len(rows))
    for k, dt in (("tid", np.int32), ("pos", np.int64), ("mapq", np.uint8),
                  ("flag", np.uint16), ("mtid", np.int32),
                  ("mpos", np.int64), ("tlen", np.int64)):
        setattr(b, k, np.array([r[k] for r in rows], dt))
    names = [r["name"].encode() for r in rows]
    b.qname = np.frombuffer(b"".join(names), np.uint8).copy()
    b.qname_off = np.concatenate([[0], np.cumsum([len(x) for x in names])]
                                 ).astype(np.int64)
    _cigar_batch(b, [r["cigar"] for r in rows])
    b.seq = np.concatenate([r["seq"] for r in rows]).astype(np.uint8)
    b.qual = np.concatenate([r["qual"] for r in rows]).astype(np.uint8)
    b.seq_off = np.concatenate([[0], np.cumsum([r["seq"].size
                                                for r in rows])]
                               ).astype(np.int64)
    _set_aux(b, [r["aux"] for r in rows])
    return b


def _cigar_text(cig) -> str:
    return "".join(f"{n}{'MIDNSHP=X'[op]}" for op, n in cig)


def _dup_templates(rows: list[dict], rng) -> list[dict]:
    """make_dup_inputs's records, name-grouped (its doc), from the
    collated pairs."""
    temps: list[list[dict]] = []
    for r in rows:
        if temps and temps[-1][0]["name"] == r["name"]:
            temps[-1].append(r)
        else:
            temps.append([r])
    out = []
    n_copy = 0

    def name(tile, x, y, umi):
        return f"SIM:1:FC1:1:{tile}:{x}:{y}" + (f":{umi}" if umi else "")

    for k, t in enumerate(temps):
        tile = int(rng.choice(DUP_TILES))
        x, y = (int(v) for v in rng.integers(1000, 40000, 2))
        umi = DUP_UMIS[int(rng.integers(2))] if rng.random() < 0.3 else None
        bc = DUP_BCS[int(rng.integers(2))]
        base = [dict(r, name="weird_name" if k == 3 else name(tile, x, y,
                                                                umi),
                     aux=r["aux"] + b"BCZ" + bc + b"\0") for r in t]
        if k % 97 == 5 and len(base) == 2:
            # the second mate unmapped, placed at the first's position
            r1, r2 = base
            r1["flag"] = (r1["flag"] | 0x8) & ~0x2
            r2.update(flag=(r2["flag"] | 0x4) & ~0x12, tid=r1["tid"],
                      pos=r1["pos"], cigar=[], mapq=0)
        group = [base]
        if k == 3 or rng.random() < 0.2:
            for c in range(1 + int(rng.integers(3))):
                n_copy += 1
                if k == 3 or rng.random() < 0.5:   # within -d 100
                    cname = name(tile, x + int(rng.integers(-90, 91)),
                                 y + int(rng.integers(-90, 91)), umi)
                else:
                    cname = name(int(rng.choice([t2 for t2 in DUP_TILES
                                                 if t2 != tile])),
                                 *(int(v) for v in
                                   rng.integers(1000, 40000, 2)), umi)
                if umi and n_copy % 3 == 0:
                    cname = cname[:-len(umi)] + DUP_UMIS[
                        1 - DUP_UMIS.index(umi)]
                cbc = DUP_BCS[1 - DUP_BCS.index(bc)] if n_copy % 4 == 0 \
                    else bc
                copy = []
                for r in base:
                    q = r["qual"].copy() if n_copy % 10 == 1 else \
                        np.maximum(r["qual"].astype(np.int64)
                                   - int(rng.integers(1, 8)), 2
                                   ).astype(np.uint8)
                    cr = dict(r, name=cname, qual=q, seq=r["seq"].copy(),
                              cigar=list(r["cigar"]),
                              aux=r["aux"].replace(b"BCZ" + bc,
                                                   b"BCZ" + cbc))
                    if n_copy % 8 == 0:
                        cr["flag"] |= 0x200
                    cig = cr["cigar"]
                    if n_copy % 5 == 0 and cr["flag"] & 0x10 and cig \
                            and cig[-1][0] == 0 and cig[-1][1] > 10:
                        # a soft clip at the 5' end of a reverse read
                        cr["cigar"] = cig[:-1] + [(0, cig[-1][1] - 6),
                                                  (4, 6)]
                    if n_copy % 6 == 0 and not cr["flag"] & 0x14 and cig \
                            and cig[0][0] == 0 and cig[0][1] > 10:
                        cr["cigar"] = [(4, 6), (0, cig[0][1] - 6)] + cig[1:]
                        cr["pos"] += 6
                    copy.append(cr)
                group.append(copy)
            if k % 3 == 0:
                # single-end copies of a read (the first, or the reverse
                # second): two with lower qualities, one within -d 100
                r = base[k % 2 * (len(base) - 1)]
                for j, dq in enumerate((3, 9)):
                    group.append([dict(
                        r, name=name(tile, x + 40 * j + 7, y + 11, umi),
                        flag=r["flag"] & 0x10, mtid=-1, mpos=-1, tlen=0,
                        qual=np.maximum(r["qual"].astype(np.int64) - dq, 2
                                        ).astype(np.uint8))])
            if k % 4 == 0 and len(base) == 2 and base[1]["cigar"]:
                # a supplementary alignment of each copy's first read
                for g in group:
                    if len(g) != 2:
                        continue
                    r = g[0]
                    L = int(r["seq"].size)
                    spos = (r["pos"] + 30011) % (REF_LEN - 400)
                    scig = [(4, 50), (0, L - 50)]
                    strand = "-" if r["flag"] & 0x10 else "+"
                    sa = (f"SAZsim1,{spos + 1},{strand},{_cigar_text(scig)},"
                          f"{r['mapq']},0;\0").encode()
                    sup = dict(r, flag=r["flag"] | 0x800, pos=spos,
                               cigar=scig,
                               aux=r["aux"] + (
                                   f"SAZsim1,{r['pos'] + 1},{strand},"
                                   f"{_cigar_text(r['cigar'])},{r['mapq']},"
                                   "0;\0").encode())
                    r["aux"] += sa
                    g.append(sup)
        for g in group:
            out.extend(g)
    return out


def make_dup_inputs(d: str) -> dict:
    """make_prep_inputs plus the inputs of markdup, rmdup, calmd and
    addreplacerg.  ``dup``: the collated pairs, each template renamed
    Illumina-style (``SIM:1:FC1:1:<tile>:<x>:<y>``, some with a UMI as an
    eighth field, one named ``weird_name``), with a ``BC`` tag, about one
    template in five copied under new names (copies within 90 pixels of
    their original, or on another tile; lower base qualities, one copy in
    ten tied on score; some QC-failed, with another UMI or barcode, a soft
    clip at a reverse read's 5' end or a forward read's start), single-end
    copies, supplementary records with ``SA`` tags, a few templates with
    an unmapped mate, two read groups with libraries; then ``fixmate -m``
    and ``sort`` by the JAX package's commands in-process, so ``MC`` and
    ``ms`` are right.  ``dup_sam`` is it as SAM, ``dup_name`` name-sorted,
    ``dup_nomc`` sorted without ``fixmate`` (no MC), ``dup_norg`` without
    its @RG lines, ``dup_grouped`` the
    name-grouped input (not in coordinate order), ``dup_marked`` through
    the JAX ``markdup -t -d 100`` (dup flags and dt/do tags for ``-c``).
    ``md`` (``dup``'s reads that start before 39,950, every 7th with a
    wrong NM, every 11th a wrong MD, every 19th with six mismatches more,
    one without a sequence) and ``md_fa``, sim1's first 40,000 bases (its
    second half in lower case), so the last reads run past its end;
    ``md_small`` 300 reads of ``md`` without soft clips or insertions,
    ``md_clipped`` its first 300; ``md_nmz`` its first 200, every 5th
    with an NM stored as a string; ``md_missing`` 200 of them under a
    header with a second contig, 50 moved onto it, which ``md_fa`` lacks;
    ``headerless``, SAM records without a header."""
    from samtools_tpu.tools.fixmate_cmd import main_fixmate as jfixmate
    from samtools_tpu.tools.markdup_cmd import main_markdup as jmarkdup
    from samtools_tpu.tools.sort_cmd import main_sort as jsort
    got = make_prep_inputs(d)
    p = os.path.join
    grp = read_alignments(got["grouped"])
    text = grp.header.text.replace("SM:s1", "SM:s1\tLB:libA").replace(
        "SM:s2", "SM:s2\tLB:libB")
    header = SamHeader.from_text(text)
    rows = _dup_templates(_rows(grp.batch), np.random.default_rng(19))
    got["dup_grouped"] = p(d, "dup_grouped.bam")
    write_bam(got["dup_grouped"], header, _batch_of(rows))
    for k in ("dup", "dup_name", "dup_nomc", "dup_marked"):
        got[k] = p(d, k + ".bam")
    fm = p(d, "dup_fm.bam")
    for argv, run in ((["-m", got["dup_grouped"], fm], jfixmate),
                      (["-o", got["dup"], fm], jsort),
                      (["-n", "-o", got["dup_name"], got["dup"]], jsort),
                      (["-o", got["dup_nomc"], got["dup_grouped"]], jsort),
                      (["-t", "-d", "100", got["dup"], got["dup_marked"]],
                       jmarkdup)):
        assert run(argv) == 0, argv
    dup = read_alignments(got["dup"])
    got["dup_norg"] = p(d, "dup_norg.bam")
    write_bam(got["dup_norg"], dup.header.with_text("".join(
        ln + "\n" for ln in dup.header.lines() if not ln.startswith("@RG"))),
        dup.batch)
    got["dup_sam"] = p(d, "dup.sam")
    with open(got["dup_sam"], "wb") as f:
        f.write(subprocess.run(
            [sys.executable, "-m", "samtools_tpu_torch", "view", "-h",
             got["dup"]], capture_output=True, check=True,
            cwd=REPO).stdout)
    got["headerless"] = p(d, "headerless.sam")
    with open(got["headerless"], "wb") as f:
        f.write(subprocess.run(
            [sys.executable, "-m", "samtools_tpu_torch", "view",
             got["dup"]], capture_output=True, check=True,
            cwd=REPO).stdout)
    # calmd's inputs
    ref = got["ref"]
    got["md_fa"] = p(d, "md.fa")
    half = MD_FA_LEN // 2
    with open(got["md_fa"], "w") as f:
        f.write(">sim1\n" + ref[:half].tobytes().decode() + "\n"
                + ref[half:MD_FA_LEN].tobytes().decode().lower() + "\n")
    rows = _rows(dup.batch.take(np.nonzero(
        (dup.batch.tid == 0) & (dup.batch.pos < MD_READS_END))[0]))
    for i, r in enumerate(rows):
        if i % 7 == 0:
            r["aux"] += b"NMC\x63"
        if i % 11 == 0:
            r["aux"] += b"MDZ10A5\0"
        if i % 19 == 0 and r["seq"].size > 40:
            for j in range(5, 35, 5):
                r["seq"][j] = 1 if r["seq"][j] != 1 else 2
    rows[5].update(seq=np.empty(0, np.uint8), qual=np.empty(0, np.uint8),
                   cigar=[])
    md = _batch_of(rows)
    got["md"] = p(d, "md.bam")
    write_bam(got["md"], dup.header, md)
    # -r's HMM leaves the BQ bytes of soft-clipped and inserted bases
    # unclamped in both packages (ROADMAP Queue 3): md_small holds reads
    # without them, md_clipped the first 300 reads as they come
    plain = [i for i, r in enumerate(rows)
             if r["seq"].size and not {op for op, _ in r["cigar"]} & {1, 4}]
    got["md_small"] = p(d, "md_small.bam")
    write_bam(got["md_small"], dup.header, md.take(np.array(plain[:300])))
    got["md_clipped"] = p(d, "md_clipped.bam")
    write_bam(got["md_clipped"], dup.header, md.take(np.arange(300)))
    nmz = md.take(np.arange(200))
    _set_aux(nmz, [bytes(nmz.aux_of(i)) + (b"NMZ3\0" if i % 5 == 0 else b"")
                   for i in range(nmz.n)])
    got["md_nmz"] = p(d, "md_nmz.bam")
    write_bam(got["md_nmz"], dup.header, nmz)
    two = SamHeader.from_text(dup.header.text.replace(
        f"@SQ\tSN:sim1\tLN:{REF_LEN}\n",
        f"@SQ\tSN:sim1\tLN:{REF_LEN}\n@SQ\tSN:sim2\tLN:5000\n"))
    m = md.take(np.arange(200))
    m.tid[150:] = 1
    m.pos[150:] = np.minimum(m.pos[150:], 4800)
    m.mtid[150:] = 1
    got["md_missing"] = p(d, "md_missing.bam")
    write_bam(got["md_missing"], two, m)
    return got


def broken_batch(b: ReadBatch) -> ReadBatch:
    """A copy of ``b`` with what ``fixmate -z`` repairs, on every seventh
    read from the second on, in turn: unmapped reads that keep a cigar,
    a MAPQ and NM tags; reads running off the contig's end (the last
    ending in a deletion, a skip and a hard clip); a position but no
    contig; cigars with = and X ops, and with empty and repeated ops."""
    b = b.take(np.arange(b.n))
    ln = b.l_qseq
    cig = [[(int(c) & 0xF, int(c) >> 4) for c in b.cigar_of(i)]
           for i in range(b.n)]
    blobs = [bytes(b.aux_of(i)) for i in range(b.n)]
    mapped = np.nonzero((b.tid == 0) & (ln >= 60))[0]
    for k, i in enumerate(mapped[1::7]):
        i, L = int(i), int(ln[i])
        kind = k % 6
        if kind == 0:
            b.flag[i] |= 0x4
            b.mapq[i] = 40
            blobs[i] += b"NMC\x02MDZ10A5\x00"
        elif kind == 1:
            b.pos[i] = REF_LEN - L // 2
        elif kind == 2:
            b.pos[i] = REF_LEN - 10
            cig[i] = [(0, L - 10), (2, 3), (3, 4), (4, 10), (5, 5)]
        elif kind == 3:
            b.tid[i] = -1
        elif kind == 4:
            cig[i] = [(7, 20), (8, 1), (7, L - 21)]
        else:
            cig[i] = [(0, 10), (0, 0), (0, L - 30), (1, 0), (4, 10),
                      (4, 10)]
    _cigar_batch(b, cig)
    _set_aux(b, blobs)
    return b


# the hand-made FASTA of make_fastq_inputs: (header line, sequence, line
# width, line end) a contig; an empty contig, a colon in a name,
# descriptions after names, lower case, CRLF line ends; the file's last
# line has no line end
FASTA_CONTIGS = (
    ("chr1 the first contig", "ACGTTGCAAC" * 23 + "ACG", 60, "\n"),
    ("chr2", ("ggatccTTAA" * 19)[:187], 70, "\n"),
    ("empty", "", 60, "\n"),
    ("HLA:01", "ACGTNNRYKMacgt" * 9, 50, "\n"),
    ("chrM\tmitochondrion", "GATTACA" * 31, 61, "\r\n"),
    ("MT", "CCGGA" * 40, 40, "\n"),
    ("chr3", "TTTAAACCCGGG" * 11, 33, "\n"),
)


def _fasta_text(contigs) -> str:
    out = []
    for hdr, seq, width, end in contigs:
        out.append(">" + hdr + end)
        out.extend(seq[i:i + width] + end for i in range(0, len(seq), width))
    return "".join(out)[:-1]  # the last line without its line end


def _tagged_batch(b: ReadBatch) -> ReadBatch:
    """The first 800 records of ``b`` with the tags fastq's and split's
    options read: OQ:Z on every third read (one shorter than its read),
    RX:Z UMIs on every fourth, OX:Z on every fifth, XN:i from -12 to 12
    and XC:c from -3 to 3 on all but every seventh, BC:Z with a '-' and a
    QT:Z of its length on every sixth, a BC of another length on every
    eleventh."""
    from samtools_tpu_torch.core.aux import delete_tags
    rows = _rows(b.take(np.arange(min(800, b.n))))
    for i, r in enumerate(rows):
        aux = r["aux"]
        L = r["qual"].size
        if i % 3 == 0 and L:
            oq = bytes(((r["qual"][::-1] % 40) + 33).astype(np.uint8))
            aux += b"OQZ" + (oq[:-1] if i % 9 == 0 else oq) + b"\0"
        if i % 4 == 0:
            aux += b"RXZ" + (b"ACGT-TTGA" if i % 8 else b"CCAA") + b"\0"
        if i % 5 == 0:
            aux += b"OXZGGTTCCAA\0"
        if i % 7:
            aux += b"XNi" + struct.pack("<i", i % 25 - 12)
            aux += b"XCc" + struct.pack("<b", i % 7 - 3)
        if i % 6 == 0 or i % 11 == 0:
            aux = bytes(delete_tags(np.frombuffer(aux, np.uint8),
                                    {"BC"}))
            aux += (b"BCZACGT-TTAA\0QTZ#&*+ ,-./\0" if i % 6 == 0
                    else b"BCZACGTTT\0")
        r["aux"] = aux
    return _batch_of(rows)


def make_fastq_inputs(d: str) -> dict:
    """make_dup_inputs plus the inputs of fastq, fasta, import, reset,
    split, faidx, fqidx and dict.  From the JAX ``fastq`` of
    ``dup_grouped``: ``fq1``/``fq2``/``fq0``/``fqs`` (``-1 -2 -0 -s``),
    ``fq_inter`` (``-N -o``: one file, /1 and /2 names), ``fq1_gz``/
    ``fq2_gz`` (BGZF, ``.fq.gz``) and ``fq1_gzip`` (``fq1`` through
    ``gzip``), ``cas1``/``cas2``/``cas_i1`` (``-i --index-format i4i4``
    with ``--i1``: CASAVA comments), ``tag1``/``tag2`` (``-T '*'``: aux
    fields in the comment), ``fa1``/``fa2`` (the JAX ``fasta``);
    ``multi_fq``, hand-made: multi-line records, UMIs at the end of the
    names, a CRLF record, a description; ``bad_fq`` (a record not
    starting with '@'), ``short_fq`` (a quality shorter than its
    sequence).  ``tagged``: ``dup_grouped``'s first 800 records with the
    tags of ``_tagged_batch``.  ``pgchain``: ``dup``'s first 500 reads
    under a header with three @PG chains.  ``slash_rg``: the same reads
    in a read group whose ID holds a '/'.  ``multi_fa``
    (``FASTA_CONTIGS``), ``multi_fa_gz`` (BGZF), ``multi_fa_gzip``
    (gzip), ``regions`` (a region file), ``alt`` (an alt-loci file for
    ``dict -l``) and ``empty`` (an empty file)."""
    import gzip

    from samtools_tpu.io import bgzf as jbgzf
    from samtools_tpu.tools.fastq_cmd import main_fastq as jfastq
    got = make_dup_inputs(d)
    p = os.path.join
    for k in ("fq1", "fq2", "fq0", "fqs", "fq_inter", "cas1", "cas2",
              "cas_i1", "tag1", "tag2", "fa1", "fa2", "multi_fq", "bad_fq",
              "short_fq"):
        got[k] = p(d, k + (".fa" if k.startswith("fa") else ".fq"))
    got["fq1_gz"], got["fq2_gz"] = p(d, "fq1b.fq.gz"), p(d, "fq2b.fq.gz")
    grouped = got["dup_grouped"]
    rest = ["-0", p(d, "rest.fq")]  # the reads of neither READ1 nor READ2
    with contextlib.redirect_stderr(io.StringIO()):
        for argv in (["-1", got["fq1"], "-2", got["fq2"], "-0", got["fq0"],
                      "-s", got["fqs"], grouped],
                     ["-N", "-o", got["fq_inter"], *rest, grouped],
                     ["-1", got["fq1_gz"], "-2", got["fq2_gz"], *rest,
                      grouped],
                     ["-i", "--index-format", "i4i4", "--i1",
                      got["cas_i1"], "-1", got["cas1"], "-2", got["cas2"],
                      *rest, grouped],
                     ["-T", "*", "-1", got["tag1"], "-2", got["tag2"],
                      *rest, grouped]):
            assert jfastq(argv) == 0, argv
        from samtools_tpu.tools.fastq_cmd import main_fasta as jfasta
        assert jfasta(["-1", got["fa1"], "-2", got["fa2"], *rest,
                       grouped]) == 0
    got["fq1_gzip"] = p(d, "fq1.fq.gzip")
    with open(got["fq1"], "rb") as f, open(got["fq1_gzip"], "wb") as g:
        g.write(gzip.compress(f.read(), mtime=0))
    with open(got["multi_fq"], "w", newline="") as f:
        f.write("@r1:ACGT+TTGA first read\nACGTACGTAC\nGTAC\n+\n"
                "IIIIIIIIII\nIIII\n"
                "@r2:NNNN\nACGT\n+r2:NNNN\n#%&(\n"
                "\n@r3:acgt+GGCC\tRG:Z:x\nAC\nGT\nAA\n+\nII\nI#\n!!\n"
                "@r4/1\r\nACGTTT\r\n+\r\nIIIII#\r\n"
                "@r5:ACGX\nAAA\n+\nIII\n")
    with open(got["bad_fq"], "w") as f:
        f.write("@a\nACGT\n+\nIIII\nxyz\nACGT\n+\nIIII\n")
    with open(got["short_fq"], "w") as f:
        f.write("@a\nACGT\n+\nIIII\n@b\nACGTAC\n+\nIII\n")
    dg = read_alignments(grouped)
    got["tagged"] = p(d, "tagged.bam")
    write_bam(got["tagged"], dg.header, _tagged_batch(dg.batch))
    dup = read_alignments(got["dup"])
    first = dup.batch.take(np.arange(500))
    text = dup.header.text + (
        "@PG\tID:bwa\tPN:bwa\tVN:0.7\n@PG\tID:pic\tPN:picard\tPP:bwa\n"
        "@PG\tID:gatk\tPN:gatk\n")
    got["pgchain"] = p(d, "pgchain.bam")
    write_bam(got["pgchain"], SamHeader.from_text(text), first)
    slash = first.take(np.arange(first.n))
    _set_aux(slash, [bytes(slash.aux_of(i)).replace(b"RGZgrpA\0",
                                                     b"RGZgrp/A\0")
                     for i in range(slash.n)])
    got["slash_rg"] = p(d, "slash_rg.bam")
    write_bam(got["slash_rg"], SamHeader.from_text(
        text.replace("ID:grpA", "ID:grp/A")), slash)
    fa_text = _fasta_text(FASTA_CONTIGS)
    got["multi_fa"] = p(d, "multi.fa")
    with open(got["multi_fa"], "w", newline="") as f:
        f.write(fa_text)
    got["multi_fa_gz"] = p(d, "multi.fa.gz")
    with open(got["multi_fa_gz"], "wb") as f:
        f.write(jbgzf.compress(fa_text.encode()))
    got["multi_fa_gzip"] = p(d, "multi.fa.gzip")
    with open(got["multi_fa_gzip"], "wb") as f:
        f.write(gzip.compress(fa_text.encode(), mtime=0))
    got["regions"] = p(d, "regions.txt")
    with open(got["regions"], "w") as f:
        f.write("chr1:5-80\n\nchr2\nHLA:01:3-20\nMT:190-999\nchr3:7\n"
                "{HLA:01}:1-4\nchrM:1,000-1,050\r\n")
    got["alt"] = p(d, "alt.txt")
    with open(got["alt"], "w") as f:
        f.write("@SQ\tSN:chr1\n#header\nchr2\t1\t2\n\nMT\n")
    got["empty"] = p(d, "empty.txt")
    open(got["empty"], "w").close()
    return got


def _checksum_report(path: str, args: list[str]) -> None:
    """The JAX ``checksum`` of ``args`` into ``path``, in-process."""
    from samtools_tpu.tools.checksum_cmd import main_checksum as jchecksum
    assert jchecksum(["-o", path] + args) == 0, args


def make_header_inputs(d: str) -> dict:
    """make_prep_inputs plus the inputs of reheader, samples, checksum and
    cram-size: ``grouped_cram31`` (``grouped_cram``'s reads as CRAM 3.1,
    by the JAX writer), ``hsplit`` (``general`` with its header in BGZF
    blocks of its own, so its first record starts a block), ``two_fa``
    (sim1 and a random sim2, the contigs of ``general``'s header),
    ``fa_list`` (``fa`` and ``two_fa``), ``names`` (``general`` and
    ``norg``, one a line), ``idx_pairs`` (``indexed`` and ``general``,
    each beside an index name, tab-separated) and checksum reports
    written by the JAX tool: ``chk_ha``/``chk_hb`` (default), ``chk_hb_B``
    (``-B``), ``chk_hb_tags`` (``-t BC,RG``, another tag set) and
    ``chk_hb_pcm`` (``-P -C -M``)."""
    from samtools_tpu.io.files import read_alignments as jread
    from samtools_tpu.io.files import write_alignments as jwrite
    from samtools_tpu_torch.io import bgzf
    from samtools_tpu_torch.io.bam import encode_header
    from samtools_tpu_torch.io.stream import BamStream
    got = make_prep_inputs(d)
    p = os.path.join
    grp = jread(got["grouped_cram"])
    got["grouped_cram31"] = p(d, "grouped31.cram")
    jwrite(got["grouped_cram31"], grp.header, grp.batch, fmt="cram",
           reference=got["fa"], fmt_opts={"version": "3.1"})
    with BamStream(got["general"]) as st:
        header, voff = st.header, st._hdr_voffset
    raw = bgzf.decompress(open(got["general"], "rb").read()).tobytes()
    hlen = len(encode_header(header))
    assert voff >> 16 == 0 and (voff & 0xFFFF) == hlen
    got["hsplit"] = p(d, "hsplit.bam")
    with open(got["hsplit"], "wb") as f:
        f.write(bgzf.compress(raw[:hlen], append_eof=False)
                + bgzf.compress(raw[hlen:]))
    got["two_fa"] = p(d, "two.fa")
    sim2 = sim.simulate_reference(VIEW_LEN2, seed=61).tobytes().decode()
    with open(got["fa"]) as f, open(got["two_fa"], "w") as g:
        g.write(f.read() + ">sim2\n" + "".join(
            sim2[i:i + 70] + "\n" for i in range(0, VIEW_LEN2, 70)))
    for key, lines in (("fa_list", [got["fa"], got["two_fa"]]),
                       ("names", [got["general"], got["norg"]]),
                       ("idx_pairs", [got["indexed"] + "\t"
                                      + got["indexed"] + ".bai",
                                      got["general"] + "\t"
                                      + got["general"] + ".bai"])):
        got[key] = p(d, key + ".txt")
        with open(got[key], "w") as f:
            f.write("".join(x + "\n" for x in lines))
    for key, args in (("chk_ha", [got["ha"]]), ("chk_hb", [got["hb"]]),
                      ("chk_hb_B", ["-B", got["hb"]]),
                      ("chk_hb_tags", ["-t", "BC,RG", got["hb"]]),
                      ("chk_hb_pcm", ["-P", "-C", "-M", got["hb"]])):
        got[key] = p(d, key + ".chk")
        _checksum_report(got[key], args)
    return got


MD_KEEP_END = 100000


def make_md_inputs(d: str) -> dict:
    """make_inputs plus the inputs of reference: ``md`` (the messy reads
    that start before MD_KEEP_END through the JAX ``calmd -b``, so they
    carry MD tags, every 7th without its MD, every 13th without NM;
    indels and soft clips from the messy reads) and ``md_sam`` (the same
    as SAM)."""
    from samtools_tpu.io.files import read_alignments as jread
    from samtools_tpu.io.files import write_alignments as jwrite
    got = make_inputs(d)
    p = os.path.join
    rc, out, err = run_jax_full("calmd", ["-b", got["messy"], got["fa"]])
    assert rc == 0, err
    full = p(d, "calmd.bam")
    with open(full, "wb") as f:
        f.write(out)
    f = jread(full)
    b = f.batch.take(np.nonzero(f.batch.pos < MD_KEEP_END)[0])
    from samtools_tpu_torch.core.aux import delete_tag
    blobs = []
    for i in range(b.n):
        buf = b.aux_of(i)
        if i % 7 == 3:
            buf = delete_tag(buf, b"MD")
        if i % 13 == 5:
            buf = delete_tag(buf, b"NM")
        blobs.append(bytes(buf))
    _set_aux(b, blobs)
    got["md"] = p(d, "md.bam")
    jwrite(got["md"], f.header, b, fmt="bam")
    got["md_sam"] = p(d, "md.sam")
    jwrite(got["md_sam"], f.header, b)
    return got


PAD_LENS = (6000, 2500)


def _fasta_of(path: str, seqs: dict, width: int = 60) -> None:
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(">" + name + "\n" + "".join(
                s[i:i + width] + "\n" for i in range(0, len(s), width)))


def make_padded_inputs(d: str) -> dict:
    """The inputs of depad, from simulated unpadded reads on two contigs
    (``pad1``, ``pad2``): overlapping pairs at 8x with the messy indels
    and soft clips, reverse second mates, mates of about one pair in
    twelve moved to the other contig, a hard clip on a few reads, some
    reads that open with an insertion (so they start on a pad column)
    and ten unmapped reads at the end.  ``sim.pad_reads`` pads the
    references and rewrites the CIGARs along them; one read that starts
    on a base after pad columns is moved back to open with a D over them.
    ``padded`` (coordinate-sorted BAM, @SQ lengths the padded ones),
    ``padded_fa`` (the padded references, ``*`` at the pads),
    ``padded_fa1`` (``pad1`` only), ``padded_emb`` (``padded`` with an
    embedded reference read at position 0 of each contig, named after
    it, M over bases and D over pads; ``padded_emb1`` the same with
    only ``pad1``'s read and the reads on ``pad1`` whose mates are not on
    ``pad2``, which depad takes without a FASTA), ``padded_bad`` (one
    read with an I op, which depad refuses), and ``unpadded`` (the reads
    before padding, for the positions and spans depad must give back)."""
    rng = np.random.default_rng(71)
    refs, parts = [], []
    for t, L in enumerate(PAD_LENS):
        ref = sim.simulate_reference(L, seed=72 + t)
        refs.append(ref)
        b = sim.simulate_overlapping_pairs(L, coverage=8.0, ref=ref,
                                           seed=74 + t)
        b.tid[:] = t
        b.mtid[:] = t
        _prefix_qnames(b, b"t%d_" % t)
        parts.append(b)
    b = ReadBatch.concat(parts)
    cig = [[(int(c) & 0xF, int(c) >> 4) for c in b.cigar_of(i)]
           for i in range(b.n)]
    for i in rng.choice(b.n, 12, replace=False):
        if cig[i][0][0] == 0 and cig[i][0][1] > 10:
            cig[i] = [(1, 2), (0, cig[i][0][1] - 2)] + cig[i][1:]
            b.pos[i] += 2
    for i in rng.choice(b.n, 6, replace=False):
        cig[i] = [(5, 4)] + cig[i]
    _cigar_batch(b, cig)
    far = rng.choice(b.n, b.n // 24, replace=False)
    b.mtid[far] = 1 - b.mtid[far]
    b.mpos[far] = rng.integers(0, 2000, far.size)
    b.tlen[far] = 0
    b = b.take(np.lexsort((b.pos, b.tid)))
    um = b.take(np.arange(10))
    um.tid[:] = -1
    um.pos[:] = -1
    um.mtid[:] = -1
    um.mpos[:] = -1
    um.tlen[:] = 0
    um.flag = (um.flag & 0xC1) | 0x4 | 0x8
    _cigar_batch(um, [[] for _ in range(um.n)])
    _prefix_qnames(um, b"u")
    unpadded = ReadBatch.concat([b, um])
    padded, pb = sim.pad_reads(refs, unpadded, seed=76)
    # one read that starts on a base after pad columns opens with a D
    # over them instead
    for i in range(pb.n):
        t, u = int(unpadded.tid[i]), int(unpadded.pos[i])
        c = pb.cigar_of(i)
        if t < 0 or u < 50 or not len(c) or (int(c[0]) & 0xF) != 0:
            continue
        k = int(pb.pos[i])
        g = 0
        while padded[t][k - g - 1] == ord("*"):
            g += 1
        if g:
            cig = [[(int(x) & 0xF, int(x) >> 4) for x in pb.cigar_of(j)]
                   for j in range(pb.n)]
            cig[i] = [(2, g)] + cig[i]
            pb.pos[i] -= g
            _cigar_batch(pb, cig)
            break
    names = ("pad1", "pad2")
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{len(s)}\n" for n, s in zip(names, padded))
        + "@CO\tpadded inputs\n")
    header = SamHeader.from_text(text)
    p = os.path.join
    got = {"dir": d, "refs": refs, "names": names}
    got["padded"] = p(d, "padded.bam")
    write_bam(got["padded"], header, pb)
    got["unpadded"] = unpadded
    seqs = {n: s.tobytes().decode() for n, s in zip(names, padded)}
    got["padded_fa"] = p(d, "padded.fa")
    _fasta_of(got["padded_fa"], seqs)
    got["padded_fa1"] = p(d, "padded1.fa")
    _fasta_of(got["padded_fa1"], {"pad1": seqs["pad1"]})
    # embedded reference reads: M over bases, D over pads
    emb = []
    for t, s in enumerate(padded):
        isbase = s != ord("*")
        edges = np.flatnonzero(np.diff(isbase.astype(np.int8))) + 1
        runs = np.diff(np.concatenate([[0], edges, [s.size]]))
        kinds = isbase[np.concatenate([[0], edges])]
        e = ReadBatch(n=1)
        e.tid = np.array([t], np.int32)
        e.pos = np.zeros(1, np.int64)
        e.mapq = np.zeros(1, np.uint8)
        e.flag = np.zeros(1, np.uint16)
        e.mtid = np.full(1, -1, np.int32)
        e.mpos = np.full(1, -1, np.int64)
        e.tlen = np.zeros(1, np.int64)
        e.qname = np.frombuffer(names[t].encode(), np.uint8).copy()
        e.qname_off = np.array([0, len(names[t])], np.int64)
        lut = np.zeros(256, np.uint8)
        lut[np.frombuffer(b"ACGT", np.uint8)] = [1, 2, 4, 8]
        e.seq = lut[s[isbase]]
        e.seq_off = np.array([0, e.seq.size], np.int64)
        e.qual = np.full(e.seq.size, 30, np.uint8)
        e.aux_off = np.zeros(2, np.int64)
        e.cigar = ((runs << 4) | np.where(kinds, 0, 2)).astype(np.uint32)
        e.cigar_off = np.array([0, runs.size], np.int64)
        emb.append(e)
    withemb = ReadBatch.concat(emb + [pb])
    order = np.lexsort((withemb.pos, np.where(withemb.tid < 0, 99,
                                              withemb.tid)))
    got["padded_emb"] = p(d, "padded_emb.bam")
    write_bam(got["padded_emb"], header, withemb.take(order))
    got["padded_emb1"] = p(d, "padded_emb1.bam")
    write_bam(got["padded_emb1"], header, ReadBatch.concat([emb[0], pb.take(
        np.flatnonzero((pb.tid == 0) & (pb.mtid != 1)))]))
    cig = [[(int(x) & 0xF, int(x) >> 4) for x in pb.cigar_of(j)]
           for j in range(pb.n)]
    j = int(np.flatnonzero(pb.tid == 1)[5])
    op, n = cig[j][0]
    cig[j][:1] = [(op, n - 1), (1, 1)]
    bad = pb.take(np.arange(pb.n))
    _cigar_batch(bad, cig)
    got["padded_bad"] = p(d, "padded_bad.bam")
    write_bam(got["padded_bad"], header, bad)
    return got


# the amplicon inputs: the ARTIC-shaped contig and a second, smaller
# panel contig
AMP_CONTIGS = (sim.ARTIC_CONTIG, ("panel2", 6000, 15))
AMP_READS = 2400
AMP_SAMPLE_READS = 1200


def make_amplicon_inputs(d: str) -> dict:
    """The inputs of ampliconclip, ampliconstats and the plot commands,
    from ``sim.amplicon_panel``: ``amp`` (2,400 reads over both contigs
    of AMP_CONTIGS, coordinate-sorted, written by the port) and
    ``primers`` (its BED, both contigs); ``s0``-``s3`` (four samples of
    1,200 reads on the ARTIC contig alone, read groups s0-s3; ``s0_sam``
    the first as SAM) and ``artic`` (their BED); ``clipped`` (``s0``
    through the port's ``ampliconclip --both-ends --strand`` and
    ``sort``); ``other`` (``s1`` under a header whose contig is a base
    longer); BEDs that ampliconclip or ampliconstats refuse or read
    otherwise: ``bed3`` (three columns), ``bad_strand`` (a ``.`` strand),
    ``short_row`` (a row of five columns), ``artic_only`` (the primers of
    the first contig, beside ``amp``'s reads on both); and the JAX tool's
    ``stats`` of ``amp`` (``stats``) and ``ampliconstats`` of the four
    samples (``astats``), the inputs of the plot commands."""
    from samtools_tpu_torch.io.files import write_alignments
    p = os.path.join
    got = {"dir": d}
    panel = sim.amplicon_panel(AMP_READS, 81, AMP_CONTIGS)
    got["amp"], got["primers"] = p(d, "amp.bam"), p(d, "primers.bed")
    write_bam(got["amp"], panel.header, panel.batch)
    with open(got["primers"], "w") as f:
        f.write(panel.bed)
    for k in range(4):
        s = sim.amplicon_panel(AMP_SAMPLE_READS, 90 + k, sample=f"s{k}")
        got[f"s{k}"] = p(d, f"s{k}.bam")
        write_bam(got[f"s{k}"], s.header, s.batch)
        if k == 0:
            got["s0_sam"] = p(d, "s0.sam")
            write_alignments(got["s0_sam"], s.header, s.batch)
        if k == 1:
            got["other"] = p(d, "other.bam")
            write_bam(got["other"], SamHeader.from_text(
                s.header.text.replace("LN:29903", "LN:29904")), s.batch)
    got["artic"] = p(d, "artic.bed")
    with open(got["artic"], "w") as f:
        f.write(s.bed)
    rows = panel.bed.splitlines(keepends=True)
    for key, text in (
            ("bed3", "".join("\t".join(r.split("\t")[:3]) + "\n"
                             for r in rows)),
            ("bad_strand", "".join(rows[:7]) + rows[7].replace("\t-\n",
                                                               "\t.\n")
             + "".join(rows[8:])),
            ("short_row", "".join(rows[:3]) + rows[3].rsplit("\t", 1)[0]
             + "\n" + "".join(rows[4:])),
            ("artic_only", "".join(r for r in rows
                                   if r.startswith("MN908947.3\t")))):
        got[key] = p(d, key + ".bed")
        with open(got[key], "w") as f:
            f.write(text)
    got["clipped"] = p(d, "clipped.bam")
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["ampliconclip", "--both-ends", "--strand", "-b",
                         got["artic"], "-o", p(d, "clip_unsorted.bam"),
                         got["s0"]]) == 0
        assert cli.main(["sort", "-o", got["clipped"],
                         p(d, "clip_unsorted.bam")]) == 0
    for key, cmd, args in (
            ("stats", "stats", [got["amp"]]),
            ("astats", "ampliconstats", [got["artic"]] + [
                got[f"s{k}"] for k in range(4)])):
        rc, out, _ = run_jax_full(cmd, args)
        assert rc == 0
        got[key] = p(d, key + ".txt")
        with open(got[key], "wb") as f:
            f.write(out)
    return got


# ------------------------------------------------ byte-for-byte tool runs
def take_files(odir: str) -> dict:
    """The files a run wrote into its directory (which is emptied)."""
    got = {}
    for name in sorted(os.listdir(odir)):
        with open(os.path.join(odir, name), "rb") as f:
            got[name] = f.read()
        os.remove(os.path.join(odir, name))
    return got


def case_dir(inputs: dict, cmd: str, name: str) -> str:
    odir = os.path.join(inputs["dir"], f"out_{cmd}_{name}")
    os.makedirs(odir, exist_ok=True)
    return odir


def _jax_bytes(cmd: str, args: list[str], stdin: str | None, env: dict):
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
    with open(stdin or os.devnull, "rb") as fin:
        p = subprocess.run([sys.executable, "-m", "samtools_tpu", cmd]
                           + args, capture_output=True, env=full, cwd=REPO,
                           stdin=fin, timeout=600)
    return p.returncode, p.stdout, p.stderr.decode()


def jax_case_runs(cmd: str, inputs: dict, cases: dict,
                  prepare=None, zlib_run: bool = True) -> dict:
    """Per case (name -> (argument template, standard input key)): the
    JAX tool's default run and its zlib run (``SAMTPU_NO_NATIVE=1``),
    each (exit code, stdout, stderr, {file: bytes}); {x} in a template
    names an input, {o} the case's output directory.  ``prepare(odir)``,
    when given, runs before each run (to copy in the inputs a command
    writes beside, such as a FASTA whose .fai faidx writes).  A command
    that writes no BGZF passes ``zlib_run=False``: its default run
    stands for both."""
    def phase(env):
        def one(name):
            odir = case_dir(inputs, cmd, name)
            if prepare is not None:
                prepare(odir)
            spec, stdin = cases[name]
            args = [a.format(o=odir, **inputs) for a in spec]
            rc, out, err = _jax_bytes(cmd, args, stdin and inputs[stdin],
                                      env)
            return rc, out, err, take_files(odir)
        with ThreadPoolExecutor(4) as ex:
            return dict(zip(cases, ex.map(one, cases)))
    default = phase({})
    plain = phase({"SAMTPU_NO_NATIVE": "1"}) if zlib_run else default
    return {k: (default[k], plain[k]) for k in cases}


def run_port_case(cmd: str, inputs: dict, cases: dict, name: str,
                  prepare=None):
    """(exit code, stdout bytes, stderr text, {file: bytes}) of the port's
    command in-process, run as jax_case_runs runs the JAX tool."""
    odir = case_dir(inputs, cmd, name)
    if prepare is not None:
        prepare(odir)
    spec, stdin = cases[name]
    args = [a.format(o=odir, **inputs) for a in spec]
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="latin-1", write_through=True)
    err = io.StringIO()
    old_in = sys.stdin
    try:
        if stdin:
            sys.stdin = io.TextIOWrapper(open(inputs[stdin], "rb"))
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main([cmd, *args])
    finally:
        if sys.stdin is not old_in:
            sys.stdin.close()
            sys.stdin = old_in
    return rc, raw.getvalue(), err.getvalue(), take_files(odir)


def _blocks(data: bytes):
    """(uncompressed size of each BGZF block, the uncompressed bytes)."""
    from samtools_tpu_torch.io import bgzf
    coffs, bsizes = bgzf.scan_blocks(data)
    sizes = [int.from_bytes(data[o + b - 4:o + b], "little")
             for o, b in zip(coffs.tolist(), bsizes.tolist())]
    return sizes, bgzf.decompress(data).tobytes()


def check_output(mine: bytes, default: bytes, plain: bytes, what: str):
    """The port's output against the JAX tool's default (libdeflate) and
    zlib outputs: BGZF must be the zlib run's bytes and the default run's
    blocks (uncompressed sizes and bytes); a gzip'd .crai the same
    content (gzip stamps the time); a BAI the zlib run's bytes (its
    virtual offsets are the zlib blocks'); anything else both runs'
    bytes."""
    from samtools_tpu_torch.io import bgzf
    if mine[:2] == b"\x1f\x8b" and bgzf.is_bgzf(mine):
        assert mine == plain, what
        assert _blocks(mine) == _blocks(default), what
    elif mine[:2] == b"\x1f\x8b":
        assert zlib.decompress(mine, 47) == zlib.decompress(default, 47), \
            what
    elif mine[:4] == b"BAI\1":
        assert mine == plain and len(mine) == len(default), what
    else:
        assert mine == plain == default, what


def check_case(got, want_pair, name: str) -> None:
    """A port run (run_port_case) against the JAX runs (jax_case_runs):
    the exit code and stderr, stdout and every file written."""
    (rc, out, err, files), (prc, pout, perr, pfiles) = want_pair
    assert (rc, err) == (prc, perr), name
    assert got[0] == rc, (name, got[2], err)
    assert got[2] == err, name
    check_output(got[1], out, pout, name)
    assert sorted(got[3]) == sorted(files) == sorted(pfiles), name
    for fname, data in got[3].items():
        check_output(data, files[fname], pfiles[fname], f"{name}/{fname}")


# ------------------------------------------- the ancillary commands, in-process
# wgsim, wgsim_eval, md5fa, md5sum-lite, seq_cache_populate, ace2sam, the
# aligner converters, fasta-sanitize and interpolate_sam import no JAX in
# either package, so both packages run them in this process: the JAX tool
# through its tools.run_command (what its cli.main dispatches to), the
# port through cli.main.  cli.main tunes the allocator first
# (core/malloc_tune.tune); run_inproc sets SAMTPU_MALLOC=0 for the call,
# unless the environment sets it, so that the pytest worker's allocator
# stays as it was (test_torch_cli.py runs tune() itself in subprocesses).


class TtyStdin(io.StringIO):
    """An empty standard input that is a terminal."""

    def isatty(self) -> bool:
        return True


def take_tree(odir: str) -> dict:
    """The files a run wrote under its directory, by path relative to
    it (subdirectories included; the directory is emptied)."""
    got = {}
    for root, _, names in os.walk(odir):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                got[os.path.relpath(path, odir)] = f.read()
    for name in os.listdir(odir):
        path = os.path.join(odir, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    return got


def run_inproc(pkg: str, cmd: str, argv: list[str], stdin=None):
    """(exit code, stdout bytes, stderr text) of ``cmd`` of ``pkg``
    ("jax" or "port") run in this process, on standard input ``stdin``
    (a path; "tty" for an empty terminal; None for an empty file).  An
    exception a process would die of gives exit code None and its type
    and message in place of stderr; SystemExit its code."""
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="latin-1", write_through=True)
    err = io.StringIO()
    old_in = sys.stdin
    sys.stdin = TtyStdin() if stdin == "tty" else io.TextIOWrapper(
        open(stdin or os.devnull, "rb"))
    untuned = "SAMTPU_MALLOC" not in os.environ
    if untuned:
        os.environ["SAMTPU_MALLOC"] = "0"
    died = None
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                if pkg == "jax":
                    from samtools_tpu.tools import run_command
                    rc = run_command(cmd, argv)
                else:
                    rc = cli.main([cmd, *argv])
            except SystemExit as e:
                rc = e.code
            except Exception as e:  # noqa: BLE001 - a process would die
                rc, died = None, f"{type(e).__name__}: {e}"
    finally:
        sys.stdin.close()
        sys.stdin = old_in
        if untuned:
            del os.environ["SAMTPU_MALLOC"]
    return rc, raw.getvalue(), died if died is not None else err.getvalue()


def ancillary_run(pkg: str, cmd: str, inputs: dict, cases: dict,
                  name: str):
    """(exit code, stdout, stderr, {file: bytes}) of one case of
    ``cases`` (name -> (argument template, standard input key or "tty"
    or None[, prepare(odir, inputs)])) run by ``pkg`` in the case's
    directory; {x} in a template names an input, {o} the case's output
    directory, whose files (subdirectories included) are taken."""
    spec, stdin, *prep = cases[name]
    odir = case_dir(inputs, cmd, name)
    take_tree(odir)
    if prep:
        prep[0](odir, inputs)
    args = [a.format(o=odir, **inputs) for a in spec]
    rc, out, err = run_inproc(pkg, cmd, args, stdin if stdin in (
        None, "tty") else inputs[stdin])
    return rc, out, err, take_tree(odir)


def mask_port(text):
    """The port's package name as the JAX package's, in str or bytes."""
    if isinstance(text, bytes):
        return text.replace(b"samtools_tpu_torch", b"samtools_tpu")
    return text.replace("samtools_tpu_torch", "samtools_tpu")


def check_ancillary(cmd: str, inputs: dict, cases: dict, name: str):
    """A case run by the JAX tool and then by the port: the same exit
    code, stdout, stderr (the package name masked) and files, byte for
    byte.  Returns the port's run."""
    want = ancillary_run("jax", cmd, inputs, cases, name)
    got = ancillary_run("port", cmd, inputs, cases, name)
    assert got[0] == want[0], (name, got[2], want[2])
    assert mask_port(got[2]) == want[2], name
    assert mask_port(got[1]) == want[1], name
    assert sorted(got[3]) == sorted(want[3]), name
    for fname, data in got[3].items():
        assert data == want[3][fname], (name, fname)
    return got


def _gz(path: str, data: bytes) -> str:
    import gzip
    with gzip.open(path, "wb") as f:
        f.write(data)
    return path


def _write(path: str, data) -> str:
    with open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return path


def _fasta_lines(name: str, seq: str, width: int = 60) -> str:
    return f">{name}\n" + "".join(seq[i:i + width] + "\n"
                                  for i in range(0, len(seq), width))


def make_misc_inputs(d: str) -> dict:
    """md5fa's, md5sum-lite's and seq_cache_populate's inputs: ``fa``
    (two contigs, lower case, IUPAC codes, spaces and a CR, a '*'), ``fq``
    (FASTQ records, one with a '+' line repeating the name), ``fa_gz``
    (``fa`` gzip'd), ``fa2`` (a contig that is also in ``fa``, an empty
    record) and ``bin`` (bytes of every value, for md5sum-lite)."""
    rng = np.random.default_rng(5)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    got = {"dir": d}
    s1 = "".join(rng.choice(list("ACGTacgtn"), 700))
    s2 = "".join(rng.choice(list("ACGTRYKMSWBDHVN"), 300))
    fa = (_fasta_lines("chr1 first contig", s1, 50)
          + ">chr2\tIUPAC\n" + s2[:100] + " " + s2[100:200] + "\r\n"
          + s2[200:] + "*\n")
    got["fa"] = _write(p("in.fa"), fa)
    got["fa_gz"] = _gz(p("in.fa.gz"), fa.encode())
    got["fa2"] = _write(p("two.fa"), _fasta_lines("again", s1[::-1])
                        + ">empty\n" + _fasta_lines("chr2", s2))
    reads = ["".join(rng.choice(list("ACGTN"), 36)) for _ in range(4)]
    got["fq"] = _write(p("in.fq"), "".join(
        f"@r{i}/1 x\n{r}\n+{'r%d' % i if i % 2 else ''}\n{'I' * 36}\n"
        for i, r in enumerate(reads)))
    got["bin"] = _write(p("bytes.bin"), bytes(range(256)) * 9000)
    return got


# the aligner outputs of the JAX package's converter tests
# (tests/test_converters.py), and more of each kind
BOWTIE = b"""\
read1/1\t+\tchr1\t100\tACGTACGT\tIIIIIIII\t0\t3:A>G
read1/1\t-\tchr1\t200\tACGTACGT\tIIIIIIII\t1\t1:C>T,5:G>A
read2\t+\tchr2\t50\tAAAA\tIIII\t2\t
read3\t-\tchr3\t75\tCCCCC\tHHHHH\t0\t0:T>C
"""
BOWTIE_MORE = b"""\
multi/1\t+\tchr1\t10\tACGTAC\tIIIIII\t1\t
multi/1\t+\tchr1\t40\tACGTAC\tIIIIII\t0\t2:a>c
multi/1\t-\tchr2\t90\tACGTAC\tIIIIII\t0\t
tie\t+\tchr1\t5\tGGGG\tIIII\t0\t1:A>G,2:C>T,3:G>N
tie\t+\tchr1\t15\tGGGG\tIIII\t0\t1:A>G,2:C>T,3:G>N
solo\t-\tchr9\t0\tTTTTTT\tABCDEF\t0\t
"""
PSL = b"""\
50\t2\t0\t0\t1\t3\t1\t5\t+\tquery1\t60\t2\t55\tchr1\t1000\t100\t160\t2\t30,20,\t2,35,\t100,135,
40\t1\t0\t0\t0\t0\t0\t0\t-\tquery2\t45\t0\t41\tchr2\t500\t200\t241\t1\t41,\t4,\t200,
"""
PSL_MORE = b"""\
psLayout version 3

match\tmis-\trep.\tN's\tQ gap\tQ gap\tT gap\tT gap\tstrand\tQ\tQ\tQ\tQ\tT\tT\tT\tT\tblock\tblockSizes\tqStarts\t tStarts
---------------------------------------------------------------------------------------------------------------------------------------------------------------
30\t9\t0\t0\t1\t2\t2\t9\t-\tquery3\t50\t1\t48\tchr1\t2000\t300\t359\t3\t10,15,14,\t2,14,34,\t300,315,345,
2\t40\t0\t0\t0\t0\t0\t0\t+\tquery4\t42\t0\t42\tchr3\t900\t10\t52\t1\t42,\t0,\t10,
"""
SOAP = b"""\
pair1/1\tACGTACGTAC\tIIIIIIIIII\t1\ta\t10\t+\tchr1\t101\t0
pair1/2\tGGGGACGTAC\tJJJJJJJJJJ\t1\tb\t10\t-\tchr1\t201\t2\tA->3\tC->7
solo1\tTTTTT\tHHHHH\t3\ta\t5\t+\tchr2\t55\t0
"""
SOAP_MORE = (b"p2/1\tACGTAC\tIIIIIIII\t1\ta\t6\t-\tchr2\t30\t1\tT->0\n"
             b"p2/2\tACGTAC\tIIIIII\t2\tb\t6\t+\tchr3\t90\t0\n"
             b"  leading\tAC\tII\t1\ta\t2\t+\tchr1\t1\t0\n"
             b"old/1\tACGTAC\tIIIIII\tx\t1\ta\t6\t+\tchr1\t7\t2\tG->4\t"
             b"A->1\n"
             b"short\tAC\tII\n"
             b"ctl\x01x\tAC\tII\t1\ta\t2\t+\tchr1\t9\t0 \x7f\n")
ZOOM = b"""\
rd1_F\tchr1:100\t+\t1
rd1_R\tchr1:300\t-\t0
solo_F\tchr2:50\t-\t2
"""
ZOOM_MORE = b"""\
plain\tchr3 x:7\t-\t0
pr_F\tchr1:10\t-\t0
pr_R\tchr2:20\t+\t3
"""
NOVO = b"""\
# comment line
@pair1/1\tL\tACGTACGTAC\tIIIIIIIIII\tU\t30\t20\t>chr1\t101\tF\t.\t.\t.
@pair1/2\tR\tGGGGACGTAC\tJJJJJJJJJJ\tU\t25\t28\t>chr1\t201\tR\t.\t.\t.\t3A>G
@solo\tL\tTTTTTGGGGG\tHHHHHHHHHH\tU\t40\t10\t>chr2\t55\tF\t.\t.\t.\t2+AC\t7A>C
@multi\tL\tAAAA\tIIII\tR\t9
"""
NOVO_MORE = b"""\
@del/1\tL\tACGTACGTACGT\tIIIIIIIIIIII\tU\t12\t12\t>chr3\t40\tF\t1\t>chr3\t80\t4-C\t5-G\t9T>A
@del/2\tR\tCCGTACGTACGT\tIIIIIIIIIIII\tU\t50\t7\t>chr3\t80\tR\t1\t>chr3\t40\t3+T
@qc\tL\tACGT\tIIII\tQC
@nm\tL\tACGT\tIIII\tNM
@ins\tL\tACGTACGTAC\tIIIIIIIIII\tU\t20\t30\t>chr4\t5\tF\t.\t.\t.\t1+GG\t6+T
"""


def export_line(machine, run, lane, tile, x, y, index, readno, seq,
                qual, chrom, contig, pos, strand, md, semap, pemap,
                passfilt):
    """One GERALD export record (tests/test_converters.py's
    ``_export_line``)."""
    f = [machine, run, str(lane), str(tile), str(x), str(y), index,
         str(readno), seq, qual, chrom, contig, str(pos), strand, md,
         semap, pemap, "", "", "", "", passfilt]
    return "\t".join(f)


EXPORT1 = "\n".join([
    export_line("M0", "5", 1, 2, 3, 4, "ACGT", 1, "ACGTACGT",
                "hhhhhhhh", "chr1", "", 100, "F", "8", "30", "40", "Y"),
    export_line("M0", "5", 1, 2, 3, 5, "", 1, "AAGTACGT", "hhhhhhhh",
                "chr1", "c2", 200, "R", "1A6", "25", "", "Y"),
    export_line("M0", "5", 1, 2, 3, 6, "", 1, "CCGTACGT", "hhhhhhhh",
                "NM", "", 0, "F", "", "", "", "Y"),
    export_line("M0", "5", 1, 2, 3, 7, "", 1, "GCGTACGT", "hhhhhhhh",
                "1:2:3", "", 0, "F", "", "", "", "Y"),
    export_line("M0", "5", 1, 2, 3, 8, "", 1, "TCGTACGT", "hhhhhhhh",
                "chr3", "", 300, "F", "2^AC$4", "12", "", "N"),
]) + "\n"

EXPORT2 = "\n".join([
    export_line("M0", "5", 1, 2, 3, 4, "ACGT", 2, "TTTTACGT",
                "hhhhhhhh", "chr1", "", 400, "R", "8", "31", "40", "Y"),
    export_line("M0", "5", 1, 2, 3, 5, "", 2, "GGGTACGT", "hhhhhhhh",
                "QC", "", 0, "F", "", "", "", "Y"),
    export_line("M0", "5", 1, 2, 3, 6, "", 2, "ACGTACGT", "hhhhhhhh",
                "chr2", "", 500, "F", "8", "20", "", "Y"),
    export_line("M0", "5", 1, 2, 3, 7, "", 2, "ACGAACGT", "hhhhhhhh",
                "chr4", "", 600, "F", "8", "22", "15", "Y"),
    export_line("M0", "5", 1, 2, 3, 8, "", 2, "ACGCACGT", "hhhhhhhh",
                "chr3", "", 700, "R", "3^2$3", "13", "", "N"),
]) + "\n"

BLAST = """\
BLASTN 2.2.26

Query= readA
fragment1
         (60 letters)

Database: ref.fa
           2 sequences; 12,000 total letters

>chr9
          Length = 5000

 Score = 95.6 bits (48), Expect = 2e-20
 Identities = 55/60 (91%)
 Strand=Plus/Plus

Query  1   ACGTACGTACGTACGTACGT-ACGTACGTA  29
           ||||||||||||||||||||  ||||||||
Sbjct  101 ACGTACGTACGTACGTACGTTACGTACGTA  130

Query  30  CCGTACGTACGTACGTACGTACGTACGTAC  59
           ||||||||||||||||||||||||||||||
Sbjct  131 CCGTACGTACGTACGTACGTACGTACGTAC  160


 Score = 40.1 bits (20), Expect = 3e-05
 Identities = 20/22 (90%)
 Strand=Plus/Minus

Query  5    ACGTACGTACGTACGTACGTAC  26
            ||||||||||||||||||||||
Sbjct  900  ACGTACGTACGT-CGTACGTAC  880

Query= readB
         (30 letters)

>chr2
          Length = 7000

 Score = 60.2 bits (30), Expect = 1e-10
 Strand=Plus/Plus

Query  3   ACGTACGTACGTACGTACGTACGTAC  28
           ||||||||||||||||||||||||||
Sbjct  55  ACGTACGTACGTACGTACGTACGTAC  80

"""
BLAST_MORE = """\
Query= readC
         (20 letters)

>chr4 another
          Length = 900

 Score = 30.0 bits (15), Expect(2) = e-04
 Strand=Plus/Plus

Query: 1   ACGTACGTAC--GTACGTAC  18
           ||||||||||  ||||||||
Sbjct: 10  ACGTACGTACAAGTACGTAC  29

"""
INTERP_SAM = "".join(
    "\t".join([name, str(fl), rn, str(pos), "30", cg, "*", "0", "0",
               "ACGT", "IIII"]) + "\n"
    for name, fl, rn, pos, cg in (
        ("r1", 0x43, "frag:1:2:3:40", 3, "10M"),
        ("r2", 0x53, "frag:1:2:3:40", 8, "6M2D4M"),
        ("r3", 0x0, "frag:1:2:3:40", 15, "12M"),
        ("r4", 0x63, "frag:1:2:3:40", 20, "5M"),
        ("r5", 0x93, "frag:1:2:3:40", 20, "3S4M1I2M"),
        ("r6", 0x1, "other:9:9:9:25", 2, "4M"),
        ("r7", 0xA3, "other:9:9:9:25", 6, "2M3N2M"),
        ("r8", 0x0, "short", 4, "3M")))


def maq_record(name, seq_bases, quals, size, map_qual, info1, info2, c0,
               c1, flag, alt_qual, seqid, pos, dist, last_byte=0) -> bytes:
    """One MAQ .map record as maq2sam.c reads it
    (tests/test_converters.py's ``_maq_map``)."""
    max_readlen = 64
    seq = bytearray(max_readlen)
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i, (b, q) in enumerate(zip(seq_bases, quals)):
        seq[i] = 0 if b == "N" else (code[b] << 6) | (q & 0x3F)
    seq[max_readlen - 1] = last_byte & 0xFF
    return struct.pack("<%dB8B3i36s" % max_readlen, *seq, size, map_qual,
                       info1, info2, c0, c1, flag, alt_qual, seqid, pos,
                       dist, name.encode() + b"\x00")


def maq_map(recs: list, fmt: int = -1, names=(b"chrA\x00", b"chrB\x00"),
            tail: bytes = b"") -> bytes:
    """A MAQ .map file's bytes (before gzip): ``fmt``, the reference
    names, the records, then ``tail``."""
    out = [struct.pack("<i", fmt), struct.pack("<i", len(names))]
    for nm in names:
        out += [struct.pack("<i", len(nm)), nm]
    out.append(struct.pack("<Q", len(recs)))
    return b"".join(out + list(recs)) + tail


MAQ_RECS = [
    maq_record("read1/1", "ACGT", [30, 31, 32, 33], 4, 40, 2, 10, 1, 2,
               0x12, 35, 0, 200 << 1, 150, last_byte=44),
    maq_record("read1/2", "TTGG", [20, 21, 22, 23], 4, 38, 1, 9, 1, 0,
               0x12, 33, 0, (350 << 1) | 1, -150, last_byte=40),
    maq_record("solo", "NACG", [0, 10, 11, 12], 4, 37, 0, 0, 0, 0, 0, 30,
               1, 77 << 1, 0, last_byte=37),
    maq_record("unm", "AAAA", [9, 9, 9, 9], 4, 0, 0, 0, 0, 0, 192, 0, 0,
               5 << 1, 0, last_byte=0),
    maq_record("ins/1", "ACGTACGTAC", [20] * 10, 10, 3, 1, 5, 1, 0, 130,
               25, 1, 40 << 1, 0, last_byte=2),
    maq_record("del/2", "ACGTACGTAC", [20] * 10, 10, 4, 1, 5, 1, 0, 130,
               25, 1, 60 << 1, 0, last_byte=0xFD),
    maq_record("sw/1", "CCCC", [40] * 4, 4, 20, 0, 0, 1, 0, 0x80 | 0x04,
               9, 0, (9 << 1) | 1, -30, last_byte=12),
    maq_record("mate/2", "GGGG", [40] * 4, 4, 20, 0, 0, 1, 0, 64, 9, 1,
               11 << 1, 0, last_byte=12),
    maq_record("rf", "TTTT", [40] * 4, 4, 20, 0, 0, 1, 0, 0x04, 9, 1,
               13 << 1, 25, last_byte=12),
]


def make_converter_inputs(d: str) -> dict:
    """The converters' inputs: each aligner output of the JAX package's
    converter tests with more records of its kind (``<kind>``; the
    ``<kind>_gz`` gzip'd), GERALD export files (``r1``, ``r2`` and their
    broken variants), MAQ .map files (``map``, ``map_trunc``,
    ``map_old``, ``map_zero``), FASTA/FASTQ names for fasta-sanitize
    (``names``), interpolate_sam's SAM and the simulated ACE
    (``sim.ace_assembly``: ``ace``, ``ace_gz``)."""
    p = lambda name: os.path.join(d, name)  # noqa: E731
    got = {"dir": d}
    for kind, data in (("bowtie", BOWTIE + BOWTIE_MORE),
                       ("psl", PSL + PSL_MORE), ("soap", SOAP + SOAP_MORE),
                       ("zoom", ZOOM + ZOOM_MORE),
                       ("novo", NOVO + NOVO_MORE),
                       ("blast", (BLAST + BLAST_MORE).encode()),
                       ("interp", INTERP_SAM.encode())):
        got[kind] = _write(p(f"in.{kind}"), data)
        got[kind + "_gz"] = _gz(p(f"in.{kind}.gz"), data)
    got["r1"] = _write(p("r1.export"), EXPORT1)
    got["r2"] = _write(p("r2.export"), EXPORT2)
    got["r1_gz"] = _gz(p("r1.export.gz"), EXPORT1.encode())
    lines2 = EXPORT2.splitlines(True)
    got["r2_short"] = _write(p("r2_short.export"), "".join(lines2[:-1]))
    got["r2_long"] = _write(p("r2_long.export"), EXPORT2 + lines2[0])
    got["r2_renamed"] = _write(p("r2_renamed.export"),
                               lines2[0].replace("\t4\t", "\t9\t", 1)
                               + "".join(lines2[1:]))
    got["r2_readno"] = _write(p("r2_readno.export"),
                              EXPORT1.splitlines(True)[0])
    got["r1_fields"] = _write(p("r1_fields.export"), "M0\t5\t1\n")
    got["r1_lowq"] = _write(p("r1_lowq.export"), export_line(
        "M0", "5", 1, 2, 3, 4, "", 1, "ACGT", "h;hh", "chr1", "", 100, "F",
        "4", "30", "", "Y") + "\n")
    got["map"] = _gz(p("in.map"), maq_map(MAQ_RECS))
    got["map_trunc"] = _gz(p("trunc.map"), maq_map(MAQ_RECS[:3],
                                                   tail=MAQ_RECS[3][:50]))
    got["map_old"] = _gz(p("old.map"), maq_map([], fmt=3))
    got["map_zero"] = _gz(p("zero.map"), maq_map([], fmt=0))
    got["names"] = _write(p("names.fa"), (
        ">ok_name desc\nACGT\n>bad*name|x\nGGTT\n"
        "@fq bad<>\nACGT\n+\n@III\n"
        ">*star first\nAC\nGT\n>=eq\nA\n> \nCC\n>\nTT\n"
        ">   spaced  name\nGG\n@q2\nACGTAC\n+q2\nII\nIIII\n"
        ">a,b(c)[d]{e}\nAAAA\n>x\\y'z\"w\nC\n>tab\tname\nG\n"))
    got["ace_text"] = sim.ace_assembly(3).ace
    got["ace"] = _write(p("in.ace"), got["ace_text"])
    got["ace_gz"] = _gz(p("in.ace.gz"), got["ace_text"].encode())
    return got


def wgsim_reads(fq1: str, fq2: str) -> list:
    """(name, read 1's bases, read 2's bases) of each pair of wgsim's two
    FASTQs, the /1 and /2 left off the name."""
    with open(fq1) as f1, open(fq2) as f2:
        a, b = f1.read().split("\n"), f2.read().split("\n")
    return [(a[i][1:-2], a[i + 1], b[i + 1]) for i in range(0, len(a) - 1, 4)]


def make_wgsim_inputs(d: str) -> dict:
    """wgsim's inputs: ``ref`` (one 20 kbp contig), ``refn`` (12 kbp with
    runs of N, one of 2 kbp), ``multi`` (three contigs: 9 kbp, 6 kbp in
    lower case and 400 bp, shorter than a fragment; gzip'd as
    ``multi_gz``); and wgsim_eval's, built from the JAX wgsim's own
    reads (``-S 7 -N 300`` on ``ref``): ``sam`` (each read placed at its
    true place by alneval's rule, some 2-300 bases off, soft-clipped,
    unmapped, on another contig, secondary, or named by another tool;
    MAPQ 0-60; a second hit for one name in ten, some with AS), ``sam2``
    (the same moved about for uniqcmp, NM tags), ``snp`` (the run's
    mutation report) and ``pileup`` (calls at its SNPs and indels and
    false ones)."""
    rng = np.random.default_rng(17)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    got = {"dir": d}
    acgt = np.array(list("ACGT"))
    ref = "".join(rng.choice(acgt, 20000))
    got["ref"] = _write(p("ref.fa"), _fasta_lines("sim1", ref))
    refn = list("".join(rng.choice(acgt, 12000)))
    for lo, hi in ((500, 520), (3000, 5000), (8000, 8004), (11990, 12000)):
        refn[lo:hi] = "N" * (hi - lo)
    got["refn"] = _write(p("refn.fa"), _fasta_lines("withN", "".join(refn)))
    multi = (_fasta_lines("ctgA desc", "".join(rng.choice(acgt, 9000)))
             + _fasta_lines("ctgB", "".join(rng.choice(acgt, 6000)).lower())
             + _fasta_lines("tiny", "".join(rng.choice(acgt, 400))))
    got["multi"] = _write(p("multi.fa"), multi)
    got["multi_gz"] = _gz(p("multi.fa.gz"), multi.encode())

    fq1, fq2 = p("eval1.fq"), p("eval2.fq")
    rc, out, _ = run_inproc("jax", "wgsim", ["-S", "7", "-N", "300",
                                             got["ref"], fq1, fq2])
    assert rc == 0
    got["snp"] = _write(p("eval.snp"), out)
    recs, recs2 = ["@HD\tVN:1.6\tSO:unsorted\n",
                   "@SQ\tSN:sim1\tLN:20000\n"], []
    for k, (name, s1, s2) in enumerate(wgsim_reads(fq1, fq2)):
        p2, p3 = (int(x) for x in name.split("_")[1:3])
        for mate, seq in ((0x40, s1), (0x80, s2)):
            rev = (mate == 0x80) != (k % 7 == 3)
            fl = 0x1 | 0x2 | mate | (0x10 if rev else 0)
            pos = p3 - len(seq) + 1 if rev else p2
            cig = f"{len(seq)}M"
            u = rng.random()
            rname, qname = "sim1", name
            if u < 0.1:
                pos += int(rng.integers(2, 300)) * (1 if pos < 10000 else -1)
            elif u < 0.15:
                cig = f"5S{len(seq) - 5}M" if not rev else \
                    f"{len(seq) - 4}M4S"
                pos += 0 if rev else 5
            elif u < 0.18:
                fl |= 0x4
            elif u < 0.2:
                rname = "sim2"
            elif u < 0.22:
                qname = f"bwa_{k}"
            elif u < 0.25:
                cig = f"{len(seq) // 2}M2I{len(seq) - len(seq) // 2 - 2}M"
            mapq = int(rng.integers(0, 61))
            aux = f"\tAS:i:{int(rng.integers(20, 100))}" if u > 0.9 else ""
            row = [qname, str(fl), rname, str(pos), str(mapq), cig, "=",
                   "0", "0", seq, "I" * len(seq)]
            recs.append("\t".join(row) + aux + "\n")
            if k % 10 == 0:
                row2 = list(row)
                row2[1] = str(fl | 0x100)
                row2[3] = str(pos + 5000 if pos < 10000 else pos - 5000)
                row2[4] = "0"
                recs.append("\t".join(row2) + (
                    f"\tAS:i:{int(rng.integers(20, 100))}" if k % 20 == 0
                    else "") + "\n")
            nm = int(rng.integers(0, 4))
            moved = int(pos + (rng.integers(50, 200) if rng.random() < 0.2
                               else 0))
            if rng.random() < 0.95:
                recs2.append("\t".join(
                    [qname, str(fl ^ (0x10 if rng.random() < 0.05 else 0)),
                     rname, str(moved), str(int(rng.integers(0, 61))), cig,
                     "*", "0", "0", seq, "*", f"NM:i:{nm}"]) + "\n")
    recs2.append("onlyhere\t0\tsim1\t5\t60\t10M\t*\t0\t0\tACGTACGTAC\t*\n")
    got["sam"] = _write(p("eval.sam"), "".join(recs))
    got["sam2"] = _write(p("eval2.sam"), "".join(recs2))
    calls = []
    for line in out.decode().splitlines():
        t = line.split("\t")
        q = int(rng.integers(0, 260))
        if t[2] != "-" and t[3] != "-":
            calls.append(f"{t[0]}\t{t[1]}\t{t[2]}\t{t[3]}\t0\t{q}\n")
        else:
            calls.append(f"{t[0]}\t{int(t[1]) + int(rng.integers(-12, 13))}"
                         f"\t*\t+A/+A\t0\t{q}.5\n")
    for _ in range(40):
        calls.append(f"sim1\t{int(rng.integers(1, 20000))}\t"
                     f"{'*' if rng.random() < 0.3 else 'A'}\tC\t0\t"
                     f"{int(rng.integers(0, 300))}\n")
    calls.append("sim1\t5\tA\tA\t0\t50\nshort\tline\n")
    got["pileup"] = _write(p("calls.pileup"), "".join(calls))
    os.remove(fq1)
    os.remove(fq2)
    return got
