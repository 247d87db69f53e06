"""Inputs and runners shared by the port's mpileup tests
(tests/test_torch_mpileup*.py).

Two BAMs over one 128 kbp simulated contig (FASTA with 60-column lines):

* ``messy``: single-end 6x with indels and soft clips,
  ``tests/test_mpileup_device_tool.py::_messy_batch``, written by the JAX
  package;
* ``pairs``: 6x properly paired reads whose mates overlap (the port's
  ``sim.simulate_overlapping_pairs``, so the overlap tweak runs), two read
  groups (``RG:Z:grpA``/``grpB``), written by the port.

The JAX tool runs as ``python -m samtools_tpu mpileup`` in a subprocess on
the JAX CPU backend; the port runs in-process through
``cli.main([...], device="cpu")``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from samtools_tpu_torch import cli, sim
from samtools_tpu_torch.io.bam import write_bam
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
    from samtools_tpu.sim import make_header as jmake_header
    from test_mpileup_device_tool import _messy_batch
    ref = sim.simulate_reference(REF_LEN, seed=7)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, ref)
    messy = os.path.join(d, "messy.bam")
    jwrite_bam(messy, jmake_header(REF_LEN), _messy_batch(ref, REF_LEN),
               threads=2)

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
    return {"dir": d, "ref": ref, "fa": fa, "messy": messy, "pairs": pairs}


def run_jax(args: list[str], engine: str) -> bytes:
    """stdout of the JAX tool; ``engine``: SAMTPU_DEVICE ("1" forces its
    device engine, "0" the host HMM)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SAMTPU_DEVICE=engine)
    p = subprocess.run([sys.executable, "-m", "samtools_tpu", "mpileup"]
                       + args, capture_output=True, env=env, cwd=REPO,
                       timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    return p.stdout


def run_port(args: list[str], out: str) -> bytes:
    """The port's output file, run in-process on the CPU."""
    assert cli.main(["mpileup", *args, "-o", out], device="cpu") == 0
    with open(out, "rb") as f:
        return f.read()


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
