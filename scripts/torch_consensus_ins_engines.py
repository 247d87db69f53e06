"""Time the port's consensus insertion engine against the JAX package's.

The port scores every insertion site of a window at once
(``samtools_tpu_torch.tools.consensus_cmd._ins_sites_vec``); the JAX
package scores one site at a time (``samtools_tpu.tools.consensus_cmd.
_ins_columns_vec``, pure numpy, no JAX).  This script runs the port's
``consensus -a --show-ins yes --show-del yes -f fastq`` host branch
(``SAMTPU_DEVICE=0``) on simulated messy reads twice, in-process: as it
is, and with each window's sites handed to the JAX per-site engine
instead.  The two outputs must be equal; it prints the walls as JSON.

A development comparison on the CPU, like the tests: it imports the JAX
package and does not run on the card's machine.

    python3 scripts/torch_consensus_ins_engines.py [--ref-len N]
        [--coverage X] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from samtools_tpu.tools import consensus_cmd as JC  # noqa: E402
from samtools_tpu_torch import cli, sim  # noqa: E402
from samtools_tpu_torch.io.bam import write_bam  # noqa: E402
from samtools_tpu_torch.tools import consensus_cmd as C  # noqa: E402


def per_site(opts, sub, p, sites, ins_by_col, qual_flat, nm_flat, rawq,
             so_ent, cps, use_mq):
    """``_ins_sites_vec``'s contract through the JAX per-site engine."""
    off, cb, cq = [0], [], []
    emit = JC._fasta_emit
    try:
        JC._fasta_emit = (lambda c, tid, pos1, nth, b, q:
                          cb.append(b) or cq.append(q) or 0)
        for ci in sites.tolist():
            JC._ins_columns_vec(opts, sub, p, ci, ins_by_col[ci], qual_flat,
                                nm_flat, rawq, so_ent, cps, None, 0, 0,
                                use_mq)
            off.append(len(cb))
    finally:
        JC._fasta_emit = emit
    return (np.array(off, np.int64), np.array(cb, np.int64),
            np.array(cq, np.int64))


def run(bam: str, out: str) -> float:
    t0 = time.perf_counter()
    rc = cli.main(["consensus", "-a", "--show-ins", "yes", "--show-del",
                   "yes", "-f", "fastq", bam, "-o", out])
    assert rc == 0, rc
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-len", type=int, default=200_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--workdir", default=None)
    a = ap.parse_args()
    torch.set_num_threads(1)
    os.environ["SAMTPU_DEVICE"] = "0"
    with tempfile.TemporaryDirectory(dir=a.workdir) as d:
        ref = sim.simulate_reference(a.ref_len, seed=7)
        b = sim.simulate_batch(ref_len=a.ref_len, coverage=a.coverage,
                               read_len=100, seed=9, paired=False,
                               err_rate=0.01, ref=ref)
        sim.simulate_messy(b, 9)
        bam = os.path.join(d, "messy.bam")
        write_bam(bam, sim.make_header(a.ref_len), b)
        outs = {k: os.path.join(d, f"{k}.fq") for k in ("batched",
                                                        "per_site")}
        walls = {"batched": run(bam, outs["batched"])}
        batched = C._ins_sites_vec
        C._ins_sites_vec = per_site
        try:
            walls["per_site"] = run(bam, outs["per_site"])
        finally:
            C._ins_sites_vec = batched
        with open(outs["batched"], "rb") as f, \
                open(outs["per_site"], "rb") as g:
            equal = f.read() == g.read()
        print(json.dumps({"ref_len": a.ref_len, "coverage": a.coverage,
                          "reads": int(b.n), "wall_s": walls,
                          "bytes_equal": equal}))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
