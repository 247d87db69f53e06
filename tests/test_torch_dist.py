"""The port's mesh over two processes: ``scripts/torch_dryrun_dist.py``
as two gloo processes, 4 CPU shards each, joined on a free local port
(the twin of tests/test_dist.py's two-process dry run)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_gloo_dryrun():
    """2 processes x 4 CPU shards: the sharded histogram, flag census and
    depth equal the local compute on every process."""
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO,
                   SAMTPU_DIST_COORD=f"localhost:{port}",
                   SAMTPU_DIST_NPROCS="2", SAMTPU_DIST_PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "torch_dryrun_dist.py")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=REPO))
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-800:]
        assert f"DIST_DRYRUN proc={pid} OK procs=2" in out, out[-800:]
