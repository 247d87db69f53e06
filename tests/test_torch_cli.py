"""The port's top-level CLI against the JAX package's, on the CPU: the two
command tables, ``help <cmd>`` for every command, the bare usage,
``--version-only``, and the allocator tuning (``core/malloc_tune``) that
``cli.main`` applies first.  ``tune()`` changes the process's allocator,
so it runs for real only in subprocesses; in this process glibc is
replaced by a recorder."""

import io
import os
import subprocess
import sys

import pytest
from torch_tool_fixtures import REPO, mask_port, run_inproc

from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.tools import COMMANDS, HOST_COMMANDS


def _jax_commands():
    from samtools_tpu.tools import COMMANDS as JAX_COMMANDS
    return JAX_COMMANDS


def test_command_tables_hold_the_same_names():
    assert sorted(COMMANDS) == sorted(_jax_commands())
    assert len(COMMANDS) == 60
    assert set(HOST_COMMANDS) <= set(COMMANDS)
    assert all(mod.startswith("samtools_tpu_torch.tools.")
               for mod, _ in COMMANDS.values())


@pytest.mark.parametrize("cmd", sorted(_jax_commands()))
def test_help_equals_jax_tool(cmd):
    kernels.reset_launches()
    got = run_inproc("port", "help", [cmd])
    want = run_inproc("jax", cmd, ["--help"])
    assert (got[0], mask_port(got[1]), mask_port(got[2])) == want
    assert not any(kernels.launches.values())


def test_usage_equals_jax_tool():
    from samtools_tpu import cli as jcli
    got, want = io.StringIO(), io.StringIO()
    cli.usage(got)
    jcli.usage(want)
    assert mask_port(got.getvalue()) == want.getvalue()
    rc, out, err = run_inproc("port", "help", [])
    assert (rc, out.decode(), err) == (0, got.getvalue(), "")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("SAMTPU_MALLOC", "PYTHONPATH")}
    return {**env, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **extra}


def test_version_only():
    """``--version-only`` prints the samtools version and the port's
    package and version, as the JAX CLI prints its own, and exits 0."""
    want = "1.23.1+samtools_tpu_torch0.1.0\n"
    assert run_inproc("port", "--version-only", []) == (0, want.encode(),
                                                        "")
    p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                        "--version-only"], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=120)
    assert (p.returncode, p.stdout, p.stderr) == (0, want, "")
    j = subprocess.run([sys.executable, "-m", "samtools_tpu",
                        "--version-only"], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=120)
    assert (j.returncode, mask_port(p.stdout)) == (0, j.stdout)


_TUNE = """
import sys
mod = __import__(sys.argv[1] + ".core.malloc_tune", fromlist=["tune"])
print(mod.tune(), mod.tune())
"""


@pytest.mark.parametrize("setting", [None, "1", "0", "off"])
def test_tune_equals_jax_tune(setting):
    """In a fresh process, the port's tune() returns what the JAX tune()
    returns, twice (applied once, then remembered), and False when
    SAMTPU_MALLOC is 0 or off."""
    env = _env(**({} if setting is None else {"SAMTPU_MALLOC": setting}))
    out = {}
    for pkg in ("samtools_tpu_torch", "samtools_tpu"):
        p = subprocess.run([sys.executable, "-c", _TUNE, pkg],
                           capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=120)
        assert p.returncode == 0, p.stderr
        out[pkg] = p.stdout
    assert out["samtools_tpu_torch"] == out["samtools_tpu"]
    assert out["samtools_tpu_torch"] == ("False False\n" if setting in (
        "0", "off") else "True True\n")


class _Libc:
    def __init__(self, calls):
        self.calls = calls

    def mallopt(self, code, value):
        self.calls.append((code, value))
        return 1


@pytest.mark.parametrize("pkg", ["samtools_tpu_torch", "samtools_tpu"])
def test_tune_sets_the_same_mallopt_values_once(pkg, monkeypatch):
    import ctypes
    mod = __import__(pkg + ".core.malloc_tune", fromlist=["tune"])
    calls = []
    monkeypatch.setattr(ctypes, "CDLL", lambda *a, **k: _Libc(calls))
    monkeypatch.setattr(mod, "_done", False)
    monkeypatch.delenv("SAMTPU_MALLOC", raising=False)
    assert mod.tune() is True and mod.tune() is True
    assert calls == [(-3, 1 << 30), (-1, 1 << 30), (-4, 0)]


def test_cli_main_tunes_first(monkeypatch):
    """cli.main calls tune() once, before the command, as the JAX CLI
    does; the bare usage returns before it."""
    events = []
    monkeypatch.setattr(cli, "tune", lambda: events.append("tune"))
    real = cli.run_command
    monkeypatch.setattr(cli, "run_command", lambda *a: (
        events.append("run"), real(*a))[1])
    assert run_inproc("port", "flags", ["PAIRED"])[0] == 0
    assert events == ["tune", "run"]
    events.clear()
    assert run_inproc("port", "--version-only", [])[0] == 0
    assert events == ["tune"]
    events.clear()
    assert cli.main([]) == 1 and events == []
