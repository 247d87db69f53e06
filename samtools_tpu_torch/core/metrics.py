"""Per-stage timing and item counters, and leveled logging.

Counterpart of samtools_tpu/core/metrics.py (:1-117).  samtools has no
tracing: what it shows is ``hts_log_*`` lines gated by ``--verbosity``
(sam_opts.h:48).  This module keeps the same two things:

* ``log(level, component, fmt)``: htslib-style stderr lines
  (``[W::component] message``), printed when ``--verbosity`` (default 3,
  warnings, like hts_verbose) admits the level.
* ``stage(name, items=, unit=)``: a context manager adding wall time and
  an item count to a named pipeline stage (decode, device work, write).
  After a command, ``cli.main`` prints the breakdown (``report``) when
  the verbosity is 4 or more or ``SAMTPU_METRICS=1``.

The counters and the verbosity belong to the process, as in the JAX
package, where a command is a process; ``cli.main`` clears both before
each command, so a command run in-process reports only its own stages.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

# hts_verbose levels: 0 quiet, 1 error, 2-3 warning, 4 info and the stage
# report, 5 and up debug
DEFAULT_VERBOSITY = 3
_VERBOSITY = DEFAULT_VERBOSITY
_LEVEL_CHAR = {1: "E", 2: "W", 3: "W", 4: "I", 5: "D"}

# stages in the order first seen: name -> [seconds, items, unit, calls]
_STAGES: dict[str, list] = {}


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = level


def verbosity() -> int:
    return _VERBOSITY


def metrics_enabled() -> bool:
    return _VERBOSITY >= 4 or os.environ.get("SAMTPU_METRICS", "") == "1"


def log(level: int, component: str, fmt: str, *args) -> None:
    """hts_log: ``[X::component] message`` on stderr when the verbosity
    admits ``level``."""
    if level > _VERBOSITY:
        return
    msg = (fmt % args) if args else fmt
    sys.stderr.write(f"[{_LEVEL_CHAR.get(level, 'D')}::{component}] {msg}\n")


@contextmanager
def stage(name: str, items: int = 0, unit: str = "items"):
    """Add the wall time of the ``with`` body, and ``items``, to
    ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0, items, unit)


def add(name: str, seconds: float, items: int = 0,
        unit: str = "items") -> None:
    """Record one call of a stage measured elsewhere."""
    s = _STAGES.get(name)
    if s is None:
        _STAGES[name] = [seconds, items, unit, 1]
    else:
        s[0] += seconds
        s[1] += items
        s[3] += 1


def reset() -> None:
    _STAGES.clear()


def _human(n: float) -> str:
    for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if n >= div:
            return f"{n / div:.2f}{suf}"
    return f"{n:.0f}"


def report(tool: str, out=None) -> None:
    """Print the stage breakdown (verbosity >= 4 or SAMTPU_METRICS=1)."""
    if not _STAGES or not metrics_enabled():
        return
    out = out or sys.stderr
    total = sum(s[0] for s in _STAGES.values())
    out.write(f"[M::{tool}] stage breakdown "
              f"(total instrumented {total:.3f}s):\n")
    for name, (sec, items, unit, calls) in _STAGES.items():
        line = f"[M::{tool}]   {name:<22} {sec:8.3f}s  x{calls}"
        if items:
            rate = items / sec if sec > 0 else 0
            line += f"  {_human(items)} {unit}  {_human(rate)} {unit}/s"
        out.write(line + "\n")
    out.flush()
