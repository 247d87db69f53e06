"""Host allocator tuning for columnar batch workloads.

Counterpart of samtools_tpu/core/malloc_tune.py: the same mallopt codes
and values, applied once.  The pileup-family tools churn many large
short-lived numpy buffers (tens of MB each, released every window).
glibc serves those from fresh anonymous mmaps, so every buffer
re-faults its pages, and on a virtualised host each minor fault costs
kernel time.  Routing large allocations through the main heap and
disabling trim makes pages fault once at the high-water mark and then
be reused.

samtools avoids this class of cost structurally (one bam1_t arena,
records reused: bam_sort.c); for a batch-columnar design the allocator
knob is the equivalent.

``cli.main`` calls ``tune()`` first, so span workers, which run through
their own ``cli.main``, get it too.  Set ``SAMTPU_MALLOC=0`` (or
``off``) to disable.
"""

from __future__ import annotations

import os

_done = False

# glibc mallopt parameter codes (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4


def tune() -> bool:
    """Apply the allocator tuning; True when applied."""
    global _done
    if _done:
        return True
    if os.environ.get("SAMTPU_MALLOC", "1") in ("0", "off"):
        return False
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        ok &= libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        ok &= libc.mallopt(_M_MMAP_MAX, 0)
        _done = bool(ok)
    except Exception:
        return False
    return _done
