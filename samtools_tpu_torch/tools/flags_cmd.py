"""Flag names <-> bits (htslib bam_str2flag), as ``--rf``/``--ff`` read
them.  Counterpart of part of samtools_tpu/tools/flags_cmd.py."""

from __future__ import annotations

from ..core.flags import FLAG_NAMES

_NAME2BIT = dict(FLAG_NAMES)


def str2flag(s: str) -> int:
    """A number (decimal, hex or octal) or comma-separated flag names; -1
    when a name is unknown."""
    try:
        return int(s, 0)
    except ValueError:
        pass
    mask = 0
    for part in s.split(","):
        if not part:
            continue
        if part not in _NAME2BIT:
            return -1
        mask |= _NAME2BIT[part]
    return mask
