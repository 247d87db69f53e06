"""samtools flags: flag names <-> bits (htslib bam_flag2str /
bam_str2flag), as the command prints them and as ``--rf``/``--ff`` and
view's ``-f``/``-F`` read them.  Counterpart of
samtools_tpu/tools/flags_cmd.py; prints samtools' bam_flags.c lines
(``0x%x\\t%d\\t%s``)."""

from __future__ import annotations

import sys

from ..core.flags import FLAG_NAMES
from .common import print_error

_NAME2BIT = dict(FLAG_NAMES)

_FLAG_DESCS = [
    "paired-end / multiple-segment sequencing technology",
    "each segment properly aligned according to aligner",
    "segment unmapped",
    "next segment in the template unmapped",
    "SEQ is reverse complemented",
    "SEQ of next segment in template is rev.complemented",
    "the first segment in the template",
    "the last segment in the template",
    "secondary alignment",
    "not passing quality controls or other filters",
    "PCR or optical duplicate",
    "supplementary alignment",
]


def flag2str(mask: int) -> str:
    return ",".join(name for name, bit in FLAG_NAMES if mask & bit)


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


def usage(fp):
    fp.write(
        "About: Convert between textual and numeric flag representation\n"
        "Usage: samtools flags FLAGS...\n"
        "\n"
        "Each FLAGS argument is either an INT (in decimal/hexadecimal/octal) representing\n"
        "a combination of the following numeric flag values, or a comma-separated string\n"
        "NAME,...,NAME representing a combination of the following flag names:\n"
        "\n")
    for (name, bit), desc in zip(FLAG_NAMES, _FLAG_DESCS):
        fp.write("%#6x %5d  %-15s%s\n" % (bit, bit, name, desc))


def main_flags(argv: list[str]) -> int:
    if not argv:
        usage(sys.stdout)
        return 0
    for arg in argv:
        mask = str2flag(arg)
        if mask < 0:
            print_error("flags", 'Could not parse "%s"', arg)
            usage(sys.stderr)
            return 1
        print("0x%x\t%d\t%s" % (mask, mask, flag2str(mask)))
    return 0
