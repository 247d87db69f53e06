"""Genomic region strings (htslib's hts_parse_region), as ``depth -r`` and
``coverage -r`` read them.

Counterpart of samtools_tpu/core/regions.py (:17-80).  Forms: "chr",
"chr:beg", "chr:beg-end", "chr:beg-", "{name}:...", digits grouped with
commas, k/m/g suffixes, and the special regions "." (everything) and "*"
(unmapped reads).
"""

from __future__ import annotations

from dataclasses import dataclass

HTS_POS_MAX = (1 << 63) - 1


@dataclass
class Region:
    tid: int          # -1 = unmapped ("*"), -2 = all (".")
    name: str
    beg: int          # 0-based inclusive
    end: int          # 0-based exclusive


class RegionError(ValueError):
    pass


def _parse_num(s: str) -> int:
    s = s.replace(",", "")
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1000, "m": 1000000, "g": 1000000000}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult) if "." in s else int(s) * mult


def parse_region(reg: str, name2tid) -> Region:
    """Parse one region string; ``name2tid`` maps a name to its tid (-1
    when unknown)."""
    if reg == ".":
        return Region(-2, ".", 0, HTS_POS_MAX)
    if reg == "*":
        return Region(-1, "*", 0, HTS_POS_MAX)
    # braces protect names containing ':'
    if reg.startswith("{"):
        close = reg.find("}")
        if close < 0:
            raise RegionError(f"could not parse region {reg!r}")
        name = reg[1:close]
        rest = reg[close + 1:]
        if rest.startswith(":"):
            rest = rest[1:]
    else:
        # htslib tries the whole string as a name first
        tid = name2tid(reg)
        if tid >= 0:
            return Region(tid, reg, 0, HTS_POS_MAX)
        colon = reg.rfind(":")
        if colon < 0:
            raise RegionError(f"unknown reference {reg!r}")
        name = reg[:colon]
        rest = reg[colon + 1:]
    tid = name2tid(name)
    if tid < 0:
        raise RegionError(f"unknown reference {name!r}")
    if not rest:
        return Region(tid, name, 0, HTS_POS_MAX)
    if "-" in rest:
        b, _, e = rest.partition("-")
        beg = _parse_num(b) - 1 if b else 0
        end = _parse_num(e) if e else HTS_POS_MAX
    else:
        # "chr:100" runs from position 100 to the end of the contig
        beg = _parse_num(rest) - 1
        end = HTS_POS_MAX
    if beg < 0:
        beg = 0
    if end < beg:
        raise RegionError(f"invalid region {reg!r} (end < begin)")
    return Region(tid, name, beg, end)
