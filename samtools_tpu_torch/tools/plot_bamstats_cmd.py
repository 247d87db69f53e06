"""plot-bamstats: draw the sections of ``stats`` output.

Counterpart of samtools_tpu/tools/plot_bamstats_cmd.py (samtools'
misc/plot-bamstats, Perl and gnuplot): the sections SN, FFQ/LFQ, GCF/GCL,
GCC, IS, RL, ID, IC, COV, GCD and MPC, drawn with matplotlib as
``<prefix>-<name>.png`` and ``<prefix>.html``, or with a prefix that
ends in ``/`` (the default: the stats file's name) as
``<dir>/<name>.png`` and ``<dir>/index.html``.  matplotlib is imported
when the command runs, with the Agg backend.  A host command: no device
work.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import UsageError, gnu_getopt


def usage(fp):
    fp.write(
        "Usage: plot-bamstats [options] <file.stats>\n\n"
        "Options:\n"
        "   -p, --prefix <path>     The output files prefix\n"
        "   -h, --help              This help message\n")


def _parse(path: str):
    sections: dict[str, list[list[str]]] = {}
    fh = sys.stdin if path == "-" else open(path)
    try:
        for line in fh:
            if not line or line[0] == "#":
                continue
            parts = line.rstrip("\n").split("\t")
            sections.setdefault(parts[0], []).append(parts[1:])
    finally:
        if path != "-":
            fh.close()
    return sections


def _f(rows, col):
    return [float(r[col]) for r in rows]


def main_plot_bamstats(argv: list[str]) -> int:
    prefix = None
    try:
        opts, args = gnu_getopt(argv, "p:h", ["prefix=", "help"])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-p", "--prefix"):
            prefix = v
        elif o in ("-h", "--help"):
            usage(sys.stdout)
            return 0
    if len(args) != 1:
        usage(sys.stderr)
        return 1
    stats_path = args[0]
    if prefix is None:
        prefix = os.path.splitext(os.path.basename(stats_path))[0] + "/"
    if prefix.endswith("/"):
        os.makedirs(prefix or ".", exist_ok=True)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    S = _parse(stats_path)
    made: list[tuple[str, str]] = []

    def save(fig, name, title):
        out = f"{prefix}{name}.png" if prefix.endswith("/") \
            else f"{prefix}-{name}.png"
        fig.savefig(out, dpi=90)
        plt.close(fig)
        made.append((os.path.basename(out), title))

    # quality per cycle (FFQ/LFQ heatmaps + mean lines)
    for key, label in (("FFQ", "first"), ("LFQ", "last")):
        rows = S.get(key)
        if not rows:
            continue
        mat = np.array([[float(x) for x in r[1:]] for r in rows])
        if mat.size == 0:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.imshow(mat.T, aspect="auto", origin="lower",
                  interpolation="nearest", cmap="viridis")
        ax.set_xlabel("Cycle")
        ax.set_ylabel("Base quality")
        ax.set_title(f"Quality per cycle, {label} fragments")
        save(fig, f"quals-{label}", f"Qualities ({label} fragments)")

    # GC content (GCF/GCL)
    if "GCF" in S or "GCL" in S:
        fig, ax = plt.subplots(figsize=(6, 4))
        for key, label in (("GCF", "first fragments"),
                           ("GCL", "last fragments")):
            rows = S.get(key)
            if rows:
                ax.plot(_f(rows, 0), _f(rows, 1), label=label)
        ax.set_xlabel("GC content [%]")
        ax.set_ylabel("Count")
        ax.set_title("GC content")
        ax.legend()
        save(fig, "gc-content", "GC content")

    # ACGT per cycle (GCC)
    rows = S.get("GCC")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        cyc = _f(rows, 0)
        for ci, base in enumerate("ACGT", start=1):
            ax.plot(cyc, _f(rows, ci), label=base)
        ax.set_xlabel("Cycle")
        ax.set_ylabel("Base content [%]")
        ax.set_title("ACGT content per cycle")
        ax.legend(ncol=4)
        save(fig, "acgt-cycles", "ACGT per cycle")

    # insert size (IS)
    rows = S.get("IS")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(_f(rows, 0), _f(rows, 1), label="all pairs")
        if len(rows[0]) >= 5:
            ax.plot(_f(rows, 0), _f(rows, 2), label="inward")
            ax.plot(_f(rows, 0), _f(rows, 3), label="outward")
            ax.plot(_f(rows, 0), _f(rows, 4), label="other")
        ax.set_xlabel("Insert size")
        ax.set_ylabel("Number of pairs")
        ax.set_title("Insert size")
        ax.legend()
        save(fig, "insert-size", "Insert size")

    # read lengths (RL)
    rows = S.get("RL")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(_f(rows, 0), _f(rows, 1))
        ax.set_xlabel("Read length")
        ax.set_ylabel("Count")
        ax.set_title("Read lengths")
        save(fig, "read-lengths", "Read lengths")

    # indel distribution (ID)
    rows = S.get("ID")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(_f(rows, 0), _f(rows, 1), label="insertions")
        ax.plot(_f(rows, 0), _f(rows, 2), label="deletions")
        ax.set_yscale("symlog")
        ax.set_xlabel("Indel length")
        ax.set_ylabel("Count")
        ax.set_title("Indel distribution")
        ax.legend()
        save(fig, "indel-dist", "Indel distribution")

    # indels per cycle (IC)
    rows = S.get("IC")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        cyc = _f(rows, 0)
        for ci, label in ((1, "ins fwd"), (2, "ins rev"),
                          (3, "del fwd"), (4, "del rev")):
            if len(rows[0]) > ci:
                ax.plot(cyc, _f(rows, ci), label=label)
        ax.set_xlabel("Cycle")
        ax.set_ylabel("Indel count")
        ax.set_title("Indels per cycle")
        ax.legend()
        save(fig, "indel-cycles", "Indels per cycle")

    # coverage (COV)
    rows = S.get("COV")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        xs = [float(r[1]) for r in rows]
        ax.plot(xs, _f(rows, 2))
        ax.set_xlabel("Coverage")
        ax.set_ylabel("Number of mapped bases")
        ax.set_title("Coverage")
        save(fig, "coverage", "Coverage")

    # GC depth (GCD)
    rows = S.get("GCD")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        gc = _f(rows, 0)
        for ci, label in ((2, "10th"), (3, "25th"), (4, "50th"),
                          (5, "75th"), (6, "90th")):
            if len(rows[0]) > ci:
                ax.plot(gc, _f(rows, ci), label=f"{label} percentile")
        ax.set_xlabel("GC content [%]")
        ax.set_ylabel("Mapped depth percentile")
        ax.set_title("GC depth")
        ax.legend()
        save(fig, "gc-depth", "GC depth")

    # mismatches per cycle (MPC)
    rows = S.get("MPC")
    if rows:
        fig, ax = plt.subplots(figsize=(6, 4))
        cyc = _f(rows, 0)
        tot = [sum(float(x) for x in r[2:]) for r in rows]
        ax.plot(cyc, tot)
        ax.set_xlabel("Cycle")
        ax.set_ylabel("Mismatches")
        ax.set_title("Mismatches per cycle")
        save(fig, "mism-per-cycle", "Mismatches per cycle")

    # html index with the SN table
    html_path = f"{prefix}index.html" if prefix.endswith("/") \
        else f"{prefix}.html"
    with open(html_path, "w") as out:
        out.write("<html><head><title>plot-bamstats</title></head>"
                  "<body>\n<h1>Summary numbers</h1>\n<table>\n")
        for r in S.get("SN", []):
            out.write("<tr><td>%s</td><td>%s</td></tr>\n"
                      % (r[0], r[1] if len(r) > 1 else ""))
        out.write("</table>\n<h1>Plots</h1>\n")
        for png, title in made:
            out.write('<h2>%s</h2><img src="%s">\n' % (title, png))
        out.write("</body></html>\n")
    return 0
