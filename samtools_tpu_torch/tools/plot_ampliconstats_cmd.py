"""plot-ampliconstats: draw the output of ``ampliconstats``.

Counterpart of samtools_tpu/tools/plot_ampliconstats_cmd.py (samtools'
misc/plot-ampliconstats, Perl and gnuplot): the per-file sections
(FREADS, FDEPTH, FVDEPTH, FPCOV, FRPERC) drawn one PNG a section with
matplotlib, and ``<prefix>-index.html`` linking them.  The combined
CREADS/CDEPTH rows are parsed and, as in the JAX tool, not drawn.
matplotlib is imported when the command runs, with the Agg backend, so
the package imports without it.  A host command: no device work.
"""

from __future__ import annotations

import os
import sys

from .common import UsageError, gnu_getopt


def usage(fp):
    fp.write(
        "Usage: plot-ampliconstats [options] <prefix> "
        "[<file.astats>]\n\n"
        "Options:\n"
        "   -p, --prefix <path>   alternative way to set the prefix\n"
        "   -h, --help            this help\n")


def main_plot_ampliconstats(argv: list[str]) -> int:
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
    if prefix is None:
        if not args:
            usage(sys.stderr)
            return 1
        prefix = args[0]
        args = args[1:]
    path = args[0] if args else "-"

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # sections: per-file rows keyed (SECT, filename)
    per_file: dict[tuple[str, str], list[float]] = {}
    combined: dict[str, list[float]] = {}
    fh = sys.stdin if path == "-" else open(path)
    try:
        for line in fh:
            if not line or line[0] == "#":
                continue
            p = line.rstrip("\n").split("\t")
            key = p[0]
            if key in ("FREADS", "FDEPTH", "FVDEPTH", "FPCOV",
                       "FRPERC") and len(p) > 2:
                vals = []
                for x in p[2:]:
                    try:
                        vals.append(float(x))
                    except ValueError:
                        vals.append(0.0)
                per_file[(key, p[1])] = vals
            elif key in ("CREADS", "CDEPTH") and len(p) > 2:
                vals = []
                for x in p[2:]:
                    try:
                        vals.append(float(x))
                    except ValueError:
                        vals.append(0.0)
                combined[p[1] if not p[1].replace(".", "").isdigit()
                         else key] = vals
    finally:
        if path != "-":
            fh.close()

    made = []

    def save(fig, name, title):
        out = f"{prefix}-{name}.png"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        fig.savefig(out, dpi=90)
        plt.close(fig)
        made.append((os.path.basename(out), title))

    for sect, ylabel, logy in (
            ("FREADS", "Reads per amplicon", True),
            ("FDEPTH", "Mean depth per amplicon", True),
            ("FVDEPTH", "Mean usable depth per amplicon", True),
            ("FPCOV", "Percent coverage per amplicon", False),
            ("FRPERC", "Percent reads per amplicon", False)):
        rows = [(f, v) for (s, f), v in per_file.items() if s == sect]
        if not rows:
            continue
        fig, ax = plt.subplots(figsize=(7, 4))
        for fname, vals in rows:
            ax.plot(range(1, len(vals) + 1), vals,
                    label=os.path.basename(fname), alpha=0.8)
        if logy:
            ax.set_yscale("symlog")
        ax.set_xlabel("Amplicon number")
        ax.set_ylabel(ylabel)
        ax.set_title(sect)
        if len(rows) <= 8:
            ax.legend(fontsize=7)
        save(fig, sect.lower(), ylabel)

    with open(f"{prefix}-index.html", "w") as out:
        out.write("<html><body><h1>plot-ampliconstats</h1>\n")
        for png, title in made:
            out.write('<h2>%s</h2><img src="%s">\n' % (title, png))
        out.write("</body></html>\n")
    return 0
