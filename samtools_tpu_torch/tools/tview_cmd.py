"""samtools tview on the port: the text, HTML and curses alignment viewer.

Counterpart of samtools_tpu/tools/tview_cmd.py (the whole module), after
samtools' bam_tview.c (the column renderer tv_pl_func :173-330, the draw
loop base_draw_aln :357-401) and bam_tview_html.c (the text and HTML
backends, :238 and :136).  Each read's row is its level
(``ops.lpileup.assign_levels``, bam_lpileup.c); the consensus line comes
from the MAQ error model (``ops.errmod.bcf_call_glfgen``, bam2bcf.c).
Output is the JAX tool's, byte for byte.

``-d T`` and ``-d H`` draw once; ``-d C`` runs the curses display, and
without a terminal on standard output exits 1 with one line, as the JAX
tool does.  Device work: the window's pileup table is ordered by K13 on
the card (``ops.pileup.build_pileup``), one launch a draw on a window
that holds reads and none on one that holds none;
``SAMTPU_DEVICE=0|host`` orders it on the host.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import flags as F
from ..core.regions import parse_region, RegionError
from ..io.fasta import load_fasta
from ..io.files import read_alignments
from ..ops.errmod import BcfCallAux, bcf_call_glfgen
from ..ops.lpileup import assign_levels
from ..ops.pileup import build_pileup
from .common import (GlobalArgs, UsageError, gnu_getopt, handle_global_opt,
                     no_card, pick_device, print_error, print_error_errno)

TEN_DIGITS = 1000000000
TV_MIN_ALNROW = 2
UNDERLINE_FLAG = 10

_NT16_STR = F.SEQ_NT16_STR
_NT16_TABLE = {c: i for i, c in enumerate(_NT16_STR)}
# nt16 -> small int (htslib seq_nt16_int: A,C,G,T -> 0..3, else 4)
_NT16_INT = {1: 0, 2: 1, 4: 2, 8: 3}
_CALL_CHARS = ",ACMGRSVTWYHKDBN"


class Screen:
    """The tixel grid of the html/text backends
    (bam_tview_html.c:84-101)."""

    def __init__(self, mcol: int):
        self.mcol = mcol
        self.rows: list[list] = []   # each row: list of [ch, attr]
        self.attr = 0

    def _ensure(self, y: int):
        while len(self.rows) <= y:
            self.rows.append([[" ", 0] for _ in range(self.mcol)])

    def addch(self, y: int, x: int, ch: str):
        if x >= self.mcol:
            return
        self._ensure(y)
        self.rows[y][x][0] = ch
        self.rows[y][x][1] = self.attr

    def printw(self, y: int, x: int, text: str):
        for i, ch in enumerate(text[:self.mcol + 2]):
            self.addch(y, x + i, ch)


def colorpair(flag: int) -> int:
    return 1 << flag


def underline() -> int:
    return 1 << UNDERLINE_FLAG


def seq_nt16_table(ch: str) -> int:
    return _NT16_TABLE.get(ch.upper(), 15)


def draw(tv: dict, screen: Screen) -> None:
    """base_draw_aln + tv_pl_func over the fetched window; ``tv["dev"]``
    is where K13 orders its pileup table (None: the host)."""
    header = tv["header"]
    b = tv["batch"]
    left_pos = tv["left_pos"]
    mcol = tv["mcol"]
    mrow = tv["mrow"]
    tid = tv["tid"]
    ref = tv["ref"]          # bytes or None, covering left_pos..+mcol-1
    bca = tv["bca"]
    show_ins = tv["ins"]

    spans = b.ref_span()
    has_cig = b.n_cigar > 0
    mapped = (b.flag & F.FUNMAP) == 0
    ends = b.pos + np.where(mapped & has_cig, spans, 1)

    sel = np.nonzero((b.tid == tid) & mapped
                     & (b.pos < left_pos + mcol) & (ends > left_pos))[0]
    sub = b.take(sel)
    pile = build_pileup(sub, tv["dev"])
    levels = assign_levels(pile, sub.n)

    sub_ends = sub.end_pos()

    def ref_char(pos: int) -> str:
        if ref is not None and 0 <= pos - left_pos < len(ref):
            return chr(ref[pos - left_pos])
        return "N"

    ccol = 0
    last_pos = left_pos - 1

    ncols = len(pile.col_pos)
    for ci in range(ncols):
        pos = int(pile.col_pos[ci])
        if pos < left_pos or ccol > mcol:
            if pos >= left_pos:
                break
            continue
        s = int(pile.col_off[ci])
        e = int(pile.col_off[ci + 1])

        # gap fill (bam_tview.c:184-189)
        for cp in range(last_pos + 1, pos):
            interval = 10 if cp < TEN_DIGITS else 20
            if cp % interval == 0 and mcol - ccol >= 10:
                screen.printw(0, ccol, "%d" % (cp + 1))
            screen.addch(1, ccol, ref_char(cp))
            ccol += 1
        interval = 10 if pos < TEN_DIGITS else 20
        if pos % interval == 0 and mcol - ccol >= 10:
            screen.printw(0, ccol, "%d" % (pos + 1))

        rb = ref_char(pos)

        # consensus call (bam_tview.c:192-209)
        entries = []
        for idx in range(s, e):
            rid = int(pile.rid[idx])
            qpos = int(pile.qpos[idx])
            l_qseq = int(sub.seq_off[rid + 1] - sub.seq_off[rid])
            qual = int(sub.qual[sub.seq_off[rid] + qpos]) \
                if qpos < l_qseq else 0
            b16 = int(sub.seq[sub.seq_off[rid] + qpos]) \
                if qpos < l_qseq else 15
            entries.append((bool(pile.is_del[idx]),
                            bool(pile.is_refskip[idx]),
                            int(sub.flag[rid]), int(sub.mapq[rid]),
                            qual, b16))
        _n, p25, qsum_f = bcf_call_glfgen(entries, seq_nt16_table(rb), bca)
        qsum = sorted((int(qsum_f[i]) << 2 | i for i in range(4)),
                      reverse=True)
        a1 = qsum[0] & 3
        a2 = qsum[1] & 3
        prior = 30.0
        p = [p25[a1 * 5 + a1], p25[a1 * 5 + a2] + prior,
             p25[a2 * 5 + a2]]
        if "ACGT"[a1] != rb.upper():
            p[0] += prior + 3
        if "ACGT"[a2] != rb.upper():
            p[2] += prior + 3
        if p[0] < p[1] and p[0] < p[2]:
            call = ((1 << a1) << 16 | int(min(p[1], p[2]) - p[0] + .499))
        elif p[2] < p[1] and p[2] < p[0]:
            call = ((1 << a2) << 16 | int(min(p[0], p[1]) - p[2] + .499))
        else:
            call = (((1 << a1) | (1 << a2)) << 16
                    | int(min(p[0], p[2]) - p[1] + .499))
        attr = underline()
        chr_ = _CALL_CHARS[(call >> 16) & 0xF]
        i4 = (call & 0xFFFF) // 10 + 1
        if i4 > 4:
            i4 = 4
        attr |= colorpair(i4)
        if chr_ == rb.upper():
            chr_ = "."
        screen.attr = attr
        screen.addch(2, ccol, chr_)
        screen.attr = 0

        # insertions at this column
        max_ins = 0
        ins_of: dict[int, str] = {}
        if show_ins:
            for idx in range(s, e):
                if pile.indel[idx] > 0 and idx in pile.ins:
                    ins_of[idx] = pile.ins[idx][0]
                    if len(ins_of[idx]) > max_ins:
                        max_ins = len(ins_of[idx])

        # core loop (bam_tview.c:232-326)
        for j in range(max_ins + 1):
            for idx in range(s, e):
                rid = int(pile.rid[idx])
                flag = int(sub.flag[rid])
                rev = bool(flag & F.FREVERSE)
                row = TV_MIN_ALNROW + int(levels[rid]) - 0
                qpos = int(pile.qpos[idx])
                l_qseq = int(sub.seq_off[rid + 1] - sub.seq_off[rid])
                if j == 0:
                    if not pile.is_del[idx]:
                        if qpos < l_qseq:
                            ch = _NT16_STR[
                                int(sub.seq[sub.seq_off[rid] + qpos])]
                        else:
                            ch = "N"
                        if tv.get("base_for") == "cs":
                            # SOLiD color-space view (bam_color.c
                            # accessors; corrected color in dot mode)
                            from ..core import colorspace as csmod
                            cc = (csmod.get_cei(sub, rid, qpos)
                                  if tv["is_dot"] else
                                  csmod.get_csi(sub, rid, qpos))
                            if cc:
                                ch = cc
                        elif tv["is_dot"] and ch.upper() == rb.upper():
                            ch = "," if rev else "."
                    else:
                        ch = ("<" if rev else ">") \
                            if pile.is_refskip[idx] else "*"
                else:
                    ins_s = ins_of.get(idx, "")
                    if j > len(ins_s):
                        ch = "*"
                    else:
                        ch = ins_s[j - 1]
                if TV_MIN_ALNROW < row < mrow:
                    attr = 0
                    if ((flag & F.FPAIRED)
                            and not (flag & F.FPROPER_PAIR)) \
                            or (flag & F.FSECONDARY):
                        attr |= underline()
                    # color modes (bam_tview.c:282-296): mapq default
                    color_for = tv.get("color_for", "mapq")
                    if color_for == "baseq":
                        q = (int(sub.qual[sub.seq_off[rid] + qpos])
                             if qpos < l_qseq and sub.qual.size else 0)
                        x = min(q // 10 + 1, 4)
                    elif color_for == "nucl":
                        code = (int(sub.seq[sub.seq_off[rid] + qpos])
                                if qpos < l_qseq else 0)
                        x = _NT16_INT.get(code, 4) + 5 if qpos < l_qseq \
                            else 4
                    else:  # mapq
                        x = min(int(sub.mapq[rid]) // 10 + 1, 4)
                    attr |= colorpair(x)
                    screen.attr = attr
                    screen.addch(row, ccol,
                                 ch.lower() if rev else ch.upper())
                    screen.attr = 0
            ch = "*" if j else rb
            if ch == "*":
                screen.attr = colorpair(8)
                screen.addch(1, ccol, ch)
                screen.attr = 0
                ccol += 1
            else:
                screen.addch(1, ccol, ch)
                ccol += 1
        last_pos = pos

    # trailing fill (base_draw_aln bam_tview.c:393-399)
    while ccol < mcol:
        pos = last_pos + 1
        interval = 10 if pos < TEN_DIGITS else 20
        if pos % interval == 0 and mcol - ccol >= 10:
            screen.printw(0, ccol, "%d" % (pos + 1))
        screen.addch(1, ccol, ref_char(pos))
        ccol += 1
        last_pos += 1


_ANSI = {1: "\x1b[34m", 2: "\x1b[32m", 3: "\x1b[33m", 5: "\x1b[32m",
         6: "\x1b[36m", 7: "\x1b[33m", 8: "\x1b[31m", 9: "\x1b[34m"}


def emit_text(screen: Screen, out) -> None:
    """bam_tview_html.c:238-298."""
    is_term = out.isatty()
    for row in screen.rows:
        for ch, attr in row:
            if is_term:
                css = 0
                while css < 32:
                    if attr & (1 << css):
                        break
                    css += 1
                out.write(_ANSI.get(css, ""))
                if attr & (1 << UNDERLINE_FLAG):
                    out.write("\033[4m")
            out.write(ch)
            if is_term:
                out.write("\x1b[0m")
                if attr & (1 << UNDERLINE_FLAG):
                    out.write("\033[0m")
        out.write("\n")


def emit_html(screen: Screen, out, title: str) -> None:
    """bam_tview_html.c:136-223."""
    out.write("<html><head>")
    out.write("<title>%s</title>" % title)
    out.write("<style type='text/css'>\n")
    out.write(".tviewbody { margin:5px; background-color:white;"
              "text-align:center;}\n")
    out.write(".tviewtitle {text-align:center;}\n")
    out.write(".tviewpre { margin:5px; background-color:white;}\n")
    for cid, col in ((0, "black"), (1, "blue"), (2, "green"),
                     (3, "yellow"), (4, "black"), (5, "green"),
                     (6, "cyan"), (7, "yellow"), (8, "red"),
                     (9, "blue")):
        out.write(".tviewc%d {color:%s;}\n.tviewcu%d {color:%s;"
                  "text-decoration:underline;}\n" % (cid, col, cid, col))
    out.write("</style>")
    out.write("</head><body>")
    out.write("<div class='tviewbody'><div class='tviewtitle'>%s</div>"
              % title)
    out.write("<pre class='tviewpre'>")
    rows = screen.rows
    for y, row in enumerate(rows):
        for x in range(screen.mcol):
            ch, attr = row[x]
            if x == 0 or attr != row[x - 1][1]:
                out.write("<span")
                css = 0
                while css < 32:
                    if attr & (1 << css):
                        out.write(" class='tviewc%s%d'"
                                  % ("u" if attr & (1 << UNDERLINE_FLAG)
                                     else "", css))
                        break
                    css += 1
                out.write(">")
            out.write({"<": "&lt;", ">": "&gt;", "&": "&amp;"}
                      .get(ch, ch))
            if x + 1 == screen.mcol or attr != row[x + 1][1]:
                out.write("</span>")
        if y + 1 < len(rows):
            out.write("<br/>")
    out.write("</pre></div></body></html>")


_HELP_LINES = [
    "        -=-    Help    -=- ",
    "",
    "?          This window",
    "Arrows     Small scroll movement",
    "h,j,k,l    Small scroll movement",
    "H,J,K,L    Large scroll movement",
    "ctrl-H     Scroll 1k left",
    "ctrl-L     Scroll 1k right",
    "space      Scroll one screen",
    "backspace  Scroll back one screen",
    "g          Go to specific location",
    "m          Color for mapping qual",
    "n          Color for nucleotide",
    "b          Color for base quality",
    ".          Toggle on/off dot view",
    "i          Toggle on/off ins",
    "v          Inverse video",
    "q          Exit",
    "",
    "Underline:      Secondary or orphan",
    "Blue:    0-9    Green: 10-19",
    "Yellow: 20-29   White: >=30",
]


def curses_loop(tv, header, fai) -> int:
    """Interactive curses display (bam_tview_curses.c:374 loop).  The
    Screen grid drawn by ``draw`` is blitted each keystroke; pair/attr
    bits map 1:1 onto curses color pairs."""
    import curses

    def fetch_ref(tid, left, width):
        if fai is None:
            return None
        try:
            return fai.fetch(header.ref_name(tid), left, left + width)
        except Exception:
            return None

    def init_colors(scr, inverse):
        if not curses.has_colors():
            return
        curses.start_color()
        curses.use_default_colors()
        C = curses
        if inverse:
            pairs = [(C.COLOR_WHITE, C.COLOR_BLUE),
                     (C.COLOR_BLACK, C.COLOR_GREEN),
                     (C.COLOR_BLACK, C.COLOR_YELLOW),
                     (C.COLOR_BLACK, C.COLOR_WHITE),
                     (C.COLOR_BLACK, C.COLOR_GREEN),
                     (C.COLOR_BLACK, C.COLOR_CYAN),
                     (C.COLOR_WHITE, C.COLOR_MAGENTA),
                     (C.COLOR_WHITE, C.COLOR_RED),
                     (C.COLOR_WHITE, C.COLOR_BLUE)]
        else:
            pairs = [(C.COLOR_BLUE, -1), (C.COLOR_GREEN, -1),
                     (C.COLOR_YELLOW, -1), (C.COLOR_WHITE, -1),
                     (C.COLOR_GREEN, -1), (C.COLOR_CYAN, -1),
                     (C.COLOR_MAGENTA, -1), (C.COLOR_RED, -1),
                     (C.COLOR_BLUE, -1)]
        for i, (fg, bg) in enumerate(pairs, start=1):
            try:
                curses.init_pair(i, fg, bg)
            except curses.error:
                pass

    def run(scr):
        curses.curs_set(0)
        inverse = False
        init_colors(scr, inverse)
        row_shift = 0
        tid = tv["tid"]
        pos = tv["left_pos"]

        def redraw():
            mrow, mcol = scr.getmaxyx()
            tv["mcol"] = mcol
            tv["mrow"] = mrow
            tv["tid"] = tid
            tv["left_pos"] = pos
            tv["ref"] = fetch_ref(tid, pos, mcol)
            screen = Screen(mcol)
            draw(tv, screen)
            scr.erase()
            nrows = len(screen.rows)
            out_y = 0
            for y in range(nrows):
                if y > TV_MIN_ALNROW:
                    if y - (TV_MIN_ALNROW + 1) < row_shift:
                        continue
                if out_y >= mrow:
                    break
                for x, (ch, attr) in enumerate(screen.rows[y]):
                    if x >= mcol - 1:
                        break
                    cattr = 0
                    for pair in range(1, 10):
                        if attr & colorpair(pair):
                            cattr |= curses.color_pair(pair)
                            break
                    if attr & underline():
                        cattr |= curses.A_UNDERLINE
                    try:
                        scr.addch(out_y, x, ch, cattr)
                    except curses.error:
                        pass
                out_y += 1
            scr.refresh()

        def win_help():
            mrow, mcol = scr.getmaxyx()
            h = min(len(_HELP_LINES) + 2, mrow)
            w = min(40, mcol)
            win = curses.newwin(h, w, 2, max(0, (mcol - w) // 2))
            win.border()
            for r, line in enumerate(_HELP_LINES[:h - 2], start=1):
                try:
                    win.addstr(r, 2, line[:w - 3])
                except curses.error:
                    pass
            win.refresh()
            win.getch()

        def win_goto():
            nonlocal tid, pos
            mcol = scr.getmaxyx()[1]
            w = min(40, mcol)
            win = curses.newwin(3, w, 2, max(0, (mcol - w) // 2))
            win.border()
            win.addstr(1, 2, "Goto: ")
            curses.echo()
            curses.curs_set(1)
            try:
                s = win.getstr(1, 8, w - 10).decode("latin-1").strip()
            except Exception:
                s = ""
            curses.noecho()
            curses.curs_set(0)
            if s:
                try:
                    region = parse_region(s, header.tid)
                    if region.tid >= 0:
                        tid = region.tid
                        pos = region.beg
                except RegionError:
                    pass

        redraw()
        while True:
            c = scr.getch()
            if c in (ord("q"), 27):
                break
            elif c == ord("?"):
                win_help()
            elif c in (ord("g"), ord("/")):
                win_goto()
            elif c == ord("m"):
                tv["color_for"] = "mapq"
            elif c == ord("b"):
                tv["color_for"] = "baseq"
            elif c == ord("n"):
                tv["color_for"] = "nucl"
            elif c == ord("v"):
                inverse = not inverse
                init_colors(scr, inverse)
            elif c in (curses.KEY_LEFT, ord("h")):
                pos -= 1
            elif c in (curses.KEY_RIGHT, ord("l")):
                pos += 1
            elif c in (curses.KEY_SLEFT, ord("H")):
                pos -= 20
            elif c in (curses.KEY_SRIGHT, ord("L")):
                pos += 20
            elif c == ord("."):
                tv["is_dot"] = not tv["is_dot"]
            elif c == ord("c"):
                tv["base_for"] = ("cs" if tv.get("base_for") != "cs"
                                  else None)
            elif c == ord("i"):
                tv["ins"] = not tv["ins"]
            elif c == 0x08:       # ctrl-H
                pos -= 1000
            elif c == 0x0C:       # ctrl-L
                pos += 1000
            elif c == ord(" "):
                pos += scr.getmaxyx()[1]
            elif c in (curses.KEY_UP, ord("j")):
                row_shift -= 1
            elif c == ord("J"):
                row_shift -= 20
            elif c in (curses.KEY_DOWN, ord("k")):
                row_shift += 1
            elif c == ord("K"):
                row_shift += 20
            elif c in (curses.KEY_BACKSPACE, 0x7F):
                pos -= scr.getmaxyx()[1]
            elif c == curses.KEY_RESIZE:
                pass
            else:
                continue
            pos = max(pos, 0)
            row_shift = max(row_shift, 0)
            redraw()
        return 0

    return curses.wrapper(run)


def usage(fp):
    fp.write("Usage: samtools tview [options] <aln.bam> [ref.fasta]\n"
             "Options:\n"
             "   -d display      output as (H)tml or (C)urses or (T)ext \n"
             "   -X              include customized index file\n"
             "   -p chr:pos      go directly to this position\n"
             "   -s STR          display only reads from this sample or group\n"
             "   -w INT          display width (with -d T only)\n"
             "   -i              hide inserts\n")


def main_tview(argv: list[str], device=None) -> int:
    """``samtools tview``; ``device``: where K13 runs (None: the CUDA
    card; ``SAMTPU_DEVICE=0|host``: the host)."""
    ga = GlobalArgs()
    view_mode = "C"
    samples = None
    position = None
    display_width = 0
    show_inserts = 1
    has_index_file = False
    try:
        opts, args = gnu_getopt(argv, "s:p:d:Xw:i", [])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-w":
            display_width = int(v)
        elif o == "-s":
            samples = v
        elif o == "-p":
            position = v
        elif o == "-X":
            has_index_file = True
        elif o == "-i":
            show_inserts = 0
        elif o == "-d":
            view_mode = {"H": "H", "h": "H", "T": "T", "t": "T"} \
                .get(v[:1], "C")
        elif handle_global_opt(ga, o, v):
            pass
        else:
            usage(sys.stderr)
            return 1
    if not args:
        usage(sys.stderr)
        return 1

    fn = args[0]
    if has_index_file:
        ref_fa = args[2] if len(args) > 2 else ga.reference
    else:
        ref_fa = args[1] if len(args) > 1 else ga.reference

    if view_mode == "C" and not sys.stdout.isatty():
        print_error("tview",
                    "curses display requires a terminal;"
                    " use -d T or -d H")
        return 1
    try:
        dev = pick_device(device)
    except RuntimeError as e:
        return no_card("tview", e)

    try:
        f = read_alignments(fn, threads=ga.nthreads)
    except OSError as e:
        print_error_errno("tview", 'can\'t open "%s"', fn, exc=e)
        return 1
    header = f.header

    mcol = 80
    colstr = os.environ.get("COLUMNS")
    if colstr:
        try:
            mcol = int(colstr)
        except ValueError:
            mcol = 80
        if mcol < 10:
            mcol = 80
    if display_width:
        mcol = display_width

    tid = 0
    left_pos = 0
    if position:
        try:
            region = parse_region(position, header.tid)
        except RegionError:
            sys.stderr.write("Unknown reference or malformed region\n")
            return 1
        if region.tid < 0:
            sys.stderr.write("Unknown reference or malformed region\n")
            return 1
        tid = region.tid
        left_pos = region.beg

    fai = None
    ref_bytes = None
    if ref_fa:
        try:
            fai = load_fasta(ref_fa)
        except Exception:
            sys.stderr.write("Could not read the reference sequence.\n")
            return 1
        if not position:
            for i, name in enumerate(header.ref_names):
                if fai.has(name):
                    tid = i
                    break
        try:
            ref_bytes = fai.fetch(header.ref_name(tid), left_pos,
                                  left_pos + mcol)
        except Exception:
            ref_bytes = None

    batch = f.batch
    if samples:
        # restrict to read groups of this sample/group (bam_tview.c:55)
        rg_ids = set()
        for line in header.text.split("\n"):
            if not line.startswith("@RG"):
                continue
            fields = dict(x.split(":", 1) for x in line.split("\t")[1:]
                          if ":" in x)
            if fields.get("ID") == samples or \
                    fields.get("SM") == samples:
                rg_ids.add(fields.get("ID"))
        if not rg_ids:
            print_error("tview",
                        'The sample or read group "%s" not present.',
                        samples)
            return 1
        from ..core.aux import batch_tag_str_values
        rgs = batch_tag_str_values(batch, "RG")
        keep = np.array([rg in rg_ids if rg is not None else False
                         for rg in rgs])
        batch = batch.take(np.nonzero(keep)[0])

    tv = {
        "header": header,
        "batch": batch,
        "left_pos": left_pos,
        "tid": tid,
        "mcol": mcol,
        "mrow": 99999,
        "ref": ref_bytes,
        "bca": BcfCallAux(0.83, 13),
        "ins": show_inserts,
        "is_dot": 1,
        "dev": dev,
    }
    if view_mode == "C":
        try:
            return curses_loop(tv, header, fai)
        except ImportError:
            print_error("tview", "python curses is unavailable;"
                        " use -d T or -d H")
            return 1

    screen = Screen(mcol)
    draw(tv, screen)

    title = "%s:%d" % (header.ref_name(tid), left_pos + 1)
    if view_mode == "H":
        emit_html(screen, sys.stdout, title)
    else:
        emit_text(screen, sys.stdout)
    sys.stdout.flush()
    return 0
