"""samtools dict: a sequence dictionary from a FASTA.

Counterpart of samtools_tpu/tools/dict_cmd.py (samtools' dict.c): the MD5
of each sequence's printable bytes upper-cased, UR from the file's real
path, AN aliases with or without ``chr``, AH:* on ``-l``'s alternate
loci.  A host command: no device work.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import sys

from .common import UsageError, gnu_getopt, print_error_errno


def usage(fp):
    fp.write(
        "\nAbout:   Create a sequence dictionary file from a fasta file\n"
        "Usage:   samtools dict [options] <file.fa|file.fa.gz>\n\n"
        "Options: -a, --assembly STR    assembly\n"
        "         -A, --alias, --alternative-name\n"
        "                               add AN tag by adding/removing 'chr'\n"
        "         -H, --no-header       do not print @HD line\n"
        "         -l, --alt FILE        add AH:* tag to alternate locus sequences\n"
        "         -o, --output FILE     file to write out dict file [stdout]\n"
        "         -s, --species STR     species\n"
        "         -u, --uri STR         URI [file:///abs/path/to/file.fa]\n\n")


def _iter_fasta(data: bytes):
    """Yield (name, sequence_bytes) kseq-style (FASTA or FASTQ)."""
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        if c in (0x0A, 0x0D):
            i += 1
            continue
        if c in (ord(">"), ord("@")):
            is_fq = c == ord("@")
            j = data.find(b"\n", i)
            if j < 0:
                j = n
            hdr = data[i + 1:j].split()
            name = hdr[0].decode("latin-1") if hdr else ""
            i = j + 1
            seq = bytearray()
            while i < n and data[i] not in (ord(">"), ord("@"), ord("+")):
                j = data.find(b"\n", i)
                if j < 0:
                    j = n
                seq += data[i:j].rstrip(b"\r")
                i = j + 1
            if is_fq and i < n and data[i] == ord("+"):
                # skip qual section
                j = data.find(b"\n", i)
                i = j + 1 if j >= 0 else n
                qlen = 0
                while i < n and qlen < len(seq):
                    j = data.find(b"\n", i)
                    if j < 0:
                        j = n
                    qlen += len(data[i:j].rstrip(b"\r"))
                    i = j + 1
            yield name, bytes(seq)
        else:
            i += 1


def main_dict(argv: list[str]) -> int:
    assembly = species = uri = None
    alias = False
    header = True
    alt_fname = None
    output = None
    try:
        opts, args = gnu_getopt(argv, "?AhHa:l:s:u:o:",
                                ["help", "no-header", "alias", "alt=",
                                 "alternative-name", "assembly=",
                                 "species=", "uri=", "output="])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o in ("-A", "--alias", "--alternative-name"):
            alias = True
        elif o in ("-a", "--assembly"):
            assembly = v
        elif o in ("-l", "--alt"):
            alt_fname = v
        elif o in ("-s", "--species"):
            species = v
        elif o in ("-u", "--uri"):
            uri = v
        elif o in ("-o", "--output"):
            output = v
        elif o in ("-H", "--no-header"):
            header = False
        else:
            usage(sys.stderr)
            return 1
    if args:
        fname = args[0]
    elif not sys.stdin.isatty():
        fname = "-"
    else:
        usage(sys.stderr)
        return 1

    is_alt = set()
    if alt_fname:
        try:
            for line in open(alt_fname):
                line = line.rstrip("\n")
                if not line or line[0] == "@":
                    continue
                is_alt.add(line.split("\t")[0])
        except OSError as e:
            print_error_errno("dict", "Cannot open %s", alt_fname, exc=e)
            return 1

    try:
        if fname == "-":
            data = sys.stdin.buffer.read()
        else:
            with open(fname, "rb") as f:
                data = f.read()
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
    except OSError as e:
        print_error_errno("dict", "Cannot open %s", fname, exc=e)
        return 1

    out = open(output, "w") if output else sys.stdout
    if header:
        out.write("@HD\tVN:1.0\tSO:unsorted\n")
    for name, seq in _iter_fasta(data):
        # keep printable chars, uppercase (dict.c:79-82)
        filtered = bytes(c for c in seq if 0x21 <= c <= 0x7E).upper()
        md5 = hashlib.md5(filtered).hexdigest()
        out.write(f"@SQ\tSN:{name}\tLN:{len(filtered)}\tM5:{md5}")
        if name in is_alt:
            out.write("\tAH:*")
        if alias:
            if name.startswith("chr"):
                an = name[3:]
                out.write(f"\tAN:{an}")
            else:
                an = name
                out.write(f"\tAN:chr{an}")
            if an == "M":
                out.write(",chrMT,MT")
            elif an == "MT":
                out.write(",chrM,M")
        if uri:
            out.write(f"\tUR:{uri}")
        elif fname != "-":
            out.write(f"\tUR:file://{os.path.realpath(fname)}")
        if assembly:
            out.write(f"\tAS:{assembly}")
        if species:
            out.write(f"\tSP:{species}")
        out.write("\n")
    if output:
        out.close()
    return 0
