"""Ancillary misc/ tools: md5fa, md5sum-lite, seq_cache_populate.

Counterpart of samtools_tpu/tools/misc_cmds.py, samtools' misc/md5fa.c
(per-sequence and ordered/unordered file MD5s), misc/md5sum-lite.c (an
md5sum drop-in) and misc/seq_cache_populate.pl (REF_CACHE population:
one file per sequence named by its MD5 under <root>/xx/yy/rest).
samtools ships these as standalone programs; here they are subcommands
of the one CLI.  Host commands: no device work.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import sys


def _fasta_records(path: str):
    """(name, cleaned_seq_bytes) per record; printable chars uppercased
    (md5fa.c:61-64 filter — identical to htslib's ref MD5 rule)."""
    if path == "-":
        fh = sys.stdin.buffer
    else:
        fh = open(path, "rb")
        if fh.read(2) == b"\x1f\x8b":
            fh.close()
            fh = gzip.open(path, "rb")
        else:
            fh.seek(0)
    name = None
    parts: list[bytes] = []
    try:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">") or line.startswith(b"@"):
                if name is not None:
                    yield name, _clean(b"".join(parts))
                name = line[1:].split()[0].decode("latin-1") if \
                    len(line) > 1 else ""
                parts = []
            elif line.startswith(b"+") and name is not None and parts:
                # FASTQ qual section: emit and skip quals
                yield name, _clean(b"".join(parts))
                name = None
                parts = []
                next(fh, None)
            else:
                if name is not None:
                    parts.append(line)
        if name is not None:
            yield name, _clean(b"".join(parts))
    finally:
        if fh is not sys.stdin.buffer:
            fh.close()


def _clean(seq: bytes) -> bytes:
    out = bytearray()
    for c in seq:
        if 0x21 <= c <= 0x7E:
            out.append(c - 32 if 0x61 <= c <= 0x7A else c)
    return bytes(out)


def main_md5fa(argv: list[str]) -> int:
    paths = argv or ["-"]
    for fn in paths:
        try:
            md5_all = hashlib.md5()
            unordered = bytearray(16)
            for name, seq in _fasta_records(fn):
                digest = hashlib.md5(seq).digest()
                for i in range(16):
                    unordered[i] ^= digest[i]
                sys.stdout.write("%s  %s  %s\n"
                                 % (digest.hex(), fn, name))
                md5_all.update(seq)
            sys.stdout.write("%s  %s  >ordered\n"
                             % (md5_all.hexdigest(), fn))
            sys.stdout.write("%s  %s  >unordered\n"
                             % (bytes(unordered).hex(), fn))
        except OSError:
            sys.stderr.write("md5fa: %s: No such file or directory\n"
                             % fn)
            return 1
    return 0


def main_md5sum_lite(argv: list[str]) -> int:
    """md5sum drop-in (misc/md5sum-lite.c)."""
    paths = argv or ["-"]
    for fn in paths:
        try:
            h = hashlib.md5()
            fh = sys.stdin.buffer if fn == "-" else open(fn, "rb")
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
            if fn != "-":
                fh.close()
            sys.stdout.write("%s  %s\n"
                             % (h.hexdigest(), "-" if fn == "-" else fn))
        except OSError:
            sys.stderr.write("md5sum-lite: %s: No such file or "
                             "directory\n" % fn)
            return 1
    return 0


def main_seq_cache_populate(argv: list[str]) -> int:
    """seq_cache_populate.pl: write each sequence into
    <root>/<md5[0:2]>/<md5[2:4]>/<md5[4:]> for REF_CACHE lookup."""
    root = None
    subdirs = 2
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-root":
            i += 1
            root = argv[i]
        elif a == "-subdirs":
            i += 1
            subdirs = int(argv[i])
        else:
            args.append(a)
        i += 1
    if root is None or not args:
        sys.stderr.write(
            "Usage: samtools_tpu_torch seq_cache_populate -root <dir> "
            "[-subdirs <n>] <fasta> ...\n")
        return 1
    n = 0
    for fn in args:
        try:
            for name, seq in _fasta_records(fn):
                md5 = hashlib.md5(seq).hexdigest()
                parts = [md5[2 * k:2 * k + 2] for k in range(subdirs)]
                d = os.path.join(root, *parts)
                os.makedirs(d, exist_ok=True)
                dest = os.path.join(d, md5[2 * subdirs:])
                if not os.path.exists(dest):
                    with open(dest + ".tmp", "wb") as out:
                        out.write(seq)
                    os.replace(dest + ".tmp", dest)
                sys.stderr.write("%s -> %s\n" % (name, dest))
                n += 1
        except OSError as e:
            sys.stderr.write("seq_cache_populate: %s: %s\n"
                             % (fn, e.strerror))
            return 1
    sys.stderr.write("Processed %d sequences\n" % n)
    return 0
