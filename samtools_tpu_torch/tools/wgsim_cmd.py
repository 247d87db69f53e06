"""wgsim — whole-genome read simulator.

Counterpart of samtools_tpu/tools/wgsim_cmd.py, samtools' misc/wgsim.c:
the same mutation model (hom/het substitutions, extendable indels), read
generation, recurrent sequencing errors, read naming, and mutation
report — driven by a bit-exact POSIX drand48 LCG, so a given -S seed
gives the JAX tool's FASTQs and mutation report byte for byte.

The code is a statement-level port of wgsim.c's control flow.  That is
forced, not chosen: matching the output for a given -S seed requires
consuming the drand48 stream in exactly the same order, so any
semantically-equivalent rewrite either reproduces this control flow or
loses seed parity.  Seed parity is what makes simulated-data fixtures
transferable between the two packages.  The port's vectorised simulator
is sim.py; this file exists for the parity contract.  A host command: no
device work.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from .common import UsageError, gnu_getopt

NOCHANGE, INSERT, SUBSTITUTE, DELETE = 0, 0x1000, 0xE000, 0xF000
MUTMSK = 0xF000

_NT4 = np.full(256, 4, np.uint16)
for _i, _b in enumerate("ACGT"):
    _NT4[ord(_b)] = _i
    _NT4[ord(_b.lower())] = _i


class Drand48:
    """POSIX drand48/srand48 (48-bit LCG), bit-exact."""

    __slots__ = ("x",)
    A = 0x5DEECE66D
    C = 0xB
    M = 1 << 48

    def __init__(self, seed: int = 0):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> float:
        self.x = (self.A * self.x + self.C) % self.M
        return self.x / self.M


def ran_normal(r: Drand48, state: list) -> float:
    """genran.c gaussian via polar Box-Muller with cached second value."""
    if state[0] == 0:
        while True:
            v1 = 2.0 * r.next() - 1.0
            v2 = 2.0 * r.next() - 1.0
            rsq = v1 * v1 + v2 * v2
            if not (rsq >= 1.0 or rsq == 0.0):
                break
        fac = math.sqrt(-2.0 * math.log(rsq) / rsq)
        state[0] = 1
        state[1] = v1 * fac
        return v2 * fac
    state[0] = 0
    return state[1]


def mut_diref(seq4, is_hap, r: Drand48, mut_rate, indel_frac, indel_extend):
    """Generate the two haplotypes' mut_t arrays (wgsim_mut_diref)."""
    n = seq4.size
    hap1 = seq4.astype(np.uint16).copy()
    hap2 = hap1.copy()
    deleting = 0
    for i in range(n):
        c = int(seq4[i])
        hap1[i] = hap2[i] = c
        if deleting:
            if r.next() < indel_extend:
                if deleting & 1:
                    hap1[i] |= DELETE
                if deleting & 2:
                    hap2[i] |= DELETE
                continue
            deleting = 0
        if c < 4 and r.next() < mut_rate:
            if r.next() >= indel_frac:  # substitution
                rr = r.next()
                c2 = (c + int(rr * 3.0 + 1)) & 3
                if is_hap or r.next() < 0.333333:
                    hap1[i] = hap2[i] = SUBSTITUTE | c2
                else:
                    if r.next() < 0.5:
                        hap1[i] = SUBSTITUTE | c2
                    else:
                        hap2[i] = SUBSTITUTE | c2
            else:  # indel
                if r.next() < 0.5:  # deletion
                    if is_hap or r.next() < 0.333333:
                        hap1[i] = hap2[i] = DELETE
                        deleting = 3
                    else:
                        deleting = 1 if r.next() < 0.5 else 2
                        if deleting == 1:
                            hap1[i] = DELETE
                        else:
                            hap2[i] = DELETE
                else:  # insertion
                    num_ins, ins = 0, 0
                    while True:
                        num_ins += 1
                        ins = (ins << 2) | int(r.next() * 4.0)
                        if not (num_ins < 4 and r.next() < indel_extend):
                            break
                    val = (num_ins << 12) | (ins << 4) | c
                    if is_hap or r.next() < 0.333333:
                        hap1[i] = hap2[i] = val
                    else:
                        if r.next() < 0.5:
                            hap1[i] = val
                        else:
                            hap2[i] = val
    return hap1, hap2


def print_mutref(out, name, seq4, hap1, hap2):
    """wgsim_print_mutref output (mutation report on stdout)."""
    ACGTN = "ACGTN"
    IUPAC = "XACMGRSVTWYHKDBN"
    n = seq4.size
    j = 0
    for i in range(n):
        c0 = int(seq4[i])
        c1 = int(hap1[i])
        c2 = int(hap2[i])
        if c0 >= 4:
            continue
        if (c1 & MUTMSK) == NOCHANGE and (c2 & MUTMSK) == NOCHANGE:
            continue
        if c1 == c2:  # hom
            if (c1 & MUTMSK) == SUBSTITUTE:
                out.write("%s\t%d\t%c\t%c\t-\n"
                          % (name, i + 1, ACGTN[c0], ACGTN[c1 & 0xF]))
            elif (c1 & MUTMSK) == DELETE:
                if i >= j:
                    run = []
                    j = i
                    while (j < n and hap1[j] == hap2[j]
                           and (int(hap1[j]) & MUTMSK) == DELETE):
                        run.append(ACGTN[int(seq4[j])])
                        j += 1
                    out.write("%s\t%d\t%s\t-\t-\n"
                              % (name, i + 1, "".join(run)))
            elif ((c1 & MUTMSK) >> 12) <= 4:  # ins
                nn, ins = (c1 & MUTMSK) >> 12, c1 >> 4
                run = []
                while nn > 0:
                    run.append(ACGTN[ins & 0x3])
                    ins >>= 2
                    nn -= 1
                out.write("%s\t%d\t-\t%s\t-\n" % (name, i + 1, "".join(run)))
        else:  # het
            if (c1 & MUTMSK) == SUBSTITUTE or (c2 & MUTMSK) == SUBSTITUTE:
                out.write("%s\t%d\t%c\t%c\t+\n"
                          % (name, i + 1, ACGTN[c0],
                             IUPAC[1 << (c1 & 0x3) | 1 << (c2 & 0x3)]))
            elif (c1 & MUTMSK) == DELETE:
                if i >= j:
                    run = []
                    j = i
                    while (j < n and hap1[j] != hap2[j]
                           and (int(hap1[j]) & MUTMSK) == DELETE):
                        run.append(ACGTN[int(seq4[j])])
                        j += 1
                    out.write("%s\t%d\t%s\t-\t-\n"
                              % (name, i + 1, "".join(run)))
            elif (c2 & MUTMSK) == DELETE:
                if i >= j:
                    run = []
                    j = i
                    while (j < n and hap1[j] != hap2[j]
                           and (int(hap2[j]) & MUTMSK) == DELETE):
                        run.append(ACGTN[int(seq4[j])])
                        j += 1
                    out.write("%s\t%d\t%s\t-\t-\n"
                              % (name, i + 1, "".join(run)))
            elif ((c1 & MUTMSK) >> 12) <= 4 and ((c1 & MUTMSK) >> 12) > 0:
                nn, ins = (c1 & MUTMSK) >> 12, c1 >> 4
                run = []
                while nn > 0:
                    run.append(ACGTN[ins & 0x3])
                    ins >>= 2
                    nn -= 1
                out.write("%s\t%d\t-\t%s\t+\n" % (name, i + 1, "".join(run)))
            elif ((c2 & MUTMSK) >> 12) <= 4 or ((c2 & MUTMSK) >> 12) > 0:
                nn, ins = (c2 & MUTMSK) >> 12, c2 >> 4
                run = []
                while nn > 0:
                    run.append(ACGTN[ins & 0x3])
                    ins >>= 2
                    nn -= 1
                out.write("%s\t%d\t-\t%s\t+\n" % (name, i + 1, "".join(run)))


def _read_fasta(path):
    """[(name, seq_bytes)] from a (possibly gzipped) FASTA."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    seqs = []
    name = None
    parts = []
    with op(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs.append((name, b"".join(parts)))
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs.append((name, b"".join(parts)))
    return seqs


def wgsim_core(out1, out2, mutout, fa_path, is_hap, N, dist, std_dev,
               size_l, size_r, err_rate, mut_rate, indel_frac,
               indel_extend, max_n_ratio, seed):
    r = Drand48(seed)
    nstate = [0, 0.0]
    max_size = max(size_l, size_r)
    Q = "I" if err_rate == 0.0 else chr(
        int(-10.0 * math.log(err_rate) / math.log(10.0) + 0.499) + 33)
    seqs = _read_fasta(fa_path)
    tot_len = sum(len(s) for _, s in seqs)
    sys.stderr.write("[wgsim_core] calculating the total length of the "
                     "reference sequence...\n")
    sys.stderr.write("[wgsim_core] %d sequences, total length: %d\n"
                     % (len(seqs), tot_len))
    sizes = (size_l, size_r)
    for name, seq in seqs:
        L = len(seq)
        n_pairs = int(L / tot_len * N + 0.5)
        if L < dist + 3 * std_dev:
            sys.stderr.write(
                "[wgsim_core] skip sequence '%s' as it is shorter than "
                "%d!\n" % (name, dist + 3 * std_dev))
            continue
        seq4 = _NT4[np.frombuffer(seq, np.uint8)]
        hap1, hap2 = mut_diref(seq4, is_hap, r, mut_rate, indel_frac,
                               indel_extend)
        print_mutref(mutout, name, seq4, hap1, hap2)
        haps = (hap1, hap2)
        ii = 0
        max_loop_err = False
        while ii != n_pairs:
            max_loop = 1000
            while True:  # try_again target (C: goto try_again)
                while True:  # boundary retry
                    ran = ran_normal(r, nstate) * std_dev + dist
                    d = int(ran + 0.5)
                    d = max(d, max_size)
                    pos = int((L - d + 1) * r.next())
                    if not (pos < 0 or pos >= L or pos + d - 1 >= L):
                        break
                if r.next() < 0.5:
                    fpo = (out1, out2)
                    s = (sizes[0], sizes[1])
                    is_flip = 0
                else:
                    fpo = (out2, out1)
                    s = (sizes[1], sizes[0])
                    is_flip = 1
                target = haps[0 if r.next() < 0.5 else 1]
                n_sub = [0, 0]
                n_indel = [0, 0]
                n_err = [0, 0]
                ext_coor = [-10, -10]
                reads = [[], []]
                # forward read
                k = 0
                i = pos
                while 0 <= i < L and k < s[0]:
                    c = int(target[i])
                    mt = c & MUTMSK
                    if ext_coor[0] < 0:
                        if mt != NOCHANGE and mt != SUBSTITUTE:
                            i += 1
                            continue
                        ext_coor[0] = i
                    if mt == DELETE:
                        n_indel[0] += 1
                    elif mt == NOCHANGE or mt == SUBSTITUTE:
                        reads[0].append(c & 0xF)
                        k += 1
                        if mt == SUBSTITUTE:
                            n_sub[0] += 1
                    else:
                        n_indel[0] += 1
                        reads[0].append(c & 0xF)
                        k += 1
                        nn, ins = mt >> 12, c >> 4
                        while nn > 0 and k < s[0]:
                            reads[0].append(ins & 0x3)
                            k += 1
                            nn -= 1
                            ins >>= 2
                    i += 1
                if k != s[0]:
                    ext_coor[0] = -10
                # reverse read
                k = 0
                i = pos + d - 1
                while 0 <= i < L and k < s[1]:
                    c = int(target[i])
                    mt = c & MUTMSK
                    if ext_coor[1] < 0:
                        if mt != NOCHANGE and mt != SUBSTITUTE:
                            i -= 1
                            continue
                        ext_coor[1] = i
                    if mt == DELETE:
                        n_indel[1] += 1
                    elif mt == NOCHANGE or mt == SUBSTITUTE:
                        reads[1].append(c & 0xF)
                        k += 1
                        if mt == SUBSTITUTE:
                            n_sub[1] += 1
                    else:
                        n_indel[1] += 1
                        nn, ins = mt >> 12, c >> 4
                        while nn > 0 and k < s[1]:
                            nn -= 1
                            reads[1].append((ins >> (2 * nn)) & 0x3)
                            k += 1
                        reads[1].append(c & 0xF)
                        k += 1
                    i -= 1
                if k != s[1]:
                    ext_coor[1] = -10
                reads[1] = [3 - c if c < 4 else 4 for c in reads[1]]
                if ext_coor[0] < 0 or ext_coor[1] < 0:
                    # C: --ii; continue -> same pair index retried with
                    # max_loop reset by the for-loop condition
                    max_loop = 1000
                    continue
                # sequencing errors (recurrent model: c -> (c+1)&3)
                jj = 2
                for j in range(2):
                    n_n = 0
                    for idx in range(s[j]):
                        c = reads[j][idx]
                        if c >= 4:
                            c = 4
                            n_n += 1
                        elif r.next() < err_rate:
                            c = (c + 1) & 3
                            n_err[j] += 1
                        reads[j][idx] = c
                    if n_n / s[j] > max_n_ratio:
                        jj = j
                        break
                if jj < 2:  # too many ambiguous bases
                    pre = max_loop
                    max_loop -= 1
                    if pre:
                        continue  # goto try_again (no max_loop reset)
                    if not max_loop_err:
                        sys.stderr.write(
                            "Failed to produce a sequence with "
                            "insufficient Ns. Omitting some "
                            "sequence-pairs\n")
                        max_loop_err = True
                    break  # pair omitted; ii still advances
                for j in range(2):
                    fpo[j].write("@%s_%d_%d_%d:%d:%d_%d:%d:%d_%x/%d\n"
                                 % (name, ext_coor[0] + 1, ext_coor[1] + 1,
                                    n_err[0], n_sub[0], n_indel[0],
                                    n_err[1], n_sub[1], n_indel[1], ii,
                                    is_flip + 1 if j == 0 else 2 - is_flip))
                    fpo[j].write("".join("ACGTN"[c] for c in reads[j]))
                    fpo[j].write("\n+\n" + Q * s[j] + "\n")
                break
            ii += 1


def usage(fp):
    fp.write("\nProgram: wgsim (short read simulator)\n"
             "Usage:   wgsim [options] <in.ref.fa> <out.read1.fq> "
             "<out.read2.fq>\n\n"
             "Options: -e FLOAT      base error rate [0.020]\n"
             "         -d INT        outer distance between the two ends "
             "[500]\n"
             "         -s INT        standard deviation [50]\n"
             "         -N INT        number of read pairs [1000000]\n"
             "         -1 INT        length of the first read [70]\n"
             "         -2 INT        length of the second read [70]\n"
             "         -r FLOAT      rate of mutations [0.0010]\n"
             "         -R FLOAT      fraction of indels [0.15]\n"
             "         -X FLOAT      probability an indel is extended "
             "[0.30]\n"
             "         -S INT        seed for random generator [0, use "
             "the current time]\n"
             "         -A FLOAT      discard if the fraction of ambiguous "
             "bases higher than FLOAT [0.05]\n"
             "         -h            haplotype mode\n\n")


def main_wgsim(argv: list[str]) -> int:
    err_rate, mut_rate = 0.02, 0.001
    indel_frac, indel_extend, max_n = 0.15, 0.3, 0.05
    N, dist, std_dev = 1000000, 500, 50
    size_l = size_r = 70
    is_hap = False
    seed = 0
    try:
        opts, args = gnu_getopt(argv, "e:d:s:N:1:2:r:R:hX:S:A:", [])
    except UsageError:
        usage(sys.stderr)
        return 1
    for o, v in opts:
        if o == "-e":
            err_rate = float(v)
        elif o == "-d":
            dist = int(v)
        elif o == "-s":
            std_dev = int(v)
        elif o == "-N":
            N = int(v)
        elif o == "-1":
            size_l = int(v)
        elif o == "-2":
            size_r = int(v)
        elif o == "-r":
            mut_rate = float(v)
        elif o == "-R":
            indel_frac = float(v)
        elif o == "-X":
            indel_extend = float(v)
        elif o == "-S":
            seed = int(v)
        elif o == "-A":
            max_n = float(v)
        elif o == "-h":
            is_hap = True
    if len(args) != 3:
        usage(sys.stderr)
        return 1
    if seed <= 0:
        import time
        seed = int(time.time())
    with open(args[1], "w") as o1, open(args[2], "w") as o2:
        wgsim_core(o1, o2, sys.stdout, args[0], is_hap, N, dist, std_dev,
                   size_l, size_r, err_rate, mut_rate, indel_frac,
                   indel_extend, max_n, seed)
    return 0
