"""MAQ error model: per-column genotype likelihoods on the host.

Counterpart of samtools_tpu/ops/errmod.py (``ErrMod`` :25, ``_SEQ_NT16_INT``
:139, ``BcfCallAux`` :146, ``bcf_call_glfgen`` :157): htslib's
errmod_init / errmod_cal, the engine behind samtools' bcf_call_glfgen
(bam2bcf.c:65-123), which gives tview its consensus line and phase and
targetcut their per-column calls.  The model is MAQ's: the
correlated-error discount fk, the rank-ordered tail-probability penalty
beta (in ``np.longdouble``, as the C code's ``long double``) and the
heterozygote binomial prior lhet.

The arithmetic is the JAX package's, step for step: ``cal`` sorts the
bases, keeps the first 255, and adds its f64 sums from the last sorted
base to the first.  A column holds at most 255 bases and m <= 5 alleles,
so this stays a host loop, one call a column.
"""

from __future__ import annotations

import math

import numpy as np

_LD = np.longdouble


class ErrMod:
    """errmod_t: tables for a given depcorr (= 1 - theta)."""

    def __init__(self, depcorr: float, eps: float = 0.03):
        self.depcorr = depcorr
        # fk[n] = (1-depcorr)^n * (1-eps) + eps; fk[0] = 1
        n = np.arange(256)
        self.fk = np.power(1.0 - depcorr, n) * (1.0 - eps) + eps
        self.fk[0] = 1.0
        # lC[n,k] = log C(n,k)
        lg = np.array([math.lgamma(i + 1) for i in range(257)])
        self._lg = lg
        # lhet[n,k] = log C(n,k) - n ln2  (computed lazily per lookup)
        self._beta_cache: dict = {}

    def _lC_row(self, n: int) -> np.ndarray:
        k = np.arange(n + 1)
        return self._lg[n] - self._lg[k] - self._lg[n - k]

    def lhet(self, n: int, k: int) -> float:
        if n > 255:
            n = 255
        if k > n:
            k = n
        return (self._lg[n] - self._lg[k] - self._lg[n - k]
                - math.log(2.0) * n)

    def beta(self, q: int, n: int) -> np.ndarray:
        """beta[q,n,k] for k=0..n: -4.343*log(P(>k errors)/P(>=k errors))
        with per-base error e = 10^(-q/10)."""
        key = (q, n)
        cached = self._beta_cache.get(key)
        if cached is not None:
            return cached
        e = 10.0 ** (-q / 10.0)
        le = _LD(math.log(e))
        le1 = _LD(math.log(1.0 - e))
        k = np.arange(n + 1)
        lpmf = self._lC_row(n).astype(_LD) + k * le + (n - k) * le1
        pmf = np.exp(lpmf)
        # tail[k] = sum_{i=k..n} pmf[i]; tail1[k] = sum_{i=k+1..n}
        tail = np.cumsum(pmf[::-1])[::-1]
        tail1 = np.concatenate([tail[1:], np.zeros(1, _LD)])
        with np.errstate(divide="ignore"):
            beta = (-4.343 * np.log(tail1 / tail)).astype(np.float64)
        self._beta_cache[key] = beta
        return beta

    def cal(self, bases: np.ndarray, m: int) -> np.ndarray:
        """errmod_cal: phred-scaled genotype likelihoods q[m*m].

        bases: uint16 array, packing q<<5 | strand<<4 | base(2-bit/allele).
        Entries beyond 255 are truncated (the C samples randomly; we take
        the first 255 after sorting, deterministic)."""
        q_out = np.zeros(m * m, np.float64)
        n = len(bases)
        if n == 0:
            return q_out
        b = np.sort(np.asarray(bases, np.uint16))
        if n > 255:
            b = b[:255]
            n = 255

        fsum = np.zeros(16, np.float64)
        bsum = np.zeros(16, np.float64)
        c = np.zeros(16, np.int64)
        w = np.zeros(32, np.int64)
        for j in range(n - 1, -1, -1):
            v = int(b[j])
            qv = v >> 5
            if qv > 63:
                qv = 63
            if qv < 4:
                qv = 4
            k = v & 0x1F
            beta = self.beta(qv, n)
            fsum[k & 0xF] += self.fk[w[k]]
            bsum[k & 0xF] += self.fk[w[k]] * beta[w[k]]
            c[k & 0xF] += 1
            w[k] += 1

        for j in range(m):
            # homozygous <j,j>
            tmp1 = tmp3 = 0.0
            tmp2 = 0
            for k in range(m):
                if k == j:
                    continue
                tmp1 += bsum[k]
                tmp2 += int(c[k])
                tmp3 += fsum[k]
            if tmp2:
                q_out[j * m + j] = tmp1
            # heterozygous <j,k>
            for k in range(j + 1, m):
                cjk = int(c[j] + c[k])
                tmp1 = 0.0
                tmp2 = 0
                for i in range(m):
                    if i == j or i == k:
                        continue
                    tmp1 += bsum[i]
                    tmp2 += int(c[i])
                if tmp2:
                    v = tmp1 - 4.343 * self.lhet(cjk, int(c[k]))
                else:
                    v = -4.343 * self.lhet(cjk, int(c[k]))
                q_out[j * m + k] = q_out[k * m + j] = v
            for k in range(m):
                if q_out[j * m + k] < 0.0:
                    q_out[j * m + k] = 0.0
        return q_out


_SEQ_NT16_INT = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                         np.int64)

DEF_MAPQ = 20
CAP_DIST = 25


class BcfCallAux:
    """bcf_call_init equivalent (bam2bcf.c:38-47)."""

    def __init__(self, theta: float = 0.83, min_baseQ: int = 13):
        if theta <= 0.0:
            theta = 0.83
        self.capQ = 60
        self.min_baseQ = min_baseQ
        self.e = ErrMod(1.0 - theta)


def bcf_call_glfgen(entries, ref_base16: int, bca: BcfCallAux):
    """Per-column genotype PL generation (bam2bcf.c:65-123).

    ``entries`` is an iterable of per-read tuples
    (is_del, is_refskip, flag, mapq, qual, base16) for this column.
    Returns (n_used, p[25], qsum[4])."""
    bases = []
    qsum = np.zeros(4, np.float64)
    for is_del, is_refskip, flag, mapq, qual, b16 in entries:
        if is_del or is_refskip or (flag & 4):
            continue
        mq = mapq if mapq < 255 else DEF_MAPQ
        q = int(qual)
        if q < bca.min_baseQ:
            continue
        if q > 99:
            q = 99
        if mq > bca.capQ:
            mq = bca.capQ
        if q > mq:
            q = mq
        if q > 63:
            q = 63
        if q < 4:
            q = 4
        b = int(_SEQ_NT16_INT[b16 if b16 else ref_base16])
        bases.append((q << 5) | (int(bool(flag & 16)) << 4) | b)
        if b < 4:
            qsum[b] += q
    n = len(bases)
    p = bca.e.cal(np.array(bases, np.uint16), 5)
    return n, p, qsum
