"""Exact scalar/row-vectorized DP kernels (the behavioral oracle).

These reproduce the reference's alignment kernels cell-for-cell:

  * ``extend2``  — banded seed extension with z-drop, end bonus and adaptive
                   band (ksw.c:380-479 ksw_extend2).
  * ``global2``  — banded global alignment with traceback -> CIGAR
                   (ksw.c:504-607 ksw_global2).
  * ``local_sw`` — local Smith-Waterman with second-best tracking
                   (ksw.c:111-335 ksw_u8/ksw_i16 semantics).
  * ``align2``   — local SW + reverse second pass for start coordinates
                   (ksw.c:343-365 ksw_align2).

They are the ground truth the device kernels (ops/) are tested against,
and the host fallback for odd-shaped problems.  Inner rows are vectorized
with numpy using an exact prefix-scan formulation of the F (gap-in-query)
dependency; all tie-breaking, early-exit and band-shrink behaviors match
the reference code cited above.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

MINUS_INF = -0x40000000

# xtra flag bits (ksw.h)
KSW_XBYTE = 0x10000
KSW_XSUBO = 0x20000
KSW_XSTOP = 0x40000
KSW_XSTART = 0x80000


def extend2(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    end_bonus: int,
    zdrop: int,
    h0: int,
) -> Tuple[int, int, int, int, int, int]:
    """ksw_extend2: returns (score, qle, tle, gtle, gscore, max_off).

    Exact port of ksw.c:380-479 with the inner row vectorized (the F
    dependency becomes a running-max prefix scan; see module docstring).
    """
    qlen, tlen = len(query), len(target)
    assert h0 > 0
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qprof = mat[:, query].astype(np.int64)  # (5, qlen): qprof[tc, j]

    ehh = np.zeros(qlen + 1, dtype=np.int64)
    ehe = np.zeros(qlen + 1, dtype=np.int64)
    # first row (ksw.c:395-397)
    ehh[0] = h0
    if qlen >= 1:
        ehh[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and ehh[j - 1] > e_ins:
            ehh[j] = ehh[j - 1] - e_ins
            j += 1
    # adjust w (ksw.c:399-407)
    max_mat = int(mat.max())
    max_ins = int((qlen * max_mat + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_mat + end_bonus - o_del) / e_del + 1.0)
    w = min(w, max(max_del, 1))

    maxv, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    jidx = np.arange(qlen + 1, dtype=np.int64)
    for i in range(tlen):
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        h1_init = h0 - (o_del + e_del * (i + 1)) if beg == 0 else 0
        if h1_init < 0:
            h1_init = 0
        q = qprof[target[i]]
        sl = slice(beg, end)
        Hdiag = ehh[sl].copy()
        E = ehe[sl].copy()
        M = np.where(Hdiag != 0, Hdiag + q[sl], 0)  # the M-zero quirk (ksw.c:433)
        # F prefix scan: F(beg)=0; F(j)=max(F(j-1)-e_ins, max(M(j-1)-oe_ins,0))
        u = np.maximum(M - oe_ins, 0)
        n = end - beg
        F = np.zeros(n, dtype=np.int64)
        if n > 1:
            v = u[:-1] + jidx[:n - 1] * e_ins
            run = np.maximum.accumulate(v)
            F[1:] = np.maximum(run - (jidx[1:n] - 1) * e_ins, 0)
        H = np.maximum(np.maximum(M, E), F)
        # E(i+1, j)
        ehe[sl] = np.maximum(E - e_del, np.maximum(M - oe_del, 0))
        # row max m and mj (ties -> largest j; ksw.c:437-438)
        if n > 0:
            m = int(H.max())
            mj = beg + int(np.flatnonzero(H == m)[-1]) if m > 0 else beg + n - 1
        else:
            m, mj = 0, -1
        # shifted write-back: ehh[j] = H(i, j-1)
        ehh[beg] = h1_init
        ehh[beg + 1 : end + 1] = H
        ehe[end] = 0
        h1_last = H[-1] if n > 0 else h1_init
        if end == qlen:
            # ksw.c:451-452: max_ie also updates when gscore ties h1
            if not (gscore > h1_last):
                max_ie = i
            gscore = max(gscore, int(h1_last))
        if m == 0:
            break
        if m > maxv:
            maxv, max_i, max_j = m, i, mj
            if abs(mj - i) > max_off:
                max_off = abs(mj - i)
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if maxv - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if maxv - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the band (ksw.c:466-469)
        j = beg
        while j < end and ehh[j] == 0 and ehe[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and ehh[j] == 0 and ehe[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen
    return int(maxv), max_j + 1, max_i + 1, max_ie + 1, int(gscore), int(max_off)


def _push_cigar(cigar: List[Tuple[int, int]], op: int, length: int) -> None:
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + length)
    else:
        cigar.append((op, length))


def global2(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    w: int,
    want_cigar: bool = True,
) -> Tuple[int, Optional[List[Tuple[int, int]]]]:
    """ksw_global2: banded global alignment; returns (score, cigar).

    cigar ops: 0=M, 1=I (gap in target), 2=D (gap in query), as the
    reference's push_cigar produces (ksw.c:504-607)."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qprof = mat[:, query].astype(np.int64)
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None

    ehh = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    ehe = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    ehh[0] = 0
    for j in range(1, qlen + 1):
        if j > w:
            break
        ehh[j] = -(o_ins + e_ins * j)
    for i in range(tlen):
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1_init = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        if end <= beg:
            ehh[end] = h1_init
            ehe[end] = MINUS_INF
            continue
        q = qprof[target[i]]
        sl = slice(beg, end)
        Hdiag = ehh[sl].copy()
        E = ehe[sl].copy()
        M = Hdiag + q[sl]
        n = end - beg
        # F(beg) = -inf; F(j) = max(F(j-1)-e_ins, M(j-1)-oe_ins)
        F = np.full(n, MINUS_INF, dtype=np.int64)
        if n > 1:
            jr = np.arange(n - 1, dtype=np.int64)
            v = (M[:-1] - oe_ins) + jr * e_ins
            run = np.maximum.accumulate(v)
            F[1:] = run - jr * e_ins
        d = np.where(M >= E, 0, 1).astype(np.uint8)
        H = np.maximum(M, E)
        d = np.where(H >= F, d, 2).astype(np.uint8)
        H = np.maximum(H, F)
        # e bits: (E - e_del) > (M - oe_del) -> 1<<2
        newE = np.maximum(E - e_del, M - oe_del)
        d |= ((E - e_del) > (M - oe_del)).astype(np.uint8) << 2
        # f bits: (F - e_ins) > (M - oe_ins) -> 2<<4 (ksw.c: a traceback in
        # the F state reads bits 4-5 and must read 2 to stay in it)
        d |= ((F - e_ins) > (M - oe_ins)).astype(np.uint8) << 5
        if want_cigar:
            z[i, : n] = d
        ehe[sl] = newE
        ehh[beg] = h1_init
        ehh[beg + 1 : end + 1] = H
        ehe[end] = MINUS_INF
    score = int(ehh[qlen])
    if not want_cigar:
        return score, None
    cigar: List[Tuple[int, int]] = []
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        beg = max(i - w, 0)
        which = (int(z[i, k - beg]) >> (which << 1)) & 3
        if which == 0:
            _push_cigar(cigar, 0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push_cigar(cigar, 2, 1)
            i -= 1
        else:
            _push_cigar(cigar, 1, 1)
            k -= 1
    if i >= 0:
        _push_cigar(cigar, 2, i + 1)
    if k >= 0:
        _push_cigar(cigar, 1, k + 1)
    cigar.reverse()
    return score, cigar


@dataclass
class KswResult:
    """kswr_t (ksw.h): local-SW result."""

    score: int = 0
    te: int = -1
    qe: int = -1
    score2: int = -1
    te2: int = -1
    tb: int = -1
    qb: int = -1


def local_sw(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    minsc: int = 0x10000,
    endsc: int = 0x10000,
    score_cap: Optional[int] = None,
) -> KswResult:
    """Local SW with the reference's second-best bookkeeping.

    Mirrors ksw_u8/ksw_i16 (ksw.c:111-335): per-row maxima tracked in a
    merged-runs array for score2/te2; qe is the smallest query index
    achieving the row max at te; early stop when gmax >= endsc; u8 score
    saturation expressed via score_cap=255."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qprof = mat[:, query].astype(np.int64)
    r = KswResult()
    E = np.zeros(qlen, dtype=np.int64)
    Hprev = np.zeros(qlen, dtype=np.int64)
    Hmax = np.zeros(qlen, dtype=np.int64)
    b: List[Tuple[int, int]] = []  # (imax, i) runs
    gmax, te = 0, -1
    jr = np.arange(qlen - 1, dtype=np.int64) if qlen > 1 else None
    for i in range(tlen):
        q = qprof[target[i]]
        Hdiag = np.empty(qlen, dtype=np.int64)
        Hdiag[0] = 0
        Hdiag[1:] = Hprev[:-1]
        Hpre = np.maximum(np.maximum(Hdiag + q, 0), E)  # H without F
        # F scan: F(0)=0; F(j) = max(0, F(j-1)-e_ins, Hpre(j-1)-oe_ins)
        F = np.zeros(qlen, dtype=np.int64)
        if qlen > 1:
            v = (Hpre[:-1] - oe_ins) + jr * e_ins
            run = np.maximum.accumulate(v)
            F[1:] = np.maximum(run - jr * e_ins, 0)
        H = np.maximum(Hpre, F)
        E = np.maximum(np.maximum(E - e_del, H - oe_del), 0)
        Hprev = H
        imax = int(H.max()) if qlen else 0
        if imax >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append((imax, i))
            elif b[-1][0] < imax:
                b[-1] = (imax, i)
        if imax > gmax:
            gmax, te = imax, i
            Hmax = H.copy()
            if (score_cap is not None and gmax >= score_cap) or gmax >= endsc:
                break
    r.score = gmax if score_cap is None or gmax < score_cap else score_cap
    r.te = te
    if score_cap is None or r.score != score_cap:
        if qlen and gmax > 0:
            mx = int(Hmax.max())
            r.qe = int(np.flatnonzero(Hmax == mx)[0])
        if b:
            max_mat = int(mat.max())
            rng = (r.score + max_mat - 1) // max_mat
            low, high = te - rng, te + rng
            for sc, e in b:
                if (e < low or e > high) and sc > r.score2:
                    r.score2, r.te2 = sc, e
    return r


def align2(
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    xtra: int,
) -> KswResult:
    """ksw_align2 (ksw.c:343-365): forward local SW; if KSW_XSTART, align
    the reversed prefixes to recover (qb, tb)."""
    minsc = (xtra & 0xFFFF) if (xtra & KSW_XSUBO) else 0x10000
    endsc = (xtra & 0xFFFF) if (xtra & KSW_XSTOP) else 0x10000
    cap = 255 if (xtra & KSW_XBYTE) else None
    r = local_sw(query, target, mat, o_del, e_del, o_ins, e_ins, minsc, endsc, cap)
    if not (xtra & KSW_XSTART):
        return r
    if (xtra & KSW_XSUBO) and r.score < (xtra & 0xFFFF):
        return r
    if r.qe < 0 or r.te < 0:
        return r
    q2 = query[: r.qe + 1][::-1].copy()
    t2 = target[: r.te + 1][::-1].copy()
    rr = local_sw(q2, t2, mat, o_del, e_del, o_ins, e_ins, 0x10000, r.score, cap)
    if r.score == rr.score:
        r.tb = r.te - rr.te
        r.qb = r.qe - rr.qe
    return r


# ---------------------------------------------------------------------------
# brute-force oracles for testing the oracles
# ---------------------------------------------------------------------------

def brute_local_sw(query, target, mat, o_del, e_del, o_ins, e_ins):
    """O(n*m) unoptimized local SW for cross-checking."""
    qlen, tlen = len(query), len(target)
    H = np.zeros((tlen + 1, qlen + 1), dtype=np.int64)
    E = np.zeros((tlen + 1, qlen + 1), dtype=np.int64)  # gap in query (del)
    F = np.zeros((tlen + 1, qlen + 1), dtype=np.int64)  # gap in target (ins)
    best, bi, bj = 0, -1, -1
    for i in range(1, tlen + 1):
        for j in range(1, qlen + 1):
            E[i][j] = max(E[i - 1][j] - e_del, H[i - 1][j] - o_del - e_del, 0)
            F[i][j] = max(F[i][j - 1] - e_ins, H[i][j - 1] - o_ins - e_ins, 0)
            H[i][j] = max(
                0,
                H[i - 1][j - 1] + mat[target[i - 1], query[j - 1]],
                E[i][j],
                F[i][j],
            )
            if H[i][j] > best:
                best, bi, bj = int(H[i][j]), i - 1, j - 1
    return best, bi, bj


def brute_global(query, target, mat, o_del, e_del, o_ins, e_ins):
    """Unbanded global affine alignment score."""
    qlen, tlen = len(query), len(target)
    NEG = -(1 << 40)
    H = np.full((tlen + 1, qlen + 1), NEG, dtype=np.int64)
    E = np.full((tlen + 1, qlen + 1), NEG, dtype=np.int64)
    F = np.full((tlen + 1, qlen + 1), NEG, dtype=np.int64)
    H[0][0] = 0
    for j in range(1, qlen + 1):
        F[0][j] = max(F[0][j - 1] - e_ins, H[0][j - 1] - o_ins - e_ins)
        H[0][j] = F[0][j]
    for i in range(1, tlen + 1):
        E[i][0] = max(E[i - 1][0] - e_del, H[i - 1][0] - o_del - e_del)
        H[i][0] = E[i][0]
        for j in range(1, qlen + 1):
            E[i][j] = max(E[i - 1][j] - e_del, H[i - 1][j] - o_del - e_del)
            F[i][j] = max(F[i][j - 1] - e_ins, H[i][j - 1] - o_ins - e_ins)
            H[i][j] = max(H[i - 1][j - 1] + mat[target[i - 1], query[j - 1]], E[i][j], F[i][j])
    return int(H[tlen][qlen])
