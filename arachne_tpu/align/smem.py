"""SMEM seeding: super-maximal exact match collection over the FM-index.

Reproduces the reference's three-pass seed collection
(mem_collect_intv, bwamem.c:114-162):

  pass 1: all SMEMs via the forward-then-backward sweep (bwt_smem1a,
          bwt.c:289-351) keeping those >= min_seed_len;
  pass 2: re-seed long (>= min_seed_len*split_factor) low-occ
          (<= split_width) SMEMs from their midpoint with
          min_intv = occ+1;
  pass 3: LAST-like forward seeding (bwt_seed_strategy1, bwt.c:358-379)
          when max_mem_intv > 0.

This host implementation drives the batched FMIndex rank queries; the
fully-batched device formulation lives in ops/fm_rank.py and is verified
against this one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex


@dataclass
class SMEM:
    """A bi-interval match (bwtintv_t): rows [k, k+s) cover query [qb, qe)."""

    k: int   # x[0]: forward-BWT interval start
    l: int   # x[1]: reverse-BWT interval start
    s: int   # x[2]: interval size (occurrence count)
    qb: int  # query begin (info>>32)
    qe: int  # query end   ((uint32)info)

    @property
    def length(self) -> int:
        return self.qe - self.qb


def smem1a(
    idx: FMIndex,
    q: np.ndarray,
    x: int,
    min_intv: int,
    max_intv: int = 0,
) -> Tuple[int, List[SMEM]]:
    """bwt_smem1a (bwt.c:289-351): SMEMs covering query position x.

    Returns (next_x, mems) where next_x is the end of the longest exact
    match starting at x (the caller's scan-resumption point).
    """
    length = len(q)
    mems: List[SMEM] = []
    if q[x] > 3:
        return x + 1, mems
    if min_intv < 1:
        min_intv = 1
    x0, x1, x2 = idx.set_intv(np.array([int(q[x])]))
    ik = (int(x0[0]), int(x1[0]), int(x2[0]), x + 1)  # (k, l, s, info_end)

    # forward sweep, collecting interval-change points
    curr: List[Tuple[int, int, int, int]] = []
    i = x + 1
    while i < length:
        if ik[2] < max_intv:  # interval small enough (3rd-pass variant)
            curr.append(ik)
            break
        if q[i] < 4:
            c = 3 - int(q[i])  # complement for forward extension
            o0, o1, os = idx.extend(
                np.array([ik[0]]), np.array([ik[1]]), np.array([ik[2]]), is_back=False
            )
            if int(os[0, c]) != ik[2]:  # interval size changed
                curr.append(ik)
                if int(os[0, c]) < min_intv:
                    break
            ik = (int(o0[0, c]), int(o1[0, c]), int(os[0, c]), i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    curr.reverse()  # longer matches (smaller intervals) first
    ret = curr[0][3]
    prev = curr

    # backward sweep
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 else (int(q[i]) if q[i] < 4 else -1)
        curr = []
        for p in prev:
            if c >= 0 and p[2] >= max_intv:
                o0, o1, os = idx.extend(
                    np.array([p[0]]), np.array([p[1]]), np.array([p[2]]), is_back=True
                )
                oc = (int(o0[0, c]), int(o1[0, c]), int(os[0, c]), p[3])
            else:
                oc = None
            if c < 0 or p[2] < max_intv or (oc is not None and oc[2] < min_intv):
                if not curr:
                    if not mems or i + 1 < mems[-1].qb:
                        mems.append(SMEM(k=p[0], l=p[1], s=p[2], qb=i + 1, qe=p[3]))
            elif not curr or oc[2] != curr[-1][2]:
                curr.append(oc)
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()  # sorted by start coordinate
    return ret, mems


def seed_strategy1(
    idx: FMIndex, q: np.ndarray, x: int, min_len: int, max_intv: int
) -> Tuple[int, Optional[SMEM]]:
    """bwt_seed_strategy1 (bwt.c:358-379): LAST-like forward seeding."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    x0, x1, x2 = idx.set_intv(np.array([int(q[x])]))
    ik = (int(x0[0]), int(x1[0]), int(x2[0]))
    i = x + 1
    while i < length:
        if q[i] < 4:
            c = 3 - int(q[i])
            o0, o1, os = idx.extend(
                np.array([ik[0]]), np.array([ik[1]]), np.array([ik[2]]), is_back=False
            )
            nxt = (int(o0[0, c]), int(o1[0, c]), int(os[0, c]))
            if nxt[2] < max_intv and i - x >= min_len:
                if nxt[2] > 0:
                    return i + 1, SMEM(k=nxt[0], l=nxt[1], s=nxt[2], qb=x, qe=i + 1)
                return i + 1, None
            ik = nxt
        else:
            return i + 1, None
        i += 1
    return length, None


def collect_seeds(idx: FMIndex, q: np.ndarray, opt: MemOptions) -> List[SMEM]:
    """mem_collect_intv (bwamem.c:114-162): three-pass seed collection,
    sorted by (qb, qe) packed key exactly like the reference's intv sort."""
    length = len(q)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mems: List[SMEM] = []
    # pass 1
    x = 0
    while x < length:
        if q[x] < 4:
            x, found = smem1a(idx, q, x, 1, 0)
            for m in found:
                if m.length >= opt.min_seed_len:
                    mems.append(m)
        else:
            x += 1
    # pass 2: re-seed inside long, low-occ SMEMs
    old_n = len(mems)
    for k in range(old_n):
        p = mems[k]
        if p.length < split_len or p.s > opt.split_width:
            continue
        _, found = smem1a(idx, q, (p.qb + p.qe) >> 1, p.s + 1, 0)
        for m in found:
            if m.length >= opt.min_seed_len:
                mems.append(m)
    # pass 3: LAST-like
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(idx, q, x, opt.min_seed_len, opt.max_mem_intv)
                if m is not None and m.s > 0:
                    mems.append(m)
            else:
                x += 1
    # sort by packed (qb<<32|qe) like ks_introsort(mem_intv) on .info
    mems.sort(key=lambda m: (m.qb << 32) | m.qe)
    return mems
