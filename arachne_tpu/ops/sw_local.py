"""Batched local Smith-Waterman on the device (mate-rescue kernel).

Batched reformulation of ksw_u8/ksw_i16 (ksw.c:111-335) with the same
shape strategy as sw_extend: problems on the trailing axis, query on the
leading one, a fori_loop over target rows whose body is a few elementwise
ops.

The device computes per-row maxima and the best-row H vector; the
reference's second-best bookkeeping (the merged-run "b array" feeding
score2/te2) is reconstructed exactly on the host from the per-row maxima —
it is a tiny O(tlen) pass per problem.

``align2_batch`` adds ksw_align2's reverse second pass (ksw.c:343-365) to
recover (qb, tb), again as a device batch.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..align.ksw import KswResult
from ..config import MemOptions


@functools.partial(
    jax.jit, static_argnames=("qmax", "tmax", "o_del", "e_del", "o_ins", "e_ins")
)
def local_sw_batch_kernel(
    qs: jnp.ndarray,      # (B, qmax) int8
    ts: jnp.ndarray,      # (B, tmax) int8
    qlens: jnp.ndarray,   # (B,)
    tlens: jnp.ndarray,   # (B,)
    endscs: jnp.ndarray,  # (B,) early-stop score (0x10000 = never)
    mat: jnp.ndarray,
    qmax: int,
    tmax: int,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
):
    B = qs.shape[0]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jidx = jnp.arange(qmax, dtype=jnp.int32)[:, None]
    qsT = qs.T.astype(jnp.int32)
    valid_q = jidx < qlens[None, :]

    state = dict(
        H=jnp.zeros((qmax, B), jnp.int32),
        E=jnp.zeros((qmax, B), jnp.int32),
        Hmax=jnp.zeros((qmax, B), jnp.int32),
        gmax=jnp.zeros((B,), jnp.int32),
        te=jnp.full((B,), -1, jnp.int32),
        alive=jnp.ones((B,), bool),
        row_max=jnp.zeros((tmax, B), jnp.int32),
    )

    def body(i, st):
        ii = jnp.int32(i)
        row_live = st["alive"] & (ii < tlens)
        tcode = jnp.where(ii < tlens, ts[:, i], 4).astype(jnp.int32)
        q_row = mat[tcode[None, :], qsT]
        Hdiag = jnp.concatenate(
            [jnp.zeros((1, B), jnp.int32), st["H"][:-1]], axis=0
        )
        Hpre = jnp.maximum(jnp.maximum(Hdiag + q_row, 0), st["E"])
        Hpre = jnp.where(valid_q, Hpre, 0)
        # F scan: F(0)=0; F(j)=max(0, F(j-1)-e_ins, Hpre(j-1)-oe_ins)
        v = (Hpre - oe_ins) + jidx * e_ins
        run = jax.lax.cummax(v, axis=0)
        F = jnp.zeros((qmax, B), jnp.int32)
        F = F.at[1:].set(jnp.maximum(run[:-1] - (jidx[1:] - 1) * e_ins, 0))
        H = jnp.maximum(Hpre, F)
        H = jnp.where(valid_q, H, 0)
        Enew = jnp.maximum(jnp.maximum(st["E"] - e_del, H - oe_del), 0)
        Enew = jnp.where(valid_q, Enew, 0)
        imax = jnp.max(H, axis=0)
        improved = imax > st["gmax"]
        upd = row_live & improved
        gmax = jnp.where(upd, imax, st["gmax"])
        te = jnp.where(upd, ii, st["te"])
        Hmax = jnp.where(upd[None, :], H, st["Hmax"])
        # early stop AFTER recording this row (ksw.c:205)
        die = upd & (gmax >= endscs)
        keep = row_live[None, :]
        row_max = st["row_max"].at[i].set(jnp.where(row_live, imax, 0))
        return dict(
            H=jnp.where(keep, H, st["H"]),
            E=jnp.where(keep, Enew, st["E"]),
            Hmax=Hmax,
            gmax=gmax,
            te=te,
            alive=st["alive"] & ~die,
            row_max=row_max,
        )

    st = jax.lax.fori_loop(0, tmax, body, state)
    # qe: smallest query index achieving the Hmax row's max
    hm = st["Hmax"]
    col_max = jnp.max(hm, axis=0)
    big = jnp.int32(1 << 30)
    qe = jnp.min(jnp.where(hm == col_max[None, :], jidx, big), axis=0)
    qe = jnp.where(col_max > 0, qe, -1)
    return st["gmax"], st["te"], qe, st["row_max"]


def _score2_from_rowmax(
    row_max: np.ndarray, tlen: int, score: int, te: int, minsc: int, max_mat: int
) -> Tuple[int, int]:
    """Reconstruct the merged-run b-array second-best (ksw.c:192-227).

    Host reference for score2_scan (the device formulation below); kept as
    the spec and used by tests."""
    # the C merge keys on the entry's *stored* row (the row of the last
    # strict improvement): a row merges only if it directly follows it
    b: List[Tuple[int, int]] = []
    for i in range(tlen):
        imax = int(row_max[i])
        if imax >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append((imax, i))
            elif b[-1][0] < imax:
                b[-1] = (imax, i)
    score2, te2 = -1, -1
    if b:
        rng = (score + max_mat - 1) // max_mat
        low, high = te - rng, te + rng
        for sc, e in b:
            if (e < low or e > high) and sc > score2:
                score2, te2 = sc, e
    return score2, te2


def score2_scan(
    row_max: jnp.ndarray,   # (tmax, B) int32 per-row maxima
    tlens: jnp.ndarray,     # (B,)
    gmax: jnp.ndarray,      # (B,) forward-pass best score
    te: jnp.ndarray,        # (B,) forward-pass best row
    minscs: jnp.ndarray,    # (B,) b-array threshold (0x10000 = never)
    max_mat: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The b-array second-best (ksw.c:192-227) as ONE device scan over
    target rows, vectorized across the batch — the per-problem row_max
    matrix never leaves the device.

    The C merge automaton has a one-row memory: a qualifying row either
    STARTS a new entry (previous row non-qualifying, or it was absorbed),
    IMPROVES the open entry (strictly greater, consecutive), or is
    ABSORBED (consecutive but not greater; the entry keeps its old stored
    row, so the next row always starts fresh).  Entries are emitted in
    creation order — when superseded, plus the final open one — and the
    second best takes the first strict maximum outside [te-rng, te+rng],
    matching the C loop exactly (_score2_from_rowmax is the spec;
    tests/test_ops_local_global.py holds the two equal)."""
    tmax, B = row_max.shape
    rng = (gmax + max_mat - 1) // max_mat
    low, high = te - rng, te + rng

    def emit(best2, te2, ent_val, ent_row, do):
        outside = (ent_row < low) | (ent_row > high)
        better = do & outside & (ent_val > best2)
        return (
            jnp.where(better, ent_val, best2),
            jnp.where(better, ent_row, te2),
        )

    def step(carry, inp):
        v, i = inp
        qual_prev, absorb_prev, ent_val, ent_row, open_, best2, te2 = carry
        qual = (v >= minscs) & (i < tlens)
        start = qual & (~qual_prev | absorb_prev)
        cont = qual & qual_prev & ~absorb_prev
        improve = cont & (v > ent_val)
        absorb = cont & ~improve
        # a new entry supersedes the open one -> the old entry is final
        best2, te2 = emit(best2, te2, ent_val, ent_row, start & open_)
        upd = start | improve
        ent_val = jnp.where(upd, v, ent_val)
        ent_row = jnp.where(upd, i, ent_row)
        open_ = open_ | start
        return (qual, absorb, ent_val, ent_row, open_, best2, te2), None

    init = (
        jnp.zeros((B,), bool),
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), bool),
        jnp.full((B,), -1, jnp.int32),
        jnp.full((B,), -1, jnp.int32),
    )
    rows_i = jnp.arange(tmax, dtype=jnp.int32)
    (_, _, ent_val, ent_row, open_, best2, te2), _ = jax.lax.scan(
        step, init, (row_max, rows_i)
    )
    best2, te2 = emit(best2, te2, ent_val, ent_row, open_)
    return best2, te2


@functools.partial(
    jax.jit,
    static_argnames=("qmax", "tmax", "o_del", "e_del", "o_ins", "e_ins", "max_mat"),
)
def local_sw_full_kernel(
    qs, ts, qlens, tlens, endscs, minscs, mat,
    qmax, tmax, o_del, e_del, o_ins, e_ins, max_mat,
):
    """Forward local SW + on-device second-best: (gmax, te, qe, s2, t2)."""
    gmax, te, qe, row_max = local_sw_batch_kernel(
        qs, ts, qlens, tlens, endscs, mat,
        qmax, tmax, o_del, e_del, o_ins, e_ins,
    )
    s2, t2 = score2_scan(row_max, tlens, gmax, te, minscs, max_mat)
    return gmax, te, qe, s2, t2


class BatchLocalSW:
    """Batched ksw_align2: forward pass + reverse pass for coordinates."""

    def __init__(self, opt: MemOptions, qmax: int = 192, tmax: int = 768):
        # qmax floor 192 (not 160): with <=192bp reads every dispatch of
        # this kernel then shares ONE executable shape, compiled once in
        # the engine's warmup, never mid-run
        self.opt = opt
        self.qmax = qmax
        self.tmax = tmax
        self.mat = jnp.asarray(opt.scoring_matrix(), jnp.int32)
        self.max_mat = int(opt.scoring_matrix().max())
        self.reset()

    def reset(self):
        self.problems: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def submit(self, query: np.ndarray, target: np.ndarray, minsc: int) -> int:
        self.problems.append((query, target, minsc))
        return len(self.problems) - 1

    CHUNK = 1024  # fixed device batch: one compile per (qmax, tmax)

    def _run_kernel(self, qs_list, ts_list, endscs, minscs=None):
        """Dispatch problems; returns (gmax, te, qe, score2, te2) arrays.

        With ``minscs`` the b-array second-best runs ON DEVICE
        (score2_scan) — the (tmax, B) row-max matrix never transfers;
        without it score2/te2 come back as -1 (the reverse pass doesn't
        need them but shares the jitted executables via minsc=never)."""
        B = len(qs_list)
        from .sw_extend import pad_batch

        never = 0x10000
        if minscs is None:
            minscs = [never] * B
        qmax = max(self.qmax, -(-max((len(q) for q in qs_list), default=1) // 64) * 64)
        tmax = max(self.tmax, -(-max((len(t) for t in ts_list), default=1) // 64) * 64)
        # sorted by target length like the other batchers; outputs are
        # unsorted back to input order before returning
        order = sorted(range(B), key=lambda i: len(ts_list[i]))
        qs_list = [qs_list[i] for i in order]
        ts_list = [ts_list[i] for i in order]
        endscs = [endscs[i] for i in order]
        minscs = [minscs[i] for i in order]
        chunk_outs = []
        pending = []
        from ..runtime.timers import TIMERS
        from .devicepool import dispatch_devices, put
        from .sw_extend import _dev_name

        devs = dispatch_devices()
        for ci, c0 in enumerate(range(0, B, self.CHUNK)):
            dev = devs[ci % len(devs)]
            c1 = min(c0 + self.CHUNK, B)
            nb = c1 - c0
            Bp = self.CHUNK if B > self.CHUNK else pad_batch(nb, 32)
            qs = np.full((Bp, qmax), 4, np.int8)
            ts = np.full((Bp, tmax), 4, np.int8)
            qlens = np.ones(Bp, np.int32)
            tlens = np.zeros(Bp, np.int32)
            ends = np.full(Bp, never, np.int32)
            mins = np.full(Bp, never, np.int32)
            ends[:nb] = np.asarray(endscs[c0:c1], np.int32)
            mins[:nb] = np.asarray(minscs[c0:c1], np.int32)
            for i in range(nb):
                q, t = qs_list[c0 + i], ts_list[c0 + i]
                qs[i, : len(q)] = q
                ts[i, : len(t)] = t
                qlens[i] = len(q)
                tlens[i] = len(t)
            TIMERS.add(f"chunks.{_dev_name(dev)}", 0.0)
            out = local_sw_full_kernel(
                put(qs, dev), put(ts, dev), put(qlens, dev), put(tlens, dev),
                put(ends, dev), put(mins, dev), put(self.mat, dev), qmax, tmax,
                self.opt.o_del, self.opt.e_del, self.opt.o_ins, self.opt.e_ins,
                self.max_mat,
            )
            pending.append((out, nb))

        # fetch after all chunks are in flight
        for out, nb in pending:
            with TIMERS.stage(f"local.dispatch.{qmax}x{tmax}"):
                chunk_outs.append(([np.asarray(o) for o in out], nb))
        merged = []
        inv = np.empty(B, np.int64)
        inv[np.asarray(order)] = np.arange(B)
        for j in range(5):
            parts = [arrs[j][:nb] for arrs, nb in chunk_outs]
            merged.append(np.concatenate(parts)[inv])
        return merged

    def run_align2(self) -> List[KswResult]:
        """Full ksw_align2 semantics (XSUBO|XSTART) for all problems."""
        if not self.problems:
            return []
        qs_list = [p[0] for p in self.problems]
        ts_list = [p[1] for p in self.problems]
        never = 0x10000
        gmax, te, qe, score2, te2 = self._run_kernel(
            qs_list, ts_list, [never] * len(self.problems),
            minscs=[p[2] for p in self.problems],
        )
        results = []
        rev_q, rev_t, rev_stop, rev_ids = [], [], [], []
        for i, (q, t, minsc) in enumerate(self.problems):
            r = KswResult()
            r.score = int(gmax[i])
            r.te = int(te[i])
            r.qe = int(qe[i])
            r.score2 = int(score2[i])
            r.te2 = int(te2[i])
            results.append(r)
            if r.score >= minsc and r.qe >= 0 and r.te >= 0:
                rev_q.append(q[: r.qe + 1][::-1].copy())
                rev_t.append(t[: r.te + 1][::-1].copy())
                rev_stop.append(r.score)
                rev_ids.append(i)
        if rev_ids:
            g2, t2, q2, _, _ = self._run_kernel(rev_q, rev_t, rev_stop)
            for k, i in enumerate(rev_ids):
                r = results[i]
                if int(g2[k]) == r.score:
                    r.tb = r.te - int(t2[k])
                    r.qb = r.qe - int(q2[k])
        self.reset()
        return results
