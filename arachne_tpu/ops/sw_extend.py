"""Batched banded seed-extension DP on the device (XLA formulation).

Batched reformulation of ksw_extend2 (ksw.c:380-479): instead of one
scalar banded DP per seed, thousands of (query, ref-window) extension
problems run as one device program.  Layout: problems on the trailing
axis, query positions on the leading axis; the target-row loop is a
`lax.fori_loop` whose body is a handful of elementwise ops over a
(Qmax, B) tile.

Exactness vs the scalar kernel:
  * The F (gap-in-query) recurrence F(j+1)=max(F(j)-e, max(M(j)-oe,0)) is
    a running max: F(j) = cummax_k<j (u(k)+k*e) - (j-1)*e with
    u=max(M-oe,0) — associative, so `lax.cummax` computes the row in
    log-depth without the left-to-right dependency.
  * The reference's adaptive beg shrink only skips cells that are
    provably {h=0,e=0}; recomputing them yields the same zeros (the M-zero
    quirk maps zero diagonals to zero scores), so a masked full-row
    computation is bit-identical.  Right of the adaptive end the
    reference leaves its eh[] slots untouched, and a column that enters
    the window later reads them; the carry keeps them the same way.
  * The hard band (j in [i-w, i+w+1)) and the early z-drop/zero-row exits
    become per-problem masks and `alive` freezing.

Outputs match ksw_extend2's 6-tuple (score, qle, tle, gtle, gscore,
max_off) element-for-element; tests/test_ops.py checks this against the
scalar oracle over randomized problems.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MemOptions

NEG_BIG = -(1 << 30)  # plain int: a module-level jnp constant would initialize the backend at import, breaking jax.distributed.initialize


@functools.partial(
    jax.jit,
    static_argnames=("qmax", "tmax", "o_del", "e_del", "o_ins", "e_ins", "zdrop"),
)
def extend_batch_kernel(
    qs: jnp.ndarray,        # (B, qmax) int8 query codes (0..4), padded
    ts: jnp.ndarray,        # (B, tmax) int8 target codes
    qlens: jnp.ndarray,     # (B,) int32
    tlens: jnp.ndarray,     # (B,) int32
    ws: jnp.ndarray,        # (B,) int32 band width (already min-clamped)
    h0s: jnp.ndarray,       # (B,) int32 seed scores
    mat: jnp.ndarray,       # (5, 5) int32 scoring matrix
    qmax: int,
    tmax: int,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    zdrop: int,
) -> Tuple[jnp.ndarray, ...]:
    B = qs.shape[0]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jidx = jnp.arange(qmax, dtype=jnp.int32)[:, None]          # (qmax, 1)
    # per-problem query profile: qprof[j, b] = mat[t, q_b(j)] gathered per row
    qsT = qs.T.astype(jnp.int32)                               # (qmax, B)
    valid_q = jidx < qlens[None, :]                            # (qmax, B)

    # initial previous-row H: H(-1, j) = max(h0 - oe_ins - j*e_ins, 0)
    h0r = h0s[None, :].astype(jnp.int32)
    Hprev = jnp.maximum(h0r - oe_ins - jidx * e_ins, 0)
    Hprev = jnp.where(valid_q, Hprev, 0)
    Eprev = jnp.zeros((qmax, B), jnp.int32)

    state = dict(
        H=Hprev,
        E=Eprev,
        alive=jnp.ones((B,), bool),
        end=qlens.astype(jnp.int32),
        maxv=h0s.astype(jnp.int32),
        max_i=jnp.full((B,), -1, jnp.int32),
        max_j=jnp.full((B,), -1, jnp.int32),
        max_ie=jnp.full((B,), -1, jnp.int32),
        gscore=jnp.full((B,), -1, jnp.int32),
        max_off=jnp.zeros((B,), jnp.int32),
    )

    def body(i, st):
        ii = jnp.int32(i)
        row_live = st["alive"] & (ii < tlens)                   # (B,)
        tcode = jnp.where(ii < tlens, ts[:, i], 4).astype(jnp.int32)  # (B,)
        q_row = mat[tcode[None, :], qsT]                        # (qmax, B)
        # adaptive end (ksw.c:417-418,468-469): the zero-tail scan shrinks
        # the window and is observable through the j==qlen gscore update
        end_used = jnp.minimum(jnp.minimum(st["end"], ii + ws + 1), qlens)  # (B,)
        in_band = (
            (jidx >= ii - ws[None, :])
            & (jidx < end_used[None, :])
            & valid_q
        )
        beg0 = ii - ws <= 0                                     # beg == 0 per problem
        h1_init = jnp.where(
            beg0, jnp.maximum(h0s - (o_del + e_del * (ii + 1)), 0), 0
        ).astype(jnp.int32)
        # H(i-1, -1): h0 for the first row (eh[0].h init, ksw.c:395),
        # otherwise the previous row's first-column boundary
        bound_prev = jnp.where(
            ii == 0,
            h0s,
            jnp.where(
                (ii - 1) - ws <= 0,
                jnp.maximum(h0s - (o_del + e_del * ii), 0),
                0,
            ),
        ).astype(jnp.int32)
        Hdiag = jnp.concatenate([bound_prev[None, :], st["H"][:-1]], axis=0)
        M = jnp.where(Hdiag != 0, Hdiag + q_row, 0)
        # F starts at 0 at the window's first column (ksw.c:420): a cell left
        # of the window (the first-column boundary while h0 is still
        # positive) must not feed the scan
        u = jnp.where(in_band, jnp.maximum(M - oe_ins, 0), 0)
        v = u + jidx * e_ins
        run = jax.lax.cummax(v, axis=0)
        F = jnp.zeros((qmax, B), jnp.int32)
        F = F.at[1:].set(jnp.maximum(run[:-1] - (jidx[1:] - 1) * e_ins, 0))
        H = jnp.maximum(jnp.maximum(M, st["E"]), F)
        H = jnp.where(in_band, H, 0)
        Enew = jnp.maximum(st["E"] - e_del, jnp.maximum(M - oe_del, 0))
        Enew = jnp.where(in_band, Enew, 0)
        # columns right of the window keep their last values, as the
        # reference's eh[] array does: a column entering the window later
        # (the adaptive end grows by up to 2 per row) reads them, and for
        # a column never reached yet that is the first row's H(-1, j)
        right = jidx >= end_used[None, :]
        H_keep = jnp.where(right, st["H"], H)
        E_keep = jnp.where(jidx > end_used[None, :], st["E"], Enew)

        m = jnp.max(H, axis=0)                                  # (B,)
        # mj: largest j attaining m (ties -> later j, ksw.c:437)
        is_max = (H == m[None, :]) & in_band
        mj = jnp.max(jnp.where(is_max, jidx, -1), axis=0)

        # gscore: the window reached the end of the query this row
        ends_q = (end_used == qlens) & (ii < tlens)
        h_last = jnp.take_along_axis(H, (qlens - 1)[None, :], axis=0)[0]
        # ksw.c:451-452: max_ie updates on ties (gscore > h1 keeps old)
        upd_ie = ends_q & row_live & ~(st["gscore"] > h_last)
        gscore = jnp.where(ends_q & row_live, jnp.maximum(st["gscore"], h_last), st["gscore"])
        max_ie = jnp.where(upd_ie, ii, st["max_ie"])

        # break conditions
        zero_row = m == 0
        improved = m > st["maxv"]
        diag_i = ii - st["max_i"]
        diag_j = mj - st["max_j"]
        drop_del = st["maxv"] - m - (diag_i - diag_j) * e_del > zdrop
        drop_ins = st["maxv"] - m - (diag_j - diag_i) * e_ins > zdrop
        zdropped = jnp.where(diag_i > diag_j, drop_del, drop_ins) & (zdrop > 0)
        die = row_live & (zero_row | ((~improved) & zdropped))

        maxv = jnp.where(row_live & improved, m, st["maxv"])
        max_i = jnp.where(row_live & improved, ii, st["max_i"])
        max_j = jnp.where(row_live & improved, mj, st["max_j"])
        off = jnp.abs(mj - ii)
        max_off = jnp.where(
            row_live & improved, jnp.maximum(st["max_off"], off), st["max_off"]
        )

        # adaptive end update (ksw.c:468-469): scan the shifted slot array
        # (slot j holds H(i, j-1) and E(i+1, j)) for the last nonzero slot
        slot_idx = jnp.arange(qmax + 1, dtype=jnp.int32)[:, None]
        slot_h = jnp.concatenate([h1_init[None, :], H], axis=0)       # (qmax+1, B)
        slot_e = jnp.concatenate([Enew, jnp.zeros((1, B), jnp.int32)], axis=0)
        nonzero = ((slot_h != 0) | (slot_e != 0)) & (slot_idx <= end_used[None, :])
        jstar = jnp.max(jnp.where(nonzero, slot_idx, -1), axis=0)
        new_end = jnp.minimum(jstar + 2, qlens)
        survive = row_live & ~die
        end_next = jnp.where(survive, new_end, st["end"])

        keep = row_live[None, :]
        return dict(
            H=jnp.where(keep, H_keep, st["H"]),
            E=jnp.where(keep, E_keep, st["E"]),
            alive=st["alive"] & ~die,
            end=end_next,
            maxv=maxv,
            max_i=max_i,
            max_j=max_j,
            max_ie=max_ie,
            gscore=gscore,
            max_off=max_off,
        )

    st = jax.lax.fori_loop(0, tmax, body, state)
    return (
        st["maxv"],
        st["max_j"] + 1,
        st["max_i"] + 1,
        st["max_ie"] + 1,
        st["gscore"],
        st["max_off"],
    )


def pad_batch(B: int, minimum: int = 64) -> int:
    """Round the batch size up to a power-of-two bucket (>= minimum) so the
    jit cache sees a small, fixed set of shapes."""
    n = minimum
    while n < B:
        n <<= 1
    return n


def clamp_band(opt: MemOptions, qlen: int, w: int, end_bonus: int, max_mat: int) -> int:
    """The per-problem w clamp at the top of ksw_extend2 (ksw.c:399-407)."""
    max_ins = int((qlen * max_mat + end_bonus - opt.o_ins) / opt.e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_mat + end_bonus - opt.o_del) / opt.e_del + 1.0)
    return min(w, max(max_del, 1))


class BatchExtender:
    """Pads and dispatches extension problems to the device kernel.

    Call ``submit`` repeatedly, then ``run`` to execute the whole batch;
    results come back as ksw_extend2 6-tuples in submission order."""

    def __init__(self, opt: MemOptions, qmax: int = 192, tmax: int = 512):
        # qmax floor 192: extension queries are seed sub-reads (p100 = 131
        # on 150 bp libraries), so every dispatch of <=192 bp reads shares
        # ONE executable shape; longer reads re-bucket in 64-multiples
        self.opt = opt
        self.qmax = qmax
        self.tmax = tmax
        self.mat = jnp.asarray(opt.scoring_matrix(), jnp.int32)
        self.max_mat = int(opt.scoring_matrix().max())
        self.reset()

    def reset(self):
        self.queries = []
        self.targets = []
        self.ws = []
        self.h0s = []

    def submit(self, query: np.ndarray, target: np.ndarray, w: int, end_bonus: int, h0: int) -> int:
        w = clamp_band(self.opt, len(query), w, end_bonus, self.max_mat)
        self.queries.append(query)
        self.targets.append(target)
        self.ws.append(w)
        self.h0s.append(h0)
        return len(self.queries) - 1

    CHUNK = 4096  # fixed device batch: exactly one compile per (qmax, tmax)

    def run(self):
        B = len(self.queries)
        if B == 0:
            return []
        # bucket padded shapes to multiples of 64 so jit caches stay warm
        qmax = max(self.qmax, -(-max(len(q) for q in self.queries) // 64) * 64)
        tmax = max(self.tmax, -(-max(len(t) for t in self.targets) // 64) * 64)
        # problems of similar target length share a chunk; results are
        # unsorted back to submission order below
        order = sorted(range(B), key=lambda i: len(self.targets[i]))
        self.queries = [self.queries[i] for i in order]
        self.targets = [self.targets[i] for i in order]
        self.ws = [self.ws[i] for i in order]
        self.h0s = [self.h0s[i] for i in order]
        results = []
        pending = []
        from ..runtime.timers import TIMERS
        from .devicepool import dispatch_devices, put

        devs = dispatch_devices()
        for ci, c0 in enumerate(range(0, B, self.CHUNK)):
            dev = devs[ci % len(devs)]
            c1 = min(c0 + self.CHUNK, B)
            nb = c1 - c0
            # one executable per (qmax, tmax) at full chunks; small batches
            # bucket to powers of two so a handful of shapes covers them
            Bp = self.CHUNK if B > self.CHUNK else pad_batch(nb)
            qs = np.full((Bp, qmax), 4, np.int8)
            ts = np.full((Bp, tmax), 4, np.int8)
            meta = np.zeros((4, Bp), np.int32)       # qlen, tlen, w, h0
            meta[0] = 1
            meta[2:] = 1
            meta[2, :nb] = self.ws[c0:c1]
            meta[3, :nb] = self.h0s[c0:c1]
            for i in range(nb):
                q = self.queries[c0 + i]
                t = self.targets[c0 + i]
                qs[i, : len(q)] = q
                ts[i, : len(t)] = t
                meta[0, i] = len(q)
                meta[1, i] = len(t)
            TIMERS.add(f"chunks.{_dev_name(dev)}", 0.0)
            out = _extend_stacked(
                put(qs, dev), put(ts, dev), put(meta, dev), put(self.mat, dev),
                qmax=qmax, tmax=tmax, o_del=self.opt.o_del, e_del=self.opt.e_del,
                o_ins=self.opt.o_ins, e_ins=self.opt.e_ins, zdrop=self.opt.zdrop,
            )
            pending.append((out, nb))

        # fetch AFTER all chunks are dispatched, so the device (or every
        # device of the pool) works through the queue without host gaps
        for out, nb in pending:
            with TIMERS.stage(f"extend.dispatch.{qmax}x{tmax}"):
                arr = np.asarray(out)               # ONE (6, B) fetch
            results.extend(tuple(int(v) for v in arr[:, i]) for i in range(nb))
        unsorted = [None] * B
        for k, i in enumerate(order):
            unsorted[i] = results[k]
        self.reset()
        return unsorted


def _dev_name(dev) -> str:
    """Stage-timer label of a dispatch target (None = default device)."""
    if dev is None:
        dev = jax.local_devices()[0]
    return f"{dev.platform}{dev.id}"


@functools.partial(
    jax.jit, static_argnames=("qmax", "tmax", "o_del", "e_del", "o_ins", "e_ins", "zdrop")
)
def _extend_stacked(qs, ts, meta, mat, *, qmax, tmax, o_del, e_del, o_ins, e_ins, zdrop):
    """extend_batch_kernel with one (4, B) meta upload (qlen, tlen, w, h0)
    and one (6, B) result fetch per chunk."""
    out = extend_batch_kernel(
        qs, ts, meta[0], meta[1], meta[2], meta[3], mat,
        qmax, tmax, o_del, e_del, o_ins, e_ins, zdrop,
    )
    return jnp.stack(out)
