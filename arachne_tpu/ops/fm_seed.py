"""Device-side SMEM seeding: the three-pass seed collection as device scans.

The reference's seeding (mem_collect_intv, bwamem.c:114-162) is an
irregular per-read while-loop over FM-index extensions — the #1 hot loop
(SURVEY.md 3.5).  Here the whole pass-1 sweep program runs as ONE jitted
``lax.while_loop`` over a dense (R reads) state: every iteration advances
every read's current sweep by one step (a forward extension, or one
backward step that extends all carried intervals), with batched occ4
gathers feeding the interval updates.  Pass 2 (re-seeding) runs the same
machine over a per-read queue of (pivot, min_intv) jobs; pass 3 is a
lockstep LAST-like forward scan.

Fixed-size buffers replace the reference's growable vectors:
  * MAXC  — carried intervals per sweep (curr/prev, bwt.c:304-345)
  * MAXS  — SMEMs recorded per read per pass
Reads that overflow any buffer are flagged and transparently redone with
the host collector (align/smem_batch.py), so output is always exact; the
parity test checks equality with the host collector read-for-read.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..align.smem import SMEM
from ..config import MemOptions
from ..index.fmindex import FMIndex
from .fm_rank import DeviceFMIndex, extend_device

I32 = jnp.int32

# phases
PH_PIVOT = 0   # looking for the next pivot (skip Ns / check end)
PH_FWD = 1     # forward sweep
PH_BACK = 2    # backward sweep
PH_DONE = 3


def _smem_pass_program(
    fm: DeviceFMIndex,
    qs: jnp.ndarray,                            # (R, L) int8 codes
    qlens: jnp.ndarray,                         # (R,)
    pivots0: jnp.ndarray,                       # (R,) first pivot per read
    min_intvs: jnp.ndarray,                     # (R,) min_intv per read
    single_sweep: bool,                         # True: one sweep only (pass 2)
    R: int,
    L: int,
    MAXC: int,
    MAXS: int,
):
    """Runs smem1a sweeps; for single_sweep=False the pivot chain
    x -> ret(x) is followed to the end of each read (pass 1).

    ``fm`` may be a global-table DeviceFMIndex or a shard-local one (then
    this runs inside a shard_map and every occ4 psums over fm.axis).

    All integer state rides fm.idt (int32, or int64 for wide tables —
    genomes >= 2^31 rows), set by shadowing I32 locally."""
    I32 = fm.idt
    qsT = qs.astype(I32)

    st = dict(
        phase=jnp.full((R,), PH_PIVOT, I32),
        x=pivots0.astype(I32),
        i=jnp.zeros((R,), I32),
        ik=jnp.zeros((R, 4), I32),               # k, l, s, info
        curr=jnp.zeros((R, MAXC, 4), I32),
        curr_n=jnp.zeros((R,), I32),
        prev=jnp.zeros((R, MAXC, 4), I32),
        prev_n=jnp.zeros((R,), I32),
        sweep_mem=jnp.zeros((R, MAXS, 5), I32),  # per-sweep mems (desc qb)
        sweep_n=jnp.zeros((R,), I32),
        out=jnp.zeros((R, MAXS, 5), I32),        # final mems per read
        out_n=jnp.zeros((R,), I32),
        overflow=jnp.zeros((R,), bool),
        steps=jnp.zeros((), I32),
    )

    def get_code(x):
        """q[x] with bounds masking -> 4 (N) out of range."""
        xc = jnp.clip(x, 0, L - 1)
        code = jnp.take_along_axis(qsT, xc[:, None], axis=1)[:, 0]
        return jnp.where((x >= 0) & (x < qlens), code, 4)

    def start_fwd(st, ready):
        """Initialize a forward sweep at pivot x for ready reads."""
        c = get_code(st["x"])
        x0 = fm.L2[jnp.clip(c, 0, 3)] + 1
        x2 = fm.L2[jnp.clip(c, 0, 3) + 1] - fm.L2[jnp.clip(c, 0, 3)]
        x1 = fm.L2[3 - jnp.clip(c, 0, 3)] + 1
        ik = jnp.stack([x0, x1, x2, st["x"] + 1], axis=1)
        st = dict(st)
        st["ik"] = jnp.where(ready[:, None], ik, st["ik"])
        st["i"] = jnp.where(ready, st["x"] + 1, st["i"])
        st["curr_n"] = jnp.where(ready, 0, st["curr_n"])
        st["sweep_n"] = jnp.where(ready, 0, st["sweep_n"])
        st["phase"] = jnp.where(ready, PH_FWD, st["phase"])
        return st

    def push_curr(st, do, item):
        """Append item (R,4) to curr for reads in ``do``."""
        n = st["curr_n"]
        ovf = do & (n >= MAXC)
        slot = jnp.clip(n, 0, MAXC - 1)
        upd = (jnp.arange(MAXC, dtype=I32)[None, :] == slot[:, None]) & (do & ~ovf)[:, None]
        curr = jnp.where(upd[:, :, None], item[:, None, :], st["curr"])
        st = dict(st)
        st["curr"] = curr
        st["curr_n"] = jnp.where(do & ~ovf, n + 1, n)
        st["overflow"] = st["overflow"] | ovf
        return st

    def body(st):
        st = dict(st)
        phase = st["phase"]

        # ---- PH_PIVOT: find next pivot / finish read ----
        in_pivot = phase == PH_PIVOT
        c_at_x = get_code(st["x"])
        past_end = st["x"] >= qlens
        is_n = (c_at_x >= 4) & ~past_end
        done_now = in_pivot & past_end
        st["phase"] = jnp.where(done_now, PH_DONE, st["phase"])
        st["x"] = jnp.where(in_pivot & is_n, st["x"] + 1, st["x"])
        ready = in_pivot & ~past_end & ~is_n
        st = start_fwd(st, ready)

        # ---- PH_FWD: one forward step ----
        in_fwd = st["phase"] == PH_FWD
        ci = get_code(st["i"])
        at_end = st["i"] >= qlens
        terminal = in_fwd & (at_end | (ci >= 4))
        live_f = in_fwd & ~terminal
        comp = 3 - jnp.clip(ci, 0, 3)
        o0, o1, osz = extend_device(
            fm, st["ik"][:, 0], st["ik"][:, 1], st["ik"][:, 2], is_back=False
        )
        gi = jnp.arange(R)
        n0 = jnp.take_along_axis(o0, comp[:, None], axis=1)[:, 0]
        n1 = jnp.take_along_axis(o1, comp[:, None], axis=1)[:, 0]
        ns = jnp.take_along_axis(osz, comp[:, None], axis=1)[:, 0]
        changed = live_f & (ns != st["ik"][:, 2])
        st = push_curr(st, changed | terminal, st["ik"])
        too_small = changed & (ns < min_intvs)
        advance = live_f & ~too_small
        new_ik = jnp.stack([n0, n1, ns, st["i"] + 1], axis=1)
        st["ik"] = jnp.where(advance[:, None], new_ik, st["ik"])
        st["i"] = jnp.where(advance, st["i"] + 1, st["i"])
        # reads that just reached the end push the final interval
        hit_len = advance & (st["i"] >= qlens)
        st = push_curr(st, hit_len, st["ik"])
        to_back = terminal | too_small | hit_len
        # transition to backward: prev = reversed curr; ret = last-pushed info
        ret = jnp.take_along_axis(
            st["curr"][:, :, 3], jnp.clip(st["curr_n"] - 1, 0, MAXC - 1)[:, None], axis=1
        )[:, 0]
        rev_idx = jnp.clip(st["curr_n"][:, None] - 1 - jnp.arange(MAXC)[None, :], 0, MAXC - 1)
        prev_rev = jnp.take_along_axis(st["curr"], rev_idx[:, :, None], axis=1)
        st["prev"] = jnp.where(to_back[:, None, None], prev_rev, st["prev"])
        st["prev_n"] = jnp.where(to_back, st["curr_n"], st["prev_n"])
        st["x"] = jnp.where(to_back, ret, st["x"])  # x now holds ret
        st["i"] = jnp.where(to_back, -(1 << 30), st["i"])  # marker; set below
        # backward starts at pivot-1: stash pivot in ik[:,3]? we need the
        # original pivot; it is recoverable: the first curr entry... store
        # pivot in a dedicated slot instead: reuse sweep_mem? simplest:
        # carry pivot in st["pivot_keep"]
        st["phase"] = jnp.where(to_back, PH_BACK, st["phase"])
        st["i"] = jnp.where(to_back, st["pivot_keep"] - 1, st["i"])

        # ---- PH_BACK: one backward step over all prev items ----
        in_back = st["phase"] == PH_BACK
        cb = get_code(st["i"])
        c_ok = in_back & (st["i"] >= 0) & (cb < 4)
        # batched extension of all prev items
        p = st["prev"]
        b0, b1, bs = extend_device(
            fm,
            p[:, :, 0].reshape(-1),
            p[:, :, 1].reshape(-1),
            jnp.maximum(p[:, :, 2].reshape(-1), 0),
            is_back=True,
        )
        cbc = jnp.clip(cb, 0, 3)
        sel = cbc[:, None].repeat(MAXC, 1).reshape(-1)[:, None]
        nb0 = jnp.take_along_axis(b0, sel, axis=1).reshape(R, MAXC)
        nb1 = jnp.take_along_axis(b1, sel, axis=1).reshape(R, MAXC)
        nbs = jnp.take_along_axis(bs, sel, axis=1).reshape(R, MAXC)

        # sequential per-item logic via a scan over the MAXC axis
        def item_step(carry, j):
            ncurr, last_s, pushed_mem, st_curr, st_mem, st_memn, ovf = carry
            valid = in_back & (j < st["prev_n"])
            pj = st["prev"][:, j]
            oks = nbs[:, j]
            keep = (~c_ok) | (oks < min_intvs)
            # push mem if curr empty and not contained
            last_qb = jnp.take_along_axis(
                st_mem[:, :, 3], jnp.clip(st_memn - 1, 0, MAXS - 1)[:, None], axis=1
            )[:, 0]
            no_contain = (st_memn == 0) | (st["i"] + 1 < last_qb)
            do_mem = valid & keep & (ncurr == 0) & no_contain
            memovf = do_mem & (st_memn >= MAXS)
            slot = jnp.clip(st_memn, 0, MAXS - 1)
            mem_item = jnp.stack(
                [pj[:, 0], pj[:, 1], pj[:, 2], st["i"] + 1, pj[:, 3]], axis=1
            )
            updm = (
                jnp.arange(MAXS, dtype=I32)[None, :] == slot[:, None]
            ) & (do_mem & ~memovf)[:, None]
            st_mem = jnp.where(updm[:, :, None], mem_item[:, None, :], st_mem)
            st_memn = jnp.where(do_mem & ~memovf, st_memn + 1, st_memn)
            # push curr if extension kept the interval alive and size is new
            do_curr = valid & ~keep & ((ncurr == 0) | (oks != last_s))
            currovf = do_curr & (ncurr >= MAXC)
            cslot = jnp.clip(ncurr, 0, MAXC - 1)
            curr_item = jnp.stack([nb0[:, j], nb1[:, j], oks, pj[:, 3]], axis=1)
            updc = (
                jnp.arange(MAXC, dtype=I32)[None, :] == cslot[:, None]
            ) & (do_curr & ~currovf)[:, None]
            st_curr = jnp.where(updc[:, :, None], curr_item[:, None, :], st_curr)
            ncurr = jnp.where(do_curr & ~currovf, ncurr + 1, ncurr)
            last_s = jnp.where(do_curr, oks, last_s)
            ovf = ovf | memovf | currovf
            return (ncurr, last_s, pushed_mem, st_curr, st_mem, st_memn, ovf), None

        carry0 = (
            jnp.zeros((R,), I32),
            jnp.full((R,), -1, I32),
            jnp.zeros((R,), bool),
            jnp.zeros((R, MAXC, 4), I32),
            st["sweep_mem"],
            st["sweep_n"],
            st["overflow"],
        )
        carry, _ = jax.lax.scan(item_step, carry0, jnp.arange(MAXC))
        ncurr, _, _, new_curr, new_mem, new_memn, ovf = carry
        st["sweep_mem"] = jnp.where(in_back[:, None, None], new_mem, st["sweep_mem"])
        st["sweep_n"] = jnp.where(in_back, new_memn, st["sweep_n"])
        st["overflow"] = ovf

        sweep_done = in_back & ((ncurr == 0) | (st["i"] - 1 < -1))
        cont = in_back & ~sweep_done
        st["prev"] = jnp.where(cont[:, None, None], new_curr, st["prev"])
        st["prev_n"] = jnp.where(cont, ncurr, st["prev_n"])
        st["i"] = jnp.where(cont, st["i"] - 1, st["i"])

        # sweep finished: reverse sweep_mem (desc->asc qb) into out
        def flush(st, done_mask):
            n_out = st["out_n"]
            sn = st["sweep_n"]
            # out[o + t] = sweep_mem[sn-1-t] for t in [0, sn)
            tidx = jnp.arange(MAXS)[None, :]
            src = jnp.clip(sn[:, None] - 1 - tidx, 0, MAXS - 1)
            rev = jnp.take_along_axis(st["sweep_mem"], src[:, :, None], axis=1)
            dst = n_out[:, None] + tidx
            can = done_mask[:, None] & (tidx < sn[:, None]) & (dst < MAXS)
            ovf2 = done_mask & (n_out + sn > MAXS)
            out = st["out"]
            # one-hot write: out[d] = rev[t] where dst[t] == d and can[t]
            dst_w = jnp.where(can, dst, MAXS)  # masked rows land out of range
            onehot = dst_w[:, :, None] == jnp.arange(MAXS, dtype=I32)[None, None, :]
            written = jnp.any(onehot, axis=1)                     # (R, MAXS_dst)
            # gather the source row index t for each destination d
            tsel = jnp.argmax(onehot, axis=1)                     # (R, MAXS_dst)
            vals = jnp.take_along_axis(rev, tsel[:, :, None], axis=1)
            out = jnp.where(written[:, :, None], vals, out)
            st = dict(st)
            st["out"] = out
            st["out_n"] = jnp.where(done_mask, jnp.minimum(n_out + sn, MAXS), n_out)
            st["overflow"] = st["overflow"] | ovf2
            return st

        st = flush(st, sweep_done)
        if single_sweep:
            st["phase"] = jnp.where(sweep_done, PH_DONE, st["phase"])
        else:
            st["phase"] = jnp.where(sweep_done, PH_PIVOT, st["phase"])
            # x already holds ret (the next pivot)
        st["steps"] = st["steps"] + 1
        return st

    # carry the pivot through the sweep
    st["pivot_keep"] = pivots0.astype(I32)

    def body_with_pivot(st):
        # remember pivot at fwd start
        in_pivot = st["phase"] == PH_PIVOT
        st = dict(st)
        st["pivot_keep"] = jnp.where(in_pivot, st["x"], st["pivot_keep"])
        return body(st)

    def cond(st):
        return jnp.any(st["phase"] != PH_DONE) & (st["steps"] < 16 * L + 64)

    st = jax.lax.while_loop(cond, body_with_pivot, st)
    return st["out"], st["out_n"], st["overflow"]


@functools.partial(
    jax.jit,
    static_argnames=("primary", "seq_len", "single_sweep", "R", "L", "MAXC", "MAXS"),
)
def _smem_pass_kernel(
    occ, words, L2, primary, seq_len,          # device FM tables (arrays/ints)
    qs, qlens, pivots0, min_intvs,
    single_sweep: bool, R: int, L: int, MAXC: int, MAXS: int,
):
    fm = DeviceFMIndex(
        occ=occ, words=words, L2=L2,
        primary=int(primary), seq_len=int(seq_len), l_pac=0,
    )
    return _smem_pass_program(
        fm, qs, qlens, pivots0, min_intvs, single_sweep, R, L, MAXC, MAXS
    )


def _pass3_program(
    fm: DeviceFMIndex,
    qs: jnp.ndarray,
    qlens: jnp.ndarray,
    min_seed_len: int,
    max_intv: int,
    R: int,
    L: int,
    MAXS: int,
):
    """bwt_seed_strategy1 pivot chains (bwt.c:358-379) in lockstep."""
    I32 = fm.idt
    qsT = qs.astype(I32)

    def get_code(x):
        xc = jnp.clip(x, 0, L - 1)
        code = jnp.take_along_axis(qsT, xc[:, None], axis=1)[:, 0]
        return jnp.where((x >= 0) & (x < qlens), code, 4)

    st = dict(
        x=jnp.zeros((R,), I32),
        i=jnp.zeros((R,), I32),
        ik=jnp.zeros((R, 3), I32),
        scanning=jnp.zeros((R,), bool),
        done=jnp.zeros((R,), bool),
        out=jnp.zeros((R, MAXS, 5), I32),
        out_n=jnp.zeros((R,), I32),
        overflow=jnp.zeros((R,), bool),
        steps=jnp.zeros((), I32),
    )

    def body(st):
        st = dict(st)
        # idle readers look for a pivot
        idle = ~st["scanning"] & ~st["done"]
        cx = get_code(st["x"])
        past = st["x"] >= qlens
        st["done"] = st["done"] | (idle & past)
        skip_n = idle & ~past & (cx >= 4)
        st["x"] = jnp.where(skip_n, st["x"] + 1, st["x"])
        start = idle & ~past & (cx < 4)
        c = jnp.clip(cx, 0, 3)
        ik0 = jnp.stack(
            [fm.L2[c] + 1, fm.L2[3 - c] + 1, fm.L2[c + 1] - fm.L2[c]], axis=1
        )
        st["ik"] = jnp.where(start[:, None], ik0, st["ik"])
        st["i"] = jnp.where(start, st["x"] + 1, st["i"])
        st["scanning"] = st["scanning"] | start

        # scanning readers take one forward step
        scan = st["scanning"]
        ci = get_code(st["i"])
        at_end = scan & (st["i"] >= qlens)
        hit_n = scan & ~at_end & (ci >= 4)
        live = scan & ~at_end & ~hit_n
        comp = 3 - jnp.clip(ci, 0, 3)
        o0, o1, osz = extend_device(
            fm, st["ik"][:, 0], st["ik"][:, 1], st["ik"][:, 2], is_back=False
        )
        n0 = jnp.take_along_axis(o0, comp[:, None], axis=1)[:, 0]
        n1 = jnp.take_along_axis(o1, comp[:, None], axis=1)[:, 0]
        ns = jnp.take_along_axis(osz, comp[:, None], axis=1)[:, 0]
        emit = live & (ns < max_intv) & (st["i"] - st["x"] >= min_seed_len)
        do_push = emit & (ns > 0)
        ovf = do_push & (st["out_n"] >= MAXS)
        slot = jnp.clip(st["out_n"], 0, MAXS - 1)
        item = jnp.stack([n0, n1, ns, st["x"], st["i"] + 1], axis=1)
        upd = (
            jnp.arange(MAXS, dtype=I32)[None, :] == slot[:, None]
        ) & (do_push & ~ovf)[:, None]
        st["out"] = jnp.where(upd[:, :, None], item[:, None, :], st["out"])
        st["out_n"] = jnp.where(do_push & ~ovf, st["out_n"] + 1, st["out_n"])
        st["overflow"] = st["overflow"] | ovf
        adv = live & ~emit
        new_ik = jnp.stack([n0, n1, ns], axis=1)
        st["ik"] = jnp.where(adv[:, None], new_ik, st["ik"])
        st["i"] = jnp.where(adv, st["i"] + 1, st["i"])
        # stop conditions: emit / N / end-of-read -> new pivot at i+1 (or len)
        stop = at_end | hit_n | emit
        nxt = jnp.where(at_end, qlens, st["i"] + 1)
        st["x"] = jnp.where(stop, nxt, st["x"])
        st["scanning"] = st["scanning"] & ~stop
        st["steps"] = st["steps"] + 1
        return st

    def cond(st):
        return jnp.any(~st["done"]) & (st["steps"] < 8 * L + 64)

    st = jax.lax.while_loop(cond, body, st)
    return st["out"], st["out_n"], st["overflow"]


@functools.partial(
    jax.jit,
    static_argnames=("primary", "seq_len", "min_seed_len", "max_intv", "R", "L", "MAXS"),
)
def _pass3_kernel(
    occ, words, L2, primary, seq_len,
    qs, qlens, min_seed_len: int, max_intv: int, R: int, L: int, MAXS: int,
):
    fm = DeviceFMIndex(
        occ=occ, words=words, L2=L2,
        primary=int(primary), seq_len=int(seq_len), l_pac=0,
    )
    return _pass3_program(fm, qs, qlens, min_seed_len, max_intv, R, L, MAXS)


class GlobalPassRunner:
    """Runs the seeding passes against replicated (global) device tables."""

    def __init__(self, dfm: DeviceFMIndex):
        self.dfm = dfm

    def run_pass(self, qs, qlens, pivots0, min_intvs, single_sweep, R, L, MAXC, MAXS):
        d = self.dfm
        return _smem_pass_kernel(
            d.occ, d.words, d.L2, d.primary, d.seq_len,
            qs, qlens, pivots0, min_intvs, single_sweep, R, L, MAXC, MAXS,
        )

    def run_pass3(self, qs, qlens, min_seed_len, max_intv, R, L, MAXS):
        d = self.dfm
        return _pass3_kernel(
            d.occ, d.words, d.L2, d.primary, d.seq_len,
            qs, qlens, min_seed_len, max_intv, R, L, MAXS,
        )


def collect_seeds_device(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    dfm: DeviceFMIndex = None,
    MAXC: int = 12,
    MAXS: int = 48,
) -> List[List[SMEM]]:
    """Three-pass seed collection with the sweeps on device.

    Identical per-read output to align.smem.collect_seeds; reads that
    overflow the fixed device buffers are redone with the host collector.
    ``dfm`` may be a DeviceFMIndex (replicated tables) or any runner
    object exposing run_pass/run_pass3 — e.g. parallel.mesh.ShardedFMTables
    for the block-sharded index (lookup-as-collective mode).
    """
    from ..align.smem_batch import collect_seeds_batch
    from .sw_extend import pad_batch

    if dfm is None:
        dfm = DeviceFMIndex.from_host(idx)
    runner = dfm if hasattr(dfm, "run_pass") else GlobalPassRunner(dfm)
    n = len(reads)
    if n == 0:
        return []
    R = pad_batch(n, 64)
    L = max(64, -(-max(len(r) for r in reads) // 64) * 64)
    qs = np.full((R, L), 4, np.int8)
    qlens = np.zeros(R, np.int32)
    for i, r in enumerate(reads):
        qs[i, : len(r)] = r
        qlens[i] = len(r)
    qs_d = jnp.asarray(qs)
    qlens_d = jnp.asarray(qlens)

    # ---- pass 1 ----
    out1, n1, ovf1 = runner.run_pass(
        qs_d, qlens_d,
        jnp.zeros(R, I32), jnp.ones(R, I32), False, R, L, MAXC, MAXS,
    )
    out1 = np.asarray(out1)
    n1 = np.asarray(n1)
    overflow = np.asarray(ovf1).copy()

    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    pass1: List[List[SMEM]] = []
    pass2_jobs: List[List[Tuple[int, int]]] = []
    for r in range(R):
        lst = []
        jobs = []
        if r < n and not overflow[r]:
            for t in range(int(n1[r])):
                k, l, s, qb, qe = (int(v) for v in out1[r, t])
                if qe - qb >= opt.min_seed_len:
                    m = SMEM(k=k, l=l, s=s, qb=qb, qe=qe)
                    lst.append(m)
                    if m.length >= split_len and m.s <= opt.split_width:
                        jobs.append(((m.qb + m.qe) >> 1, m.s + 1))
        pass1.append(lst)
        pass2_jobs.append(jobs)

    # ---- pass 2: one single-sweep round per job rank ----
    pass2: List[List[SMEM]] = [[] for _ in range(R)]
    max_jobs = max((len(j) for j in pass2_jobs), default=0)
    for round_i in range(max_jobs):
        pivots = np.array(
            [
                pass2_jobs[r][round_i][0] if round_i < len(pass2_jobs[r]) else int(qlens[r])
                for r in range(R)
            ],
            np.int32,
        )
        minis = np.array(
            [
                pass2_jobs[r][round_i][1] if round_i < len(pass2_jobs[r]) else 1
                for r in range(R)
            ],
            np.int32,
        )
        o2, c2, ov2 = runner.run_pass(
            qs_d, qlens_d,
            jnp.asarray(pivots), jnp.asarray(minis), True, R, L, MAXC, MAXS,
        )
        o2 = np.asarray(o2)
        c2 = np.asarray(c2)
        overflow |= np.asarray(ov2)
        for r in range(R):
            if r < n and round_i < len(pass2_jobs[r]) and not overflow[r]:
                for t in range(int(c2[r])):
                    k, l, s, qb, qe = (int(v) for v in o2[r, t])
                    if qe - qb >= opt.min_seed_len:
                        pass2[r].append(SMEM(k=k, l=l, s=s, qb=qb, qe=qe))

    # ---- pass 3 ----
    pass3: List[List[SMEM]] = [[] for _ in range(R)]
    if opt.max_mem_intv > 0:
        o3, c3, ov3 = runner.run_pass3(
            qs_d, qlens_d, opt.min_seed_len, opt.max_mem_intv, R, L, MAXS
        )
        o3 = np.asarray(o3)
        c3 = np.asarray(c3)
        overflow |= np.asarray(ov3)
        for r in range(R):
            if r < n and not overflow[r]:
                for t in range(int(c3[r])):
                    k, l, s, qb, qe = (int(v) for v in o3[r, t])
                    pass3[r].append(SMEM(k=k, l=l, s=s, qb=qb, qe=qe))

    # assemble + host fallback for overflowing reads
    fallback_ids = [r for r in range(n) if overflow[r]]
    fallback = {}
    if fallback_ids:
        fb = collect_seeds_batch(idx, [reads[r] for r in fallback_ids], opt)
        fallback = dict(zip(fallback_ids, fb))
    out: List[List[SMEM]] = []
    for r in range(n):
        if r in fallback:
            out.append(fallback[r])
            continue
        mems = pass1[r] + pass2[r] + pass3[r]
        mems.sort(key=lambda m: (m.qb << 32) | m.qe)
        out.append(mems)
    return out
