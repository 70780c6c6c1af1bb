"""Batched banded global alignment (CIGAR) on the device.

Batched reformulation of ksw_global2 (ksw.c:504-607): the DP runs on
device with the direction bits written to a (tmax, qmax+1, B) uint8 tensor
(full-width columns instead of the reference's band-packed z matrix — the
band test happens at traceback time); the short backtrack walk runs on the
host per problem.

Direction byte layout matches the reference: bits 0-1 H-source
(0=M, 1=E/del, 2=F/ins), bit 2 E-continuation, bit 5 F-continuation.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..align.ksw import MINUS_INF, _push_cigar
from ..config import MemOptions

# Whether the backtrack walk runs on the device by default: set from a
# timing of both walks on the card (PERF.md, "device against host
# traceback").
DEVICE_TB = True

# Number of problems that went through the full direction-tensor fetch +
# backtrack walk (i.e. were NOT dispatched by the provable all-M shortcut in
# run()).  Lets e2e tests assert the gapped traceback path genuinely fires
# on indel-bearing inputs instead of being dead code behind the shortcut.
TRACEBACK_FETCHES = 0


@functools.partial(
    jax.jit,
    static_argnames=("qmax", "tmax", "o_del", "e_del", "o_ins", "e_ins", "want_z"),
)
def global_batch_kernel(
    qs: jnp.ndarray,     # (B, qmax) int8
    ts: jnp.ndarray,     # (B, tmax) int8
    qlens: jnp.ndarray,  # (B,)
    tlens: jnp.ndarray,  # (B,)
    ws: jnp.ndarray,     # (B,) band width
    mat: jnp.ndarray,
    qmax: int,
    tmax: int,
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    want_z: bool = True,
):
    B = qs.shape[0]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    NEG = jnp.int32(MINUS_INF)
    jidx = jnp.arange(qmax, dtype=jnp.int32)[:, None]
    qsT = qs.T.astype(jnp.int32)
    valid_q = jidx < qlens[None, :]

    # first row: H(-1, j) = -(o_ins + e_ins*(j+1)) within the band
    Hprev = jnp.where(
        (jidx + 1 <= ws[None, :]) & valid_q,
        -(o_ins + e_ins * (jidx + 1)),
        NEG,
    )
    Eprev = jnp.full((qmax, B), NEG, jnp.int32)

    state = dict(
        H=Hprev,
        E=Eprev,
        z=jnp.zeros((tmax if want_z else 1, qmax, B), jnp.uint8),
        score=jnp.full((B,), MINUS_INF, jnp.int32),
    )

    def body(i, st):
        ii = jnp.int32(i)
        row_live = ii < tlens
        tcode = jnp.where(row_live, ts[:, i], 4).astype(jnp.int32)
        q_row = mat[tcode[None, :], qsT]
        in_band = (jidx >= ii - ws[None, :]) & (jidx < ii + ws[None, :] + 1) & valid_q
        bound_prev = jnp.where(
            ii == 0,
            0,
            jnp.where((ii - 1) <= ws, -(o_del + e_del * ii), NEG),
        ).astype(jnp.int32)
        Hdiag = jnp.concatenate([bound_prev[None, :], st["H"][:-1]], axis=0)
        E = st["E"]
        M = Hdiag + q_row
        # F scan with -inf init: F(j) = max_k<j (M(k) - oe_ins - (j-1-k)e_ins)
        v = (M - oe_ins) + jidx * e_ins
        run = jax.lax.cummax(jnp.where(in_band, v, NEG), axis=0)
        F = jnp.full((qmax, B), NEG, jnp.int32)
        F = F.at[1:].set(run[:-1] - (jidx[1:] - 1) * e_ins)
        d = jnp.where(M >= E, 0, 1).astype(jnp.uint8)
        H = jnp.maximum(M, E)
        d = jnp.where(H >= F, d, 2).astype(jnp.uint8)
        H = jnp.maximum(H, F)
        d = d | (((E - e_del) > (M - oe_del)).astype(jnp.uint8) << 2)
        d = d | (((F - e_ins) > (M - oe_ins)).astype(jnp.uint8) << 5)
        Enew = jnp.maximum(E - e_del, M - oe_del)
        H = jnp.where(in_band, H, NEG)
        Enew = jnp.where(in_band, Enew, NEG)
        if want_z:
            z = st["z"].at[i].set(jnp.where(in_band & row_live[None, :], d, 0))
        else:
            z = st["z"]
        # score: H at (tlen-1, qlen-1)
        h_last = jnp.take_along_axis(H, (qlens - 1)[None, :], axis=0)[0]
        score = jnp.where(ii == tlens - 1, h_last, st["score"])
        keep = row_live[None, :]
        return dict(
            H=jnp.where(keep, H, st["H"]),
            E=jnp.where(keep, Enew, st["E"]),
            z=z,
            score=score,
        )

    st = jax.lax.fori_loop(0, tmax, body, state)
    return st["score"], st["z"]


def traceback(
    z: np.ndarray, qlen: int, tlen: int, w: int
) -> List[Tuple[int, int]]:
    """Backtrack (ksw.c:588-602) over the full-width direction matrix."""
    cigar: List[Tuple[int, int]] = []
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i, k]) >> (which << 1)) & 3
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
    return cigar


@functools.partial(jax.jit, static_argnames=("qmax", "tmax", "max_steps"))
def traceback_device(
    z: jnp.ndarray,      # (tmax, qmax, B) uint8 direction bytes (on device)
    qlens: jnp.ndarray,  # (B,)
    tlens: jnp.ndarray,  # (B,)
    ws: jnp.ndarray,     # (B,)
    *,
    qmax: int,
    tmax: int,
    max_steps: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The backtrack walk (ksw.c:588-602) on device, all lanes in parallel.

    The (tmax, qmax, B) direction tensor (15.7 MB per 256-problem chunk
    at 320x192) never leaves the device; the host gets a per-step op
    stream (max_steps x B int8, 131 KB) plus the final (i, k) for its
    trailing D/I push.  Per-step ops mirror the host `traceback` exactly:
    0=M (i-1, k-1), 2=D (i-1), 1=I (k-1); 3 marks steps after the lane
    finished.  Host reverses, appends the tail runs, and run-length
    encodes (decode_traceback_ops)."""
    B = z.shape[2]
    zf = z.reshape(tmax * qmax, B)
    i0 = tlens - 1
    k0 = jnp.minimum(i0 + ws + 1, qlens) - 1

    def body(s, st):
        i, k, which, ops = st
        active = (i >= 0) & (k >= 0)
        idx = jnp.clip(i, 0, tmax - 1) * qmax + jnp.clip(k, 0, qmax - 1)
        zv = jnp.take_along_axis(zf, idx[None, :], axis=0)[0].astype(jnp.int32)
        nw = (zv >> (which << 1)) & 3
        # host semantics: nw==0 -> M (i-1,k-1); ==1 -> D (i-1); >=2 -> I (k-1)
        op = jnp.where(nw == 0, 0, jnp.where(nw == 1, 2, 1)).astype(jnp.int8)
        op = jnp.where(active, op, jnp.int8(3))
        ops = jax.lax.dynamic_update_slice(ops, op[None, :], (s, 0))
        i = jnp.where(active & (nw <= 1), i - 1, i)
        k = jnp.where(active & (nw != 1), k - 1, k)
        # the RAW 2-bit value (including 3) is the next read's shift state,
        # exactly as the host walk keeps it
        which = jnp.where(active, nw, which)
        return i, k, which, ops

    ops0 = jnp.full((max_steps, B), 3, jnp.int8)
    i, k, _which, ops = jax.lax.fori_loop(
        0, max_steps, body, (i0.astype(jnp.int32), k0.astype(jnp.int32),
                             jnp.zeros(B, jnp.int32), ops0)
    )
    return ops, i, k


@jax.jit
def _bundle_tb(score, ops, fi, fk):
    """Stack (score, fi, fk) as int8 rows on top of the op stream so one
    chunk's traceback lands in a single (12 + max_steps, B) int8 fetch."""
    meta = jnp.stack(
        [score.astype(jnp.int32), fi.astype(jnp.int32), fk.astype(jnp.int32)]
    )                                                        # (3, B)
    meta8 = jax.lax.bitcast_convert_type(meta, jnp.int8)     # (3, B, 4)
    meta_rows = meta8.transpose(0, 2, 1).reshape(12, -1)     # (12, B)
    return jnp.concatenate([meta_rows, ops], axis=0)


def decode_traceback_ops(
    ops_col: np.ndarray, fi: int, fk: int
) -> List[Tuple[int, int]]:
    """Host-side finish of traceback_device for one lane: reverse the op
    stream, append the trailing D/I runs, run-length encode (the inverse
    order + merge of the host `traceback`)."""
    seq = ops_col[ops_col != 3]
    cigar: List[Tuple[int, int]] = []
    tail: List[Tuple[int, int]] = []
    if fi >= 0:
        tail.append((2, fi + 1))
    if fk >= 0:
        tail.append((1, fk + 1))
    full = list(seq) + [op for op, n in tail for _ in range(n)]
    for op in reversed(full):
        _push_cigar(cigar, int(op), 1)
    return cigar


class BatchGlobal:
    """Batched bwa-style global alignment returning (score, cigar)."""

    def __init__(self, opt: MemOptions, qmax: int = 192, tmax: int = 320):
        # qmax floor 192 (not 160): with <=192bp reads every dispatch of
        # this kernel then shares ONE executable shape, compiled once in
        # the engine's warmup, never mid-run
        self.opt = opt
        self.qmax = qmax
        self.tmax = tmax
        self.mat = jnp.asarray(opt.scoring_matrix(), jnp.int32)
        self.mat_np = opt.scoring_matrix().astype(np.int64)
        self.reset()

    def reset(self):
        self.problems: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def submit(self, query: np.ndarray, target: np.ndarray, w: int) -> int:
        self.problems.append((query, target, w))
        return len(self.problems) - 1

    CHUNK = 1024  # fixed device batch: one compile per (qmax, tmax, want_z)
    CHUNK_Z = 256  # a traceback chunk's (tmax, qmax, B) direction tensor: keep it small

    def _kernel(self, problems, want_z: bool):
        from .sw_extend import pad_batch

        B = len(problems)
        # sorted by target length like the other batchers; outputs
        # unsorted back to input order before returning
        order = sorted(range(B), key=lambda i: len(problems[i][1]))
        problems = [problems[i] for i in order]
        qmax = max(self.qmax, -(-max(len(q) for q, _, _ in problems) // 64) * 64)
        tmax = max(self.tmax, -(-max(len(t) for _, t, _ in problems) // 64) * 64)
        chunk = self.CHUNK_Z if want_z else self.CHUNK
        scores = []
        zs = []
        pending = []
        from ..runtime.timers import TIMERS
        from .devicepool import dispatch_devices, put
        from .sw_extend import _dev_name

        devs = dispatch_devices()
        for ci, c0 in enumerate(range(0, B, chunk)):
            dev = devs[ci % len(devs)]
            c1 = min(c0 + chunk, B)
            nb = c1 - c0
            Bp = chunk if B > chunk else pad_batch(nb, 32)
            qs = np.full((Bp, qmax), 4, np.int8)
            ts = np.full((Bp, tmax), 4, np.int8)
            qlens = np.ones(Bp, np.int32)
            tlens = np.ones(Bp, np.int32)
            ws = np.ones(Bp, np.int32)
            for i in range(nb):
                q, t, w = problems[c0 + i]
                qs[i, : len(q)] = q
                ts[i, : len(t)] = t
                qlens[i] = len(q)
                tlens[i] = len(t)
                ws[i] = w
            TIMERS.add(f"chunks.{_dev_name(dev)}", 0.0)
            score, z = global_batch_kernel(
                put(qs, dev), put(ts, dev), put(qlens, dev), put(tlens, dev),
                put(ws, dev), put(self.mat, dev), qmax, tmax,
                self.opt.o_del, self.opt.e_del, self.opt.o_ins, self.opt.e_ins,
                want_z=want_z,
            )
            pending.append((score, z, nb))

        # fetch after all chunks are in flight
        for score, z, nb in pending:
            with TIMERS.stage(
                f"global.dispatch.{qmax}x{tmax}{'z' if want_z else ''}"
            ):
                scores.append(np.asarray(score)[:nb])
                if want_z:
                    zs.append(np.asarray(z)[:, :, :nb])
        inv = np.empty(B, np.int64)
        inv[np.asarray(order)] = np.arange(B)
        score_all = np.concatenate(scores)[inv]
        z_all = np.concatenate(zs, axis=2)[:, :, inv] if zs else None
        return score_all, z_all

    def _device_tb_enabled(self) -> bool:
        """Walk the direction tensor ON DEVICE and fetch per-step ops
        (traceback_device) instead of copying the (tmax, qmax, B) z tensor
        to the host walk.  DEVICE_TB is the measured default (PERF.md);
        ARACHNE_DEVICE_TB=0/1 selects a walk explicitly (tests run both)."""
        import os

        flag = os.environ.get("ARACHNE_DEVICE_TB", "")
        if flag in ("0", "1"):
            return flag == "1"
        return DEVICE_TB

    def _traceback_on_device(self, problems):
        """(score, cigar) for gapped problems with the backtrack walk on
        device; mirrors _kernel's tlen-sorted chunking."""
        from ..runtime.timers import TIMERS
        from .devicepool import dispatch_devices, put
        from .sw_extend import _dev_name, pad_batch

        B = len(problems)
        order = sorted(range(B), key=lambda i: len(problems[i][1]))
        problems = [problems[i] for i in order]
        qmax = max(self.qmax, -(-max(len(q) for q, _, _ in problems) // 64) * 64)
        tmax = max(self.tmax, -(-max(len(t) for _, t, _ in problems) // 64) * 64)
        chunk = self.CHUNK_Z
        pending = []
        devs = dispatch_devices()
        for ci, c0 in enumerate(range(0, B, chunk)):
            dev = devs[ci % len(devs)]
            c1 = min(c0 + chunk, B)
            nb = c1 - c0
            Bp = pad_batch(nb, 32)
            qs = np.full((Bp, qmax), 4, np.int8)
            ts = np.full((Bp, tmax), 4, np.int8)
            qlens = np.ones(Bp, np.int32)
            tlens = np.ones(Bp, np.int32)
            ws = np.ones(Bp, np.int32)
            for i in range(nb):
                q, t, w = problems[c0 + i]
                qs[i, : len(q)] = q
                ts[i, : len(t)] = t
                qlens[i] = len(q)
                tlens[i] = len(t)
                ws[i] = w
            ql_d, tl_d, ws_d = put(qlens, dev), put(tlens, dev), put(ws, dev)
            TIMERS.add(f"chunks.{_dev_name(dev)}", 0.0)
            score, z = global_batch_kernel(
                put(qs, dev), put(ts, dev), ql_d, tl_d, ws_d, put(self.mat, dev),
                qmax, tmax,
                self.opt.o_del, self.opt.e_del, self.opt.o_ins,
                self.opt.e_ins, want_z=True,
            )
            ops, fi, fk = traceback_device(
                z, ql_d, tl_d, ws_d, qmax=qmax, tmax=tmax,
                max_steps=qmax + tmax,
            )
            # ONE fetch per chunk: score/fi/fk bitcast to int8 rows and
            # stacked onto the op stream
            bundle = _bundle_tb(score, ops, fi, fk)
            pending.append((bundle, nb))

        results = []
        for bundle, nb in pending:
            with TIMERS.stage(f"global.devtb.{qmax}x{tmax}"):
                raw = np.asarray(bundle)
            meta = (
                raw[:12]
                .reshape(3, 4, raw.shape[1])
                .transpose(0, 2, 1)
                .copy()
                .view(np.int32)[..., 0]
            )
            sc, fi_h, fk_h = meta[0], meta[1], meta[2]
            ops_h = raw[12:]
            for i in range(nb):
                cig = decode_traceback_ops(ops_h[:, i], int(fi_h[i]), int(fk_h[i]))
                results.append((int(sc[i]), cig))
        inv = np.empty(B, np.int64)
        inv[np.asarray(order)] = np.arange(B)
        return [results[int(j)] for j in inv]

    def run(self, want_cigar: bool = True):
        """Two-phase: score-only first; full traceback only for problems
        whose optimum is not provably the all-M alignment.

        If rlen == qlen and the global score equals the no-gap score
        sum(mat[t, q]), the traceback is exactly [(M, qlen)]: any
        equal-scoring gapped path would need E(i,i) > M(i,i) (or F > max)
        at some diagonal cell, which would beat the all-M total since the
        diagonal suffix scores are shared — contradiction.  The reference's
        tie-breaking prefers M at every cell (ksw.c:551-554), so the bits
        are 0 along the diagonal.  This skips the (tmax, qmax, B) direction
        tensor transfer for the typical indel-free alignment."""
        if not self.problems:
            return []
        problems = self.problems
        self.problems = []
        out: List[Optional[Tuple[int, Optional[List[Tuple[int, int]]]]]] = [None] * len(problems)
        need_tb = []
        # length-mismatched problems can never take the all-M shortcut, so
        # the score-only pass would be pure waste for them (the traceback
        # kernel recomputes the same DP); send them straight to traceback
        # and score-screen only the equal-length ones
        screened = [
            i for i, (q, t, w) in enumerate(problems)
            if not want_cigar or len(q) == len(t)
        ]
        if screened:
            score, _ = self._kernel([problems[i] for i in screened], want_z=False)
            for k, i in enumerate(screened):
                q, t, w = problems[i]
                sc = int(score[k])
                if not want_cigar:
                    out[i] = (sc, None)
                elif sc == int(self.mat_np[t, q].sum()):
                    out[i] = (sc, [(0, len(q))])
                else:
                    need_tb.append(i)
        if want_cigar:
            need_tb += [
                i for i, (q, t, w) in enumerate(problems) if len(q) != len(t)
            ]
            need_tb.sort()
        if need_tb:
            global TRACEBACK_FETCHES
            TRACEBACK_FETCHES += len(need_tb)
            sub = [problems[i] for i in need_tb]
            if self._device_tb_enabled():
                for k, res in zip(need_tb, self._traceback_on_device(sub)):
                    out[k] = res
            else:
                score2, z = self._kernel(sub, want_z=True)
                z = np.asarray(z)
                for k, i in enumerate(need_tb):
                    q, t, w = problems[i]
                    cig = traceback(z[:, :, k], len(q), len(t), w)
                    out[i] = (int(score2[k]), cig)
        return out
