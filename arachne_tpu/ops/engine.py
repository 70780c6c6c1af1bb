"""TpuEngine: barcode-level batched candidate generation on the device.

Drop-in replacement for the scalar per-read path inside
DoRFAForOneBarcode: all reads of a barcode run through device-batched
seeding/extension (ops.batch), wave-batched mate rescue (ops.sw_local) and
wave-batched CIGAR finalization (ops.sw_global).  Output is identical to
the oracle engine — every sequential decision (rescue skip windows, dedup
after each rescue, reg2aln's w2-doubling loop) is replayed on the host
with device results in hand.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align import ksw
from ..align.cigar import (
    MemAln,
    OP_D,
    OP_S,
    approx_mapq_se,
    gen_cigar_finish,
    gen_cigar_prepare,
    infer_bw,
)
from ..align.extend import AlnReg, sort_dedup_patch
from ..align.pairing import infer_dir
from ..align.pipeline import EasyAlignment, interpret_align, seq_to_codes
from ..config import ArachneConfig, MemOptions
from ..index.fmindex import FMIndex
from .batch import batch_align_single
from .sw_extend import BatchExtender
from .sw_global import BatchGlobal
from .sw_local import BatchLocalSW


_WARMED = False

# Headroom left on the device when the FM-index tables are uploaded for
# device seeding: room for the DP batches, their executables and the
# allocator's fragmentation.
TABLE_HEADROOM_BYTES = 4 << 30


def table_budget(device) -> int:
    """Bytes the replicated rank tables may take on ``device``: its
    allocator limit less TABLE_HEADROOM_BYTES (ARACHNE_HBM_BUDGET
    overrides).  A backend that reports no limit (the CPU) has no cap."""
    env = os.environ.get("ARACHNE_HBM_BUDGET")
    if env is not None:
        return int(env)
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit is None:
        return 1 << 62
    return max(0, int(limit) - TABLE_HEADROOM_BYTES)


def _device_seeding_from_env() -> bool:
    """Seeding runs on the host unless ARACHNE_DEVICE_SEEDING=1 asks for
    the device path, which has not yet been measured faster on the GPU."""
    flag = os.environ.get("ARACHNE_DEVICE_SEEDING", "0")
    if flag not in ("0", "1"):
        raise ValueError(f"ARACHNE_DEVICE_SEEDING must be 0 or 1, not {flag!r}")
    return flag == "1"


class TpuEngine:
    """Batched device engine bound to one index + config."""

    def __init__(
        self, idx: FMIndex, cfg: ArachneConfig, device_seeding: Optional[bool] = None
    ):
        self.idx = idx
        self.cfg = cfg
        self.opt = cfg.mem
        self.mat = cfg.mem.scoring_matrix()
        self.extender = BatchExtender(cfg.mem)
        self.local = BatchLocalSW(cfg.mem)
        self.global_ = BatchGlobal(cfg.mem)
        self.dfm = None
        import jax

        if jax.devices()[0].platform == "gpu":
            # the device engine's host stages (seeding, chaining, CIGAR walk,
            # RFA tail) are native code; a pure-Python fallback on a GPU
            # host would be a silent slowdown, so a missing library is fatal
            from ..native import require_lib

            require_lib()
        if device_seeding is None:
            device_seeding = _device_seeding_from_env()
        if device_seeding:
            mode = getattr(cfg.pipeline, "index_mode", "auto")
            n_dev = len(jax.devices())
            # genomes >= 2^31 rows ride the wide (int64) rank path; their
            # tables are also what makes sharding worthwhile
            wide = idx.seq_len >= (1 << 31)
            blocks = -(-idx.seq_len // 128)
            table_bytes = blocks * 4 * (8 if wide else 4) + blocks * 8 * 4
            budget = table_budget(jax.local_devices()[0])
            if mode == "auto":
                # shard exactly when the replicated tables would not fit
                mode = "sharded" if n_dev > 1 and table_bytes > budget else "replicated"
            if mode == "sharded" and n_dev > 1:
                from ..parallel.mesh import ShardedFMTables, make_mesh

                self.dfm = ShardedFMTables(idx, make_mesh(), wide=wide)
            elif table_bytes <= budget:
                from .fm_rank import DeviceFMIndex

                self.dfm = DeviceFMIndex.from_host(idx, wide=wide)
            else:
                # tables fit neither replicated (over budget) nor sharded
                # (single device): graceful host-seeding fallback instead
                # of an out-of-memory error at upload
                print(
                    f"device seeding disabled: index tables "
                    f"({table_bytes >> 20} MiB) exceed the per-device budget "
                    f"({budget >> 20} MiB) and no multi-device mesh is "
                    f"available to shard them",
                    flush=True,
                )

    def warmup(self) -> None:
        """Execute every device kernel once at its production batch shape.

        Compiling happens on the first call of each shape; doing it here,
        under TIMERS.suppress(), keeps compile time out of the stage
        timers and out of the run's steady state.  Runs once per process."""
        global _WARMED
        if _WARMED:
            return
        from ..runtime.timers import TIMERS

        # suppress(): the batchers' inner fetch timers must not book the
        # compile time as steady-state dispatch time
        with TIMERS.suppress():
            q = np.zeros(32, np.uint8)
            t = np.zeros(64, np.uint8)
            self.extender.submit(q, t, self.opt.w, 0, 32)
            self.extender.run()
            self.local.submit(q, t, self.opt.min_seed_len * self.opt.a)
            self.local.run_align2()
            # global: score-only executable AND the traceback (want_z)
            # executable; make the shapes force the z path (len mismatch)
            self.global_.submit(q, t[: len(q) + 1], self.opt.w)
            self.global_.run()
        _WARMED = True

    # ------------------------------------------------------------------
    # batched GoBwaMemMateSW over all pairs of a barcode
    # ------------------------------------------------------------------

    def align_pairs(
        self, pairs: List[Tuple[np.ndarray, np.ndarray]]
    ) -> List[Tuple[List[EasyAlignment], List[EasyAlignment]]]:
        idx, opt, pes = self.idx, self.opt, self.cfg.pes
        flat_reads: List[np.ndarray] = []
        for r1, r2 in pairs:
            flat_reads.append(r1)
            flat_reads.append(r2)
        regs_flat = batch_align_single(
            idx, opt, flat_reads, self.extender, self.mat, dfm=self.dfm
        )
        regs1 = [regs_flat[2 * i] for i in range(len(pairs))]
        regs2 = [regs_flat[2 * i + 1] for i in range(len(pairs))]
        best1 = [max((r.score for r in rs), default=0) for rs in regs1]
        best2 = [max((r.score for r in rs), default=0) for rs in regs2]
        delta = self.cfg.rfa.chain_score_delta
        from ..runtime.timers import TIMERS

        # rescue read1 around read2's hits, then read2 around read1's
        with TIMERS.stage("rescue"):
            self._rescue_wave(pairs, regs2, regs1, best2, side=0, score_delta=delta)
            self._rescue_wave(pairs, regs1, regs2, best1, side=1, score_delta=delta)
        out = []
        for i in range(len(pairs)):
            out.append(
                (
                    [interpret_align(idx, r) for r in regs1[i]],
                    [interpret_align(idx, r) for r in regs2[i]],
                )
            )
        return out

    def _rescue_wave(
        self,
        pairs,
        anchor_regs: List[List[AlnReg]],
        mate_regs: List[List[AlnReg]],
        best_anchor: List[int],
        side: int,
        score_delta: int,
    ) -> None:
        """mem_matesw (bwamem_pair.c:111-180 + gobwa.go:286-324) with ONE
        device dispatch for the whole side.

        The set of attempted anchors is fully determined by the pre-rescue
        snapshot (anchor order, the best-score delta filter, the
        max_matesw cap) — only the skip-window check and the
        insert+dedup-after-each-attempt bookkeeping depend on the evolving
        mate list.  So every attempt's SW window (a pure function of the
        anchor) is computed up front and batched in one dispatch; the
        sequential semantics are then replayed on the host, consuming the
        precomputed SW results.  Anchors the replay decides to skip simply
        leave their (already computed) result unused — output is
        byte-identical to the per-attempt loop."""
        idx, opt, pes = self.idx, self.opt, self.cfg.pes
        l_pac = idx.l_pac

        # per-pair attempted-anchor list from the snapshot
        attempts: List[List[AlnReg]] = []
        for pi in range(len(pairs)):
            lst: List[AlnReg] = []
            mate_seq = pairs[pi][side]
            if mate_seq is not None and len(mate_seq) > 0:
                for a in anchor_regs[pi]:
                    if len(lst) >= opt.max_matesw:
                        break
                    if a.score < best_anchor[pi] - score_delta:
                        continue
                    lst.append(a)
            attempts.append(lst)

        # one batch: the SW window of every attempt the PRE-rescue mate
        # list doesn't already satisfy (the skip hint).  The hint is only a
        # batching filter — the authoritative skip check reruns during the
        # replay against the evolving list; in the rare case dedup removed
        # the hint's proper mate, the replay falls back to the (bit-
        # identical, tests/test_ops.py) host oracle for that one attempt.
        # windows are built lazily: eagerly only for attempts the hint
        # doesn't skip (the common well-paired case pays nothing), and on
        # demand in the replay's rare hint-miss branch.  May hold None for
        # an invalid window.
        windows: Dict[Tuple[int, int], Optional[Tuple]] = {}
        batch_keys = []
        for pi, lst in enumerate(attempts):
            mate_seq = pairs[pi][side]
            hint_regs = mate_regs[pi]
            for ai, a in enumerate(lst):
                if self._matesw_skip(a, hint_regs):
                    continue
                win = self._matesw_window(a, mate_seq)
                windows[(pi, ai)] = win
                if win is not None:
                    batch_keys.append((pi, ai))
        results: Dict[Tuple[int, int], object] = {}
        if batch_keys:
            from ..runtime.timers import TIMERS

            for key in batch_keys:
                seq, rb, ref = windows[key]
                self.local.submit(seq, ref, opt.min_seed_len * opt.a)
            with TIMERS.stage("rescue.device"):
                out = self.local.run_align2()
            results = dict(zip(batch_keys, out))

        # replay the sequential skip/insert/dedup bookkeeping
        for pi, lst in enumerate(attempts):
            mate_seq = pairs[pi][side]
            for ai, a in enumerate(lst):
                if self._matesw_skip(a, mate_regs[pi]):
                    continue
                if (pi, ai) in windows:
                    win = windows[(pi, ai)]
                else:
                    # hint said skip but the evolved list disagrees
                    win = self._matesw_window(a, mate_seq)
                if win is None:
                    continue  # window invalid -> no SW, attempt still counted
                seq, rb, ref = win
                aln = results.get((pi, ai))
                if aln is None:
                    # hint said skip but the evolved list disagrees (dedup
                    # removed the proper mate): exact host oracle
                    l_ms = len(mate_seq)
                    xtra = (
                        ksw.KSW_XSUBO
                        | ksw.KSW_XSTART
                        | (ksw.KSW_XBYTE if l_ms * opt.a < 250 else 0)
                        | (opt.min_seed_len * opt.a)
                    )
                    aln = ksw.align2(
                        seq, ref, self.mat, opt.o_del, opt.e_del,
                        opt.o_ins, opt.e_ins, xtra,
                    )
                l_ms = len(mate_seq)
                if aln.score >= opt.min_seed_len and aln.qb >= 0:
                    b = AlnReg()
                    b.rid = a.rid
                    b.is_alt = a.is_alt
                    # FR rescue is always is_rev=True (gobwa Pes model)
                    b.qb = l_ms - (aln.qe + 1)
                    b.qe = l_ms - aln.qb
                    b.rb = (l_pac << 1) - (rb + aln.te + 1)
                    b.re = (l_pac << 1) - (rb + aln.tb)
                    b.score = aln.score
                    b.csub = aln.score2
                    b.secondary = -1
                    b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                    regs = mate_regs[pi]
                    ins = len(regs)
                    for i in range(len(regs)):
                        if regs[i].score < b.score:
                            ins = i
                            break
                    regs.insert(ins, b)
                # dedup after every attempt (mem_matesw tail)
                deduped = list(sort_dedup_patch(opt, mate_regs[pi]))
                mate_regs[pi].clear()
                mate_regs[pi].extend(deduped)

    def _matesw_skip(self, anchor: AlnReg, mate_regs: List[AlnReg]) -> bool:
        """mem_matesw's skip[] check for the FR orientation: a mate already
        properly placed relative to the anchor makes the attempt free."""
        pes = self.cfg.pes
        l_pac = self.idx.l_pac
        for m in mate_regs:
            r, dist = infer_dir(l_pac, anchor.rb, m.rb)
            if r == 1 and pes.low <= dist <= pes.high:
                return True
        return False

    def _matesw_window(self, anchor: AlnReg, mate_seq: np.ndarray):
        """The SW window of one rescue attempt — a pure function of the
        anchor (FR orientation).  Returns (rev_seq, rb, ref) or None if the
        attempt does no SW."""
        idx, opt, pes = self.idx, self.opt, self.cfg.pes
        l_pac = idx.l_pac
        l_ms = len(mate_seq)
        # FR: is_rev=True, is_larger=True — vectorized reverse-complement
        m = np.asarray(mate_seq)[::-1]
        seq = np.where(m < 4, 3 - m, 4).astype(np.uint8)
        rb = (anchor.rb + pes.low) - l_ms
        re = anchor.rb + pes.high
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        if rb >= re:
            return None
        ref, rid, rb, re = idx.fetch_seq(rb, (rb + re) >> 1, re)
        if anchor.rid != rid or re - rb < opt.min_seed_len:
            return None
        return (seq, rb, ref)

    # ------------------------------------------------------------------
    # batched mem_reg2aln over many hits
    # ------------------------------------------------------------------

    def reg2aln_batch(
        self, jobs: List[Tuple[np.ndarray, Optional[AlnReg]]]
    ) -> List[MemAln]:
        """mem_reg2aln (bwamem.c:1086-1156) with the w2-doubling loop run
        as waves of batched global alignments."""
        idx, opt, mat = self.idx, self.opt, self.mat

        class _Job:
            __slots__ = (
                "query", "ar", "a", "w2", "last_sc", "iter", "done",
                "score", "cigar", "nm", "md", "prep",
            )

        out_jobs: List[Optional[object]] = []
        active: List[object] = []
        for query, ar in jobs:
            if ar is None or ar.rb < 0 or ar.re < 0:
                a = MemAln()
                a.flag |= 0x4
                j = _Job()
                j.a = a
                j.done = True
                out_jobs.append(j)
                continue
            j = _Job()
            j.query = query
            j.ar = ar
            a = MemAln()
            a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
            if ar.secondary >= 0:
                a.flag |= 0x100
            j.a = a
            w2 = max(
                infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
                infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins),
            )
            if w2 > opt.w:
                w2 = min(w2, ar.w)
            j.w2 = w2
            j.last_sc = -(1 << 30)
            j.iter = 0
            j.done = False
            out_jobs.append(j)
            active.append(j)

        while active:
            dp_jobs = []
            for j in active:
                j.w2 = min(j.w2, opt.w * 4)
                ar = j.ar
                prep = gen_cigar_prepare(
                    idx, j.query[ar.qb : ar.qe], ar.rb, ar.re, j.w2, opt, mat
                )
                j.prep = prep
                if prep[0] == "fail":
                    j.score, j.cigar, j.nm, j.md = 0, None, -1, ""
                elif prep[0] == "done":
                    _, q2, rs2, sc, cig = prep
                    j.score, j.cigar, j.nm, j.md = gen_cigar_finish(
                        q2, rs2, ar.rb, idx.l_pac, sc, cig, True
                    )
                else:
                    dp_jobs.append(j)
            if dp_jobs:
                from ..runtime.timers import TIMERS

                for j in dp_jobs:
                    _, q2, rs2, w_eff = j.prep
                    self.global_.submit(q2, rs2, w_eff)
                with TIMERS.stage("cigar.device"):
                    results = self.global_.run()
                for j, (sc, cig) in zip(dp_jobs, results):
                    _, q2, rs2, w_eff = j.prep
                    j.score, j.cigar, j.nm, j.md = gen_cigar_finish(
                        q2, rs2, j.ar.rb, idx.l_pac, sc, cig, True
                    )
            next_active = []
            for j in active:
                if j.score == j.last_sc or j.w2 == opt.w * 4:
                    j.done = True
                else:
                    j.last_sc = j.score
                    j.w2 <<= 1
                    j.iter += 1
                    if j.iter < 3 and j.score < j.ar.truesc - opt.a:
                        next_active.append(j)
                    else:
                        j.done = True
            active = next_active

        # host finalization (bwa-side of mem_reg2aln); the depos/pos2rid
        # coordinate conversions batch across all jobs (they were two tiny
        # numpy calls per alignment)
        mapped = [j for j in out_jobs if not (j.a.flag & 0x4)]
        if mapped:
            fpos_all, is_rev_all = idx.depos(
                np.array(
                    [
                        j.ar.rb if j.ar.rb < idx.l_pac else j.ar.re - 1
                        for j in mapped
                    ],
                    np.int64,
                )
            )
        poses = np.zeros(len(mapped), np.int64)
        for k, j in enumerate(mapped):
            a = j.a
            ar = j.ar
            l_query = len(j.query)
            a.NM = j.nm
            a.MD = j.md
            cigar = list(j.cigar) if j.cigar else []
            pos = int(fpos_all[k])
            a.is_rev = bool(is_rev_all[k])
            if cigar:
                if cigar[0][0] == OP_D:
                    pos += cigar[0][1]
                    cigar = cigar[1:]
                elif cigar[-1][0] == OP_D:
                    cigar = cigar[:-1]
            if ar.qb != 0 or ar.qe != l_query:
                clip5 = l_query - ar.qe if a.is_rev else ar.qb
                clip3 = ar.qb if a.is_rev else l_query - ar.qe
                if clip5:
                    cigar = [(OP_S, clip5)] + cigar
                if clip3:
                    cigar = cigar + [(OP_S, clip3)]
            a.cigar = cigar
            poses[k] = pos
        if mapped:
            rids = idx.pos2rid(poses)
            for k, j in enumerate(mapped):
                a, ar = j.a, j.ar
                a.rid = int(rids[k])
                a.pos = int(poses[k]) - idx.packed.anns[a.rid].offset
                a.score = ar.score
                a.sub = max(ar.sub, ar.csub)
                a.is_alt = ar.is_alt
                a.alt_sc = ar.alt_sc
        return [j.a for j in out_jobs]
