"""FM-index queries over the planar BWT layout (host/numpy, batch-first).

Implements the reference's rank/SA machinery (bwt.c) and reference-store
coordinate functions (bntseq.c) with *vectorized batch* signatures: every
query takes arrays of positions so thousands of seeding states advance per
call.  The same data layout is uploaded to device memory for the JAX path
(ops/fm_rank.py).

Coordinate convention (inherited): positions live on the forward+reverse-
complement concatenation of length ``seq_len = 2*l_pac``; rows of the BWT
matrix are 0..seq_len with the ``$`` character removed at ``primary``
(bwt.c:114 ``k -= (k >= primary)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .build import FMIndexData, PackedReference, unpack_2bit, OCC_INTERVAL

_LANE_MASK = np.uint32(0x55555555)


def _popcount32(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


class FMIndex:
    """Batched FM-index over a PackedReference + FMIndexData pair."""

    def __init__(self, packed: PackedReference, fm: FMIndexData):
        self.packed = packed
        self.fm = fm
        self.l_pac = packed.l_pac
        self.seq_len = fm.seq_len
        self.primary = fm.primary
        self.L2 = fm.L2
        self._words = fm.bwt_words
        self._occ = fm.occ
        self._offsets = packed.contig_offsets()
        self._lengths = np.array([a.length for a in packed.anns], dtype=np.int64)
        self._name_to_rid = {a.name: i for i, a in enumerate(packed.anns)}

    # ------------------------------------------------------------------
    # rank queries (bwt.c:107-220 semantics, vectorized)
    # ------------------------------------------------------------------

    def occ(self, k: np.ndarray, c: int) -> np.ndarray:
        """Occ(k, c): occurrences of char c in bwt[0..k] (inclusive), with
        the reference's row-index conventions: k == -1 -> 0,
        k == seq_len -> L2[c+1]-L2[c] (bwt.c:107-129)."""
        k = np.asarray(k, dtype=np.int64)
        res = np.zeros(k.shape, dtype=np.int64)
        at_end = k == self.seq_len
        res[at_end] = self.L2[c + 1] - self.L2[c]
        live = (~at_end) & (k != -1)
        if live.any():
            res[live] = self._occ_core(k[live], c)
        return res

    def _occ_core(self, k: np.ndarray, c: int) -> np.ndarray:
        kk = k - (k >= self.primary)
        block = kk >> 7
        base = self._occ[block, c]
        j = kk & 127
        word_base = block * 8
        gather = word_base[:, None] + np.arange(8, dtype=np.int64)[None, :]
        words = self._words[gather]  # (B, 8) uint32
        wi = (j >> 4)[:, None]
        p = (j & 15)[:, None]
        widx = np.arange(8, dtype=np.int64)[None, :]
        nvalid = np.where(widx < wi, 16, np.where(widx == wi, p + 1, 0))
        shift = ((16 - nvalid) * 2).astype(np.uint64)
        mask = (~((np.uint64(1) << shift) - np.uint64(1))).astype(np.uint32)
        y = words & mask
        sel_hi = y if (c & 2) else ~y
        sel_lo = y if (c & 1) else ~y
        t = (sel_hi >> np.uint32(1)) & sel_lo & _LANE_MASK
        cnt = _popcount32(t).sum(axis=1)
        if c == 0:
            cnt -= (16 - nvalid).sum(axis=1)
        return base + cnt

    def occ4(self, k: np.ndarray) -> np.ndarray:
        """Occ for all four characters at once; returns (B, 4) int64."""
        k = np.asarray(k, dtype=np.int64)
        out = np.zeros(k.shape + (4,), dtype=np.int64)
        at_end = k == self.seq_len
        if at_end.any():
            out[at_end] = (self.L2[1:5] - self.L2[0:4])[None, :]
        live = (~at_end) & (k != -1)
        if live.any():
            kl = k[live]
            kk = kl - (kl >= self.primary)
            block = kk >> 7
            base = self._occ[block]  # (B, 4)
            j = kk & 127
            gather = (block * 8)[:, None] + np.arange(8, dtype=np.int64)[None, :]
            words = self._words[gather]
            wi = (j >> 4)[:, None]
            p = (j & 15)[:, None]
            widx = np.arange(8, dtype=np.int64)[None, :]
            nvalid = np.where(widx < wi, 16, np.where(widx == wi, p + 1, 0))
            shift = ((16 - nvalid) * 2).astype(np.uint64)
            mask = (~((np.uint64(1) << shift) - np.uint64(1))).astype(np.uint32)
            y = words & mask
            cnts = np.empty((len(kk), 4), dtype=np.int64)
            ny = ~y
            for c in range(4):
                sel_hi = y if (c & 2) else ny
                sel_lo = y if (c & 1) else ny
                t = (sel_hi >> np.uint32(1)) & sel_lo & _LANE_MASK
                cnt = _popcount32(t).sum(axis=1)
                if c == 0:
                    cnt -= (16 - nvalid).sum(axis=1)
                cnts[:, c] = cnt
            out[live] = base + cnts
        return out

    def bwt_char(self, k: np.ndarray) -> np.ndarray:
        """B0(k): the BWT character at stored row k (bwt.h bwt_B0).

        Callers must pre-adjust for primary (x = k - (k > primary))."""
        k = np.asarray(k, dtype=np.int64)
        word = self._words[k >> 4]
        sh = (((~k) & 15) << 1).astype(np.uint32)
        return ((word >> sh) & np.uint32(3)).astype(np.uint8)

    # ------------------------------------------------------------------
    # bidirectional extension (bwt.c:262-275)
    # ------------------------------------------------------------------

    def extend(self, x0: np.ndarray, x1: np.ndarray, x2: np.ndarray, is_back: bool
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched bwt_extend: returns (ok0, ok1, ok2) each (B, 4) where
        ok*[b, c] is the interval after extending with char c.

        x0/x1 are the interval start coordinates (x[0] = forward BWT, x[1]
        = reverse BWT), x2 the size.  For is_back=False the roles of x0/x1
        swap exactly as the reference's ``!is_back`` indexing does."""
        xb = x0 if is_back else x1   # ik.x[!is_back]
        tk = self.occ4(xb - 1)
        tl = self.occ4(xb - 1 + x2)
        ok_b = self.L2[None, :4] + 1 + tk          # ok[c].x[!is_back]
        ok_s = tl - tk                             # ok[c].x[2]
        # the complement-ordered coordinate (ok[c].x[is_back])
        hit_primary = ((xb <= self.primary) & (xb + x2 - 1 >= self.primary)).astype(np.int64)
        ok_o = np.empty_like(ok_b)
        ok_o[:, 3] = (x1 if is_back else x0) + hit_primary
        ok_o[:, 2] = ok_o[:, 3] + ok_s[:, 3]
        ok_o[:, 1] = ok_o[:, 2] + ok_s[:, 2]
        ok_o[:, 0] = ok_o[:, 1] + ok_s[:, 1]
        if is_back:
            return ok_b, ok_o, ok_s   # (x[0], x[1], size)
        return ok_o, ok_b, ok_s

    def set_intv(self, c: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Initial single-base interval (bwt.h bwt_set_intv)."""
        c = np.asarray(c, dtype=np.int64)
        x0 = self.L2[c] + 1
        x2 = self.L2[c + 1] - self.L2[c]
        x1 = self.L2[3 - c] + 1
        return x0, x1, x2

    # ------------------------------------------------------------------
    # suffix-array lookup (bwt.c:86-96)
    # ------------------------------------------------------------------

    def sa(self, k: np.ndarray) -> np.ndarray:
        """SA values for BWT rows k (batched).  Uses the full SA when kept,
        otherwise bounded inverse-Psi walks to the sampled entries (native
        C++ when available — the numpy walk was the genome-scale chaining
        bottleneck at ~0.5 ms/row)."""
        k = np.asarray(k, dtype=np.int64)
        if self.fm.sa is not None:
            return self.fm.sa[k]
        native = self._sa_native(k)
        if native is not None:
            return native
        intv = self.fm.sa_intv
        mask = intv - 1
        steps = np.zeros(k.shape, dtype=np.int64)
        cur = k.copy()
        while True:
            todo = (cur & mask) != 0
            if not todo.any():
                break
            steps[todo] += 1
            cur[todo] = self._inv_psi(cur[todo])
        base = self.fm.sa_sampled[cur >> int(np.log2(intv))]
        # sampled[0] stores -1 in place of seq_len (bwt.c:83): walking from
        # row 0 wraps past the sentinel, matching the reference arithmetic.
        return steps + base

    def _sa_native(self, k: np.ndarray) -> Optional[np.ndarray]:
        """sa_batch via native/smem.cpp; None if the library is absent."""
        import ctypes

        from ..native import get_lib, native_threads

        lib = get_lib()
        if lib is None or not hasattr(lib, "sa_batch") or len(k) == 0:
            return None
        if getattr(self, "_sa_tables_c", None) is None:
            self._sa_tables_c = (
                np.ascontiguousarray(self._words, np.uint32),
                np.ascontiguousarray(self._occ, np.int64),
                np.ascontiguousarray(self.L2, np.int64),
                np.ascontiguousarray(self.fm.sa_sampled, np.int64),
            )
        words, occ, L2, sampled = self._sa_tables_c
        rows = np.ascontiguousarray(k, np.int64)
        out = np.empty(len(k), np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        rc = lib.sa_batch(
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(len(words)),
            occ.ctypes.data_as(i64p),
            L2.ctypes.data_as(i64p),
            ctypes.c_int64(int(self.primary)),
            ctypes.c_int64(int(self.seq_len)),
            sampled.ctypes.data_as(i64p),
            ctypes.c_int64(int(self.fm.sa_intv)),
            rows.ctypes.data_as(i64p),
            ctypes.c_int64(len(k)),
            out.ctypes.data_as(i64p),
            ctypes.c_int32(native_threads()),
        )
        if rc != 0:
            return None
        return out

    def _inv_psi(self, k: np.ndarray) -> np.ndarray:
        """invPsi (bwt.c:53-59), batched."""
        x = k - (k > self.primary)
        c = self.bwt_char(x).astype(np.int64)
        occs = np.empty(len(k), dtype=np.int64)
        for ch in range(4):
            m = c == ch
            if m.any():
                occs[m] = self.occ(k[m], ch)
        res = self.L2[c] + occs
        return np.where(k == self.primary, 0, res)

    # ------------------------------------------------------------------
    # reference-store coordinate functions (bntseq.c)
    # ------------------------------------------------------------------

    def depos(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """bns_depos: map forward-reverse coordinate to forward + strand."""
        pos = np.asarray(pos, dtype=np.int64)
        is_rev = pos >= self.l_pac
        fpos = np.where(is_rev, (self.l_pac << 1) - 1 - pos, pos)
        return fpos, is_rev

    def pos2rid(self, fpos: np.ndarray) -> np.ndarray:
        """bns_pos2rid: contig id for forward positions; -1 if >= l_pac."""
        fpos = np.asarray(fpos, dtype=np.int64)
        rid = np.searchsorted(self._offsets, fpos, side="right") - 1
        return np.where(fpos >= self.l_pac, -1, rid).astype(np.int64)

    def intv2rid(self, rb: np.ndarray, re: np.ndarray) -> np.ndarray:
        """bns_intv2rid: -2 if bridging strands, -1 if spanning contigs."""
        rb = np.asarray(rb, dtype=np.int64)
        re = np.asarray(re, dtype=np.int64)
        fb, _ = self.depos(rb)
        fe, _ = self.depos(np.maximum(re - 1, rb))
        rid_b = self.pos2rid(fb)
        rid_e = np.where(rb < re, self.pos2rid(fe), rid_b)
        out = np.where(rid_b == rid_e, rid_b, -1)
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        return np.where(bridging, -2, out).astype(np.int64)

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """bns_get_seq: base codes for [beg, end) on the fwd-rev coordinate.
        Returns empty if the interval bridges the strand boundary."""
        beg, end = int(beg), int(end)
        if end < beg:
            beg, end = end, beg
        end = min(end, self.seq_len)
        beg = max(beg, 0)
        if beg < self.l_pac < end:
            return np.empty(0, dtype=np.uint8)
        cached = self._fwd_codes()
        if beg >= self.l_pac:
            b, e = (self.l_pac << 1) - end, (self.l_pac << 1) - beg
            fwd = cached[b:e] if cached is not None else unpack_2bit(self.packed.pac, b, e)
            return (3 - fwd[::-1]).astype(np.uint8)
        if cached is not None:
            return cached[beg:end]
        return unpack_2bit(self.packed.pac, beg, end)

    def fetch_seq(self, beg: int, mid: int, end: int) -> Tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq: clamp [beg,end) to the contig containing mid and
        return (seq, rid, clamped_beg, clamped_end).

        Scalar path in pure Python (bisect over a cached offsets list):
        the vectorized depos/pos2rid on 1-element arrays cost ~25 us of
        numpy call overhead per window — a quarter of the RFA host stage
        at 10k windows/superbatch."""
        import bisect as _bisect

        if end < beg:
            beg, end = end, beg
        mid = int(mid)
        two = self.l_pac << 1
        is_rev = mid >= self.l_pac
        fmid = (two - 1 - mid) if is_rev else mid
        offs = getattr(self, "_offsets_list", None)
        if offs is None:
            offs = self._offsets_list = self._offsets.tolist()
        rid = _bisect.bisect_right(offs, fmid) - 1
        ann = self.packed.anns[rid]
        far_beg = ann.offset
        far_end = far_beg + ann.length
        if is_rev:
            far_beg, far_end = two - far_end, two - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.get_seq(beg, end), rid, beg, end

    # Unpacked forward-strand cache: trades 1 byte/base of host RAM for
    # O(1) window slicing (the per-window 2-bit unpack was ~15% of the
    # chaining stage).  Gated by size so multi-Gbp genomes keep the 2-bit
    # footprint; override with ARACHNE_UNPACK_MAX (bases).
    #
    # Round 5 measured the RAM-generous alternative and it LOSES at
    # human scale: unpacking 3.1 Gbp to a byte-per-base cache cost 767
    # vs 989 pairs/s on the 6.2e9-row 100k-pair run (chain.host 24 s ->
    # 85 s) — at that size every window slice is a DRAM/TLB miss over a
    # 3.1 GB array, while the 4x-denser pac keeps more of itself in
    # cache, and the one-time unpack itself burns ~30 s inside the
    # pipeline.  The fixed 256 Mbp cap is the measured right default.
    _UNPACK_MAX_DEFAULT = 1 << 28

    def _fwd_codes(self) -> Optional[np.ndarray]:
        cached = getattr(self, "_fwd_cache", None)
        if cached is not None:
            return cached if cached.size else None
        import os

        limit = int(os.environ.get("ARACHNE_UNPACK_MAX", self._UNPACK_MAX_DEFAULT))
        if self.l_pac > limit:
            self._fwd_cache = np.empty(0, dtype=np.uint8)
            return None
        self._fwd_cache = unpack_2bit(self.packed.pac, 0, self.l_pac)
        return self._fwd_cache

    def fetch_seq_batch(self, begs, mids, ends):
        """Vectorized bns_fetch_seq over many windows: clamp each [beg,end)
        to the contig containing mid; returns (seqs, rids, begs, ends) with
        seqs a list of uint8 arrays."""
        begs = np.asarray(begs, dtype=np.int64).copy()
        ends = np.asarray(ends, dtype=np.int64).copy()
        swap = ends < begs
        if swap.any():
            b = begs[swap]
            begs[swap] = ends[swap]
            ends[swap] = b
        fmid, is_rev = self.depos(np.asarray(mids, dtype=np.int64))
        rids = self.pos2rid(fmid)
        offs = self._offsets[rids]
        lens = self._lengths[rids]
        two_lp = self.l_pac << 1
        far_beg = np.where(is_rev, two_lp - (offs + lens), offs)
        far_end = np.where(is_rev, two_lp - offs, offs + lens)
        begs = np.maximum(begs, far_beg)
        ends = np.minimum(ends, far_end)
        fwd = self._fwd_codes()
        seqs = []
        if fwd is not None:
            for b, e in zip(begs, ends):
                b = int(b); e = int(e)
                if e <= b:
                    seqs.append(np.empty(0, dtype=np.uint8))
                elif b >= self.l_pac:
                    seqs.append((3 - fwd[two_lp - e : two_lp - b][::-1]).astype(np.uint8))
                else:
                    seqs.append(fwd[b:e])
        else:
            for b, e in zip(begs, ends):
                seqs.append(self.get_seq(int(b), int(e)))
        return seqs, rids, begs, ends

    def get_contig_seq(self, chrom: str, start: int, end: int, reversed_: bool = False) -> np.ndarray:
        """GoBwaReference.GetSeq semantics (gobwa.go:50-80): fetch [start,
        end) of a contig by name; optionally reverse-complement."""
        rid = self._name_to_rid[chrom]
        off = self.packed.anns[rid].offset
        seq, _, b, e = self.fetch_seq(start + off, (2 * off + start + end) >> 1, end + off)
        if reversed_:
            return (3 - seq[::-1]).astype(np.uint8)
        return seq

    @property
    def contig_names(self):
        return [a.name for a in self.packed.anns]

    def rid_of(self, name: str) -> int:
        return self._name_to_rid[name]
