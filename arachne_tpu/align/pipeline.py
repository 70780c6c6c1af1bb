"""Candidate generation: per-read alignment + paired mate rescue.

``align_single``         = mem_align1_core (bwamem.c:1048-1084)
``align_pair_with_rescue`` = GoBwaMemMateSW (gobwa.go:226-337): align both
mates independently, then rescue each side around the near-best hits of the
other (score_delta window, <=50 rescue rounds per side).
``EasyAlignment``        = the cgo bridge's interpreted hit (gobwa.go:339-371).

The extension DP is pluggable (see extend.chain2aln) so this same driver
runs either the scalar oracle or the batched device kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import ArachneConfig, InsertSizeModel, MemOptions
from ..index.fmindex import FMIndex
from .chain import chain_filter, filter_chained_seeds, mem_chain
from .extend import AlnReg, ExtendFn, chain2aln, sort_dedup_patch
from .pairing import matesw


NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4[ord(_c)] = _i
    NT4[ord(_c.lower())] = _i


def seq_to_codes(seq) -> np.ndarray:
    """SequenceConvert (gobwa.go:159-167): ASCII -> 2-bit codes (4 = N)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return NT4[np.frombuffer(bytes(seq), dtype=np.uint8)].copy()


def align_single(
    idx: FMIndex,
    opt: MemOptions,
    codes: np.ndarray,
    extender: Optional[ExtendFn] = None,
    mat: Optional[np.ndarray] = None,
) -> List[AlnReg]:
    """mem_align1_core: chain -> filter -> extend -> dedup."""
    if mat is None:
        mat = opt.scoring_matrix()
    chains = mem_chain(idx, codes, opt)
    chains = chain_filter(opt, chains)
    filter_chained_seeds(idx, codes, chains, opt)
    regs: List[AlnReg] = []
    for c in chains:
        chain2aln(idx, codes, c, opt, regs, extender=extender, mat=mat)
    regs = sort_dedup_patch(opt, regs, idx, codes, mat)
    # Arachne never calls mem_mark_primary_se; regions keep the memset-zero
    # secondary fields (see chain2aln), matching the cgo path's behavior.
    return regs


@dataclass
class EasyAlignment:
    """InterpretAlign (gobwa.go:339-371): contig-space view of an AlnReg.

    For reverse hits ``offset`` is the *rightmost* forward-strand base and
    ``aend`` the leftmost-1, exactly as the bridge reports them; the RFA
    layer swaps them back (aligner.go:1511-1516)."""

    offset: int
    aend: int
    contig: str
    rid: int
    reversed_: bool
    score: int
    read_s: int
    read_e: int
    secondary: bool
    reg: AlnReg


def interpret_align(idx: FMIndex, reg: AlnReg) -> EasyAlignment:
    l_pac = idx.l_pac
    ann = idx.packed.anns[reg.rid]
    if reg.rb < l_pac:
        offset = reg.rb - ann.offset
        rev = False
    else:
        offset = l_pac * 2 - 1 - reg.rb - ann.offset
        rev = True
    if reg.re < l_pac:
        aend = reg.re - ann.offset
    else:
        aend = l_pac * 2 - 1 - reg.re - ann.offset
    return EasyAlignment(
        offset=int(offset),
        aend=int(aend),
        contig=ann.name,
        rid=reg.rid,
        reversed_=rev,
        score=reg.score,
        read_s=reg.qb,
        read_e=reg.qe,
        secondary=(reg.secondary >= 0 or reg.secondary_all > 0),
        reg=reg,
    )


def align_pair_with_rescue(
    idx: FMIndex,
    opt: MemOptions,
    pes: InsertSizeModel,
    read1: Optional[np.ndarray],
    read2: Optional[np.ndarray],
    score_delta: int = 25,
    extender: Optional[ExtendFn] = None,
    mat: Optional[np.ndarray] = None,
) -> Tuple[List[EasyAlignment], List[EasyAlignment]]:
    """GoBwaMemMateSW (gobwa.go:226-337)."""
    if mat is None:
        mat = opt.scoring_matrix()
    regs1 = align_single(idx, opt, read1, extender, mat) if read1 is not None and len(read1) else []
    regs2 = align_single(idx, opt, read2, extender, mat) if read2 is not None and len(read2) else []
    best1 = max((r.score for r in regs1), default=0)
    best2 = max((r.score for r in regs2), default=0)
    # rescue read1 around read2's near-best hits (gobwa.go:286-300)
    if read1 is not None and len(read1):
        num = 0
        i = 0
        anchors = list(regs2)  # snapshot order; C iterates the pre-rescue list
        while i < len(anchors) and num < opt.max_matesw:
            if anchors[i].score >= best2 - score_delta:
                num += 1
                matesw(idx, opt, pes, anchors[i], read1, regs1, mat)
            i += 1
    # rescue read2 around read1's (post-rescue) near-best hits (:309-324)
    if read2 is not None and len(read2):
        num = 0
        i = 0
        anchors = list(regs1)
        while i < len(anchors) and num < opt.max_matesw:
            if anchors[i].score >= best1 - score_delta:
                num += 1
                matesw(idx, opt, pes, anchors[i], read2, regs2, mat)
            i += 1
    return (
        [interpret_align(idx, r) for r in regs1],
        [interpret_align(idx, r) for r in regs2],
    )
