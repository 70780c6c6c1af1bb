"""Reference packing and FM-index construction.

Replacement for the index layer the reference consumes but does
not build (it requires prebuilt ``bwa index`` output on disk;
gobwa.go:128-147, SURVEY.md 2.3).  We implement the full construction
pipeline ourselves:

  * FASTA -> 2-bit packed reference (.pac semantics; bntseq.c:227-300
    add1/bns_fasta2bntseq) with exact lrand48-based N randomization
    (seed 11) so the packed bytes match ``bwa index`` bit-for-bit.
  * Suffix array over the forward+reverse-complement concatenation via
    numpy prefix doubling (replaces is.c SA-IS; same output).
  * BWT + occ checkpoints in a device-friendly planar layout (the
    reference interleaves counts into the bwt words, bwt.h:72-78; we keep
    separate dense arrays that upload directly to device memory).
  * Sampled and/or full suffix-array storage.

Everything here is host-side construction; queries live in fmindex.py.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..utils.rng import Lrand48

NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i

OCC_INTERVAL = 128  # bwt.h:36; blocks of 128 bases per occ checkpoint


def available_ram_bytes() -> int:
    """MemAvailable from /proc/meminfo (the kernel's estimate of what can
    be allocated without swapping); conservative sysconf fallback."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0


@dataclass
class ContigAnn:
    """One reference contig annotation (bntann1_t, bntseq.h)."""

    name: str
    offset: int
    length: int
    n_ambs: int = 0
    anno: str = "(null)"
    is_alt: bool = False


@dataclass
class AmbHole:
    """A run of ambiguous bases (bntamb1_t, bntseq.h)."""

    offset: int
    length: int
    amb: str


@dataclass
class PackedReference:
    """2-bit packed forward reference + annotations (bntseq_t semantics)."""

    pac: np.ndarray          # uint8, 4 bases/byte, forward strand only
    l_pac: int               # forward length in bases
    anns: List[ContigAnn] = field(default_factory=list)
    ambs: List[AmbHole] = field(default_factory=list)
    seed: int = 11           # bns->seed (bntseq.c:292)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    def contig_offsets(self) -> np.ndarray:
        return np.array([a.offset for a in self.anns], dtype=np.int64)

    def contig_lengths(self) -> np.ndarray:
        return np.array([a.length for a in self.anns], dtype=np.int64)


def parse_fasta(path: str) -> List[Tuple[str, str, str]]:
    """Parse a (possibly gzipped) FASTA into (name, comment, sequence)."""
    opener = gzip.open if path.endswith(".gz") else open
    out: List[Tuple[str, str, List[str]]] = []
    with opener(path, "rt") as fh:
        name = None
        comment = ""
        chunks: List[str] = []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, comment, "".join(chunks)))
                header = line[1:].split(None, 1)
                name = header[0]
                comment = header[1] if len(header) > 1 else ""
                chunks = []
            elif line and name is not None:
                chunks.append(line.strip())
        if name is not None:
            out.append((name, comment, "".join(chunks)))
    return out


def pack_reference(contigs: List[Tuple[str, str, str]], seed: int = 11) -> PackedReference:
    """FASTA contigs -> PackedReference (add1 semantics, bntseq.c:227-275).

    Ambiguous bases are replaced with lrand48()&3 under srand48(seed) in
    sequence order, exactly as the reference does, so .pac output is
    byte-identical to ``bwa index``.
    """
    rng = Lrand48(seed)
    anns: List[ContigAnn] = []
    ambs: List[AmbHole] = []
    codes_parts: List[np.ndarray] = []
    offset = 0
    for name, comment, seq in contigs:
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        n_amb = 0
        amb_mask = codes >= 4
        if amb_mask.any():
            # record N-holes: runs keyed by the *raw character* (add1 keeps
            # one hole per run of identical ambiguity characters)
            idx = np.flatnonzero(amb_mask)
            start = idx[0]
            last_char = raw[idx[0]]
            run_len = 1
            for j in idx[1:]:
                if j == start + run_len and raw[j] == last_char:
                    run_len += 1
                else:
                    ambs.append(AmbHole(offset + int(start), int(run_len), chr(last_char)))
                    n_amb += 1
                    start, last_char, run_len = j, raw[j], 1
            ambs.append(AmbHole(offset + int(start), int(run_len), chr(last_char)))
            n_amb += 1
            # randomize, in order, matching lrand48()&3 per ambiguous base
            repl = np.array([rng.lrand48() & 3 for _ in range(len(idx))], dtype=np.uint8)
            codes[idx] = repl
        anns.append(
            ContigAnn(
                name=name,
                offset=offset,
                length=len(codes),
                n_ambs=n_amb,
                anno=comment if comment else "(null)",
            )
        )
        offset += len(codes)
        codes_parts.append(codes)
    all_codes = (
        np.concatenate(codes_parts) if codes_parts else np.empty(0, dtype=np.uint8)
    )
    return PackedReference(pac=pack_2bit(all_codes), l_pac=len(all_codes), anns=anns, ambs=ambs, seed=seed)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) 4-per-byte, high bits first (_set_pac layout)."""
    n = len(codes)
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (
        (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    ).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, start: int, end: int) -> np.ndarray:
    """Unpack forward-strand base codes for [start, end) (_get_pac layout)."""
    if end <= start:
        return np.empty(0, dtype=np.uint8)
    b0, b1 = start // 4, (end + 3) // 4
    chunk = pac[b0:b1]
    expanded = np.empty(len(chunk) * 4, dtype=np.uint8)
    expanded[0::4] = (chunk >> 6) & 3
    expanded[1::4] = (chunk >> 4) & 3
    expanded[2::4] = (chunk >> 2) & 3
    expanded[3::4] = chunk & 3
    off = start - b0 * 4
    return expanded[off : off + (end - start)]


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes+sentinel.

    Returns SA of length n+1 over the string codes$ where $ sorts first.
    Uses the native C++ SA-IS (native/sais.cpp, linear time) when the
    toolchain is available, else numpy prefix doubling.  Replaces is.c's
    SA-IS; output is identical either way.
    """
    from ..native import suffix_array_native

    native = suffix_array_native(np.asarray(codes, dtype=np.uint8))
    if native is not None:
        return native
    n = len(codes)
    # sentinel gets rank 0; real bases rank code+1
    rank = np.empty(n + 1, dtype=np.int64)
    rank[:n] = codes.astype(np.int64) + 1
    rank[n] = 0
    m = n + 1
    k = 1
    order = np.argsort(rank, kind="stable")
    # densify initial ranks
    r_ord = rank[order]
    neq = np.empty(m, dtype=np.int64)
    neq[0] = 0
    neq[1:] = (r_ord[1:] != r_ord[:-1]).astype(np.int64)
    dense = np.cumsum(neq)
    rank = np.empty(m, dtype=np.int64)
    rank[order] = dense
    while rank[order[-1]] != m - 1:
        second = np.full(m, -1, dtype=np.int64)
        second[: m - k] = rank[k:]
        order = np.lexsort((second, rank))
        r_ord = rank[order]
        s_ord = second[order]
        neq[0] = 0
        neq[1:] = ((r_ord[1:] != r_ord[:-1]) | (s_ord[1:] != s_ord[:-1])).astype(np.int64)
        dense = np.cumsum(neq)
        rank = np.empty(m, dtype=np.int64)
        rank[order] = dense
        k <<= 1
        if k >= m:
            break
    return order


@dataclass
class FMIndexData:
    """Constructed FM-index arrays (device-friendly planar layout).

    The reference interleaves 4x uint64 occ checkpoints with the packed BWT
    every 128 bases (bwt.h:72-78).  We keep the same 128-base checkpoint
    granularity but as separate dense arrays: ``bwt_words`` (uint32, 16
    bases/word, MSB-first, exactly bwa's word packing) and ``occ``
    (int64 [n_blocks, 4], counts strictly before each block).  This uploads
    to HBM as flat tensors and gathers cleanly in JAX/Pallas.
    """

    seq_len: int            # 2 * l_pac
    primary: int            # row index of the $-suffix removal point
    L2: np.ndarray          # int64[5], cumulative counts; L2[0]=0
    bwt_words: np.ndarray   # uint32[ceil(seq_len/16)] packed BWT chars
    occ: np.ndarray         # int64[n_blocks, 4] checkpoints every 128 bases
    sa: Optional[np.ndarray]       # full SA (int64[seq_len+1]) or None
    sa_sampled: Optional[np.ndarray]  # sampled SA values or None
    sa_intv: int = 32


def bwt_from_sa(
    codes2: np.ndarray, sa: np.ndarray, chunk: int = 1 << 26
) -> Tuple[np.ndarray, int]:
    """BWT characters (with the $ row removed) + primary, from a full SA.

    codes2: the forward+reverse-complement concatenated base codes.
    sa: suffix array of codes2$ (length n+1).  Stored BWT indexing follows
    bwt.c: row k of the matrix maps to stored position k - (k > primary
    ... i.e. stored[j] is the char of row j + (j >= primary)).

    Chunked: the obvious ``codes2[rows - 1]`` over a concatenated row list
    would materialize two extra full-SA-sized temporaries (~100 GB at
    human-genome scale); this streams sa in slices instead, so the only
    full-size allocation is the output itself.
    """
    n = len(codes2)
    out = np.empty(n, dtype=np.uint8)
    primary = -1
    w = 0
    for start in range(0, len(sa), chunk):
        seg = sa[start : start + chunk]
        if primary < 0:
            hits = np.flatnonzero(seg == 0)
            if hits.size:
                primary = start + int(hits[0])
        vals = seg[seg != 0]
        # BWT char of a row with SA value v (v>0) is codes2[v-1]; the v==0
        # row is removed (that is primary).  Row 0 (v==n) -> codes2[n-1].
        out[w : w + len(vals)] = codes2[vals - 1]
        w += len(vals)
    return out, primary


def pack_bwt_words(bwt_chars: np.ndarray, chunk: int = 1 << 24) -> np.ndarray:
    """Pack BWT chars 16-per-uint32, MSB-first (bwt.h bwt_B0 layout).

    Padded to whole 128-base occ blocks so block-wise gathers of 8 words
    never run out of range.  Chunked to stay memory-proportional at
    genome scale."""
    n = len(bwt_chars)
    n_words = ((n + OCC_INTERVAL - 1) // OCC_INTERVAL) * (OCC_INTERVAL // 16)
    out = np.zeros(n_words, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    for start in range(0, n, chunk):
        seg = bwt_chars[start : start + chunk]
        pad_len = ((len(seg) + 15) // 16) * 16
        padded = np.zeros(pad_len, dtype=np.uint32)
        padded[: len(seg)] = seg
        mat = padded.reshape(-1, 16)
        words = (mat << shifts[None, :]).sum(axis=1, dtype=np.uint64).astype(np.uint32)
        out[start // 16 : start // 16 + len(words)] = words
    return out


def occ_checkpoints(
    bwt_chars: np.ndarray, interval: int = OCC_INTERVAL, chunk_blocks: int = 1 << 18
) -> np.ndarray:
    """occ[b, c] = number of c in bwt_chars[0 : b*interval] (chunked)."""
    n = len(bwt_chars)
    n_blocks = (n + interval - 1) // interval + 1
    per_block = np.zeros((n_blocks, 4), dtype=np.int64)
    for b0 in range(0, n_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_blocks)
        seg = bwt_chars[b0 * interval : b1 * interval]
        pad_len = (b1 - b0) * interval
        if len(seg) < pad_len:
            seg = np.concatenate(
                [seg, np.full(pad_len - len(seg), 255, dtype=bwt_chars.dtype)]
            )
        blocks = seg.reshape(b1 - b0, interval)
        for c in range(4):
            per_block[b0:b1, c] = (blocks == c).sum(axis=1)
    occ = np.zeros((n_blocks + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=occ[1:])
    return occ[:n_blocks]


def codes2_packed(packed: PackedReference, chunk: int = 1 << 24) -> Tuple[np.ndarray, np.ndarray]:
    """2-bit packed fwd+revcomp concatenation + symbol counts, chunked.

    Produces the incremental builder's input without materializing the
    full uint8 codes2 (n bytes saved -> n/4); counts feed L2."""
    n = 2 * packed.l_pac
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    counts = np.zeros(4, dtype=np.int64)
    # chunk must stay a multiple of 4 so packed chunks butt-join bytewise
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        if start < packed.l_pac:
            fwd_end = min(end, packed.l_pac)
            seg = unpack_2bit(packed.pac, start, fwd_end)
            if end > packed.l_pac:  # chunk straddles the fwd/rev boundary
                rev_hi = packed.l_pac - 0
                rev_lo = packed.l_pac - (end - packed.l_pac)
                tail = 3 - unpack_2bit(packed.pac, rev_lo, rev_hi)[::-1]
                seg = np.concatenate([seg, tail.astype(np.uint8)])
        else:
            # rev region: codes2[j] = 3 - fwd[2*l_pac - 1 - j]
            rev_hi = 2 * packed.l_pac - start
            rev_lo = 2 * packed.l_pac - end
            seg = (3 - unpack_2bit(packed.pac, rev_lo, rev_hi)[::-1]).astype(np.uint8)
        counts += np.bincount(seg, minlength=4).astype(np.int64)
        out[start // 4 : start // 4 + (len(seg) + 3) // 4] = pack_2bit(seg)
    return out, counts


def build_fmindex_incremental(
    packed: PackedReference, sa_intv: int = 32, progress: bool = False
) -> FMIndexData:
    """Memory-proportional FM-index build via incremental BWT.

    The reference hits the same scaling wall and switches from full-SA
    construction to incremental ropebwt2 above 50 Mbp (bwtindex.c:271,
    rope.c); this is that strategy over our planar layout: a C++ B+-tree
    dynamic-rank sequence prepends one text symbol per step
    (native/ropebwt.cpp), then one LF-cycle walk samples the SA
    (bwt_cal_sa semantics, bwt.c:62-84).  Peak memory is O(n/4) instead of
    the ~8n-byte in-RAM suffix array, which is what makes >=2^31-row
    (human-scale) indexes buildable at all.  Output is bit-identical to
    build_fmindex (parity: tests/test_index_incremental.py)."""
    from ..native import rb_bwt_build_native, sa_sample_walk_native

    n = 2 * packed.l_pac
    pac2, counts = codes2_packed(packed)
    prog = np.zeros(1, dtype=np.int64)
    mon = None
    if progress:
        import threading
        import time as _time

        stop = {"done": False}

        def _report():
            t0 = _time.time()
            while not stop["done"]:
                _time.sleep(15)
                done = int(prog[0])
                if done and not stop["done"]:
                    rate = done / max(1e-9, _time.time() - t0)
                    eta = (n - done) / max(1.0, rate)
                    print(
                        f"[index] incremental BWT {done/1e6:.0f}/{n/1e6:.0f} Msym "
                        f"({rate/1e6:.1f} Msym/s, eta {eta/60:.1f} min)",
                        flush=True,
                    )

        mon = threading.Thread(target=_report, daemon=True)
        mon.start()
    try:
        res = rb_bwt_build_native(pac2, n, prog)
    finally:
        if progress:
            stop["done"] = True
    if res is None:
        raise RuntimeError(
            "incremental index build requires the native toolchain "
            "(native/ropebwt.cpp failed to build or load); use build_mode='sais'"
        )
    bwt_pac2, primary = res
    bwt_chars = unpack_2bit(bwt_pac2, 0, n)
    del bwt_pac2
    L2 = np.zeros(5, dtype=np.int64)
    np.cumsum(counts, out=L2[1:])
    words = pack_bwt_words(bwt_chars)
    occ = occ_checkpoints(bwt_chars)
    del bwt_chars
    # pac2 stays alive for the anchored PARALLEL walk (chunk-boundary
    # suffix rows come from backward-searching text windows); n/4 bytes
    # of extra residency buys the concurrency that replaces the serial
    # ~35-min single-chain chase at human scale
    sampled = sa_sample_walk_native(
        words, occ, L2, primary, n, sa_intv, pac2=pac2, progress=prog
    )
    del pac2
    if sampled is None:
        raise RuntimeError("native sa_sample_walk unavailable")
    return FMIndexData(
        seq_len=n,
        primary=primary,
        L2=L2,
        bwt_words=words,
        occ=occ,
        sa=None,
        sa_sampled=sampled,
        sa_intv=sa_intv,
    )


def build_fmindex(
    packed: PackedReference,
    sa_intv: int = 32,
    keep_full_sa: bool = True,
) -> FMIndexData:
    """Construct the FM-index over forward+reverse-complement.

    Large-genome memory discipline: the dominant transient is the full
    suffix array (8 bytes/row; ~50 GB for GRCh38 fwd+rev) — the lean
    native SA-IS (native/sais.cpp) keeps everything else inside that one
    buffer, and the arrays below are freed as soon as their consumers are
    done, so human-scale builds peak around 75 GB (vs ~170 GB before the
    lean rewrite, which forced such genomes onto the far slower
    incremental path)."""
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    rev = (3 - fwd[::-1]).astype(np.uint8)
    codes2 = np.concatenate([fwd, rev])
    del fwd, rev
    n = len(codes2)
    counts = np.bincount(codes2, minlength=4).astype(np.int64)
    L2 = np.zeros(5, dtype=np.int64)
    np.cumsum(counts, out=L2[1:])
    sa = suffix_array(codes2)
    bwt_chars, primary = bwt_from_sa(codes2, sa)
    del codes2
    sampled = None
    if sa_intv > 0:
        # bwt_sa semantics: sa_row[k] where rows are matrix rows 0..n.
        idx = np.arange(0, n + 1, sa_intv)
        sampled = sa[idx].astype(np.int64)
        sampled[0] = -1  # mirror bwt_cal_sa's sa[0] = -1 sentinel (bwt.c:83)
    sa_keep = sa.astype(np.int64, copy=False) if keep_full_sa else None
    del sa
    return FMIndexData(
        seq_len=n,
        primary=primary,
        L2=L2,
        bwt_words=pack_bwt_words(bwt_chars),
        occ=occ_checkpoints(bwt_chars),
        sa=sa_keep,
        sa_sampled=sampled,
        sa_intv=sa_intv,
    )


# ---------------------------------------------------------------------------
# On-disk native format (.arx) — single .npz with pac + fm arrays
# ---------------------------------------------------------------------------

def save_index(path: str, packed: PackedReference, fm: FMIndexData) -> None:
    # compression saves ~40% on small indexes but costs minutes of
    # single-thread zlib on genome-scale ones; store raw above 1 Gbp rows
    saver = np.savez_compressed if fm.seq_len <= 1_000_000_000 else np.savez
    saver(
        path,
        pac=packed.pac,
        l_pac=np.int64(packed.l_pac),
        ann_names=np.array([a.name for a in packed.anns]),
        ann_offsets=np.array([a.offset for a in packed.anns], dtype=np.int64),
        ann_lengths=np.array([a.length for a in packed.anns], dtype=np.int64),
        ann_annos=np.array([a.anno for a in packed.anns]),
        amb_offsets=np.array([h.offset for h in packed.ambs], dtype=np.int64),
        amb_lengths=np.array([h.length for h in packed.ambs], dtype=np.int64),
        amb_chars=np.array([h.amb for h in packed.ambs]),
        seq_len=np.int64(fm.seq_len),
        primary=np.int64(fm.primary),
        L2=fm.L2,
        bwt_words=fm.bwt_words,
        occ=fm.occ,
        sa=fm.sa if fm.sa is not None else np.empty(0, dtype=np.int64),
        sa_sampled=fm.sa_sampled if fm.sa_sampled is not None else np.empty(0, dtype=np.int64),
        sa_intv=np.int64(fm.sa_intv),
    )


def load_index(path: str) -> Tuple[PackedReference, FMIndexData]:
    z = np.load(path, allow_pickle=False)
    anns = [
        ContigAnn(name=str(n), offset=int(o), length=int(l), anno=str(a))
        for n, o, l, a in zip(z["ann_names"], z["ann_offsets"], z["ann_lengths"], z["ann_annos"])
    ]
    ambs = [
        AmbHole(offset=int(o), length=int(l), amb=str(c))
        for o, l, c in zip(z["amb_offsets"], z["amb_lengths"], z["amb_chars"])
    ]
    packed = PackedReference(pac=z["pac"], l_pac=int(z["l_pac"]), anns=anns, ambs=ambs)
    sa = z["sa"] if z["sa"].size else None
    sampled = z["sa_sampled"] if z["sa_sampled"].size else None
    fm = FMIndexData(
        seq_len=int(z["seq_len"]),
        primary=int(z["primary"]),
        L2=z["L2"],
        bwt_words=z["bwt_words"],
        occ=z["occ"],
        sa=sa,
        sa_sampled=sampled,
        sa_intv=int(z["sa_intv"]),
    )
    return packed, fm


def build_index_files(
    fasta_path: str,
    out_prefix: Optional[str] = None,
    keep_full_sa="auto",
    build_mode: str = "auto",
    progress: bool = False,
) -> str:
    """CLI helper: build and save a native index next to the FASTA.

    ``keep_full_sa`` may be True/False or "auto" (config.IndexOptions
    sa_mode): auto keeps the dense SA only when fwd+rev is at most
    sa_full_max_len rows, so genome-scale indexes stay sampled-SA by
    default (the full SA for GRCh38 alone would be ~50 GB).

    ``build_mode`` selects the construction algorithm ("auto"/"sais"/
    "incremental", IndexOptions.build_mode): auto uses the in-RAM SA-IS
    below build_incremental_min_rows and the memory-proportional
    incremental BWT (native/ropebwt.cpp) above it."""
    from ..config import IndexOptions

    opts = IndexOptions()
    out = (out_prefix or fasta_path) + ".arx.npz"
    contigs = parse_fasta(fasta_path)
    packed = pack_reference(contigs)
    n_rows = 2 * packed.l_pac
    if build_mode == "auto":
        if n_rows <= opts.build_incremental_min_rows:
            build_mode = "sais"
        else:
            # Above the small-genome threshold the choice is RAM-driven:
            # the lean SA-IS route peaks ~13 bytes/row (8 SA + text copies
            # + type bits + recursion buckets, measured) and is several
            # times faster than the memory-proportional incremental BWT
            # (~0.3n bytes), so take it whenever this host can hold it.
            avail = available_ram_bytes()
            need = int(n_rows * opts.sais_bytes_per_row)
            build_mode = "sais" if avail > need else "incremental"
            if progress:
                print(
                    f"[index] build-mode auto: {n_rows/1e9:.1f}e9 rows, "
                    f"sais needs ~{need >> 30} GiB, {avail >> 30} GiB "
                    f"available -> {build_mode}",
                    flush=True,
                )
    if build_mode == "incremental":
        fm = build_fmindex_incremental(packed, progress=progress)
    else:
        if keep_full_sa == "auto":
            keep_full_sa = n_rows <= opts.sa_full_max_len
        fm = build_fmindex(packed, keep_full_sa=bool(keep_full_sa))
    save_index(out, packed, fm)
    return out
