"""Native (C++) host components, loaded via ctypes.

Compiled by g++ from the sources in this directory into ``build/``
(gitignored), once per content hash of the sources.  Without a toolchain
the host paths fall back to pure numpy; the device engine, which needs
the native seeding, chaining and RFA tail on a GPU, calls ``require_lib``
so that a build or load failure there is an error, not a slowdown.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from typing import Callable, List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
# a prebuilt library to load instead of building one (the sanitizer tests
# point this at an instrumented build)
_LIB_PATH: Optional[str] = None
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


_SOURCES = [
    "sais.cpp", "smem.cpp", "chain.cpp", "ropebwt.cpp", "rfa_tail.cpp",
    "cigarwalk.cpp",
]

# Expected ABI of the compiled library (ARACHNE_NATIVE_ABI in ropebwt.cpp).
# A cached .so that predates a signature change reports an older value (or
# lacks the symbol entirely) and is rejected rather than loaded with
# mismatched ctypes argtypes, which would corrupt memory silently.
_EXPECTED_ABI = 8


def cached_build(
    stem: str,
    sources: List[str],
    command: Callable[[str], List[str]],
    out_dir: str,
) -> str:
    """Compile ``sources`` once per content hash; returns the library path.

    The name carries a hash of the sources, the compile command and the
    host's machine type, so a checkout never loads a library built from
    other sources.  A file lock serialises concurrent builders (one
    process per card may start at once); the output is renamed into place
    only when complete.  A failed compile raises RuntimeError with the
    compiler's message."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(command("OUT")).encode())
    h.update(platform.machine().encode())
    path = os.path.join(out_dir, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f".{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = path + ".part"
            try:
                proc = subprocess.run(command(tmp), capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"building {stem}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {stem} failed (rc={proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}"
                )
            os.replace(tmp, path)
    return path


def _build() -> str:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES]
    return cached_build(
        "arachne_native",
        srcs,
        lambda out: ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-pthread", "-o", out] + srcs,
        os.path.join(_DIR, "build"),
    )


def require_lib() -> ctypes.CDLL:
    """The native library, or RuntimeError saying why it is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {_error}")
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH or _build())
        lib.arachne_native_abi.restype = ctypes.c_int64
        if lib.arachne_native_abi() != _EXPECTED_ABI:
            _error = "ABI mismatch between ropebwt.cpp and this module"
            return None
    except (OSError, RuntimeError, AttributeError) as e:
        _error = str(e)
        return None
    _bind(lib)
    _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare argtypes/restype of every exported function."""
    lib.sais_u8_i64.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.sais_u8_i64.restype = ctypes.c_int
    lib.sais_u8_i32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.sais_u8_i32.restype = ctypes.c_int
    lib.sais_ref_u8_i64.argtypes = lib.sais_u8_i64.argtypes
    lib.sais_ref_u8_i64.restype = ctypes.c_int
    lib.smem_collect_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),   # words
        ctypes.c_int64,                    # n_words
        ctypes.POINTER(ctypes.c_int64),    # occ
        ctypes.POINTER(ctypes.c_int64),    # L2
        ctypes.c_int64,                    # primary
        ctypes.c_int64,                    # seq_len
        ctypes.POINTER(ctypes.c_uint8),    # qs
        ctypes.POINTER(ctypes.c_int32),    # qlens
        ctypes.c_int32,                    # n_reads
        ctypes.c_int32,                    # L
        ctypes.c_int32,                    # min_seed_len
        ctypes.c_int32,                    # split_len
        ctypes.c_int32,                    # split_width
        ctypes.c_int64,                    # max_mem_intv
        ctypes.POINTER(ctypes.c_int64),    # out
        ctypes.POINTER(ctypes.c_int32),    # out_n
        ctypes.POINTER(ctypes.c_uint8),    # overflow
        ctypes.c_int32,                    # MAXS
        ctypes.c_int32,                    # n_threads
    ]
    lib.smem_collect_batch.restype = ctypes.c_int
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p_ = ctypes.POINTER(ctypes.c_int64)
    lib.sa_batch.argtypes = [
        u32p, ctypes.c_int64, i64p_, i64p_,       # words, n_words, occ, L2
        ctypes.c_int64, ctypes.c_int64,           # primary, seq_len
        i64p_, ctypes.c_int64,                    # sampled, sa_intv
        i64p_, ctypes.c_int64, i64p_,             # rows, n, out
        ctypes.c_int32,                           # n_threads
    ]
    lib.sa_batch.restype = ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.chain_batch.argtypes = [
        i64p, i32p, i32p, i64p,          # mem_s/qb/qe, mem_off
        i64p, i64p, i32p, i32p, i64p,    # occ rbeg/rid/qbeg/len, occ_off
        i32p,                            # qlen
        ctypes.c_int32, ctypes.c_int64,  # n_reads, l_pac
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,   # w, gap, max_occ
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # min_w, min_seed, max_ext
        ctypes.c_double, ctypes.c_double,                  # mask, drop
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # a, o_del, e_del
        ctypes.c_int32, ctypes.c_int32,                    # o_ins, e_ins
        i32p,                            # out_nchains
        i64p, i32p, i32p, i32p, f64p, i32p,   # chain pos/rid/w/kept/frac/nseeds
        i64p, i64p, i32p,                # rmax0, rmax1, seed_idx
        ctypes.c_int32,                  # n_threads
    ]
    lib.chain_batch.restype = ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64pp = ctypes.POINTER(ctypes.c_int64)
    lib.rb_bwt_build.argtypes = [
        u8p, ctypes.c_int64, u8p, i64pp, i64pp,
    ]
    lib.rb_bwt_build.restype = ctypes.c_int
    lib.sa_sample_walk.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        i64pp, i64pp,                       # occ, L2
        ctypes.c_int64, ctypes.c_int64,     # primary, seq_len
        ctypes.c_int64, i64pp,              # sa_intv, out
    ]
    lib.sa_sample_walk.restype = ctypes.c_int
    lib.sa_sample_walk_par.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        i64pp, i64pp,                       # occ, L2
        ctypes.c_int64, ctypes.c_int64,     # primary, seq_len
        ctypes.c_int64, i64pp,              # sa_intv, out
        u8p,                                # pac2 (2-bit text)
        ctypes.c_int32, ctypes.c_int32,     # n_chunks, n_threads
        i64pp,                              # progress
    ]
    lib.sa_sample_walk_par.restype = ctypes.c_int
    i32 = ctypes.c_int32
    i32p_ = ctypes.POINTER(ctypes.c_int32)
    i64p2 = ctypes.POINTER(ctypes.c_int64)
    f64p2 = ctypes.POINTER(ctypes.c_double)
    u8p2 = ctypes.POINTER(ctypes.c_uint8)
    u64p2 = ctypes.POINTER(ctypes.c_uint64)
    lib.rfa_tail.argtypes = (
        [i32, i32]
        + [i64p2, i64p2, f64p2, f64p2]            # pos/aend/logp/score
        + [i32p_] * 5                              # mism/indels/sclip/slen/seqlen
        + [u8p2, i32p_, i32p_, i32p_]              # rev/contig/aln_id/read_of
        + [i64p2, i64p2, i64p2, i32p_, u64p2]      # locs/locs_off/aln_off/mate_of/jitter
        + [ctypes.c_double, ctypes.c_double, i32, i32, i32]
        + [i64p2, i64p2]                           # centromeres
        + [u8p2, u8p2, u8p2, i32p_, i32p_, u8p2]   # active/proper/pick/mapq/molid/amol
        + [f64p2, f64p2, f64p2, i32p_]             # mconf/mdiff/sum/mate
        + [i32p_, f64p2, u8p2, i32p_, f64p2]       # sb slot/score/proper/reads/conf
        + [i32p_] * 4                              # copies/in/out/uniq
        + [f64p2, i32p_, i32p_]                    # md_score/reads_in_mol/n_mol
    )
    lib.rfa_tail.restype = ctypes.c_int
    i32p_c = ctypes.POINTER(ctypes.c_int32)
    i64p_c = ctypes.POINTER(ctypes.c_int64)
    u8p_c = ctypes.POINTER(ctypes.c_uint8)
    lib.cigar_walk_batch.argtypes = [
        i32p_c, i64p_c,                 # cig, cig_off
        u8p_c, i64p_c,                  # ref, ref_off
        u8p_c, i64p_c,                  # read, read_off
        u8p_c, i64p_c, i64p_c,          # rev, ref_start, ref_end
        i32p_c,                         # edit_dist
        ctypes.c_int64,                 # n
        i32p_c, i64p_c, i32p_c, i32p_c, # counters, locs, rlocs, n
        ctypes.c_int32,                 # n_threads
    ]
    lib.cigar_walk_batch.restype = ctypes.c_int


def cigar_walk_available() -> bool:
    return get_lib() is not None


def cigar_walk_batch_native(
    cig: np.ndarray, cig_off: np.ndarray,
    ref: np.ndarray, ref_off: np.ndarray,
    read: np.ndarray, read_off: np.ndarray,
    rev: np.ndarray, ref_start: np.ndarray, ref_end: np.ndarray,
    edit_dist: np.ndarray, n_threads: int = 1,
):
    """Batched GetAlignments cigar walk (native/cigarwalk.cpp).

    Returns (counters (n,6) int32, mism_locs int64, mism_read_locs int32,
    mism_n (n,) int32); the locus arrays are indexed at each hit's
    read_off base.  None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(cig_off) - 1
    counters = np.zeros((n, 6), np.int32)
    mism_locs = np.zeros(int(read_off[-1]), np.int64)
    mism_read_locs = np.zeros(int(read_off[-1]), np.int32)
    mism_n = np.zeros(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.cigar_walk_batch(
        cig.ctypes.data_as(i32p), cig_off.ctypes.data_as(i64p),
        ref.ctypes.data_as(u8p), ref_off.ctypes.data_as(i64p),
        read.ctypes.data_as(u8p), read_off.ctypes.data_as(i64p),
        rev.ctypes.data_as(u8p), ref_start.ctypes.data_as(i64p),
        ref_end.ctypes.data_as(i64p), edit_dist.ctypes.data_as(i32p),
        np.int64(n),
        counters.ctypes.data_as(i32p), mism_locs.ctypes.data_as(i64p),
        mism_read_locs.ctypes.data_as(i32p), mism_n.ctypes.data_as(i32p),
        np.int32(n_threads),
    )
    if rc != 0:
        return None
    return counters, mism_locs, mism_read_locs, mism_n


def native_threads() -> int:
    """Worker threads for native batch calls: ARACHNE_NATIVE_THREADS, else
    the machine's cores (capped) — the old hardcoded 4 both oversubscribed
    small hosts and under-used big ones."""
    import os as _os

    env = _os.environ.get("ARACHNE_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(_os.cpu_count() or 4, 16))


def smem_available() -> bool:
    return get_lib() is not None


def chain_available() -> bool:
    return get_lib() is not None


def sais_available() -> bool:
    return get_lib() is not None


def ropebwt_available() -> bool:
    return get_lib() is not None


def rb_bwt_build_native(
    pac2: np.ndarray, n: int, progress: Optional[np.ndarray] = None
) -> Optional[tuple]:
    """Incremental BWT of an n-symbol 2-bit-packed text (ropebwt.cpp).

    Returns (bwt_pac2, primary) with the stored BWT in the same 4-per-byte
    high-first packing, or None when the native library is unavailable.
    ``progress`` may be a 1-element int64 array the builder updates with the
    number of processed symbols (poll it from another thread; the ctypes
    call releases the GIL)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    primary = np.zeros(1, dtype=np.int64)
    if progress is None:
        progress = np.zeros(1, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rb_bwt_build(
        pac2.ctypes.data_as(u8p),
        np.int64(n),
        out.ctypes.data_as(u8p),
        primary.ctypes.data_as(i64p),
        progress.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return out, int(primary[0])


def sa_sample_walk_native(
    bwt_words: np.ndarray,
    occ: np.ndarray,
    L2: np.ndarray,
    primary: int,
    seq_len: int,
    sa_intv: int,
    pac2: Optional[np.ndarray] = None,
    progress: Optional[np.ndarray] = None,
    n_chunks: int = 64,
) -> Optional[np.ndarray]:
    """Sampled SA via the LF-cycle walk (bwt_cal_sa, bwt.c:62-84).

    With ``pac2`` (the 2-bit fwd+rev text) the parallel anchored version
    runs: chunk-boundary suffix rows found by backward search, segments
    walked concurrently with interleaved prefetched chains
    (sa_sample_walk_par; identical output, parity-tested).  Without it,
    the serial single-chain walk."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(seq_len // sa_intv + 1, dtype=np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p2 = ctypes.POINTER(ctypes.c_uint8)
    occ_c = np.ascontiguousarray(occ, dtype=np.int64)
    L2_c = np.ascontiguousarray(L2, dtype=np.int64)
    if pac2 is not None:
        if progress is None:
            progress = np.zeros(1, dtype=np.int64)
        rc = lib.sa_sample_walk_par(
            bwt_words.ctypes.data_as(u32p),
            np.int64(len(bwt_words)),
            occ_c.ctypes.data_as(i64p),
            L2_c.ctypes.data_as(i64p),
            np.int64(primary),
            np.int64(seq_len),
            np.int64(sa_intv),
            out.ctypes.data_as(i64p),
            pac2.ctypes.data_as(u8p2),
            np.int32(n_chunks),
            np.int32(native_threads()),
            progress.ctypes.data_as(i64p),
        )
        if rc == 0:
            return out
    rc = lib.sa_sample_walk(
        bwt_words.ctypes.data_as(u32p),
        np.int64(len(bwt_words)),
        occ_c.ctypes.data_as(i64p),
        L2_c.ctypes.data_as(i64p),
        np.int64(primary),
        np.int64(seq_len),
        np.int64(sa_intv),
        out.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return out


def suffix_array_native(codes: np.ndarray) -> Optional[np.ndarray]:
    """SA of codes+sentinel via native SA-IS; None if unavailable.

    Matches index.build.suffix_array: returns SA of length n+1 over the
    string codes$ with $ smallest."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes)
    s = np.empty(n + 1, dtype=np.uint8)
    s[:n] = codes
    s[:n] += 1  # in place: `codes + 1` would cost a second n-byte temporary
    s[n] = 0
    if n + 1 < (1 << 31):
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sais_u8_i32(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(n + 1),
            np.int32(6),
        )
        if rc != 0:
            return None
        return sa.astype(np.int64)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.sais_u8_i64(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int64(n + 1),
        np.int64(6),
    )
    if rc != 0:
        return None
    return sa
