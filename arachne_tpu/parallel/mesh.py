"""Device mesh + sharded execution of the alignment compute.

The scaling model (SURVEY.md 5, BASELINE.md): barcode buckets/read batches
are data-parallel across the mesh's ``data`` axis; the FM-index tables are
either replicated (small genomes) or sharded across the ``index`` axis with
collective gathers.  No hand-written NCCL/MPI — XLA collectives (NCCL over NVLink on GPUs) via
jax.sharding + jit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MemOptions
from ..ops.sw_extend import extend_batch_kernel


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def pad_to_multiple(x: np.ndarray, multiple: int, fill) -> np.ndarray:
    b = x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return x
    pad = np.full((rem,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def sharded_extend(
    mesh: Mesh,
    opt: MemOptions,
    qs: np.ndarray,
    ts: np.ndarray,
    qlens: np.ndarray,
    tlens: np.ndarray,
    ws: np.ndarray,
    h0s: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """Run the extension batch data-parallel across the mesh.

    Problems are padded to a multiple of the mesh size and sharded on the
    batch axis; the scoring matrix is replicated.  Returns host arrays
    trimmed to the original batch size."""
    n = mesh.devices.size
    B = qs.shape[0]
    qs_p = pad_to_multiple(qs, n, 4)
    ts_p = pad_to_multiple(ts, n, 4)
    ql_p = pad_to_multiple(qlens, n, 1)
    tl_p = pad_to_multiple(tlens, n, 0)
    ws_p = pad_to_multiple(ws, n, 1)
    h0_p = pad_to_multiple(h0s, n, 1)
    mat = jnp.asarray(opt.scoring_matrix(), jnp.int32)
    batch_sharding = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    args = [
        jax.device_put(jnp.asarray(a), batch_sharding)
        for a in (qs_p, ts_p, ql_p, tl_p, ws_p, h0_p)
    ]
    mat_d = jax.device_put(mat, repl)
    out = extend_batch_kernel(
        args[0], args[1], args[2], args[3], args[4], args[5], mat_d,
        qs_p.shape[1], ts_p.shape[1],
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
    )
    return tuple(np.asarray(o)[:B] for o in out)


def replicated_index_arrays(mesh: Mesh, fm_occ: np.ndarray, fm_words: np.ndarray):
    """Replicate FM-index tables across the mesh (small-genome mode)."""
    repl = NamedSharding(mesh, P())
    return (
        jax.device_put(jnp.asarray(fm_occ), repl),
        jax.device_put(jnp.asarray(fm_words), repl),
    )


class ShardedFMTables:
    """Resident block-sharded FM-index + jitted shard_map rank layer.

    Replaces the rank layer of bwt.c:262-351 for genomes too big to
    replicate: the occ checkpoint table and BWT words are uploaded ONCE,
    each device holding a contiguous range of 128-base blocks along
    ``index_axis`` (other mesh axes see them replicated).  A rank query
    batch is replicated to every shard; the owning shard answers (the occ
    rows keep their *global* cumulative counts, so one shard answers a
    query completely) and a psum over ``index_axis`` assembles the batch —
    lookup-as-collective (SURVEY.md 5).

    Implements the seeding runner interface (run_pass / run_pass3), so
    ops.fm_seed.collect_seeds_device drives the WHOLE three-pass seeding
    state machine against the sharded index: the per-step occ4s inside the
    jitted while_loops become local-lookup + psum via the shard-aware
    DeviceFMIndex (ops/fm_rank.py)."""

    def __init__(self, idx, mesh: Mesh, index_axis: str = "data", wide: bool = None):
        from jax import shard_map

        from ..ops.fm_rank import DeviceFMIndex, occ4_device

        if wide is None:
            wide = idx.seq_len >= (1 << 31)
        if wide and not jax.config.jax_enable_x64:
            print(
                "[arachne] wide sharded FM tables: enabling jax_enable_x64 "
                "process-wide (see ops/fm_rank.py)",
                flush=True,
            )
            jax.config.update("jax_enable_x64", True)
        it = np.int64 if wide else np.int32
        n = int(mesh.shape[index_axis])
        occ = idx.fm.occ.astype(it)
        words = idx.fm.bwt_words
        blocks = occ.shape[0]
        per = -(-blocks // n)
        if per * n != blocks:
            occ = np.concatenate([occ, np.zeros((per * n - blocks, 4), it)])
        need = per * n * 8
        if len(words) < need:
            words = np.concatenate([words, np.zeros(need - len(words), words.dtype)])
        row_spec = P(index_axis, None)
        self.wide = wide
        self.mesh = mesh
        self.axis = index_axis
        self.per = per
        self.primary = int(idx.primary)
        self.seq_len = int(idx.seq_len)
        self.occ_d = jax.device_put(
            jnp.asarray(occ), NamedSharding(mesh, row_spec)
        )
        self.words_d = jax.device_put(
            jnp.asarray(words[:need].reshape(per * n, 8)),
            NamedSharding(mesh, row_spec),
        )
        self.L2_d = jax.device_put(
            jnp.asarray(idx.fm.L2.astype(it)), NamedSharding(mesh, P())
        )

        axis, per_l, primary, seq_len = index_axis, per, self.primary, self.seq_len

        def local_fm(occ_l, words_l, L2_l):
            return DeviceFMIndex(
                occ=occ_l, words=words_l.reshape(-1), L2=L2_l,
                primary=primary, seq_len=seq_len, l_pac=0,
                row_lo=jax.lax.axis_index(axis) * per_l, rows=per_l, axis=axis,
            )

        self._local_fm = local_fm
        self._row_spec = row_spec
        # per-static-config jitted shard_map callables (statics are closed
        # over — shard_map specs only describe array arguments)
        self._cache = {}

        def occ4_fn(occ_l, words_l, L2_l, ks):
            return occ4_device(local_fm(occ_l, words_l, L2_l), ks)

        self._occ4 = jax.jit(
            shard_map(
                occ4_fn, mesh=mesh,
                in_specs=(row_spec, row_spec, P(), P()), out_specs=P(),
                check_vma=False,
            )
        )

    def _shard_jit(self, key, fn, n_batch_args):
        from jax import shard_map

        cached = self._cache.get(key)
        if cached is None:
            cached = jax.jit(
                shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(self._row_spec, self._row_spec, P())
                    + (P(),) * n_batch_args,
                    out_specs=(P(), P(), P()),
                    check_vma=False,
                )
            )
            self._cache[key] = cached
        return cached

    # -- host rank API (numpy in/out, edge rows handled on device)
    def occ4(self, ks: np.ndarray) -> np.ndarray:
        ks = np.asarray(ks)
        B = len(ks)
        Bp = max(64, 1 << max(B - 1, 1).bit_length())
        kt = np.int64 if self.wide else np.int32
        ks_p = np.full(Bp, -1, kt)
        ks_p[:B] = ks.astype(kt)
        out = self._occ4(self.occ_d, self.words_d, self.L2_d, jnp.asarray(ks_p))
        return np.asarray(out)[:B].astype(np.int64)

    # -- seeding runner interface (ops.fm_seed.collect_seeds_device)
    def run_pass(self, qs, qlens, pivots0, min_intvs, single_sweep, R, L, MAXC, MAXS):
        from ..ops.fm_seed import _smem_pass_program

        local_fm = self._local_fm

        def pass_fn(occ_l, words_l, L2_l, qs_, qlens_, p0_, mi_):
            return _smem_pass_program(
                local_fm(occ_l, words_l, L2_l), qs_, qlens_, p0_, mi_,
                single_sweep, R, L, MAXC, MAXS,
            )

        fn = self._shard_jit(("pass", single_sweep, R, L, MAXC, MAXS), pass_fn, 4)
        return fn(self.occ_d, self.words_d, self.L2_d, qs, qlens, pivots0, min_intvs)

    def run_pass3(self, qs, qlens, min_seed_len, max_intv, R, L, MAXS):
        from ..ops.fm_seed import _pass3_program

        local_fm = self._local_fm

        def pass3_fn(occ_l, words_l, L2_l, qs_, qlens_):
            return _pass3_program(
                local_fm(occ_l, words_l, L2_l), qs_, qlens_,
                min_seed_len, max_intv, R, L, MAXS,
            )

        fn = self._shard_jit(
            ("pass3", min_seed_len, max_intv, R, L, MAXS), pass3_fn, 2
        )
        return fn(self.occ_d, self.words_d, self.L2_d, qs, qlens)
