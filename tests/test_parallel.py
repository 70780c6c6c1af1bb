"""Mesh / sharded-index tests on the virtual 8-device CPU mesh.

The sharded FM-index (parallel/mesh.py ShardedFMTables) replaces the rank
layer of /root/reference/src/gobwa/bwa/bwt.c:262-351 for genomes too big
to replicate: tables resident one-block-range-per-device, lookups merged
with a psum over the index axis.  These tests check rank parity and that
the FULL device seeding state machine (ops/fm_seed.py) produces identical
seeds against replicated and sharded tables.
"""

import numpy as np
import pytest

from arachne_tpu.config import MemOptions
from arachne_tpu.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu.parallel.mesh import ShardedFMTables, make_mesh, sharded_extend

OPT = MemOptions()


@pytest.fixture(scope="module")
def idx(small_reference):
    packed = pack_reference(small_reference)
    fm = build_fmindex(packed)
    return FMIndex(packed, fm)


def _mutated_reads(idx, rng, n=24, L=140):
    fwd = unpack_2bit(idx.packed.pac, 0, idx.l_pac)
    reads = []
    for _ in range(n):
        p = int(rng.integers(0, len(fwd) - L - 1))
        r = fwd[p : p + L].copy()
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, L))
            r[j] = (r[j] + 1) % 4
        if rng.integers(0, 3) == 0:
            r[int(rng.integers(0, L))] = 4
        reads.append(r)
    return reads


class TestShardedIndex:
    def test_occ4_matches_host(self, idx, rng):
        import jax

        mesh = make_mesh(min(8, len(jax.devices())))
        tab = ShardedFMTables(idx, mesh)
        ks = np.concatenate(
            [rng.integers(-1, idx.seq_len + 1, 300),
             [-1, 0, idx.seq_len, idx.primary, idx.primary - 1]]
        ).astype(np.int64)
        assert np.array_equal(tab.occ4(ks), idx.occ4(ks))

    def test_occ4_on_2d_mesh(self, idx, rng):
        """(data, index) mesh: tables sharded over 'index', replicated over
        'data' — the layout where reads are data-parallel."""
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()[:8]
        mesh = Mesh(np.array(devs).reshape(2, 4), ("data", "index"))
        tab = ShardedFMTables(idx, mesh, index_axis="index")
        ks = rng.integers(-1, idx.seq_len + 1, 200).astype(np.int64)
        assert np.array_equal(tab.occ4(ks), idx.occ4(ks))

    def test_device_seeding_against_sharded_index(self, idx, rng):
        """The whole three-pass seeding state machine runs under shard_map
        with per-step occ4 psums; output must equal the scalar collector."""
        import jax

        from arachne_tpu.align.smem import collect_seeds
        from arachne_tpu.ops.fm_seed import collect_seeds_device

        mesh = make_mesh(min(8, len(jax.devices())))
        tab = ShardedFMTables(idx, mesh)
        reads = _mutated_reads(idx, rng)
        got = collect_seeds_device(idx, reads, OPT, dfm=tab)
        key = lambda lst: [(m.k, m.l, m.s, m.qb, m.qe) for m in lst]
        for i, (g, r) in enumerate(zip(got, reads)):
            assert key(g) == key(collect_seeds(idx, r, OPT)), i

    def test_replicated_and_sharded_seeding_agree(self, idx, rng):
        from arachne_tpu.ops.fm_rank import DeviceFMIndex
        from arachne_tpu.ops.fm_seed import collect_seeds_device

        import jax

        mesh = make_mesh(min(8, len(jax.devices())))
        reads = _mutated_reads(idx, rng, n=16)
        repl = collect_seeds_device(idx, reads, OPT, dfm=DeviceFMIndex.from_host(idx))
        shrd = collect_seeds_device(idx, reads, OPT, dfm=ShardedFMTables(idx, mesh))
        key = lambda lst: [(m.k, m.l, m.s, m.qb, m.qe) for m in lst]
        for a, b in zip(repl, shrd):
            assert key(a) == key(b)


class TestShardedExtend:
    def test_matches_scalar(self, idx, rng):
        import jax

        from arachne_tpu.align import ksw
        from arachne_tpu.ops.sw_extend import clamp_band

        mesh = make_mesh(min(8, len(jax.devices())))
        B = 16
        qlen, tlen = 64, 96
        ts = rng.integers(0, 4, (B, tlen)).astype(np.int8)
        qs = np.full((B, qlen), 4, np.int8)
        qs[:, :50] = ts[:, :50]
        out = sharded_extend(
            mesh, OPT, qs, ts,
            np.full(B, 50, np.int32), np.full(B, tlen, np.int32),
            np.full(B, clamp_band(OPT, 50, 100, 5, 1), np.int32),
            np.full(B, 19, np.int32),
        )
        mat = OPT.scoring_matrix()
        for i in range(B):
            exp = ksw.extend2(
                qs[i, :50].astype(np.uint8), ts[i].astype(np.uint8), mat,
                6, 1, 6, 1, clamp_band(OPT, 50, 100, 5, 1), 5, 100, 19,
            )
            assert tuple(int(o[i]) for o in out) == exp


class TestWideShardedIndex:
    def test_wide_sharded_occ4_and_seeding(self, idx, rng):
        """int64 (wide) sharded tables: rank parity + full device seeding
        parity on the 8-device mesh (the mode big genomes auto-select,
        ops/engine.py table-size rule)."""
        import jax

        from arachne_tpu.align.smem import collect_seeds
        from arachne_tpu.ops.fm_seed import collect_seeds_device

        try:
            tabs = ShardedFMTables(idx, make_mesh(), wide=True)
            assert tabs.wide
            ks = np.concatenate(
                [rng.integers(-1, idx.seq_len + 1, 200),
                 [-1, 0, idx.seq_len, idx.primary]]
            ).astype(np.int64)
            assert np.array_equal(tabs.occ4(ks), idx.occ4(ks))
            reads = _mutated_reads(idx, rng, n=12)
            got = collect_seeds_device(idx, reads, OPT, dfm=tabs)
            for r, g in zip(reads, got):
                exp = collect_seeds(idx, r, OPT)
                assert [(m.k, m.l, m.s, m.qb, m.qe) for m in g] == [
                    (m.k, m.l, m.s, m.qb, m.qe) for m in exp
                ]
        finally:
            jax.config.update("jax_enable_x64", False)
