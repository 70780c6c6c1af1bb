"""Device-seeding ceiling: is the occ4 slot machine latency- or bandwidth-bound?

Two very different ceilings bound device seeding:

  * BANDWIDTH: how many independent occ4 rank queries the card answers
    per second when they arrive as one big batch (pure gather + popcount,
    no sequential dependency);
  * LATENCY: how long one step of a lax.while_loop takes when each step's
    queries depend on the previous step's answers (the seeding state
    machine's structure, bwt.c:262-351).

If the batch path is orders of magnitude faster than the loop path, the
state machine is step-latency-bound and a deeper-pipelined formulation
(k independent queries per lane per step) changes the ceiling; if both
paths converge, HBM gather bandwidth is the wall and the no-go stands.

Each timing is the median of repeated calls, each waited for with
jax.block_until_ready.  Pass an index larger than the card's 50 MB L2 to
measure memory rather than cache.

Usage: python scripts/seeding_microbench.py [index.arx.npz]
  (defaults to building a small 8 Mbp index in memory)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def timed(fn, runs=15):
    """Median seconds of fn(prev) over `runs` calls, each waited for with
    block_until_ready; each call sees the previous result, so chained
    calls cannot be merged."""
    import jax

    out = jax.block_until_ready(fn(None))          # warm-up / compile
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(out))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main() -> None:
    import jax
    import jax.numpy as jnp

    from arachne_tpu.index import FMIndex, load_index
    from arachne_tpu.ops.fm_rank import DeviceFMIndex, occ4_device

    if len(sys.argv) > 1:
        packed, fm = load_index(sys.argv[1])
        idx = FMIndex(packed, fm)
    else:
        from arachne_tpu.index.build import build_fmindex, pack_reference

        rng0 = np.random.default_rng(0)
        genome = "".join("ACGT"[i] for i in rng0.integers(0, 4, 8_000_000))
        packed = pack_reference([("c", "", genome)])
        idx = FMIndex(packed, build_fmindex(packed, keep_full_sa=False))
    dfm = DeviceFMIndex.from_host(idx)
    print(f"index: seq_len={idx.seq_len:,}  device={jax.devices()[0]}")
    rng = np.random.default_rng(1)

    # --- bandwidth: independent queries, one dispatch -------------------
    occ4_jit = jax.jit(lambda k: occ4_device(dfm, k))
    for B in (1 << 14, 1 << 17, 1 << 20):
        ks = jnp.asarray(
            rng.integers(0, idx.seq_len, B).astype(np.int64).astype(dfm.idt)
        )
        occ4_jit(ks)  # warm/compile

        def step(prev, ks=ks, B=B):
            if prev is None:
                return occ4_jit(ks)
            # rotate by the previous answer so chained executions cannot
            # be CSE'd, but stay batch-independent WITHIN each execution
            return occ4_jit((ks + prev[0, 0].astype(dfm.idt)) % idx.seq_len)

        dt = timed(step)
        print(f"bandwidth  B={B:>8,}: {dt * 1e3:8.2f} ms/exec  "
              f"{B / dt / 1e6:9.1f} M rank-queries/s")

    # --- latency: sequentially dependent while-loop steps ---------------
    def chain_loop(ks, n_steps):
        def body(c):
            i, k = c
            o = occ4_device(dfm, k)
            nk = (k + o[:, 0].astype(dfm.idt) + 1) % idx.seq_len
            return i + 1, nk

        return jax.lax.while_loop(
            lambda c: c[0] < n_steps, body, (jnp.int32(0), ks)
        )[1]

    for B in (256, 4096):
        ks = jnp.asarray(
            rng.integers(0, idx.seq_len, B).astype(np.int64).astype(dfm.idt)
        )
        for n_steps in (64, 256):
            f = jax.jit(lambda k, n=n_steps: chain_loop(k, n))
            f(ks)  # warm

            def step(prev, ks=ks, f=f):
                return f(ks if prev is None else prev)

            dt = timed(step)
            per_step = dt / n_steps
            print(f"latency    B={B:>5}, steps={n_steps:>3}: "
                  f"{per_step * 1e6:8.1f} us/step  "
                  f"{B / per_step / 1e6:9.2f} M dependent-queries/s")


if __name__ == "__main__":
    main()
