"""Multi-host data-parallel execution.

The reference is strictly single-node (goroutines + channels, SURVEY.md 5
"Distributed communication backend: none").  This build's scale-out:

  * ``jax.distributed.initialize`` forms the process group, one process
    per card: a JAX process reserves most of a card's memory when it
    starts, so processes never share one;
  * the barcode-sorted stream is work-partitioned round-robin by
    superbatch: process ``i`` handles superbatches where
    ``batch_index % num_processes == i`` — no communication needed on the
    input side because barcodes are independent work units;
  * each host writes its own output shards (mirroring the reference's
    sharded BAMs — no output collective needed);
  * run statistics merge at the end with a psum over a trivial mesh;
  * failure handling: a host that dies simply leaves its residue of
    superbatches unprocessed; the per-host checkpoint manifest
    (runtime/checkpoint.py) records exactly which, so a re-run with the
    same topology resumes only the missing work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class DistContext:
    process_index: int = 0
    process_count: int = 1
    initialized: bool = False


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistContext:
    """Initialize the process group (no-op for single-process runs).

    MUST run before the first jax backend touch (jax.devices / any array
    op) — jax.distributed.initialize silently degrades to a single-process
    view once a backend is live.  Each process is pinned to one card
    (``local_device_ids``; see local_card).  CPU multi-process collectives
    go through Gloo (jax>=0.9 default), which the 2-process integration
    test (tests/test_distributed.py) exercises."""
    if coordinator is None:
        coordinator = os.environ.get("ARACHNE_COORDINATOR")
    if coordinator is None:
        return DistContext()
    card = local_card(process_id)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=None if card is None else [card],
    )
    return DistContext(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        initialized=True,
    )


def local_card(process_id: Optional[int]) -> Optional[int]:
    """The card this process drives: processes are numbered consecutively
    on each host, one per card, so process i takes card i mod (cards on
    the host).  None where there is no card to pin (a CPU run)."""
    if process_id is None or os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return None
    cards = gpus_on_host()
    return process_id % cards if cards else None


def gpus_on_host() -> int:
    """Cards visible to this process, counted without starting a JAX
    backend: CUDA_VISIBLE_DEVICES when set, else nvidia-smi's list."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    import subprocess

    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return 0
    return len(p.stdout.split()) if p.returncode == 0 else 0


def partition_work(items: Iterator, ctx: DistContext) -> Iterator:
    """Round-robin assignment of independent work items to this process.

    The production barcode-stream partition lives in
    runtime.checkpoint.CheckpointedStream (same i %% P == p rule, fused
    with resume skipping); this helper serves ad-hoc callers."""
    for i, item in enumerate(items):
        if i % ctx.process_count == ctx.process_index:
            yield item


def _with_timeout(fn, timeout_s: float, what: str):
    """Run fn() on a daemon thread; None if it does not finish in time.

    The end-of-run collectives block forever if a peer died mid-run
    (gloo has no failure detector); a bounded wait lets the survivors
    finish their own shards, report local stats, and exit cleanly so a
    re-run with the surviving topology (claim-based manifests accept any
    process count) picks up the dead host's residue."""
    import threading

    box = []

    def run():
        try:
            box.append(fn())
        except Exception as e:  # noqa: BLE001 - surfaced as a warning
            box.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if not box or isinstance(box[0], Exception):
        detail = f": {box[0]}" if box else " (timeout)"
        print(
            f"WARNING: {what} did not complete{detail} — a peer process "
            f"likely died; continuing with local values. Re-run with the "
            f"surviving process count to finish its share.",
            flush=True,
        )
        return None
    return box[0]


def allreduce_stats(values: np.ndarray, ctx: DistContext) -> np.ndarray:
    """Sum an int64 stats vector across all hosts (psum over the global
    mesh); identity for single-process runs.  Falls back to the local
    vector (with a loud warning) if the collective cannot complete
    because a peer died."""
    if not ctx.initialized or ctx.process_count == 1:
        return values
    from jax.experimental.multihost_utils import process_allgather

    timeout = float(os.environ.get("ARACHNE_COLLECTIVE_TIMEOUT", 120))
    out = _with_timeout(
        lambda: np.asarray(process_allgather(jnp.asarray(values))).sum(axis=0),
        timeout,
        "final stats allreduce",
    )
    return values if out is None else out


def allreduce_max_int(value: int, ctx: DistContext) -> int:
    """Max of an int across all hosts; identity for single-process runs.

    Used to agree on the checkpoint generation before any manifest is
    written: a slow host's glob could otherwise see a fast peer's fresh
    manifest and compute generation max+1, mis-keying its claims."""
    if not ctx.initialized or ctx.process_count == 1:
        return value
    from jax.experimental.multihost_utils import process_allgather

    timeout = float(os.environ.get("ARACHNE_COLLECTIVE_TIMEOUT", 120))
    out = _with_timeout(
        lambda: int(np.asarray(process_allgather(jnp.asarray(np.int64(value)))).max()),
        timeout,
        "checkpoint generation agreement",
    )
    if out is None:
        # unlike the end-of-run stats merge, generation agreement CANNOT
        # fall back to local values (the fleet would split across
        # generations); nothing has been written yet, so abort cleanly
        raise RuntimeError(
            "generation agreement collective failed — a peer process died "
            "during startup; relaunch the fleet"
        )
    return out


def assert_uniform_int(value: int, ctx: DistContext, what: str) -> None:
    """Fail loudly unless every host reports the same value.

    Used for checkpoint claim-digest agreement: each resuming host globs
    sibling manifests independently, so shared-filesystem visibility lag
    (NFS attribute caching) or a host that saved to a non-shared path can
    leave one host missing a peer's claims — it would silently re-run that
    peer's completed sets and the merged output would carry duplicates.
    Nothing has been written at agreement time, so aborting is safe."""
    if not ctx.initialized or ctx.process_count == 1:
        return
    from jax.experimental.multihost_utils import process_allgather

    timeout = float(os.environ.get("ARACHNE_COLLECTIVE_TIMEOUT", 120))
    out = _with_timeout(
        lambda: np.asarray(process_allgather(jnp.asarray(np.int64(value)))),
        timeout,
        f"{what} agreement",
    )
    if out is None:
        raise RuntimeError(
            f"{what} agreement collective failed — a peer process died "
            "during startup; relaunch the fleet"
        )
    if not (out == out[0]).all():
        raise RuntimeError(
            f"hosts disagree on {what} ({out.tolist()}): a resuming host "
            "cannot see every sibling manifest (shared-filesystem lag or a "
            "manifest saved to a non-shared path). Re-check the checkpoint "
            "path is on a shared filesystem and relaunch; resuming now "
            "would re-run another host's completed sets as duplicates."
        )


def shard_suffix(ctx: DistContext) -> str:
    """Per-host output shard suffix (empty for single-host runs)."""
    if ctx.process_count == 1:
        return ""
    return f".host{ctx.process_index:03d}"
