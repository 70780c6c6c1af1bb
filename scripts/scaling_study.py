"""Multi-device scaling study: the production e2e over an N-device mesh.

The reference's only scaling mechanism is worker threads on one host
(aligner.go:335-336, main.go:40); ours is (a) in-process chunk-level data
parallelism over local devices (ops/devicepool.py) and (b) process-per-
chip with claim-partitioned barcode streams (parallel/distributed.py).
This script measures (a) on the virtual CPU mesh at n_devices in
{1,2,4,8} — the only multi-"chip" topology available in this environment
(XLA_FLAGS=--xla_force_host_platform_device_count) — plus (b) at 2
processes, records pairs/s + stage timers, and byte-compares every run's
output against the 1-device baseline.

Honest-measurement caveat printed with the results: virtual CPU devices
all share this host's physical cores (2 here), so total COMPUTE does not
grow with n_devices — the curve measures orchestration overhead and
host-stage serialization, not chip scaling; the per-stage timers are the
attribution.  See BASELINE.md "Multi-device scaling" for the model this
feeds.

Usage: python scripts/scaling_study.py [--pairs 20000] [--threads 2]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_fixture(cache: str, n_pairs: int):
    """2 Mbp genome + n_pairs simulated pairs (bench-fixture shaped)."""
    import numpy as np

    os.makedirs(cache, exist_ok=True)
    ref = os.path.join(cache, "scale_ref.fa")
    r1 = os.path.join(cache, f"scale_{n_pairs}.R1.fq.gz")
    r2 = os.path.join(cache, f"scale_{n_pairs}.R2.fq.gz")
    if not os.path.exists(ref):
        rng = np.random.default_rng(20260820)
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 2_000_000))
        with open(ref, "w") as fh:
            fh.write(">chr_bench\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i : i + 70] + "\n")
    if not os.path.exists(ref + ".arx.npz"):
        from arachne_tpu.index import build_index_files

        build_index_files(ref)
    if not (os.path.exists(r1) and os.path.exists(r2)):
        from arachne_tpu.index import parse_fasta
        from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads

        n_barcodes = max(10, n_pairs // 60)
        simulate_linked_reads(
            parse_fasta(ref), r1, r2,
            SimConfig(
                n_barcodes=n_barcodes, molecules_per_barcode=3,
                pairs_per_molecule=max(1, n_pairs // n_barcodes // 3),
                seed=7,
            ),
        )
    return ref, r1, r2


def run_once(ref, r1, r2, n_devices, threads, extra_env=None, extra_args=None):
    """One production e2e in a subprocess on an n_devices CPU mesh."""
    out = tempfile.mkdtemp(prefix=f"scale_n{n_devices}_")
    stats_path = os.path.join(out, "stats.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_devices} "
        + env.get("XLA_FLAGS", "")
    ).strip()
    env.setdefault("ARACHNE_DEVICE_DP", "auto")
    # host-side seeding, the production default
    env.setdefault("ARACHNE_DEVICE_SEEDING", "0")
    env.update(extra_env or {})
    argv = [
        "align", "--sam", "--engine", "tpu", "-t", str(threads),
        "--stats-json", stats_path, out, ref, r1, r2,
    ] + (extra_args or [])
    # force the host platform through the config API before any jax
    # use, exactly as tests/conftest.py does, and ASSERT the mesh size
    # inside the run
    prog = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
        f"assert len(jax.devices()) == {n_devices}, jax.devices(); "
        "from arachne_tpu.cli import main; main(sys.argv[1:])"
    )
    cmd = [sys.executable, "-c", prog] + argv
    t0 = time.time()
    res = subprocess.run(cmd, env=env, capture_output=True, text=True)
    wall = time.time() - t0
    if res.returncode != 0:
        print(res.stdout[-2000:], res.stderr[-2000:])
        raise SystemExit(f"run failed at n_devices={n_devices}")
    with open(stats_path) as fh:
        stats = json.load(fh)
    sam = os.path.join(out, "bc_sorted_bam.sam")
    return {
        "out_dir": out,
        "sam": sam,
        "wall_s": wall,
        "pairs": stats["reads"],
        "elapsed_s": stats["elapsed_s"],
        "pairs_per_sec": stats["reads"] / max(stats["elapsed_s"], 1e-9),
        "stage_times": {
            k: round(v["seconds"], 3)
            for k, v in stats.get("stage_times", {}).items()
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=20_000)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--devices", default="1,2,4,8")
    args = ap.parse_args()
    cache = os.path.expanduser("~/.cache/arachne_bench")
    ref, r1, r2 = make_fixture(cache, args.pairs)

    results = {}
    baseline_sam = None
    for n in [int(x) for x in args.devices.split(",")]:
        r = run_once(ref, r1, r2, n, args.threads)
        if baseline_sam is None:
            baseline_sam = r["sam"]
            identical = True
        else:
            identical = (
                open(baseline_sam, "rb").read() == open(r["sam"], "rb").read()
            )
        r["identical_to_1dev"] = identical
        results[n] = r
        print(
            f"n_devices={n}: {r['pairs_per_sec']:.1f} pairs/s "
            f"({r['pairs']} pairs, {r['elapsed_s']:.2f}s align, "
            f"{r['wall_s']:.1f}s wall) identical={identical}",
            flush=True,
        )
        print(f"  stages: {r['stage_times']}", flush=True)

    base = results[min(results)]["pairs_per_sec"]
    print("\n--- scaling curve (vs 1 device) ---")
    for n, r in sorted(results.items()):
        print(f"  {n} dev: {r['pairs_per_sec'] / base:.2f}x")
    print(
        "\nCaveat: virtual CPU devices share this host's physical cores "
        f"({os.cpu_count()}); the curve bounds orchestration overhead, "
        "not chip compute scaling."
    )
    with open(os.path.join(cache, "scaling_study.json"), "w") as fh:
        json.dump(
            {str(k): {kk: vv for kk, vv in v.items() if kk != "out_dir"}
             for k, v in results.items()},
            fh, indent=2,
        )


if __name__ == "__main__":
    main()
