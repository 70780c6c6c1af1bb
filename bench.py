"""Benchmarks on one NVIDIA GPU: kernel GCUPS + end-to-end aligner throughput.

Prints one JSON line per metric ({"metric", "value", "unit",
"vs_baseline"}); the LAST line is the headline product metric —
**end-to-end pairs/s/card** on a BASELINE-config-2-shaped run
(simulate -> index -> full barcode-joint RFA align with the device engine),
with a per-stage wall-time breakdown in "detail".  No GPU baseline has been
recorded yet, so its vs_baseline is null.

The first line is DP GCUPS (banded Smith-Waterman extension cell updates
per second) of the batched extension kernel — the hot inner loop (SURVEY.md
3.5; the reference's equivalent is single-thread SSE2 ksw_extend2/ksw_u8
at ~1 GCUPS); its vs_baseline compares against this repo's exact scalar
oracle measured on the same host, cell-for-cell on the same problem set.

Timing: each kernel call ends in jax.block_until_ready; the median of 30
calls after warm-up.  The end-to-end runs compile in an explicit warmup
(TpuEngine.warmup) before their timer starts.  Off a GPU the script exits
non-zero: its numbers are device numbers.  Fixtures are cached in
.bench_cache/ inside the checkout.

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, ".bench_cache")

from arachne_tpu.align import ksw
from arachne_tpu.cli import enable_compilation_cache
from arachne_tpu.config import MemOptions

enable_compilation_cache()
from arachne_tpu.ops.sw_extend import _extend_stacked, clamp_band

import jax
import jax.numpy as jnp


def make_problems(rng, B, qlen, tlen):
    ts = rng.integers(0, 4, (B, tlen)).astype(np.int8)
    qs = np.full((B, qlen), 4, np.int8)
    for i in range(B):
        q = ts[i, 40 : 40 + qlen].copy()
        nmut = rng.integers(0, 6)
        idxs = rng.integers(0, qlen, nmut)
        q[idxs] = (q[idxs] + 1) % 4
        qs[i] = q
    return qs, ts


def timed(fn, runs=30):
    """Median seconds of fn() over `runs` calls, each waited for with
    block_until_ready, after two warm-up calls (compile + first run)."""
    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card():
    """The card as JAX and nvidia-smi report it (name, power limit)."""
    dev = jax.devices()[0]
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": p.stdout.strip().splitlines()[0],
    }


def _bench_fixture(cache: str):
    """2 Mbp reference + 320-barcode/19,200-pair simulated linked reads,
    cached across bench runs (the index build is deterministic).

    19,200 pairs keep a run long enough that fixed costs stay a small
    share of the timed window."""
    import gzip
    import os

    os.makedirs(cache, exist_ok=True)
    ref = os.path.join(cache, "bench_ref.fa")
    r1 = os.path.join(cache, "bench20k.R1.fq.gz")
    r2 = os.path.join(cache, "bench20k.R2.fq.gz")
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

        simulate_linked_reads(
            parse_fasta(ref), r1, r2,
            SimConfig(
                n_barcodes=320, molecules_per_barcode=3, pairs_per_molecule=20,
                seed=7,
            ),
        )
    return ref, r1, r2


def _repeat_fixture(cache: str):
    """3 Mbp repeat-planted genome + skewed linked-read library: 10 repeat
    families (20 x 1 kb copies at 95% identity) drive max_occ seed
    subsampling / frac_rep / chain filtering (bwamem.c:265-315), and the
    barcode sizes are lognormal-skewed with one 30k-read (15k-pair)
    barcode and every-17th barcode invalid (VX:i:0) — the hard paths RFA
    exists for."""
    import os

    os.makedirs(cache, exist_ok=True)
    ref = os.path.join(cache, "repeat_ref.fa")
    r1 = os.path.join(cache, "repeat.R1.fq.gz")
    r2 = os.path.join(cache, "repeat.R2.fq.gz")
    if not os.path.exists(ref):
        from arachne_tpu.io.simulate import make_repeat_genome

        seq = make_repeat_genome(
            3_000_000, n_families=10, copies=20, unit_len=1000,
            identity=0.95, seed=20260821,
        )
        with open(ref, "w") as fh:
            fh.write(">chr_repeat\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i : i + 70] + "\n")
    if not os.path.exists(ref + ".arx.npz"):
        from arachne_tpu.index import build_index_files

        build_index_files(ref)
    if not (os.path.exists(r1) and os.path.exists(r2)):
        from arachne_tpu.index import parse_fasta
        from arachne_tpu.io.simulate import (
            SimConfig, simulate_linked_reads, skewed_pair_counts,
        )

        rng = np.random.default_rng(11)
        counts = skewed_pair_counts(
            rng, 150, mean_pairs=30, sigma=1.2, big_barcode_pairs=15_000
        )
        simulate_linked_reads(
            parse_fasta(ref), r1, r2,
            SimConfig(
                n_barcodes=150, pair_counts=counts, pairs_per_molecule=25,
                invalid_every=17, seed=9,
            ),
        )
    return ref, r1, r2


def bench_indel_e2e():
    """Gapped-path run: the bench fixture simulated WITH sequencing indels
    (10% of reads), so the traceback path (ops/sw_global) runs on the card
    in every bench."""
    import argparse
    import gzip
    import os
    import shutil
    import tempfile

    from arachne_tpu.cli import run_align
    from arachne_tpu.runtime.accuracy import evaluate_sam

    cache = CACHE
    os.makedirs(cache, exist_ok=True)
    ref = os.path.join(cache, "bench_ref.fa")   # shares the e2e genome
    r1 = os.path.join(cache, "bench_indel20k.R1.fq.gz")
    r2 = os.path.join(cache, "bench_indel20k.R2.fq.gz")
    if not os.path.exists(ref):
        _bench_fixture(cache)
    if not os.path.exists(r1):
        from arachne_tpu.index import parse_fasta
        from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads

        simulate_linked_reads(
            parse_fasta(ref), r1, r2,
            SimConfig(n_barcodes=320, molecules_per_barcode=3,
                      pairs_per_molecule=20, indel_rate=0.1, vary_quals=True,
                      seed=2),
        )
    from arachne_tpu.runtime.timers import TIMERS

    TIMERS.reset()
    out = tempfile.mkdtemp(prefix="arachne_bench_indel_")
    try:
        args = argparse.Namespace(
            centromeres="", improper_pair_penalty=-4.0, partitions=40_000_000,
            read_group="sample:library:molecule:flowcell:lane",
            sample_id="sample", threads=2, sam=True, debug_tags=False,
            engine="tpu", checkpoint="", stats_json="", profile_dir="",
            output=out, reference=ref, r1=r1, r2=r2,
        )
        stats = run_align(args)
        acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
        import re as _re

        gapped = 0
        with open(os.path.join(out, "bc_sorted_bam.sam")) as fh:
            for line in fh:
                if not line.startswith("@") and _re.search(
                    r"\d+[ID]", line.split("\t")[5]
                ):
                    gapped += 1
    finally:
        shutil.rmtree(out, ignore_errors=True)
    pps = stats.reads / max(stats.elapsed, 1e-9)
    overall = acc.correct / max(acc.total, 1)
    stage = TIMERS.as_dict()
    stage.pop("warmup", None)
    return {
        "metric": "indel_e2e_pairs_per_sec",
        "value": round(pps, 1),
        "unit": "pairs/s/card",
        "vs_baseline": round(overall, 4),
        "detail": {
            "pairs": stats.reads,
            "accuracy_overall": round(overall, 4),
            "gapped_records": gapped,
            "stage_seconds": {k: round(v["seconds"], 3) for k, v in stage.items()},
            "fixture": "2 Mbp genome, 19200 pairs, indel_rate 0.1 (device "
                       "traceback path)",
        },
    }


def bench_repeat_genome():
    """Hard-path run: repeat genome + skewed/invalid barcodes, with
    accuracy from the truth-encoding read names.  One full run (the main
    e2e metric already covers steady-state variance)."""
    import argparse
    import os
    import shutil
    import tempfile

    from arachne_tpu.cli import run_align
    from arachne_tpu.runtime.accuracy import evaluate_sam
    from arachne_tpu.runtime.timers import TIMERS

    cache = CACHE
    ref, r1, r2 = _repeat_fixture(cache)
    out = tempfile.mkdtemp(prefix="arachne_bench_rep_")
    TIMERS.reset()
    try:
        args = argparse.Namespace(
            centromeres="", improper_pair_penalty=-4.0, partitions=40_000_000,
            read_group="sample:library:molecule:flowcell:lane",
            sample_id="sample", threads=2, sam=True, debug_tags=False,
            engine="tpu", checkpoint="", stats_json="", profile_dir="",
            output=out, reference=ref, r1=r1, r2=r2,
        )
        stats = run_align(args)
        acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    pps = stats.reads / max(stats.elapsed, 1e-9)
    overall = acc.correct / max(acc.total, 1)
    return {
        "metric": "repeat_genome_pairs_per_sec",
        "value": round(pps, 1),
        "unit": "pairs/s/card",
        "vs_baseline": round(overall, 4),
        "detail": {
            "pairs": stats.reads,
            "barcodes": stats.barcodes,
            "elapsed_s": round(stats.elapsed, 2),
            "accuracy_overall": round(overall, 4),
            "accuracy_csv": acc.as_csv().splitlines(),
            "fixture": "3Mbp/10 repeat families x20 copies @95% id; "
                       "150 skewed barcodes + one 15k-pair + VX:i:0 every 17th",
        },
    }


def _hard_fixture(cache: str):
    """Realistic-noise calibration fixture: 3 Mbp genome with
    high-identity repeat families (8 x 15 x 2 kb at 99.9%) + reads at 1%
    substitutions, 10% indel reads, varied quals, skewed barcodes with
    invalid ones — hard enough that accuracy is meaningfully < 1.0 and
    the low-MAPQ tail is populated, so MAPQ calibration (and regressions
    in it) are visible."""
    import os

    os.makedirs(cache, exist_ok=True)
    ref = os.path.join(cache, "hard_ref.fa")
    r1 = os.path.join(cache, "hard.R1.fq.gz")
    r2 = os.path.join(cache, "hard.R2.fq.gz")
    if not os.path.exists(ref):
        from arachne_tpu.io.simulate import make_repeat_genome

        seq = make_repeat_genome(
            3_000_000, n_families=8, copies=15, unit_len=2000,
            identity=0.999, seed=20260821,
        )
        with open(ref, "w") as fh:
            fh.write(">chr_hard\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i : i + 70] + "\n")
    if not os.path.exists(ref + ".arx.npz"):
        from arachne_tpu.index import build_index_files

        build_index_files(ref)
    if not (os.path.exists(r1) and os.path.exists(r2)):
        from arachne_tpu.index import parse_fasta
        from arachne_tpu.io.simulate import (
            SimConfig, simulate_linked_reads, skewed_pair_counts,
        )

        rng = np.random.default_rng(23)
        counts = skewed_pair_counts(rng, 120, mean_pairs=40, sigma=1.1)
        simulate_linked_reads(
            parse_fasta(ref), r1, r2,
            SimConfig(
                n_barcodes=120, pair_counts=counts, pairs_per_molecule=25,
                error_rate=0.01, indel_rate=0.1, vary_quals=True,
                invalid_every=19, seed=31,
            ),
        )
    return ref, r1, r2


def bench_mapq_calibration():
    """MAPQ calibration on realistic noise: empirical error vs the error
    each reported q claims (10^(-q/10)), per MAPQ bin.  value = expected
    calibration error (record-weighted |empirical - claimed|, lower
    better); vs_baseline = overall accuracy (expected < 1.0 on this
    fixture, so placement regressions surface here too).  The living
    mapq.csv the reference's RFAStats vestige intended
    (aligner.go:217-229)."""
    import argparse
    import os
    import shutil
    import tempfile

    from arachne_tpu.cli import run_align
    from arachne_tpu.runtime.accuracy import evaluate_sam

    cache = CACHE
    ref, r1, r2 = _hard_fixture(cache)
    out = tempfile.mkdtemp(prefix="arachne_bench_cal_")
    try:
        args = argparse.Namespace(
            centromeres="", improper_pair_penalty=-4.0, partitions=40_000_000,
            read_group="sample:library:molecule:flowcell:lane",
            sample_id="sample", threads=2, sam=True, debug_tags=False,
            engine="tpu", checkpoint="", stats_json="", profile_dir="",
            output=out, reference=ref, r1=r1, r2=r2,
        )
        stats = run_align(args)
        acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    overall = acc.correct / max(acc.total, 1)
    return {
        "metric": "mapq_expected_calibration_error",
        "value": round(acc.expected_calibration_error(), 5),
        "unit": "|empirical-claimed| err, record-weighted",
        "vs_baseline": round(overall, 4),
        "detail": {
            "pairs": stats.reads,
            "pairs_per_sec": round(stats.reads / max(stats.elapsed, 1e-9), 1),
            "accuracy_overall": round(overall, 4),
            "calibration": acc.calibration_rows(),
            "fixture": "3 Mbp, 8x15x2kb repeats @99.9% id; 1% subs + 10% "
                       "indel reads + varied quals; 120 skewed barcodes",
        },
    }


def bench_end_to_end(trials: int = 3):
    """Full-pipeline pairs/s with the device engine; returns the JSON record.

    Best-of-N full runs (min elapsed), with every trial's pairs/s kept in
    the record."""
    import argparse
    import os
    import shutil
    import tempfile

    from arachne_tpu.cli import run_align
    from arachne_tpu.runtime.timers import TIMERS

    cache = CACHE
    ref, r1, r2 = _bench_fixture(cache)
    best = None          # (elapsed, stats, stage_dict, warm)
    all_pps = []
    for _trial in range(trials):
        out = tempfile.mkdtemp(prefix="arachne_bench_out_")
        TIMERS.reset()
        try:
            args = argparse.Namespace(
                centromeres="", improper_pair_penalty=-4.0, partitions=40_000_000,
                read_group="sample:library:molecule:flowcell:lane",
                sample_id="sample", threads=2, sam=True, debug_tags=False,
                engine="tpu", checkpoint="", stats_json="", profile_dir="",
                output=out, reference=ref, r1=r1, r2=r2,
            )
            stats = run_align(args)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        stage = TIMERS.as_dict()
        warm = stage.pop("warmup", {"seconds": 0.0})["seconds"]
        all_pps.append(round(stats.reads / max(stats.elapsed, 1e-9), 1))
        if best is None or stats.elapsed < best[0]:
            best = (stats.elapsed, stats, stage, warm)
    elapsed, stats, stage, warm = best
    pps = stats.reads / max(elapsed, 1e-9)
    return {
        "metric": "end_to_end_pairs_per_sec",
        "value": round(pps, 1),
        "unit": "pairs/s/card",
        "vs_baseline": None,
        "detail": {
            "pairs": stats.reads,
            "barcodes": stats.barcodes,
            "elapsed_s": round(elapsed, 2),
            "trial_pairs_per_sec": all_pps,
            "warmup_s_excluded": round(warm, 2),
            "engine": "tpu",
            "device": card(),
            "stage_seconds": {k: v["seconds"] for k, v in stage.items()},
        },
    }


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the card; JAX's device is "
                 f"{jax.devices()[0].platform}")
    device = card()
    B, qlen, tlen = 4096, 100, 250
    opt = MemOptions()
    rng = np.random.default_rng(0)
    qs, ts = make_problems(rng, B, qlen, tlen)
    w = clamp_band(opt, qlen, opt.w, opt.pen_clip5, 1)
    meta = np.stack([np.full(B, v, np.int32) for v in (qlen, tlen, w, 19)])
    mat = jnp.asarray(opt.scoring_matrix(), jnp.int32)
    args = (jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(meta), mat)
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
              zdrop=opt.zdrop)
    dt = timed(lambda: _extend_stacked(*args, qmax=qlen, tmax=tlen, **kw))

    # in-band cells per problem (what the scalar kernel computes)
    cells_per = 0
    for i in range(tlen):
        beg = max(0, i - w)
        end = min(qlen, i + w + 1)
        cells_per += max(0, end - beg)
    total_cells = cells_per * B
    gcups = total_cells / dt / 1e9

    # scalar-oracle baseline on a sample of the same problems
    n_base = 32
    t0 = time.perf_counter()
    for i in range(n_base):
        ksw.extend2(
            qs[i].astype(np.uint8), ts[i].astype(np.uint8), opt.scoring_matrix(),
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w, opt.pen_clip5,
            opt.zdrop, 19,
        )
    base_dt = (time.perf_counter() - t0) / n_base
    base_gcups = cells_per / base_dt / 1e9

    result = {
        "metric": "seed_extension_DP_GCUPS",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / base_gcups, 1),
        "detail": {
            "batch": B,
            "qlen": qlen,
            "tlen": tlen,
            "band": w,
            "kernel": "xla",
            "device": device,
            "batch_ms": round(dt * 1e3, 3),
            "baseline_gcups_scalar_oracle": round(base_gcups, 4),
        },
    }
    print(json.dumps(result), flush=True)

    # hard-path run: repeat genome + skewed/invalid barcodes + accuracy
    rep = bench_repeat_genome()
    print(json.dumps(rep), flush=True)

    # gapped-path run: indels through the device traceback
    ind = bench_indel_e2e()
    print(json.dumps(ind), flush=True)

    # MAPQ calibration on realistic noise (accuracy intentionally < 1.0)
    cal = bench_mapq_calibration()
    print(json.dumps(cal), flush=True)

    # headline product metric LAST (the driver parses the final JSON line)
    e2e = bench_end_to_end()
    e2e["detail"]["kernel_gcups"] = result["value"]
    e2e["detail"]["repeat_genome"] = {
        "pairs_per_sec": rep["value"],
        "accuracy": rep["detail"]["accuracy_overall"],
    }
    e2e["detail"]["indel_e2e"] = {
        "pairs_per_sec": ind["value"],
        "accuracy": ind["detail"]["accuracy_overall"],
        "gapped_records": ind["detail"]["gapped_records"],
    }
    e2e["detail"]["mapq_calibration"] = {
        "expected_calibration_error": cal["value"],
        "accuracy": cal["detail"]["accuracy_overall"],
    }
    print(json.dumps(e2e), flush=True)


if __name__ == "__main__":
    main()
