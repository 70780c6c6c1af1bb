#!/usr/bin/env python3
"""Smoke test: the aligner's main path on one NVIDIA GPU, end to end.

    python chip_smoke.py                one card: every phase below
    python chip_smoke.py --four-cards   four cards: the multi-card paths only

Phases, in order; the first failure exits non-zero and prints no result:

  device    JAX's first device is a GPU; the native host library builds
            and loads (no fallback).
  kernels   each DP batcher at production shapes on the card against the
            scalar oracle (align/ksw.py) on >= 64 problems and against the
            same XLA program on the host backend on a whole chunk, with N
            bases, narrow bands, z-drop exits and a non-default scoring
            matrix.  All DP state is int32, so equality is exact.  Also
            times the extension kernel (median of 30 runs after warm-up).
  mainpath  a 64 Mbp genome (scripts/make_scale_genome.py, ROADMAP config-3
            shape), 24,000 simulated 2x150 bp pairs with indels, `cli
            index`, `cli align --engine tpu --sam --stats-json`, `cli
            evaluate`: accuracy >= 0.99, every pair emitted, all three
            batchers ran.  The same input is aligned again (warm), and twice
            with the other traceback walk, so both walks are timed.
  identity  the first 2,040 pairs (whole barcodes) aligned on the card,
            with --engine oracle, and with device seeding: byte-identical.

With --four-cards (needs four GPUs): (a) the in-process round-robin over
four cards against one card, (b) --index-mode sharded with device seeding
against host seeding, (c) four processes, one per card, through
--coordinator, whose shards together equal the one-process records.

The fixtures and their indexes are cached in .smoke_cache/ (gitignored),
so a second run skips the build.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")

# ROADMAP config-3 shape: one 64 Mbp chromosome-scale contig
GENOME = dict(contigs=1, contig_len=64_000_000, seed=7)
# 400 barcodes x 3 molecules x 20 pairs = 24,000 pairs of 2x150 bp
READS = dict(barcodes=400, molecules=3, pairs=20, indel_rate=0.05, seed=11)
SUBSET_BARCODES = 34            # 34 x 60 = 2,040 pairs
# parity batch sizes: one production chunk of each batcher
EXT_B, LOCAL_B, GLOBAL_B = 4096, 1024, 1024
TIMING_RUNS = 30
FOUR_CARD_GENOME = dict(contigs=1, contig_len=8_000_000, seed=5)
FOUR_CARD_READS = dict(barcodes=80, molecules=3, pairs=20, indel_rate=0.05, seed=3)


T0 = time.time()


class SmokeFailure(Exception):
    pass


def say(msg):
    """A progress line, stamped with the seconds since the smoke started."""
    print(f"{time.time() - T0:7.1f}s {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------------
# processes
# ----------------------------------------------------------------------

def cpu_env():
    """Environment of a child that must never take the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return env


def run(cmd, env=None, log=None, timeout=1100):
    """Run a child to completion; raise with its output tail on failure."""
    t0 = time.time()
    p = subprocess.run(
        cmd, cwd=REPO, env=env or dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=timeout,
    )
    if log:
        with open(log, "w") as fh:
            fh.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode != 0:
        raise SmokeFailure(
            f"{' '.join(cmd[:6])} ... exited {p.returncode} after "
            f"{time.time() - t0:.1f} s\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
        )
    return p


def cli(*args, env=None, log=None):
    return run([sys.executable, "-m", "arachne_tpu.cli", *args], env=env, log=log)


def phase_child(name, work):
    """Run one phase in a child process; returns its JSON report."""
    out = os.path.join(work, f"{name}.json")
    if os.path.exists(out):
        os.remove(out)
    run([sys.executable, os.path.abspath(__file__), "--phase", name,
         "--work", work], log=os.path.join(work, f"{name}.log"))
    with open(out) as fh:
        return json.load(fh)


def write_report(work, name, report):
    with open(os.path.join(work, f"{name}.json"), "w") as fh:
        json.dump(report, fh, indent=1)


# ----------------------------------------------------------------------
# fixtures (host only; children run with JAX_PLATFORMS=cpu)
# ----------------------------------------------------------------------

def build_fixture(tag, genome, reads):
    """Genome, index, reads and the identity subset, cached by parameters."""
    d = os.path.join(CACHE, tag)
    os.makedirs(d, exist_ok=True)
    stamp = os.path.join(d, "fixture.json")
    want = {"genome": genome, "reads": reads, "subset": SUBSET_BARCODES}
    f = {
        "ref": os.path.join(d, "ref.fa"),
        "r1": os.path.join(d, "r1.fq.gz"), "r2": os.path.join(d, "r2.fq.gz"),
        "s1": os.path.join(d, "s1.fq.gz"), "s2": os.path.join(d, "s2.fq.gz"),
    }
    if os.path.exists(stamp):
        with open(stamp) as fh:
            have = json.load(fh)
        if have.get("params") == want:
            f["pairs"], f["subset_pairs"] = have["pairs"], have["subset_pairs"]
            f["setup_s"] = 0.0
            return f
    t0 = time.time()
    env = cpu_env()
    run([sys.executable, "scripts/make_scale_genome.py", f["ref"],
         "--contigs", str(genome["contigs"]),
         "--contig-len", str(genome["contig_len"]), "--seed", str(genome["seed"])],
        env=env)
    cli("index", f["ref"], env=env, log=os.path.join(d, "index.log"))
    cli("simulate", f["ref"], "--out-r1", f["r1"], "--out-r2", f["r2"],
        "--barcodes", str(reads["barcodes"]), "--molecules", str(reads["molecules"]),
        "--pairs", str(reads["pairs"]), "--indel-rate", str(reads["indel_rate"]),
        "--vary-quals", "--seed", str(reads["seed"]), env=env)
    f["pairs"] = count_pairs(f["r1"])
    f["subset_pairs"] = take_barcodes(f, SUBSET_BARCODES)
    with open(stamp, "w") as fh:
        json.dump({"params": want, "pairs": f["pairs"],
                   "subset_pairs": f["subset_pairs"]}, fh)
    f["setup_s"] = time.time() - t0
    return f


def fastq_records(path):
    with gzip.open(path, "rt") as fh:
        while True:
            rec = [fh.readline() for _ in range(4)]
            if not rec[0]:
                return
            yield rec


def barcode_of(header):
    for field in header.rstrip("\n").split("\t"):
        if field.startswith("BX:Z:"):
            return field[5:]
    return ""


def count_pairs(r1):
    return sum(1 for _ in fastq_records(r1))


def barcode_groups(r1, r2):
    """Yield (barcode, [(rec1, rec2), ...]) for each run of one barcode."""
    group, bc = [], None
    for a, b in zip(fastq_records(r1), fastq_records(r2)):
        this = barcode_of(a[0])
        if group and this != bc:
            yield bc, group
            group = []
        bc = this
        group.append((a, b))
    if group:
        yield bc, group


def write_pairs(groups, o1, o2):
    with gzip.open(o1, "wt") as f1, gzip.open(o2, "wt") as f2:
        for _bc, group in groups:
            for a, b in group:
                f1.writelines(a)
                f2.writelines(b)
    return sum(len(g) for _bc, g in groups)


def take_barcodes(f, n_barcodes):
    """Write the first n_barcodes whole barcodes of the reads; returns pairs."""
    groups = []
    for item in barcode_groups(f["r1"], f["r2"]):
        if len(groups) == n_barcodes:
            break
        groups.append(item)
    return write_pairs(groups, f["s1"], f["s2"])


# ----------------------------------------------------------------------
# SAM checks
# ----------------------------------------------------------------------

def sam_path(out_dir):
    return os.path.join(out_dir, "bc_sorted_bam.sam")


def sam_qnames(path):
    names = set()
    with open(path) as fh:
        for line in fh:
            if not line.startswith("@"):
                names.add(line.split("\t", 1)[0])
    return names


def sam_records(paths):
    recs = []
    for p in paths:
        with open(p) as fh:
            recs += [l for l in fh if not l.startswith("@")]
    return sorted(recs)


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def oracle_sliced(f, work, n_slices):
    """--engine oracle on the identity subset, as n_slices processes over
    contiguous barcode ranges (the scalar oracle is single-threaded Python).
    Barcodes are independent work units, so the subset's bc-sorted SAM is
    the first slice's header followed by every slice's records in order;
    returns that file's path."""
    groups = list(barcode_groups(f["s1"], f["s2"]))
    bounds = [round(k * len(groups) / n_slices) for k in range(n_slices + 1)]
    procs = []
    for k in range(n_slices):
        part = groups[bounds[k]:bounds[k + 1]]
        if not part:
            continue
        d = os.path.join(work, f"oracle_{k:02d}")
        r1, r2 = d + ".r1.fq.gz", d + ".r2.fq.gz"
        write_pairs(part, r1, r2)
        log = open(d + ".log", "w")
        procs.append((d, log, subprocess.Popen(
            [sys.executable, "-m", "arachne_tpu.cli", "align", "--engine", "oracle",
             "--sam", "-t", "1", d, f["ref"], r1, r2],
            cwd=REPO, env=cpu_env(), stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for d, log, p in procs:
        try:
            if p.wait(timeout=1000) != 0:
                failed.append(d)
        finally:
            log.close()
    check(not failed, f"oracle slices failed: {failed} (see their .log files)")
    out = os.path.join(work, "subset_oracle.sam")
    with open(out, "w") as fo:
        for i, (d, _log, _p) in enumerate(procs):
            with open(sam_path(d)) as fh:
                for line in fh:
                    if i == 0 or not line.startswith("@"):
                        fo.write(line)
    return out


def same_shards(a, b):
    """Every SAM shard of run directory a equals b's, byte for byte."""
    names = sorted(n for n in os.listdir(a) if n.endswith(".sam"))
    return names == sorted(n for n in os.listdir(b) if n.endswith(".sam")) and all(
        same_bytes(os.path.join(a, n), os.path.join(b, n)) for n in names
    )


def accuracy(sam):
    p = cli("evaluate", sam, env=cpu_env())
    last = p.stdout.strip().splitlines()[-1].split(",")
    check(last[0] == "all", f"unexpected evaluate output: {p.stdout[-500:]}")
    return int(last[1]), int(last[2]), float(last[3])


# ----------------------------------------------------------------------
# phases that run on the card (each in a child process)
# ----------------------------------------------------------------------

def gpu_device():
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX's first device is {dev.platform!r}, not a GPU")
    return dev


def child_device(work):
    from arachne_tpu import native

    dev = gpu_device()
    native.require_lib()
    import jax

    write_report(work, "device", {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    })


def _mutate(rng, seq, sub_rate=0.03, n_indels=2):
    import numpy as np

    s = seq.copy()
    hit = rng.random(len(s)) < sub_rate
    s[hit] = rng.integers(0, 5, int(hit.sum()))
    s = list(s)
    for _ in range(int(rng.integers(0, n_indels + 1))):
        if len(s) < 3:
            break
        j = int(rng.integers(1, len(s) - 1))
        if rng.random() < 0.5:
            del s[j]
        else:
            s.insert(j, int(rng.integers(0, 4)))
    return np.array(s, np.uint8)


def _target(rng, n):
    import numpy as np

    t = rng.integers(0, 4, n).astype(np.uint8)
    t[rng.random(n) < 0.01] = 4          # N bases
    return t


def extension_problems(rng, n, qmax=192, tmax=512):
    """Seed-extension problems up to (qmax, tmax): related and unrelated
    (z-drop and zero-row exits), N bases, narrow and wide bands."""
    probs = []
    for i in range(n):
        tlen = int(rng.integers(1, tmax + 1))
        t = _target(rng, tlen)
        qlen = int(rng.integers(1, qmax + 1))
        if i % 4 == 3:
            q = rng.integers(0, 5, qlen).astype("uint8")
        else:
            src = t if tlen >= qlen + 4 else _target(rng, qlen + 4)
            q = _mutate(rng, src[: qlen + 2])[:qlen]
            if len(q) == 0:
                q = src[:1].copy()
        w = int(rng.integers(1, 8)) if i % 5 == 0 else int(rng.integers(8, 151))
        probs.append((q, t, w, 5, int(rng.integers(1, 200))))
    return probs


def local_problems(rng, n, qlen_max=150, tmax=768):
    """Mate-rescue windows: a read planted (mutated) in a longer window."""
    probs = []
    for i in range(n):
        tlen = int(rng.integers(20, tmax + 1))
        t = _target(rng, tlen)
        qlen = int(rng.integers(10, min(qlen_max, tlen) + 1))
        off = int(rng.integers(0, tlen - qlen + 1))
        if i % 5 == 4:
            q = rng.integers(0, 4, qlen).astype("uint8")
        else:
            q = _mutate(rng, t[off : off + qlen])
        probs.append((q, t, int(rng.integers(10, 40))))
    return probs


def global_problems(rng, n, qmax=192, tmax=320):
    """Global (CIGAR) problems: half equal-length (the score-only screen,
    some failing it), half with indels (straight to traceback)."""
    probs = []
    for i in range(n):
        tlen = int(rng.integers(8, min(qmax, tmax) + 1))
        t = _target(rng, tlen)
        if i % 2 == 0:
            q = t.copy()
            hit = rng.random(tlen) < 0.02
            q[hit] = rng.integers(0, 5, int(hit.sum()))
        else:
            q = _mutate(rng, t, sub_rate=0.02, n_indels=3)[:qmax]
        # bands as gen_cigar_prepare sets them: never below |tlen - qlen| + 3
        w_min = abs(len(t) - len(q)) + 3
        w = w_min + (int(rng.integers(0, 3)) if i % 7 == 0 else int(rng.integers(3, 98)))
        probs.append((q, t, w))
    return probs


def _median_ms(fn):
    import jax

    jax.block_until_ready(fn())                      # compile + warm-up
    jax.block_until_ready(fn())
    times = []
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e3 * times[len(times) // 2], 1e3 * times[0], 1e3 * times[-1]


def child_kernels(work):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from arachne_tpu.align import ksw
    from arachne_tpu.cli import enable_compilation_cache
    from arachne_tpu.config import MemOptions
    from arachne_tpu.ops import sw_extend
    from arachne_tpu.ops.sw_extend import BatchExtender
    from arachne_tpu.ops.sw_global import BatchGlobal
    from arachne_tpu.ops.sw_local import BatchLocalSW

    enable_compilation_cache()
    gpu_device()
    cpu = jax.devices("cpu")[0]
    report = {}
    rng = np.random.default_rng(2024)
    sample = rng.choice(EXT_B, min(96, EXT_B), replace=False)
    for label, opt in (
        ("default", MemOptions()),
        ("custom_scoring", MemOptions(a=2, b=5, o_del=5, e_del=2, o_ins=4, e_ins=2, zdrop=60)),
        ("zdrop_off", MemOptions(zdrop=0)),
    ):
        mat = opt.scoring_matrix()
        probs = extension_problems(rng, EXT_B)
        runs = []
        for device in (None, cpu):
            with jax.default_device(device or jax.devices()[0]):
                be = BatchExtender(opt)
                for p in probs:
                    be.submit(*p)
                runs.append(be.run())
        got, want = runs
        check(got == want, f"extension {label}: card != host backend on "
              f"{sum(g != w for g, w in zip(got, want))} of {EXT_B} problems")
        for i in sample:
            q, t, w, eb, h0 = probs[i]
            ref = ksw.extend2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                              w, eb, opt.zdrop, h0)
            check(got[i] == ref, f"extension {label} problem {i}: {got[i]} != ksw {ref}")
        report[f"extend_{label}"] = {"problems": EXT_B, "oracle_sample": len(sample)}

    # timing at the production shape, problems sorted by target length as
    # the batcher dispatches them
    opt = MemOptions()
    probs = extension_problems(rng, EXT_B)
    probs.sort(key=lambda p: len(p[1]))
    qs = np.full((EXT_B, 192), 4, np.int8)
    ts = np.full((EXT_B, 512), 4, np.int8)
    meta = np.zeros((4, EXT_B), np.int32)
    for i, (q, t, w, eb, h0) in enumerate(probs):
        qs[i, : len(q)] = q
        ts[i, : len(t)] = t
        meta[:, i] = (len(q), len(t), w, h0)
    args = [jnp.asarray(x) for x in (qs, ts, meta, opt.scoring_matrix().astype(np.int32))]
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
              zdrop=opt.zdrop)
    report["extend_timing"] = {
        "shape": f"{EXT_B} x 192 x 512", "runs": TIMING_RUNS,
        "xla_ms_median_min_max": _median_ms(
            lambda: sw_extend._extend_stacked(*args, qmax=192, tmax=512, **kw)
        ),
    }

    # mate rescue: the XLA formulation on the card against the same program
    # on the host backend (whole chunk) and against ksw.align2 (sample)
    opt = MemOptions()
    mat = opt.scoring_matrix()
    probs = local_problems(rng, LOCAL_B)
    runs = []
    for device in (None, cpu):
        with jax.default_device(device or jax.devices()[0]):
            b = BatchLocalSW(opt)
            for p in probs:
                b.submit(*p)
            runs.append([(r.score, r.te, r.qe, r.score2, r.te2, r.tb, r.qb)
                         for r in b.run_align2()])
    check(runs[0] == runs[1], "local SW: card != host backend")
    for i in rng.choice(LOCAL_B, min(80, LOCAL_B), replace=False):
        q, t, minsc = probs[i]
        e = ksw.align2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                       ksw.KSW_XSUBO | ksw.KSW_XSTART | minsc)
        check(runs[0][i] == (e.score, e.te, e.qe, e.score2, e.te2, e.tb, e.qb),
              f"local SW problem {i}: {runs[0][i]} != ksw")
    report["local"] = {"problems": LOCAL_B, "oracle_sample": min(80, LOCAL_B)}

    # global: score-only screen + traceback, host walk and device walk
    probs = global_problems(rng, GLOBAL_B)
    results = {}
    for walk in ("1", "0"):
        os.environ["ARACHNE_DEVICE_TB"] = walk
        for device in (None, cpu):
            with jax.default_device(device or jax.devices()[0]):
                b = BatchGlobal(opt)
                for p in probs:
                    b.submit(*p)
                results[(walk, device is None)] = b.run()
    os.environ.pop("ARACHNE_DEVICE_TB")
    base = results[("1", True)]
    for key, res in results.items():
        check(res == base, f"global {key}: differs from the card's device walk")
    gapped = 0
    for i in rng.choice(GLOBAL_B, min(80, GLOBAL_B), replace=False):
        q, t, w = probs[i]
        e = ksw.global2(q, t, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w)
        check(base[i] == e, f"global problem {i}: {base[i]} != ksw {e}")
        gapped += any(op in (1, 2) for op, _ in base[i][1])
    check(gapped > 0, "global sample has no gapped CIGAR")
    report["global"] = {"problems": GLOBAL_B, "oracle_sample": min(80, GLOBAL_B),
                        "gapped_in_sample": gapped}
    write_report(work, "kernels", report)


def _align_in_process(argv, env_overrides=None):
    """cli.main(argv) in this process, with the stage timers reset; returns
    the stats JSON it wrote."""
    from arachne_tpu import cli
    from arachne_tpu.ops import devicepool
    from arachne_tpu.runtime.timers import TIMERS

    saved_env = {k: os.environ.get(k) for k in (env_overrides or {})}
    os.environ.update(env_overrides or {})
    devicepool.reset_cache()
    TIMERS.reset()
    try:
        cli.main(argv)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        devicepool.reset_cache()
    stats_path = argv[argv.index("--stats-json") + 1]
    with open(stats_path) as fh:
        return json.load(fh)


def child_align(work):
    """All card-side align runs of the one-card smoke, in one process."""
    from arachne_tpu.ops import sw_global

    gpu_device()
    with open(os.path.join(work, "fixture.json")) as fh:
        f = json.load(fh)

    def argv(name, r1, r2, *extra):
        out = os.path.join(work, name)
        return ["align", "--engine", "tpu", "--sam", "--stats-json",
                os.path.join(work, f"{name}.stats.json"), *extra,
                out, f["ref"], r1, r2]

    report = {}
    # identity subset first: it also compiles most shapes before timing
    report["subset_dev"] = _align_in_process(argv("subset_dev", f["s1"], f["s2"]))
    report["subset_devseed"] = _align_in_process(
        argv("subset_devseed", f["s1"], f["s2"], "--index-mode", "replicated"),
        {"ARACHNE_DEVICE_SEEDING": "1"},
    )
    flip = "0" if sw_global.DEVICE_TB else "1"
    for name, env in (
        ("main", None),
        ("main_2", None),
        ("main_tb_flip", {"ARACHNE_DEVICE_TB": flip}),
        ("main_tb_flip_2", {"ARACHNE_DEVICE_TB": flip}),
    ):
        report[name] = _align_in_process(argv(name, f["r1"], f["r2"]), env)
    report["device_tb_default"] = sw_global.DEVICE_TB
    write_report(work, "align", report)


def child_pool(work):
    """--four-cards (a) and (b): one process driving all four cards."""
    import jax

    gpu_device()
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs visible, need 4")
    with open(os.path.join(work, "fixture.json")) as fh:
        f = json.load(fh)

    def argv(name, *extra):
        return ["align", "--engine", "tpu", "--sam", "--stats-json",
                os.path.join(work, f"{name}.stats.json"), *extra,
                os.path.join(work, name), f["ref"], f["r1"], f["r2"]]

    report = {
        "one_card": _align_in_process(argv("one_card"), {"ARACHNE_DEVICE_DP": "0"}),
        "four_cards": _align_in_process(argv("four_cards")),
        "sharded_devseed": _align_in_process(
            argv("sharded_devseed", "--index-mode", "sharded"),
            {"ARACHNE_DEVICE_SEEDING": "1"},
        ),
        "platform": jax.devices()[0].platform,
        "count": len(jax.devices()),
        "kind": jax.devices()[0].device_kind,
    }
    write_report(work, "pool", report)


CHILDREN = {"device": child_device, "kernels": child_kernels,
            "align": child_align, "pool": child_pool}


# ----------------------------------------------------------------------
# the parent: stays off JAX, so the card is free for one child at a time
# ----------------------------------------------------------------------

def nvidia_smi():
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi: {e}") from e
    check(p.returncode == 0 and p.stdout.strip(), f"nvidia-smi failed: {p.stderr}")
    return p.stdout.strip().splitlines()


class Background:
    """A function run on a thread; join() returns its value or re-raises."""

    def __init__(self, fn, *args):
        self.box = {}
        self.t = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.t.start()

    def _run(self, fn, args):
        try:
            self.box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            self.box["error"] = e

    def join(self):
        self.t.join()
        if "error" in self.box:
            raise self.box["error"]
        return self.box["value"]


def stage_calls(stats, prefix):
    return sum(v["calls"] for k, v in stats["stage_times"].items() if k.startswith(prefix))


def stage_split(stats):
    keep = ("seed", "chain", "extend", "rescue", "cigar", "rfa", "io", "warmup")
    out = {}
    for k, v in stats["stage_times"].items():
        if k.split(".")[0] in keep and not k.startswith("chunks."):
            out[k] = v["seconds"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def smoke_one_card(work):
    print(" | ".join(nvidia_smi()), flush=True)
    dev = phase_child("device", work)
    say(f"[device] {dev['kind']} x{dev['count']}: native host library loaded")

    fixture = Background(build_fixture, "onecard", GENOME, READS)
    t0 = time.time()
    k = phase_child("kernels", work)
    t = k["extend_timing"]
    say(f"[kernels] parity exact in {time.time() - t0:.1f} s: "
          + ", ".join(f"{n} {v['problems']}" for n, v in k.items() if "problems" in v))
    say(f"[kernels] extension {t['shape']}: {t['xla_ms_median_min_max'][0]:.3f} ms "
        f"(median of {t['runs']})")

    f = fixture.join()
    say(f"[mainpath] fixture: {f['pairs']} pairs, subset {f['subset_pairs']} pairs, "
          f"set-up {f['setup_s']:.1f} s")
    with open(os.path.join(work, "fixture.json"), "w") as fh:
        json.dump(f, fh)
    a = phase_child("align", work)

    main = a["main"]
    check(main["reads"] == f["pairs"], f"{main['reads']} of {f['pairs']} pairs aligned")
    emitted = sam_qnames(sam_path(os.path.join(work, "main")))
    check(len(emitted) == f["pairs"], f"{len(emitted)} of {f['pairs']} pairs in the SAM")
    for prefix in ("extend.dispatch.", "local.dispatch.", ("global.dispatch.", "global.devtb.")):
        prefixes = prefix if isinstance(prefix, tuple) else (prefix,)
        n = sum(stage_calls(main, p) for p in prefixes)
        check(n > 0, f"no {' / '.join(prefixes)} calls in the main run")
    total, correct, acc = accuracy(sam_path(os.path.join(work, "main")))
    check(acc >= 0.99, f"accuracy {acc:.4f} < 0.99 ({correct}/{total})")
    for name in ("main", "main_2", "main_tb_flip", "main_tb_flip_2"):
        r = a[name]
        say(f"[mainpath] {name}: {r['pairs_per_s']:.1f} pairs/s "
              f"({r['reads']} pairs in {r['elapsed_s']:.2f} s)")
    say(f"[mainpath] accuracy {acc:.4f} ({correct}/{total}); device traceback "
          f"default {a['device_tb_default']}")
    say("[mainpath] stage split (main_2): " + json.dumps(stage_split(a["main_2"])))

    t0 = time.time()
    oracle_sam = oracle_sliced(f, work, min(12, os.cpu_count() or 1))
    dev_dir = os.path.join(work, "subset_dev")
    check(same_bytes(sam_path(dev_dir), oracle_sam),
          "subset SAM differs between --engine tpu and --engine oracle")
    check(same_shards(dev_dir, os.path.join(work, "subset_devseed")),
          "subset SAM shards differ between host and device seeding")
    say(f"[identity] {f['subset_pairs']} pairs: engine tpu == oracle == device "
          f"seeding, byte for byte (oracle {time.time() - t0:.1f} s)")
    return {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def smoke_four_cards(work):
    print(" | ".join(nvidia_smi()), flush=True)
    f = build_fixture("fourcard", FOUR_CARD_GENOME, FOUR_CARD_READS)
    with open(os.path.join(work, "fixture.json"), "w") as fh:
        json.dump(f, fh)
    pool = phase_child("pool", work)
    one = sam_path(os.path.join(work, "one_card"))
    check(same_shards(os.path.join(work, "one_card"), os.path.join(work, "four_cards")),
          "(a) four-card round-robin SAM differs from the one-card SAM")
    used = sorted(k for k in pool["four_cards"]["stage_times"] if k.startswith("chunks."))
    check(len(used) == 4, f"(a) chunks landed on {used}, not on four cards")
    say(f"[four-cards] (a) round-robin == one card; chunks per card: "
          + ", ".join(f"{k[7:]} {pool['four_cards']['stage_times'][k]['calls']}" for k in used))
    check(same_shards(os.path.join(work, "four_cards"),
                      os.path.join(work, "sharded_devseed")),
          "(b) sharded device seeding SAM differs from host seeding")
    say("[four-cards] (b) sharded index + device seeding == host seeding")

    port = free_port()
    out = os.path.join(work, "four_procs")
    procs = []
    for pid in range(4):
        log = open(os.path.join(work, f"proc{pid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "arachne_tpu.cli", "align", "--engine", "tpu",
             "--sam", "--coordinator", f"localhost:{port}", "--num-processes", "4",
             "--process-id", str(pid), out, f["ref"], f["r1"], f["r2"]],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
            stderr=subprocess.STDOUT), log))
    rcs = []
    for p, log in procs:
        try:
            rcs.append(p.wait(timeout=900))
        finally:
            log.close()
    check(rcs == [0, 0, 0, 0], f"(c) process exit codes {rcs}")
    shards = [os.path.join(out, f"bc_sorted_bam.host{i:03d}.sam") for i in range(4)]
    check(sam_records(shards) == sam_records([one]),
          "(c) the four processes' shards differ from the one-process records")
    say("[four-cards] (c) four processes, one per card: union of shards == "
          "one-process records")
    return {"platform": pool["platform"], "kind": pool["kind"], "count": pool["count"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (needs four GPUs)")
    ap.add_argument("--phase", choices=sorted(CHILDREN), help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(REPO, "arachne_tpu", "cli.py")):
        print("chip_smoke: the arachne_tpu package is not next to this script",
              file=sys.stderr)
        return 2
    if args.phase:
        sys.path.insert(0, REPO)
        CHILDREN[args.phase](args.work)
        return 0
    work = os.path.join(CACHE, "run-four" if args.four_cards else "run-one")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    try:
        device = smoke_four_cards(work) if args.four_cards else smoke_one_card(work)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED after {time.time() - t0:.1f} s: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke passed in {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
