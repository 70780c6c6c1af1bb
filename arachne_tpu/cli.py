"""arachne-tpu command line.

Usage mirrors the reference (main.go:25-103):

    arachne_tpu align <opts> output_dir reference.fa R1.fq R2.fq
    arachne_tpu index reference.fa
    arachne_tpu standardize R1.fq R2.fq        (preprocess subcommand intent,
    arachne_tpu sort R1.fq R2.fq                main.go:85 TODO)

Flags: -c/--centromeres, -i/--improper-pair-penalty (-4), -p/--partitions
(40 Mbp), -r/--read-group, -s/--sample-id, -t/--threads, plus --sam and
--engine extensions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

from . import __version__
from .config import ArachneConfig, OutputOptions, RFAOptions
from .rfa.types import Region

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Persist compiled executables across runs.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here (an empty value turns the cache off).
    Otherwise the cache lives at a fixed path inside the checkout,
    ``<checkout>/.jax_cache`` (gitignored): the path is part of the cache
    key, so it must not move between runs."""
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def load_centromeres(path: Optional[str]) -> Dict[str, Region]:
    """loadCentromeres (aligner.go:375-399): TSV rows
    CEN<chr>\t<chr>\t<start>\t<stop>; other rows ignored."""
    out: Dict[str, Region] = {}
    if not path:
        return out
    with open(path) as fh:
        for line in fh:
            if not line.startswith("CEN"):
                continue
            tokens = line.rstrip("\n").split("\t")
            if len(tokens) < 4:
                continue
            try:
                start, end = int(tokens[2]), int(tokens[3])
            except ValueError:
                continue
            out[tokens[1]] = Region(start=start, end=end)
    return out


def load_or_build_index(reference: str, keep_full_sa="auto"):
    from .index import FMIndex, build_index_files, load_index

    arx = reference + ".arx.npz"
    if os.path.exists(arx):
        packed, fm = load_index(arx)
        return FMIndex(packed, fm)
    if os.path.exists(reference + ".bwt"):
        # prebuilt `bwa index` files (the reference's required input format)
        from .index.bwaio import load_bwa_index

        print(f"Loading bwa-format index for {reference}", flush=True)
        packed, fm = load_bwa_index(reference)
        return FMIndex(packed, fm)
    print(f"Building index for {reference} ...", flush=True)
    t0 = time.time()
    build_index_files(reference, keep_full_sa=keep_full_sa)
    print(f"Index built in {time.time() - t0:.1f}s", flush=True)
    packed, fm = load_index(arx)
    return FMIndex(packed, fm)


def resolve_engine(requested: str) -> str:
    """'auto' picks the batched device engine when JAX's device is an
    accelerator, the scalar oracle on cpu-only hosts where jit compile
    latency dominates tiny runs."""
    if requested != "auto":
        return requested
    import jax

    return "tpu" if jax.devices()[0].platform != "cpu" else "oracle"


def run_align(args) -> None:
    """The Arachne() pipeline (aligner.go:269-373)."""
    from .config import PipelineOptions
    from .io.bam import BAMWriters
    from .io.fastq import iter_barcode_sets
    from .rfa.engine import do_rfa_for_one_barcode
    from .runtime.stats import RunStats

    print(f"Starting arachne-tpu. Version: {__version__}")
    # multi-host: must run before the first backend touch (resolve_engine
    # calls jax.devices); forms the process group, one process per host
    from .parallel.distributed import (
        allreduce_max_int,
        allreduce_stats,
        init_distributed,
        shard_suffix,
    )

    ctx = init_distributed(
        getattr(args, "coordinator", None) or None,
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
    )
    host_sfx = shard_suffix(ctx)
    if ctx.initialized:
        print(f"Multi-host: process {ctx.process_index}/{ctx.process_count}")
    engine_kind = resolve_engine(args.engine)
    cfg = ArachneConfig(
        rfa=RFAOptions(
            improper_pair_penalty=args.improper_pair_penalty,
            # --no-rfa: an unreachable pair threshold turns worth_running_rfa
            # off for every barcode (engine.py:31-48)
            **(
                {"rfa_min_read_pairs": 1 << 60}
                if getattr(args, "no_rfa", False)
                else {}
            ),
        ),
        output=OutputOptions(
            position_chunk_size=args.partitions,
            read_groups=args.read_group,
            sample_id=args.sample_id,
            debug_tags=args.debug_tags,
            emit_sam=args.sam,
        ),
        pipeline=PipelineOptions(
            engine=engine_kind, num_workers=max(1, args.threads),
            index_mode=getattr(args, "index_mode", "auto"),
        ),
        centromeres=args.centromeres,
        threads=args.threads,
    )
    centromeres = load_centromeres(args.centromeres)
    if not os.path.isdir(args.output):
        os.makedirs(args.output, exist_ok=True)
    if not os.access(args.output, os.W_OK):
        raise SystemExit(f"Output directory not writable: {args.output}")
    print(f"Loading reference: {args.reference}")
    idx = load_or_build_index(args.reference)
    print("Reference loaded")
    from .runtime.checkpoint import CheckpointedStream

    ckpt_path = (args.checkpoint + host_sfx) if args.checkpoint else None
    stream = CheckpointedStream(
        args.r1, args.r2, ckpt_path,
        process_index=ctx.process_index, process_count=ctx.process_count,
    )
    if ctx.initialized and ctx.process_count > 1 and ckpt_path:
        # fleet-wide generation agreement before any manifest write (see
        # CheckpointedStream.agree_generation)
        stream.agree_generation(allreduce_max_int(stream.generation, ctx))
        # ...and on the merged claim union itself: a host whose manifest
        # glob missed a sibling (NFS lag / non-shared path) would re-run
        # that sibling's completed sets as duplicates (claims_digest doc)
        from .parallel.distributed import assert_uniform_int

        assert_uniform_int(stream.claims_digest(), ctx, "checkpoint claim digest")
    # exactly-once resume: truncate the previous generation's shards back
    # to the last manifest's flushed offsets (records written after that
    # save are discarded and their barcode sets re-run)
    for fname, off in stream.resume_offsets.items():
        path = os.path.join(args.output, fname)
        if os.path.exists(path) and os.path.getsize(path) > off:
            os.truncate(path, off)
    suffix = host_sfx + (f".gen{stream.generation}" if stream.generation > 0 else "")
    bams = BAMWriters(idx, args.output, cfg, version=__version__, shard_suffix=suffix)
    # durability: BGZF/file buffers must hit the OS before a checkpoint
    # manifest can claim their records as emitted; offsets feed the
    # truncate-on-resume above
    stream.flush_fn = lambda: (bams.flush(), bams.offsets())[1]
    stream.save_initial()
    stats = RunStats()
    engine = None
    if engine_kind == "tpu":
        from .ops.engine import TpuEngine

        engine = TpuEngine(idx, cfg)
        engine.warmup()
    if stream.skip:
        print(f"Resuming: skipping {stream.skip} completed barcode sets")
    t0 = time.time()
    profiling = False
    if args.profile_dir:
        import jax

        jax.profiler.start_trace(args.profile_dir)
        profiling = True

    from .runtime.timers import TIMERS

    crash_after = int(os.environ.get("ARACHNE_CRASH_AFTER_SETS", 0))

    def emit(res, n_records, unique):
        with TIMERS.stage("io.write"):
            bams.dump(res.alignments, res.attach_bx)
        stats.note_barcode(res)
        stream.mark_done(1, n_records)
        if crash_after and stats.barcodes >= crash_after:
            # fault-injection hook (tests): die hard, mid-stream, without
            # flushing — exactly what a host failure looks like
            os._exit(17)
        if n_records > 2:
            print(
                f"working on barcode {res.barcode}  num reads: {n_records}  "
                f"doing RFA: {res.ran_rfa}  unique_barcode {unique}"
            )

    # dedicated writer thread fed by a bounded queue (the reference's
    # BamThread goroutine + Data channel, bamwriter.go:619-633): BGZF
    # deflate + record packing overlap result consumption instead of
    # serializing with it.  Queue order == emission order, so output
    # stays byte-deterministic; checkpoint mark_done runs on the writer
    # thread AFTER the dump so manifests never lead the data.
    import queue as _queue
    import threading as _threading

    emit_q: "_queue.Queue" = _queue.Queue(maxsize=64)
    writer_exc: list = []

    def _writer_loop():
        while True:
            item = emit_q.get()
            if item is None:
                return
            if writer_exc:
                continue  # drain after failure; producers must not block
            try:
                emit(*item)
            except BaseException as e:  # noqa: BLE001 - reraised in main
                writer_exc.append(e)

    # daemon + try/finally: an exception anywhere on the consume path
    # (a worker future, Ctrl-C, a writer error re-raised by emit_async)
    # must still deliver the shutdown sentinel, or the process would
    # wedge joining a blocked non-daemon thread instead of dying with
    # the real error
    writer_thread = _threading.Thread(
        target=_writer_loop, name="bam-writer", daemon=True
    )
    writer_thread.start()

    def emit_async(res, n_records, unique):
        if writer_exc:
            raise writer_exc[0]
        emit_q.put((res, n_records, unique))

    def consume():
        if engine is not None:
            # superbatch pipeline: host phases of batch N overlap the
            # device waits of batch N+1 (device calls release the GIL);
            # results are consumed in order so output stays deterministic
            import threading
            from concurrent.futures import ThreadPoolExecutor

            from .ops.engine import TpuEngine
            from .rfa.engine import process_barcodes

            tls = threading.local()

            def run_batch(batch):
                eng = getattr(tls, "engine", None)
                if eng is None:
                    eng = TpuEngine(idx, cfg)
                    tls.engine = eng
                return process_barcodes(idx, cfg, batch, eng, centromeres)

            batch_limit = int(
                os.environ.get("ARACHNE_TEST_READS_PER_BATCH", 0)
            ) or cfg.pipeline.reads_per_batch

            def superbatches():
                pending = []
                pending_pairs = 0
                for records, unique in stream:
                    pending.append((records, unique))
                    pending_pairs += len(records)
                    if pending_pairs >= batch_limit:
                        yield pending
                        pending = []
                        pending_pairs = 0
                if pending:
                    yield pending

            with ThreadPoolExecutor(max_workers=cfg.pipeline.num_workers) as pool:
                futures = []
                for batch in superbatches():
                    futures.append((pool.submit(run_batch, batch), batch))
                    while len(futures) > cfg.pipeline.num_workers:
                        fut, b = futures.pop(0)
                        for res, (recs, uniq) in zip(fut.result(), b):
                            emit_async(res, len(recs), uniq)
                for fut, b in futures:
                    for res, (recs, uniq) in zip(fut.result(), b):
                        emit_async(res, len(recs), uniq)
        else:
            for records, unique in stream:
                res = do_rfa_for_one_barcode(
                    idx, cfg, records, unique, centromeres, extender=None
                )
                emit_async(res, len(records), unique)

    try:
        consume()
    finally:
        # always deliver the sentinel: without it an error on the consume
        # path would leave the writer blocked in q.get() forever
        emit_q.put(None)
        writer_thread.join()
    if writer_exc:
        raise writer_exc[0]
    # final manifest first (flushes writers for offsets), then close
    stream.finish()
    bams.close()
    if profiling:
        import jax

        jax.profiler.stop_trace()
    dt = time.time() - t0
    stats.finish(dt)
    if ctx.initialized and ctx.process_count > 1:
        # cross-host counter merge (psum-style allgather+sum); each host
        # already wrote its own output shards, mirroring the reference's
        # sharded BAMs (no output collective needed)
        from .runtime.stats import RunStats

        merged = RunStats.from_vector(allreduce_stats(stats.to_vector(), ctx))
        merged.finish(dt)
        global_stats = merged
    else:
        global_stats = stats
    if args.stats_json:
        import json

        d = stats.as_dict()
        d["stage_times"] = TIMERS.as_dict()
        if ctx.initialized and ctx.process_count > 1:
            d["process_index"] = ctx.process_index
            d["process_count"] = ctx.process_count
            d["global"] = global_stats.as_dict()
        with open(args.stats_json + host_sfx if ctx.process_count > 1 else args.stats_json, "w") as fh:
            json.dump(d, fh, indent=2)
    if os.environ.get("ARACHNE_TIMERS"):
        print("--- stage times ---")
        print(TIMERS.summary())
    print(
        f"Arachne completed successfully: {global_stats.reads} read pairs, "
        f"{global_stats.barcodes} barcodes, "
        f"{stats.reads / max(dt, 1e-9):.1f} pairs/s"
        + (f" (host {ctx.process_index}: {stats.reads} pairs)" if ctx.process_count > 1 else "")
    )
    return stats


def run_status(ckpt_base: str, stale_after: float = 300.0) -> int:
    """Failure detection, manifest-side: every host's claim progress and
    the age of its last save.  A host whose manifest has gone stale while
    its claim is unfinished has likely died — its residue is recoverable
    by re-running with any process count (claim-based resume,
    runtime/checkpoint.py).  Returns 1 if any host looks stale/dead."""
    import glob as _glob
    import re as _re

    from .runtime.checkpoint import Checkpoint

    base = _re.sub(r"\.host\d+$", "", ckpt_base)
    paths = sorted(set(_glob.glob(base) + _glob.glob(base + ".host*")))
    paths = [p for p in paths if not p.endswith(".tmp")]
    if not paths:
        print(f"no manifests found at {base}[.host*]")
        return 1
    now = time.time()
    stale = False
    for p in paths:
        ck = Checkpoint.load(p)
        if ck is None:
            continue
        age = now - os.path.getmtime(p)
        own = ck.claims[-1] if ck.claims else None
        claims = ", ".join(
            f"g{c.g} h{c.h}/{c.P}: {c.n} sets" for c in ck.claims
        )
        # threshold scales with the host's OBSERVED save cadence (recorded
        # in the manifest): a host saving every 4s is dead after 60s of
        # silence; one saving every 10min is not.  --stale-after overrides;
        # hosts that never reached a second save fall back to the floor.
        if stale_after is not None:
            threshold = stale_after
        elif ck.save_interval > 0:
            threshold = max(60.0, 5.0 * ck.save_interval)
        else:
            threshold = 300.0
        flag = ""
        if own is not None and age > threshold:
            flag = (f"  ** STALE ({age:.0f}s since last save, threshold "
                    f"{threshold:.0f}s — host likely dead; re-run to recover its residue)")
            stale = True
        print(f"{p}: last save {age:.0f}s ago; {claims}{flag}")
    return 1 if stale else 0


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="arachne_tpu",
        description="Linked-read aligner (haplotagging/stLFR/TELLseq) on JAX",
    )
    sub = parser.add_subparsers(dest="command")

    al = sub.add_parser("align", help="align barcode-sorted paired FASTQ")
    al.add_argument("-c", "--centromeres", default="")
    al.add_argument("-i", "--improper-pair-penalty", type=float, default=-4.0)
    al.add_argument("-p", "--partitions", type=int, default=40_000_000)
    al.add_argument("-r", "--read-group", default="sample:library:molecule:flowcell:lane")
    al.add_argument("-s", "--sample-id", default="sample")
    al.add_argument("-t", "--threads", type=int, default=2)
    al.add_argument("--sam", action="store_true", help="emit SAM text instead of BAM")
    al.add_argument("--debug-tags", action="store_true")
    al.add_argument(
        "--no-rfa", action="store_true",
        help="disable barcode-joint (RFA) alignment: every barcode takes "
        "the plain paired-end path (estimateMapQualities with nil "
        "molecules, aligner.go:471); for A/B studies of molecule evidence",
    )
    al.add_argument(
        "--engine", choices=["auto", "oracle", "tpu"], default="auto",
        help="auto = batched device engine on accelerators, oracle on cpu",
    )
    al.add_argument(
        "--index-mode", choices=["auto", "replicated", "sharded"], default="auto",
        help="FM-index placement across the device mesh (sharded = "
        "block-sharded tables with psum-merged rank lookups)",
    )
    al.add_argument("--checkpoint", default="", help="checkpoint manifest path for resume")
    al.add_argument(
        "--coordinator", default=os.environ.get("ARACHNE_COORDINATOR", ""),
        help="multi-host coordinator address host:port (jax.distributed)",
    )
    al.add_argument(
        "--num-processes", type=int,
        default=int(os.environ.get("ARACHNE_NUM_PROCESSES", 0)) or None,
        help="multi-host process count",
    )
    al.add_argument(
        "--process-id", type=int,
        default=(int(os.environ["ARACHNE_PROCESS_ID"])
                 if "ARACHNE_PROCESS_ID" in os.environ else None),
        help="multi-host process id (0-based)",
    )
    al.add_argument("--stats-json", default="", help="write run statistics JSON here")
    al.add_argument("--profile-dir", default="", help="capture a jax profiler trace here")
    al.add_argument("output")
    al.add_argument("reference")
    al.add_argument("r1")
    al.add_argument("r2")
    al.set_defaults(func=run_align)

    ix = sub.add_parser("index", help="build the FM-index for a FASTA reference")
    ix.add_argument("reference")
    ix.add_argument(
        "--sa-mode", choices=["auto", "full", "sampled"], default="auto",
        help="auto = dense SA only for small genomes (IndexOptions.sa_full_max_len)",
    )
    ix.add_argument(
        "--sampled-sa", action="store_true",
        help="deprecated alias for --sa-mode sampled",
    )
    ix.add_argument(
        "--bwa-format", action="store_true",
        help="also write bwa-compatible .bwt/.sa/.pac/.ann/.amb files",
    )
    ix.add_argument(
        "--build-mode", choices=["auto", "sais", "incremental"], default="auto",
        help="construction algorithm: sais = full in-RAM suffix array "
        "(fast, ~28 GB peak per Gbp of fwd+rev rows); incremental = "
        "memory-proportional dynamic BWT (the large-genome path, "
        "bwtindex.c:271 semantics); auto switches on genome size",
    )

    st = sub.add_parser("standardize", help="convert linked-read FASTQ to BX:Z/VX:i form")
    st.add_argument("r1")
    st.add_argument("r2")
    st.add_argument("--out-r1", default="standard.R1.fq.gz")
    st.add_argument("--out-r2", default="standard.R2.fq.gz")

    so = sub.add_parser("sort", help="barcode-sort paired FASTQ")
    so.add_argument("r1")
    so.add_argument("r2")
    so.add_argument("--out-r1", default="bc_sorted.R1.fq.gz")
    so.add_argument("--out-r2", default="bc_sorted.R2.fq.gz")

    sim = sub.add_parser("simulate", help="simulate linked-read FASTQ with truth names")
    sim.add_argument("reference")
    sim.add_argument("--out-r1", default="sim.R1.fq.gz")
    sim.add_argument("--out-r2", default="sim.R2.fq.gz")
    sim.add_argument("--barcodes", type=int, default=50)
    sim.add_argument("--molecules", type=int, default=3)
    sim.add_argument("--pairs", type=int, default=12)
    sim.add_argument("--molecule-len", type=int, default=40000)
    sim.add_argument("--error-rate", type=float, default=0.002)
    sim.add_argument(
        "--indel-rate", type=float, default=0.0,
        help="per-read probability of one sequencing indel (read length "
        "stays constant; the alignment gains a real I/D op)",
    )
    sim.add_argument(
        "--vary-quals", action="store_true",
        help="per-base phred 20-40 quality strings instead of flat 'I'",
    )
    sim.add_argument("--seed", type=int, default=0)

    ev = sub.add_parser("evaluate", help="score a SAM against truth-encoded read names")
    ev.add_argument("sam")
    ev.add_argument("--tolerance", type=int, default=20)

    mg = sub.add_parser("merge", help="merge resume-generation output shards")
    mg.add_argument("output_dir")

    stt = sub.add_parser(
        "status", help="report fleet progress/staleness from checkpoint manifests"
    )
    stt.add_argument("checkpoint", help="manifest base path (as passed to --checkpoint)")
    stt.add_argument(
        "--stale-after", type=float, default=None,
        help="seconds since last save before a host is flagged stale "
        "(default: 5x the host's recorded save cadence, floor 60s)",
    )

    args = parser.parse_args(argv)
    enable_compilation_cache()
    if args.command == "align":
        run_align(args)
    elif args.command == "index":
        from .index import build_index_files

        mode = "sampled" if args.sampled_sa else args.sa_mode
        keep = {"auto": "auto", "full": True, "sampled": False}[mode]
        out = build_index_files(
            args.reference, keep_full_sa=keep,
            build_mode=args.build_mode, progress=True,
        )
        print(f"Index written to {out}")
        if args.bwa_format:
            from .index import load_index
            from .index.bwaio import save_bwa_index

            packed, fm = load_index(out)
            save_bwa_index(args.reference, packed, fm)
            print(f"bwa-format index written to {args.reference}.[bwt,sa,pac,ann,amb]")
    elif args.command == "standardize":
        from .io.standardize import standardize

        o1, o2 = standardize(args.r1, args.r2, args.out_r1, args.out_r2)
        print(f"Standardized FASTQ: {o1} {o2}")
    elif args.command == "sort":
        from .io.preprocess import barcode_sort

        o1, o2 = barcode_sort(args.r1, args.r2, args.out_r1, args.out_r2)
        print(f"Barcode-sorted FASTQ: {o1} {o2}")
    elif args.command == "simulate":
        from .index import parse_fasta
        from .io.simulate import SimConfig, simulate_linked_reads

        contigs = parse_fasta(args.reference)
        n = simulate_linked_reads(
            contigs, args.out_r1, args.out_r2,
            SimConfig(
                n_barcodes=args.barcodes,
                molecules_per_barcode=args.molecules,
                pairs_per_molecule=args.pairs,
                molecule_len=args.molecule_len,
                error_rate=args.error_rate,
                indel_rate=args.indel_rate,
                vary_quals=args.vary_quals,
                seed=args.seed,
            ),
        )
        print(f"Simulated {n} read pairs -> {args.out_r1} {args.out_r2}")
    elif args.command == "evaluate":
        from .runtime.accuracy import evaluate_sam

        stats = evaluate_sam(args.sam, args.tolerance)
        print(stats.as_csv(), end="")
    elif args.command == "status":
        rc = run_status(args.checkpoint, args.stale_after)
        raise SystemExit(rc)
    elif args.command == "merge":
        from .io.merge import merge_generations

        merged = merge_generations(args.output_dir)
        print(f"Merged {merged} sharded outputs in {args.output_dir}")
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
