"""Sanitizer build of the native C++ components (SURVEY.md 5 "race
detection/sanitizers": the reference configures none; our native code is
exercised under ASan+UBSan here) and a threaded-pipeline determinism
stress test for the superbatch thread pool (cli.py run_align engine path).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "arachne_tpu", "native")


def _asan_lib():
    p = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True
    )
    path = p.stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


class TestNativeSanitized:
    @pytest.mark.skipif(_asan_lib() is None, reason="libasan unavailable")
    def test_smem_and_sais_under_asan_ubsan(self, tmp_path):
        """Build the native library with -fsanitize=address,undefined and
        drive the full three-pass SMEM collector + SA-IS through it in a
        subprocess (LD_PRELOAD'd ASan), with multiple worker threads.
        Any heap overflow / UB / data race on the output arrays aborts the
        subprocess."""
        so = str(tmp_path / "_arachne_native_asan.so")
        import arachne_tpu.native as native_mod

        srcs = [os.path.join(NATIVE, s) for s in native_mod._SOURCES]
        subprocess.run(
            ["g++", "-O1", "-g", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all", "-shared", "-fPIC", "-pthread",
             "-o", so] + srcs,
            check=True, capture_output=True,
        )
        driver = tmp_path / "driver.py"
        driver.write_text(
            f"""
import ctypes, sys
import numpy as np
sys.path.insert(0, {REPO!r})
import arachne_tpu.native as native
# point the loader at the sanitized build
native._LIB_PATH = {so!r}
native._lib = None
native._tried = False
from arachne_tpu.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu.config import MemOptions
from arachne_tpu.align.smem import collect_seeds
from arachne_tpu.align.smem_native import collect_seeds_native

rng = np.random.default_rng(3)
seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 80_000))
packed = pack_reference([("c", "", seq)])
fm = build_fmindex(packed)   # exercises sanitized SA-IS via native path
idx = FMIndex(packed, fm)
fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
opt = MemOptions()
reads = []
for _ in range(300):
    p = int(rng.integers(0, len(fwd) - 160))
    r = fwd[p : p + 150].copy()
    for _ in range(int(rng.integers(0, 8))):
        j = int(rng.integers(0, 150))
        r[j] = (r[j] + 1) % 4
    if rng.integers(0, 4) == 0:
        r[int(rng.integers(0, 150))] = 4
    reads.append(r)
got = collect_seeds_native(idx, reads, opt, n_threads=4)
key = lambda lst: [(m.k, m.l, m.s, m.qb, m.qe) for m in lst]
for i in (0, 57, 123, 299):
    assert key(got[i]) == key(collect_seeds(idx, reads[i], opt)), i
# sanitized incremental-BWT build: B+-tree inserts, splits, emission
from arachne_tpu.index.build import build_fmindex_incremental
fm_inc = build_fmindex_incremental(packed)
assert np.array_equal(fm_inc.bwt_words, fm.bwt_words)
assert fm_inc.primary == fm.primary
print("SANITIZED_OK")
"""
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["LD_PRELOAD"] = _asan_lib()
        # python itself leaks by ASan's standards; UB/overflow still aborts
        env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
        p = subprocess.run(
            [sys.executable, str(driver)],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert p.returncode == 0, p.stdout + p.stderr
        assert "SANITIZED_OK" in p.stdout


class TestThreadedPipeline:
    def test_worker_count_does_not_change_output(self, tmp_path):
        """The superbatch thread pool (thread-local engines, in-order
        result consumption, backpressure) must produce byte-identical
        shards at any -t."""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["ARACHNE_DEVICE_SEEDING"] = "1"

        def run(args):
            p = subprocess.run(
                [sys.executable, "-m", "arachne_tpu.cli"] + args,
                env=env, capture_output=True, text=True, timeout=900,
            )
            assert p.returncode == 0, p.stdout + p.stderr
            return p

        rng = np.random.default_rng(21)
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 100_000))
        ref = str(tmp_path / "ref.fa")
        with open(ref, "w") as fh:
            fh.write(">chrT\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i : i + 70] + "\n")
        run(["index", ref])
        r1, r2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
        run(["simulate", ref, "--out-r1", r1, "--out-r2", r2,
             "--barcodes", "12", "--molecules", "2", "--pairs", "12",
             "--seed", "2"])
        outs = {}
        for t in ("1", "4"):
            out = str(tmp_path / f"out_t{t}")
            # small superbatches force several in-flight batches per run
            env["ARACHNE_TEST_READS_PER_BATCH"] = "48"
            run(["align", out, ref, r1, r2, "--engine", "tpu", "--sam",
                 "-t", t])
            with open(os.path.join(out, "bc_sorted_bam.sam")) as fh:
                outs[t] = fh.read()
        assert outs["1"] == outs["4"]
