"""Indels through the whole pipeline: the gapped paths must fire e2e.

Round-3 gap: the simulator injected substitutions only, so every e2e run
produced all-M CIGARs and the traceback z-fetch, MD/NM-around-gaps and
leading/trailing-D squeeze paths were exercised only by unit tests.  This
fixture simulates reads with genuine sequencing indels and asserts that
gapped CIGARs appear in output, score correctly vs truth, the oracle and
device engines stay record-identical, and the full traceback fetch
(ops/sw_global.py, bypassing the provable all-M shortcut) genuinely ran.
"""

import os
import re

import numpy as np
import pytest

from arachne_tpu.cli import main as cli_main
from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads
from arachne_tpu.runtime.accuracy import evaluate_sam


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    rng = np.random.default_rng(7)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 80_000)])
    contigs = [("chrI", "", genome)]
    tmp = tmp_path_factory.mktemp("indel")
    fasta = str(tmp / "indel.fa")
    with open(fasta, "w") as fh:
        fh.write(">chrI\n")
        for i in range(0, len(genome), 60):
            fh.write(genome[i : i + 60] + "\n")
    r1 = str(tmp / "i.R1.fq.gz")
    r2 = str(tmp / "i.R2.fq.gz")
    n = simulate_linked_reads(
        contigs, r1, r2,
        SimConfig(n_barcodes=6, molecules_per_barcode=2, molecule_len=9000,
                  pairs_per_molecule=10, indel_rate=0.35, vary_quals=True,
                  seed=21),
    )
    return tmp, fasta, r1, r2, n


def read_sam(path):
    recs = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("@"):
                recs.append(line.rstrip("\n").split("\t"))
    return recs


class TestIndelEndToEnd:
    def test_gapped_cigars_appear_and_score(self, sim):
        tmp, fasta, r1, r2, n_pairs = sim
        outdir = str(tmp / "out")
        cli_main(["align", "--sam", outdir, fasta, r1, r2])
        sam = os.path.join(outdir, "bc_sorted_bam.sam")
        recs = read_sam(sam)
        gapped = [r for r in recs if re.search(r"\d+[ID]", r[5])]
        # ~35% of reads carry one indel; nearly all must surface as I/D ops
        assert len(gapped) >= 0.2 * len(recs), (len(gapped), len(recs))
        # the writer emits the reference's tag set (no NM, bamwriter.go):
        # AS carries scoreAlignment, where an indel costs -3 (aligner.go:
        # 556-581), and XM counts mismatches EXCLUDING the indel
        # (mismatches = EditDistance - indel_length, aligner.go:1565)
        for r in gapped[:50]:
            as_tag = [f for f in r[11:] if f.startswith("AS:i:")]
            assert as_tag and int(as_tag[0][5:]) <= -3, r[:6] + as_tag
            xm_tag = [f for f in r[11:] if f.startswith("XM:Z:")]
            assert xm_tag, r[:6]
        stats = evaluate_sam(sam)
        assert stats.total >= 2 * n_pairs * 0.95
        assert stats.correct / stats.total >= 0.99, (stats.correct, stats.total)

    def test_device_engine_identical_and_zfetch_fires(self, sim, monkeypatch):
        monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
        tmp, fasta, r1, r2, _ = sim
        from arachne_tpu.ops import sw_global

        before = sw_global.TRACEBACK_FETCHES
        outdir = str(tmp / "out_tpu")
        cli_main(["align", "--sam", "--engine", "tpu", outdir, fasta, r1, r2])
        assert sw_global.TRACEBACK_FETCHES > before, (
            "gapped fixture must exercise the traceback z-fetch path"
        )
        a = read_sam(os.path.join(str(tmp / "out"), "bc_sorted_bam.sam"))
        b = read_sam(os.path.join(outdir, "bc_sorted_bam.sam"))
        assert a == b
