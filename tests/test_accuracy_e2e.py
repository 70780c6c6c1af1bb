"""End-to-end accuracy: simulate linked reads -> align -> score vs truth."""

import os

import numpy as np
import pytest

from arachne_tpu.cli import main as cli_main
from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads
from arachne_tpu.runtime.accuracy import evaluate_sam


def write_fasta(path, contigs):
    with open(path, "w") as fh:
        for name, _, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                fh.write(seq[i : i + 60] + "\n")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    rng = np.random.default_rng(99)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60_000)])
    contigs = [("chrS", "", genome)]
    tmp = tmp_path_factory.mktemp("sim")
    fasta = str(tmp / "sim.fa")
    write_fasta(fasta, contigs)
    r1 = str(tmp / "sim.R1.fq.gz")
    r2 = str(tmp / "sim.R2.fq.gz")
    n = simulate_linked_reads(
        contigs, r1, r2,
        SimConfig(n_barcodes=6, molecules_per_barcode=2, molecule_len=8000,
                  pairs_per_molecule=8, seed=4),
    )
    return tmp, fasta, r1, r2, n


class TestSimulatedAccuracy:
    def test_align_and_score(self, sim):
        tmp, fasta, r1, r2, n_pairs = sim
        outdir = str(tmp / "out")
        cli_main(["align", "--sam", outdir, fasta, r1, r2])
        stats = evaluate_sam(os.path.join(outdir, "bc_sorted_bam.sam"))
        assert stats.total >= 2 * n_pairs * 0.95
        accuracy = stats.correct / stats.total
        assert accuracy >= 0.97, (stats.correct, stats.total)
        # high-mapq reads should be almost always correct
        if stats.total_mapq10:
            assert stats.correct_mapq10 / stats.total_mapq10 >= 0.99

    def test_tpu_engine_same_accuracy(self, sim, monkeypatch):
        monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
        tmp, fasta, r1, r2, n_pairs = sim
        outdir = str(tmp / "out_tpu")
        cli_main(["align", "--sam", "--engine", "tpu", outdir, fasta, r1, r2])
        stats = evaluate_sam(os.path.join(outdir, "bc_sorted_bam.sam"))
        # identical output to the oracle engine
        oracle = evaluate_sam(os.path.join(str(tmp / "out"), "bc_sorted_bam.sam"))
        assert stats.total == oracle.total
        assert stats.correct == oracle.correct
        assert stats.by_mapq == oracle.by_mapq
