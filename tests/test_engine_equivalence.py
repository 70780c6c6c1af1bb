"""The batched device engine must produce identical barcode results to the
scalar oracle engine across the full DoRFAForOneBarcode workflow."""

import numpy as np
import pytest

from arachne_tpu.config import ArachneConfig
from arachne_tpu.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu.ops.engine import TpuEngine
from arachne_tpu.rfa import FastQRecordView, do_rfa_for_one_barcode

CFG = ArachneConfig()
BASES = np.array(list("ACGT"))


def to_str(codes):
    return "".join(BASES[codes])


@pytest.fixture(scope="module")
def genome(small_reference):
    packed = pack_reference(small_reference)
    fm = build_fmindex(packed)
    idx = FMIndex(packed, fm)
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    return idx, fwd


def make_reads(fwd, rng, n_pairs=8, with_mutations=True):
    recs = []
    for i in range(n_pairs):
        pos = int(rng.integers(0, len(fwd) - 320))
        frag = fwd[pos : pos + 300]
        r1 = frag[:100].copy()
        r2 = (3 - frag[200:300][::-1]).astype(np.uint8)
        if with_mutations and rng.integers(0, 2):
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(0, 100))
                r1[j] = (r1[j] + 1) % 4
        recs.append(
            FastQRecordView(
                read1=to_str(r1).encode(),
                qual1=b"I" * 100,
                read2=to_str(r2).encode(),
                qual2=b"I" * 100,
                barcode=b"A01C02B03D04",
                valid=True,
                read_info=f"pair{i}",
                read_group="",
            )
        )
    return recs


def snapshot(res):
    out = []
    for alist in res.alignments:
        row = []
        for a in alist:
            row.append(
                (
                    a.contig, a.pos, a.aend, a.score, a.mapq, a.reversed_,
                    a.active, a.is_proper, a.duplicate, tuple(a.cigar),
                    a.mismatches, a.matches, a.indels, a.soft_clipped,
                    tuple(a.mismatch_locs), round(a.log_alignment_probability, 9),
                    a.molecule_id, a.active_molecule,
                )
            )
        out.append(row)
    return out


class TestEngineEquivalence:
    def test_rfa_barcode_identical(self, genome):
        idx, fwd = genome
        rng = np.random.default_rng(11)
        recs = make_reads(fwd, rng, n_pairs=8)
        res_oracle = do_rfa_for_one_barcode(idx, CFG, recs, unique_barcode=True)
        engine = TpuEngine(idx, CFG, device_seeding=True)
        res_tpu = do_rfa_for_one_barcode(
            idx, CFG, recs, unique_barcode=True, extender=engine
        )
        assert res_oracle.ran_rfa and res_tpu.ran_rfa
        assert snapshot(res_oracle) == snapshot(res_tpu)

    def test_non_rfa_barcode_identical(self, genome):
        idx, fwd = genome
        rng = np.random.default_rng(5)
        recs = make_reads(fwd, rng, n_pairs=2)
        res_oracle = do_rfa_for_one_barcode(idx, CFG, recs, unique_barcode=True)
        engine = TpuEngine(idx, CFG, device_seeding=True)
        res_tpu = do_rfa_for_one_barcode(
            idx, CFG, recs, unique_barcode=True, extender=engine
        )
        assert snapshot(res_oracle) == snapshot(res_tpu)

    def test_repeat_heavy_barcode_identical(self, genome):
        """Reads inside the planted repeat exercise multi-hit + rescue."""
        idx, fwd = genome
        rng = np.random.default_rng(21)
        recs = []
        for i, pos in enumerate([350, 420, 480, 540, 600, 1250]):
            frag = fwd[pos : pos + 260]
            r1 = frag[:90].copy()
            r2 = (3 - frag[170:260][::-1]).astype(np.uint8)
            recs.append(
                FastQRecordView(
                    read1=to_str(r1).encode(), qual1=b"I" * 90,
                    read2=to_str(r2).encode(), qual2=b"I" * 90,
                    barcode=b"A09C08B07D06", valid=True,
                    read_info=f"rep{i}", read_group="",
                )
            )
        res_oracle = do_rfa_for_one_barcode(idx, CFG, recs, unique_barcode=True)
        engine = TpuEngine(idx, CFG, device_seeding=True)
        res_tpu = do_rfa_for_one_barcode(
            idx, CFG, recs, unique_barcode=True, extender=engine
        )
        assert snapshot(res_oracle) == snapshot(res_tpu)

    def test_mutated_mate_rescue_identical(self, genome):
        idx, fwd = genome
        rng = np.random.default_rng(7)
        recs = make_reads(fwd, rng, n_pairs=5, with_mutations=False)
        # wreck one R2's seeds so it needs rescue
        r2 = np.frombuffer(recs[2].read2, dtype=np.uint8).copy()
        for i in range(0, len(r2), 12):
            r2[i : i + 1] = ord("A") if r2[i] != ord("A") else ord("C")
        recs[2] = FastQRecordView(
            read1=recs[2].read1, qual1=recs[2].qual1,
            read2=r2.tobytes(), qual2=recs[2].qual2,
            barcode=recs[2].barcode, valid=True,
            read_info=recs[2].read_info, read_group="",
        )
        res_oracle = do_rfa_for_one_barcode(idx, CFG, recs, unique_barcode=True)
        engine = TpuEngine(idx, CFG, device_seeding=True)
        res_tpu = do_rfa_for_one_barcode(
            idx, CFG, recs, unique_barcode=True, extender=engine
        )
        assert snapshot(res_oracle) == snapshot(res_tpu)


class TestSuperbatch:
    def test_process_barcodes_identical(self, genome):
        from arachne_tpu.rfa.engine import process_barcodes

        idx, fwd = genome
        rng = np.random.default_rng(33)
        sets = []
        for bi in range(4):
            n = int(rng.integers(2, 9))
            recs = make_reads(fwd, rng, n_pairs=n)
            for r in recs:
                r.barcode = f"B{bi:02d}".encode()
                r.read_info = f"b{bi}_{r.read_info}"
            sets.append((recs, True))
        singles = [
            do_rfa_for_one_barcode(idx, CFG, recs, uniq) for recs, uniq in sets
        ]
        engine = TpuEngine(idx, CFG, device_seeding=True)
        batched = process_barcodes(idx, CFG, sets, engine)
        assert len(batched) == len(singles)
        for a, b in zip(singles, batched):
            assert a.ran_rfa == b.ran_rfa
            assert snapshot(a) == snapshot(b)


class TestNativeCigarWalk:
    def test_native_walk_matches_python_walk(self, genome, monkeypatch):
        """The C++ batched GetAlignments cigar walk (native/cigarwalk.cpp)
        against the in-loop Python walk on the same engine path, over
        reads with substitutions AND indels (gapped CIGARs, reversed
        mates, soft clips)."""
        from arachne_tpu.native import cigar_walk_available
        from arachne_tpu.rfa.engine import process_barcodes

        if not cigar_walk_available():
            pytest.skip("native library unavailable")
        idx, fwd = genome
        rng = np.random.default_rng(77)
        sets = []
        for bi in range(3):
            recs = make_reads(fwd, rng, n_pairs=6)
            for ri, r in enumerate(recs):
                r.barcode = f"W{bi:02d}".encode()
                r.read_info = f"w{bi}_{r.read_info}"
                if ri % 2 == 0:
                    # plant a deletion: drop 3 bases mid-read, extend tail
                    s = bytearray(r.read1)
                    del s[40:43]
                    r.read1 = bytes(s) + b"ACG"
            sets.append((recs, True))
        engine = TpuEngine(idx, CFG, device_seeding=True)
        monkeypatch.setenv("ARACHNE_NATIVE_CIGARWALK", "0")
        py = [snapshot(r) for r in process_barcodes(idx, CFG, sets, engine)]
        monkeypatch.setenv("ARACHNE_NATIVE_CIGARWALK", "1")
        nat = [snapshot(r) for r in process_barcodes(idx, CFG, sets, engine)]
        assert py == nat


class TestHbmBudgetFallback:
    def test_oversized_tables_fall_back_to_host_seeding(self, monkeypatch, capsys):
        """A single-device mesh whose index tables exceed the HBM budget
        must disable device seeding gracefully (no table upload / OOM)."""
        import numpy as np

        from arachne_tpu.config import ArachneConfig
        from arachne_tpu.index import FMIndex, build_fmindex, pack_reference
        from arachne_tpu.ops.engine import TpuEngine

        rng = np.random.default_rng(8)
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 4000)])
        packed = pack_reference([("c", "", seq)])
        idx = FMIndex(packed, build_fmindex(packed))
        monkeypatch.setenv("ARACHNE_HBM_BUDGET", "1")  # nothing fits
        # with a multi-device mesh the over-budget index correctly SHARDS
        eng = TpuEngine(idx, ArachneConfig(), device_seeding=True)
        from arachne_tpu.parallel.mesh import ShardedFMTables

        assert isinstance(eng.dfm, ShardedFMTables)
        # on a single device there is nothing to shard across: graceful
        # host-seeding fallback instead of an HBM OOM at table upload
        import jax

        dev0 = jax.devices()[0]
        monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev0])
        eng1 = TpuEngine(idx, ArachneConfig(), device_seeding=True)
        assert eng1.dfm is None
        assert "device seeding disabled" in capsys.readouterr().out
