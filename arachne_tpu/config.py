"""Typed configuration for the arachne-tpu linked-read aligner.

Every constant that defines the reference's observable behavior is surfaced
here with the reference value as the default.  Sources (reference repo
pdimens/arachne mounted at /root/reference):

  * BWA-MEM option defaults .......... src/gobwa/bwa/bwamem.c:48-84 (mem_opt_init)
  * RFA / aligner constants .......... src/aligner/aligner.go (cited per-field)
  * insert-size model ................ src/gobwa/gobwa.go:229-237
  * CLI flags ........................ main.go:25-41

The reference never overrides a single mem_opt_t field, so these defaults
*are* the behavior spec.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MemOptions:
    """BWA-MEM alignment options (mem_opt_t, bwamem.c:48-84)."""

    a: int = 1                  # match score
    b: int = 4                  # mismatch penalty
    o_del: int = 6              # gap open (deletion)
    e_del: int = 1              # gap extend (deletion)
    o_ins: int = 6              # gap open (insertion)
    e_ins: int = 1              # gap extend (insertion)
    w: int = 100                # band width
    T: int = 30                 # minimum output score
    zdrop: int = 100            # Z-dropoff
    pen_unpaired: int = 17      # phred-scaled penalty for unpaired reads
    pen_clip5: int = 5          # 5' clipping penalty
    pen_clip3: int = 5          # 3' clipping penalty
    max_mem_intv: int = 20      # 3rd-pass (LAST-like) seeding occ threshold
    min_seed_len: int = 19      # minimum seed length
    split_width: int = 10       # max occ of a seed to trigger re-seeding
    max_occ: int = 500          # skip seeds with more than this many occurrences
    max_chain_gap: int = 10000  # max gap between seeds in a chain
    max_ins: int = 10000        # maximum insert size (pestat)
    mask_level: float = 0.50    # chain overlap significance threshold
    drop_ratio: float = 0.50    # drop chain if weight below ratio of overlapping chain
    XA_drop_ratio: float = 0.80
    split_factor: float = 1.5   # re-seed an SMEM longer than min_seed_len*split_factor
    max_matesw: int = 50        # perform at most this many rounds of mate-SW
    mask_level_redun: float = 0.95
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    mapQ_coef_len: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200

    @property
    def mapQ_coef_fac(self) -> float:
        import math

        return math.log(self.mapQ_coef_len)

    def scoring_matrix(self):
        """5x5 scoring matrix (bwa_fill_scmat, bwa.c:110-119)."""
        import numpy as np

        mat = np.full((5, 5), -1, dtype=np.int8)
        for i in range(4):
            for j in range(4):
                mat[i, j] = self.a if i == j else -self.b
        mat[4, :] = -1
        mat[:, 4] = -1
        return mat


@dataclass(frozen=True)
class InsertSizeModel:
    """Hard-coded FR insert-size distribution (gobwa.go:229-237).

    The reference fixes Pes[FR] = {low:-35, high:500, avg:200, std:100} and
    marks FF/RF/RR as failed; mate rescue only ever runs for FR.
    """

    low: int = -35
    high: int = 500
    avg: float = 200.0
    std: float = 100.0


@dataclass(frozen=True)
class RFAOptions:
    """Barcode-joint RFA constants (src/aligner/aligner.go)."""

    improper_pair_penalty: float = -4.0   # main.go:28; log10 domain
    molecule_gap: int = 50_000            # new molecule when gap > 50kb (aligner.go:1306)
    chain_score_delta: int = 25           # GetChains score_delta (aligner.go:454)
    alignment_score_delta: int = 17       # GetAlignments delta (aligner.go:455)
    mismatch_penalty: float = -2.0        # scoreAlignment (aligner.go:559)
    indel_penalty: float = -3.0           # scoreAlignment (aligner.go:559)
    softclip_side_penalty: float = -5.0   # scoreAlignment (aligner.go:561)
    softclip_base_penalty: float = -0.5   # scoreAlignment (aligner.go:562)
    pseudo_alignment_length: float = 25.0  # psuedoCountAlignmentScore (aligner.go:548)
    pseudo_softclip_max: float = -10.0    # psuedoCountAlignmentScore (aligner.go:550)
    proper_pair_min_dist: int = -35       # isPair (aligner.go:1062)
    proper_pair_max_dist: int = 750       # isPair (aligner.go:1062), exclusive
    unmapped_score_threshold: int = 19    # IsUnmapped: score-17 < 19 (aligner.go:141)
    unmapped_score_offset: int = 17
    active_molecule_min_reads: int = 4    # isActiveMolecule: active > 4 (aligner.go:1242)
    active_molecule_min_density: float = 0.1  # active/potential >= 0.1 (aligner.go:1245)
    molecule_birth_bonus: float = -3.0    # fastScore (aligner.go:1218,1224)
    molecule_potential_coeff: float = -0.5  # fastScore birth/death (aligner.go:1204,1212)
    reference_length: float = 3_200_000_000.0  # hard-coded (aligner.go:815)
    singleton_prob: float = 0.05          # calculateLogMoleculePenalty (aligner.go:751)
    mapq_top_k: int = 15                  # top-15 scores in normalization (aligner.go:896)
    mapq_cap: float = 60.0                # (aligner.go:907)
    max_reads_per_barcode: int = 30_000   # reader.go:236
    rfa_min_read_pairs: int = 5           # worthRunningRFA (aligner.go:1026)
    # The reference additionally requires the barcode to contain '-'
    # (aligner.go:1022-1024), a 10x-ism that disables RFA for the formats
    # Arachne targets (SURVEY.md 2.4).  We gate on valid+unique+>=5 pairs by
    # default and keep the quirk behind a flag for strict parity.
    require_dash_in_barcode: bool = False
    # Optimizer schedule: Optimize(model, 1, 2, 4*n_molecules) (aligner.go:493)
    anneal_start_temp: float = 1.0
    anneal_temp_steps: int = 2
    anneal_steps_per_temp_factor: int = 4
    # Split reads (split.go)
    split_min_uncovered: int = 15         # need >=15 uncovered bases (split.go:48)
    split_min_score: int = 36             # candidate score >= 36 (split.go:97)


@dataclass(frozen=True)
class IndexOptions:
    """FM-index construction/layout options."""

    occ_interval: int = 128     # bwt.h:36 OCC_INTERVAL (bwa layout)
    sa_interval: int = 32       # `bwa index` default (bwtindex.c)
    # SA representation: "full" keeps SA[] dense (fast lookups, 8 B/row —
    # ~50 GB for GRCh38 fwd+rev), "sampled" keeps every sa_interval-th
    # entry with bounded inverse-Psi walks (bwt_sa semantics, bwt.c:86-96).
    # "auto" keeps the full SA only below sa_full_max_len rows (2^26 rows
    # = 512 MB) — the genome-scale default used by `index` and by
    # build-on-demand in `align`.
    sa_mode: str = "auto"
    sa_full_max_len: int = 1 << 26
    # Construction algorithm: "sais" materializes the full int64 suffix
    # array in RAM via the memory-lean native SA-IS (native/sais.cpp;
    # peaks ~sais_bytes_per_row bytes per fwd+rev row); "incremental" is
    # the memory-proportional ropebwt-style dynamic-BWT build
    # (native/ropebwt.cpp; the reference's own answer above 50 Mbp,
    # bwtindex.c:271) — several times slower but ~0.3 B/row.  "auto" uses
    # sais below build_incremental_min_rows unconditionally, and above it
    # whenever /proc/meminfo MemAvailable covers the sais peak (a 128 GB
    # host builds GRCh38-scale in well under an hour; a small host
    # degrades gracefully to incremental instead of OOMing).
    build_mode: str = "auto"
    build_incremental_min_rows: int = 1_000_000_000
    sais_bytes_per_row: float = 13.0


@dataclass(frozen=True)
class PipelineOptions:
    """Batching/execution options for the device pipeline."""

    engine: str = "auto"          # "oracle" (scalar host), "tpu" (batched device engine), "auto"
    reads_per_batch: int = 4096   # read pairs per superbatch (device dispatch unit)
    num_workers: int = 2          # host worker threads (-t/--threads)
    checkpoint_path: Optional[str] = None
    # FM-index placement: "replicated" puts full tables on every device
    # (small genomes); "sharded" block-shards them across the mesh with
    # psum-merged rank lookups (parallel/mesh.py ShardedFMTables) — the
    # large-genome mode; "auto" shards only when the tables would not fit
    # replicated
    index_mode: str = "auto"


@dataclass(frozen=True)
class OutputOptions:
    """BAM/SAM emission options (main.go flags + bamwriter.go)."""

    position_chunk_size: int = 40_000_000  # -p/--partitions (main.go:31)
    read_groups: str = "sample:library:molecule:flowcell:lane"
    sample_id: str = "sample"
    debug_tags: bool = False
    emit_sam: bool = False        # write .sam instead of .bam (for testing)


@dataclass(frozen=True)
class ArachneConfig:
    """Top-level configuration; mirrors ArachneArgs (aligner.go:30-44)."""

    mem: MemOptions = field(default_factory=MemOptions)
    pes: InsertSizeModel = field(default_factory=InsertSizeModel)
    rfa: RFAOptions = field(default_factory=RFAOptions)
    index: IndexOptions = field(default_factory=IndexOptions)
    pipeline: PipelineOptions = field(default_factory=PipelineOptions)
    output: OutputOptions = field(default_factory=OutputOptions)
    centromeres: Optional[str] = None  # -c TSV path
    threads: int = 2
    debug: bool = False

    def replace(self, **kw) -> "ArachneConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = ArachneConfig()
