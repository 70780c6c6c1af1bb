"""arachne-tpu: a linked-read aligner on JAX, for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
pdimens/arachne (the Go+BWA successor of 10x Genomics Lariat): barcode-joint
alignment of paired-end linked reads (haplotagging / stLFR / TELLseq) with
molecule inference (RFA) and molecule-aware MAPQ, emitting sharded BAM/SAM.

Layers (bottom to top; see SURVEY.md for the reference layer map):

  index/     FM-index construction + queries (replaces bwt.c/bntseq.c/bwa.c)
  align/     candidate generation: SMEM seeding, chaining, extension DP,
             mate rescue, CIGAR (replaces bwamem.c/bwamem_pair.c/ksw.c)
  ops/       batched device DP (XLA) and device rank queries; the
             batched engine
  rfa/       barcode-joint molecule inference, optimizer, MAPQ, dup, split
             (replaces src/aligner + src/optimizer)
  io/        FASTQ streaming/barcode grouping, format standardization,
             BAM/SAM sharded writers (replaces src/fastqreader + bamwriter)
  parallel/  device mesh, sharded index, multi-host data parallelism
"""

__version__ = "0.1.0"
