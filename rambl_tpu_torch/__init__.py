"""rambl_tpu_torch: the PyTorch + CUDA port of rambl_tpu for NVIDIA Hopper.

The JAX package `rambl_tpu` stays the reference; this package reproduces its
outputs bit for bit and imports nothing of it (nor jax). The host layers it
needs are its own copies, under the reference's module names, held equal to
the originals by tests/test_torch_host_layers.py: `config`,
`utils.{errors,checkpoint,metrics}`, `io.{pack,fasta,loader}`,
`index.{builder,taxonomy,colmap,greengenes}`, `data.simulate` and
`oracle.{sw,seed,align,binning,cluster,consensus,pipeline,polish,cohort}`.

Layout mirrors `rambl_tpu`:

- `ops.sw`: plain PyTorch Smith-Waterman (score, direction bits,
  traceback, raw best key), the twin of every SW kernel and the CPU path;
- `ops.sw_cuda`: hand-written CUDA kernels K1-K3 for sm_90a
  (`csrc/sw.cu`), built with nvcc at first use;
- `ops.sw_variants`: the K1 variant kernel (S1) and K1 on pre-transposed
  inputs (S2) (`csrc/sw_variants.cu`), for the bench scripts;
- `ops.seed`: k-mer hashing, CSR probe, candidate voting, window gather;
- `pipeline.align` / `binning` / `pileup`: the per-batch align step, LCA
  binning, node-space and slot-compacted pileup accumulators and their
  per-leaf merge;
- `pipeline.cluster` / `consensus`: membership tables, features and
  DP-means over a block of leaves; cluster and minor-haplotype consensus;
- `pipeline.assemble.stream_align`: the batch stream over a whole read set,
  on one device or data-parallel over a `parallel.mesh.DataMesh`;
- `pipeline.assemble.assemble_round`: one round of the assembly (stream,
  slot selection, clustering, consensus) -> genes;
- `pipeline.assemble.assemble` / `polish` / `assemble_cohort`: the whole
  assembly (refinement rounds, polish, checkpoints and resume, cohort
  phasing) -> final genes; `cli`: its command line; each on one device or
  data-parallel over a mesh (`mesh=`, `--mesh`);
- `parallel.mesh` / `ring` / `ring_dma` / `steps`: the mesh of ranks and
  the multi-host setup, the ring-sharded seed index, its rotation K4
  (`csrc/ring.cu`) with the plain `copy_` version, and the round's mesh
  steps (stream, merges, slot pileup, leaf-sharded clustering);
- `bench`, `scripts.bench_sw_variants`, `scripts.ablate_prep`: the bench
  entry points; `graft_entry`: the entry hooks (`entry`,
  `dryrun_multichip`); `scripts.profile_cluster`,
  `scripts.bench_align_scale`, `scripts.check_ring_dma`: the card tools.

Each package exports the names its reference counterpart exports
(`PipelineConfig`, `io.read_fasta`, `ops.sw_score`, ...).

Entry points run on the first CUDA card unless the caller passes a device
("cpu" for the plain PyTorch path); nothing falls back from the card to the
CPU on its own (`device.require_cuda`).
"""

__version__ = "0.3.0"

from rambl_tpu_torch.config import (  # noqa: F401
    PRESETS,
    PipelineConfig,
    ScoringParams,
)
