"""The benchmark's plain reference of the assembly's semantics.

Plain NumPy (and plain PyTorch for one table scan), frozen copies of the
repository's executable specification: seeding over a hashed k-mer table,
the banded affine-gap Smith-Waterman and its traceback, LCA binning,
anchor column maps by global alignment, node pileups and read counts, and
one leaf's round-0 clustering (DP-means) and consensus with its
minor-haplotype gene. It imports nothing of `jax`, `rambl_tpu` or
`rambl_tpu_torch`, and takes nothing the port made: it works out its own
seed table, taxonomy paths and column maps from the panel.
"""
