"""Taxonomic binning (oracle): read -> taxonomy-node assignment via LCA.

Replaces the reference's per-read Python tree walk (SURVEY.md L5, hot loop #2)
with a batched rule:

- a read's bin is the LCA of the taxa of all candidate pairs achieving exactly
  its best score (cfg.bin_score_delta = 0) with score >= cfg.min_score;
- unaligned reads get bin -1;
- for assembly, a leaf bin's read set = reads binned at the leaf plus reads
  binned at any ancestor (multi-mapped reads are shared down the tree, the
  RAMBL tree semantics per SURVEY.md section 2.1 L5).

The port's copy of `rambl_tpu/oracle/binning.py`, unchanged in behaviour.
"""

from __future__ import annotations

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.taxonomy import TaxonomyTables, lca_of_set
from rambl_tpu_torch.oracle.align import AlignmentResult


def bin_reads(res: AlignmentResult, tables: TaxonomyTables, cfg: PipelineConfig) -> np.ndarray:
    """Returns (B,) int32 bin node per read (-1 = unaligned)."""
    best = res.score[:, None]  # (B, 1)
    tied = (
        res.pair_valid
        & (res.pair_score >= cfg.min_score)
        & (res.pair_score >= best - cfg.bin_score_delta)
    )
    taxa = tables.ref_taxon[np.clip(res.pair_ref, 0, len(tables.ref_taxon) - 1)]
    lca = lca_of_set(tables, taxa, tied)
    return np.where(res.aligned, lca, -1).astype(np.int32)


def leaf_membership(
    bins: np.ndarray, leaf: int, tables: TaxonomyTables,
    share_depth: int | None = None,
) -> np.ndarray:
    """Bool mask of reads contributing to `leaf`: binned at the leaf or at an
    ancestor within `share_depth` ranks above it (None = unlimited - the
    classic share-down-the-tree rule; cfg.bin_share_depth bounds it for
    full-DB configs where root-binned conserved reads would join every
    leaf)."""
    dl = int(tables.depth[leaf])
    lo = 0 if share_depth is None else max(0, dl - share_depth)
    anc = set(int(tables.anc_path[leaf, d]) for d in range(lo, dl + 1))
    anc.add(leaf)
    return np.isin(bins, list(anc))
