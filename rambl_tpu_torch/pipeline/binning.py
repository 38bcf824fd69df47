"""Taxonomic binning: LCA over each read's tied candidate references.

Port of `rambl_tpu/pipeline/binning.py`, bit-identical to it and to
`rambl_tpu_torch.index.taxonomy.lca_of_set`: candidate taxa are gathered through
the dense ancestor-path table and the LCA is the deepest depth at which all
valid candidates' paths agree.
"""

from __future__ import annotations

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.taxonomy import MAX_DEPTH
from rambl_tpu_torch.pipeline.align import AlignRecords


def lca_of_set(anc_path: torch.Tensor, depth: torch.Tensor,
               nodes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """anc_path (N, D) int32, depth (N,) int32; nodes (..., C) int32 and
    valid (..., C) bool -> (...,) int32 LCA (0 where nothing is valid)."""
    nodes = nodes.long()
    paths = anc_path[nodes]                                   # (..., C, D)
    depths = depth[nodes]                                     # (..., C)
    any_valid = valid.any(dim=-1)
    first_idx = torch.argmax(valid.to(torch.int32), dim=-1)   # first valid
    gidx = first_idx[..., None, None].expand(*first_idx.shape, 1, MAX_DEPTH)
    first_path = torch.gather(paths, -2, gidx).squeeze(-2)    # (..., D)
    eff_paths = torch.where(valid[..., None], paths, first_path[..., None, :])
    agree = (eff_paths == first_path[..., None, :]).all(dim=-2)
    min_depth = torch.where(valid, depths, 1 << 30).amin(dim=-1)
    min_depth = torch.clamp(min_depth, max=MAX_DEPTH - 1)
    dd = torch.arange(MAX_DEPTH, dtype=torch.int32, device=nodes.device)
    prefix_agree = torch.cumprod(agree.to(torch.int32), dim=-1) > 0
    ok = prefix_agree & (dd <= min_depth[..., None])
    best_d = torch.clamp(torch.where(ok, dd, -1).amax(dim=-1), min=0)
    lca = torch.gather(first_path, -1, best_d[..., None].long()).squeeze(-1)
    return torch.where(any_valid, lca, 0).to(torch.int32)


def bin_batch(res: AlignRecords, ref_taxon: torch.Tensor,
              anc_path: torch.Tensor, depth: torch.Tensor,
              cfg: PipelineConfig) -> torch.Tensor:
    """(B,) int32 bin node per read (-1 = unaligned)."""
    best = res.score[:, None]
    tied = (res.pair_valid
            & (res.pair_score >= cfg.min_score)
            & (res.pair_score >= best - cfg.bin_score_delta))
    taxa = ref_taxon[torch.clamp(res.pair_ref, 0,
                                 ref_taxon.shape[0] - 1).long()]
    lca = lca_of_set(anc_path, depth, taxa, tied)
    return torch.where(res.aligned, lca, -1).to(torch.int32)
