"""Consensus calling: (cluster, column, base) count tensors -> calls.

Port of `rambl_tpu/pipeline/consensus.py`, bit-identical to it; matches
oracle.consensus / oracle.pipeline's variant-aware merging exactly:

- counts_eff[col] = cluster counts at trusted polymorphic columns (depth >=
  min_coverage AND unique argmax), bin-wide counts elsewhere; span (deletion)
  evidence always comes from the same population that voted the bases;
- a column is emitted iff it has base coverage, deletions do not outnumber
  bases, and it lies within [first, last] covered column;
- the called base is argmax (ties -> lowest code).

Sequences stay as fixed-width (called, emit) tensors on the device; the host
compacts them to ragged gene sequences (panel management is host logic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.taxonomy import MAX_DEPTH
from rambl_tpu_torch.pipeline.cluster import _BIG
from rambl_tpu_torch.pipeline.pileup import chain_use_mask


class ConsensusOut(NamedTuple):
    called: torch.Tensor   # (..., ref_len) int8 argmax base
    emit: torch.Tensor     # (..., ref_len) bool
    n_reads: torch.Tensor  # (...,) int32 population size behind each call


def call_consensus(counts_eff: torch.Tensor, span_eff: torch.Tensor):
    """(..., ref_len, 4) counts + (..., ref_len) span -> (called int8,
    emit bool), both (..., ref_len)."""
    ref_len = counts_eff.shape[-2]
    base_cover = counts_eff.sum(dim=-1).to(torch.int32)
    covered = base_cover > 0
    any_cov = covered.any(dim=-1)
    # first True (argmax takes the first index on ties; bool cast first)
    lo = torch.argmax(covered.to(torch.int32), dim=-1)
    hi = ref_len - 1 - torch.argmax(covered.flip(-1).to(torch.int32), dim=-1)
    dele = span_eff - base_cover
    cols = torch.arange(ref_len, device=counts_eff.device)
    emit = (
        covered
        & (dele <= base_cover)
        & (cols >= lo[..., None])
        & (cols <= hi[..., None])
        & any_cov[..., None]
    )
    called = torch.argmax(counts_eff, dim=-1).to(torch.int8)
    return called, emit


def _unique_top(counts: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> bool: strictly unique argmax."""
    srt = torch.sort(counts, dim=-1).values
    return srt[..., -1] > srt[..., -2]


def _use_cluster(poly_mask, counts_k, counts_all, cfg: PipelineConfig):
    """Columns where the cluster/exclusive population may override the
    backbone: polymorphic, minimum depth, unique winner, and at least
    vote_min_frac of the backbone's depth (oracle.pipeline rules)."""
    dk = counts_k.sum(dim=-1).to(torch.int32)
    dall = counts_all.sum(dim=-1).to(torch.int32)
    top = counts_k.amax(dim=-1)
    strong = (
        (dk * cfg.vote_min_frac_den >= cfg.vote_min_frac_num * dall)
        | (top >= cfg.vote_min_abs)
    )
    return (
        poly_mask
        & (dk >= cfg.min_coverage)
        & strong
        & _unique_top(counts_k)
    )


def cluster_consensus_leaves(
    q: torch.Tensor,              # (NL, M, L) int8 member query codes
    rc: torch.Tensor,             # (NL, M, L) int32 member columns
    valid: torch.Tensor,          # (NL, M)
    assign: torch.Tensor,         # (NL, M) int32
    poly_mask: torch.Tensor,      # (NL, ref_len) bool
    counts_all: torch.Tensor,     # (NL, ref_len, 4) leaf pileup
    span_all: torch.Tensor,       # (NL, ref_len)
    cfg: PipelineConfig,
) -> ConsensusOut:
    """Per-leaf cluster pileup + variant-aware consensus (round 0), for every
    leaf of a block at once."""
    NL, M, L = q.shape
    K = cfg.max_clusters_per_bin
    ref_len = counts_all.shape[1]
    dev = q.device
    one = torch.ones((), dtype=torch.int32, device=dev)

    ok = (rc >= 0) & (q < 4) & valid[:, :, None]
    lk = (torch.arange(NL, device=dev)[:, None] * K
          + torch.clamp(assign, 0, K - 1).long())          # (NL, M)
    col = torch.clamp(rc, 0, ref_len - 1).long()
    base = torch.clamp(q, 0, 3).long()
    n_cnt = NL * K * ref_len * 4
    flat = (lk[:, :, None] * ref_len + col) * 4 + base
    flat = torch.where(ok, flat, n_cnt).reshape(-1)
    cnt = torch.zeros((n_cnt + 1,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, flat, one.expand(flat.shape[0]))
    counts_k = cnt[:-1].reshape(NL, K, ref_len, 4)

    has = ok.any(dim=2)
    lo_r = torch.where(ok, rc, _BIG).amin(dim=2)
    hi_r = torch.where(ok, rc, -1).amax(dim=2)
    sentinel = NL * K * (ref_len + 1)
    lo_flat = torch.where(has, lk * (ref_len + 1)
                          + torch.clamp(lo_r, 0, ref_len), sentinel)
    hi_flat = torch.where(has, lk * (ref_len + 1)
                          + torch.clamp(hi_r + 1, 0, ref_len), sentinel)
    sp = torch.zeros((sentinel + 1,), dtype=torch.int32, device=dev)
    sp.index_add_(0, lo_flat.reshape(-1), one.expand(NL * M))
    sp.index_add_(0, hi_flat.reshape(-1), -one.expand(NL * M))
    span_k = torch.cumsum(sp[:-1].reshape(NL, K, ref_len + 1)[..., :-1],
                          dim=-1).to(torch.int32)

    use_k = _use_cluster(poly_mask[:, None, :], counts_k,
                         counts_all[:, None], cfg)
    counts_eff = torch.where(use_k[..., None], counts_k, counts_all[:, None])
    span_eff = torch.where(use_k, span_k, span_all[:, None])
    called, emit = call_consensus(counts_eff, span_eff)

    kk = torch.arange(K, dtype=torch.int32, device=dev)
    nk = ((assign[:, None, :] == kk[None, :, None])
          & valid[:, None, :]).sum(dim=2, dtype=torch.int32)
    return ConsensusOut(called=called, emit=emit, n_reads=nk)


class MinorHap(NamedTuple):
    """Per-leaf minor-haplotype consensus (frequency phasing; see
    oracle.pipeline's minor-haplotype rule and config.minorhap_*)."""

    called: torch.Tensor   # (NL, ref_len) int8
    emit: torch.Tensor     # (NL, ref_len) bool
    n_reads: torch.Tensor  # (NL,) int32 min qualifying minor depth
    n_cols: torch.Tensor   # (NL,) int32 qualifying columns


def minor_haplotype_leaves(
    excl_counts: torch.Tensor,   # (NL, ref_len, 4) leaf-EXCLUSIVE pileup
    leaf_counts: torch.Tensor,   # (NL, ref_len, 4) chain-merged backbone
    leaf_span: torch.Tensor,     # (NL, ref_len)
    cfg: PipelineConfig,
) -> MinorHap:
    """Substitute the leaf-exclusive second allele at every qualifying column
    of the backbone consensus. All thresholds integer-exact."""
    tot_ex = excl_counts.sum(dim=-1).to(torch.int32)
    srt = torch.sort(excl_counts, dim=-1).values
    mm = srt[..., -2]
    qual = (
        (tot_ex >= cfg.min_coverage)
        & (mm >= cfg.minorhap_min_abs)
        & (mm * cfg.minorhap_max_den <= cfg.minorhap_max_num * tot_ex)
        & (mm * cfg.minorhap_frac_den >= cfg.minorhap_frac_num * tot_ex)
        & (srt[..., -2] > srt[..., -3])
    )
    b1 = torch.argmax(excl_counts, dim=-1)
    lanes = torch.arange(4, device=excl_counts.device)
    c2 = torch.where(lanes == b1[..., None], -1, excl_counts)
    b2 = torch.argmax(c2, dim=-1)                       # unique where qual
    tot_all = leaf_counts.sum(dim=-1).to(torch.int32)
    counts_mh = torch.where(
        qual[..., None],
        torch.where(lanes == b2[..., None], tot_all[..., None], 0),
        leaf_counts,
    )
    called, emit = call_consensus(counts_mh, leaf_span)
    n_cols = qual.sum(dim=-1, dtype=torch.int32)
    n_reads = torch.where(qual, mm, _BIG).amin(dim=-1).to(torch.int32)
    return MinorHap(called=called, emit=emit, n_reads=n_reads, n_cols=n_cols)


def _chain_read_count(read_count, nodes, anc_path, depth,
                      share_depth=None) -> torch.Tensor:
    """Reads binned on each node's ancestor chain within share_depth ranks
    (leaf membership count without materializing per-read masks)."""
    paths = anc_path[nodes.long()].long()
    use = chain_use_mask(
        nodes, depth, MAX_DEPTH if share_depth is None else share_depth)
    return (read_count[paths] * use).sum(dim=1).to(torch.int32)
