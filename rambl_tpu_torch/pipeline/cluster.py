"""Batched DP-means clustering over leaf bins.

Port of `rambl_tpu/pipeline/cluster.py`, bit-identical to it and to
oracle.cluster.dp_means (integer distance arithmetic, same spawn/merge
rules - see that module's docstring):

- membership tables are built from bin nodes + ancestor paths (static cap
  max_bin_reads members per leaf, ascending read index), as the union of the
  leaf's ancestor-node ranges in the bin-sorted read order;
- per-member features are the member's base at each polymorphic column,
  read from a (leaves, members, ref_len) plane of base + 1;
- all leaves of a block iterate together for dp_max_iters steps, each leaf's
  state frozen once it converges (the oracle's early break);
- every count is an integer count (one-hot sums, `index_add_`), never a float
  matmul, and every argmax/argmin takes the first index on ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.taxonomy import MAX_DEPTH
from rambl_tpu_torch.utils import trace

_BIG = 1 << 30


def bin_sort(bins: torch.Tensor, n_nodes: int):
    """Sort reads by bin node for range-based membership.

    Returns (order (B,) int32 read indices sorted by (bin, read idx),
             node_start (n_nodes,), node_end (n_nodes,)) - the contiguous
    range of sorted positions holding each node's reads. Unaligned reads
    (bin -1) sort first and fall outside every node range."""
    order = torch.argsort(bins, stable=True)
    bins_sorted = bins[order].contiguous()
    nodes = torch.arange(n_nodes, dtype=bins.dtype, device=bins.device)
    node_start = torch.searchsorted(bins_sorted, nodes, right=False)
    node_end = torch.searchsorted(bins_sorted, nodes, right=True)
    return (order.to(torch.int32), node_start.to(torch.int32),
            node_end.to(torch.int32))


def member_table_ranges(order: torch.Tensor, node_start: torch.Tensor,
                        node_end: torch.Tensor, leaves: torch.Tensor,
                        anc_path: torch.Tensor, depth: torch.Tensor,
                        max_members: int, share_depth: int = MAX_DEPTH):
    """(NL, M) member read indices (ascending) + (NL, M) valid mask.

    A read is a member of a leaf iff its bin is on the leaf's ancestor chain
    within share_depth ranks (leaf itself included) -
    oracle.binning.leaf_membership. A leaf's members are the union of its
    ancestor-node ranges (depths [depth-share_depth, depth]) in the
    bin-sorted read order. Each range is ascending in read index (stable
    sort), so the first max_members of the merged union are the first
    members by read index. O(NL * W * M) with W = share_depth+1.

    In-window path nodes are a unique real chain
    (taxonomy.build_taxonomy_tables pads only BEYOND depth(leaf)); the
    window clipped at the root can repeat a node for shallow leaves, and
    each range is counted once."""
    B = order.shape[0]
    M = max_members
    D = anc_path.shape[1]
    W = min(share_depth + 1, D)
    dev = order.device
    lv = leaves.long()
    dl = depth[lv][:, None]                                       # (NL, 1)
    didx = dl - (W - 1) + torch.arange(W, dtype=torch.int32,
                                       device=dev)[None, :]       # (NL, W)
    w_ok = didx >= 0
    paths = torch.gather(anc_path[lv], 1,
                         torch.clamp(didx, 0, D - 1).long())      # (NL, W)
    # a duplicate only suppresses against an earlier USABLE column - the
    # clipped out-of-window copies must not shadow the real depth-0 range
    first = torch.ones_like(paths, dtype=torch.bool)
    for d in range(1, W):
        dup = ((paths[:, d:d + 1] == paths[:, :d]) & w_ok[:, :d]).any(dim=1)
        first[:, d] = ~dup
    use = w_ok & first
    pl = paths.long()
    starts = node_start[pl]                                       # (NL, W)
    cnt = torch.where(use, node_end[pl] - starts, 0)              # (NL, W)
    k = torch.arange(M, dtype=torch.int32, device=dev)
    pos = starts[:, :, None] + k[None, None, :]                   # (NL, W, M)
    valid = k[None, None, :] < cnt[:, :, None]
    cand = torch.where(valid, order[torch.clamp(pos, 0, B - 1).long()], _BIG)
    sortedk = torch.sort(cand.reshape(paths.shape[0], -1), dim=1).values
    sortedk = sortedk[:, :M]
    ok = sortedk < _BIG
    return torch.where(ok, sortedk, 0), ok


def feature_columns(poly_mask: torch.Tensor, max_poly_cols: int):
    """The first max_poly_cols polymorphic columns of each leaf, ascending:
    (pol_cols (NL, P) int32, 0 where not valid; pol_valid (NL, P) bool)."""
    ref_len = poly_mask.shape[1]
    cols = torch.arange(ref_len, dtype=torch.int32, device=poly_mask.device)
    key = torch.where(poly_mask, cols[None, :], _BIG)
    pol_cols = torch.topk(key, max_poly_cols, dim=1, largest=False,
                          sorted=True).values
    pol_valid = pol_cols < _BIG
    return torch.where(pol_valid, pol_cols, 0), pol_valid


def leaf_features_dense(qm: torch.Tensor, rcm: torch.Tensor,
                        member_valid: torch.Tensor, pol_cols: torch.Tensor,
                        pol_valid: torch.Tensor,
                        ref_len: int) -> torch.Tensor:
    """feat (NL, M, P) int8: member base at each polymorphic column, -1
    where the member does not cover it (or is not a member, or the column
    is not valid).

    Each member's bases scatter as base + 1 into a (NL, M, ref_len) int8
    plane with amax (0 = uncovered; invalid positions contribute 0, so they
    never mask a real base that shares their clipped column, and two
    positions projected onto one column keep the larger base, as the
    reference's .at[].max does), then the plane is read at pol_cols."""
    NL, M, L = qm.shape
    rc = rcm.to(torch.int32)
    ok = (rc >= 0) & (qm < 4)
    col = torch.clamp(rc, 0, ref_len - 1).long().reshape(NL * M, L)
    val = torch.where(ok, qm + 1, 0).to(torch.int8).reshape(NL * M, L)
    dense = torch.zeros((NL * M, ref_len), dtype=torch.int8, device=qm.device)
    dense.scatter_reduce_(1, col, val, reduce="amax", include_self=True)
    pc = torch.clamp(pol_cols, 0, ref_len - 1).long()             # (NL, P)
    g = torch.gather(dense.reshape(NL, M, ref_len), 2,
                     pc[:, None, :].expand(NL, M, pc.shape[1]))   # (NL, M, P)
    keep = (g > 0) & member_valid[:, :, None] & pol_valid[:, None, :]
    return torch.where(keep, g - 1, -1).to(torch.int8)


class DPMeansOut(NamedTuple):
    assign: torch.Tensor    # (NL, M) int32 cluster id per member
    centers: torch.Tensor   # (NL, K, P) int8
    kact: torch.Tensor      # (NL,) int32 active cluster count


def _consensus_counts(feat: torch.Tensor) -> torch.Tensor:
    """Per-column base counts (..., P, 4) int32 over every read of feat
    (..., M, P) (uncovered -1 counts nowhere)."""
    b = torch.arange(4, dtype=torch.int8, device=feat.device)
    return (feat[..., None] == b).sum(dim=-3, dtype=torch.int32)


def dp_means_leaves(feat: torch.Tensor, can_seed: torch.Tensor,
                    cfg: PipelineConfig) -> DPMeansOut:
    """DP-means for every leaf of a block at once. feat (NL, M, P) int8 (-1 =
    uncovered; invalid member rows are all -1); can_seed (NL, M) bool
    restricts spawn seeds/support to leaf-exclusive reads. Mirrors
    oracle.cluster.dp_means exactly: dp_max_iters iterations run for every
    leaf, and a leaf's state stays as it is from the iteration after it
    converged (no host read per iteration). torch.argmax/argmin return the
    first index on ties, as the oracle's do; bool rows are cast first (a row
    with no True gives 0). The (NL, M, K, P) and (NL, dp_spawn_scan, M, P)
    bool temporaries bound a block's memory (cfg.cluster_leaf_block).

    While the recorder (`utils.trace`) is on, the block's wasted work is
    counted: `dp.recount_adds` (the center recount's atomic adds, NL * M * P
    an iteration) and `dp.recount_inert_adds` (those sent to its one inert
    slot: uncovered columns and invalid member rows), `dp.leaf_iters` and
    `dp.frozen_leaf_iters` (leaf iterations run after the leaf converged),
    `dp.block_iters` and `dp.tail_iters` (iterations run after every leaf
    converged). Each leaf's convergence iteration is kept on the device;
    the counts are read with the block's outputs. The results are the same
    with the recorder on or off."""
    NL, M, P = feat.shape
    K = cfg.max_clusters_per_bin
    S = cfg.dp_spawn_scan
    lam_n, lam_d = cfg.dp_lambda_num, cfg.dp_lambda_den
    dev = feat.device
    i32 = torch.int32
    rows = torch.arange(NL, device=dev)
    kk = torch.arange(K, dtype=i32, device=dev)
    midx = torch.arange(M, dtype=i32, device=dev)

    cov = feat >= 0                                         # (NL, M, P)
    ncov = cov.sum(dim=2, dtype=i32)                        # (NL, M)

    # fallback = bin consensus (argmax counts; ties lowest base; empty -> 0)
    cnt_all = _consensus_counts(feat)                       # (NL, P, 4)
    fallback = torch.where(cnt_all.sum(dim=2) > 0,
                           torch.argmax(cnt_all, dim=2), 0).to(torch.int8)

    centers = torch.zeros((NL, K, P), dtype=torch.int8, device=dev)
    centers[:, 0] = fallback
    assign = torch.zeros((NL, M), dtype=i32, device=dev)
    kact = torch.ones((NL,), dtype=i32, device=dev)
    done = torch.zeros((NL,), dtype=torch.bool, device=dev)
    # flat (leaf, cluster, column, base) slots of the center counts; a
    # member's uncovered columns go to the one inert slot at the end
    n_cnt = NL * K * P * 4
    pcol = torch.arange(P, device=dev)
    fbase = torch.where(feat >= 0, feat.long(), 0)
    fslot_base = pcol * 4 + fbase                           # (NL, M, P)
    iters = cfg.dp_max_iters
    counting = trace.on()
    if counting:
        # the iterations each leaf ran until it converged
        conv = torch.full((NL,), iters, dtype=i32, device=dev)

    for it in range(iters):
        eq = feat[:, :, None, :] == centers[:, None, :, :]  # (NL, M, K, P)
        diff = ((~eq) & cov[:, :, None, :]).sum(dim=3, dtype=i32)
        diff = torch.where(kk[None, None, :] < kact[:, None, None], diff, _BIG)
        new_assign = torch.argmin(diff, dim=2)              # (NL, M) int64
        dmin = torch.gather(diff, 2, new_assign[:, :, None])[:, :, 0]
        new_assign = new_assign.to(i32)
        orphans = (dmin * lam_d > lam_n * ncov) & can_seed  # (NL, M)
        n_orph = orphans.sum(dim=1)
        can_spawn = (n_orph >= cfg.dp_spawn_min_orphans) & (kact < K)

        # first S orphan indices (ascending read index; _BIG = none)
        okey = torch.where(orphans, midx[None, :], _BIG)
        seeds = torch.topk(okey, S, dim=1, largest=False,
                           sorted=True).values              # (NL, S)
        sidx = torch.clamp(seeds, 0, M - 1).long()
        fv = feat[rows[:, None], sidx]                      # (NL, S, P)
        common = cov[:, None, :, :] & (fv >= 0)[:, :, None, :]
        ncom = common.sum(dim=3, dtype=i32)                 # (NL, S, M)
        dc = ((feat[:, None, :, :] != fv[:, :, None, :]) & common).sum(
            dim=3, dtype=i32)
        supp = (orphans[:, None, :] & (ncom > 0)
                & (dc * lam_d <= lam_n * ncom)).sum(dim=2, dtype=i32)
        supports = torch.where(seeds < _BIG, supp, 0)       # (NL, S)
        good = supports >= cfg.dp_spawn_min_orphans
        any_good = good.any(dim=1) & can_spawn
        first = torch.argmax(good.to(i32), dim=1)           # first good seed
        cand = torch.clamp(seeds[rows, first], 0, M - 1).long()

        # the spawned center (the seed's bases) is not written: the recount
        # below replaces every center, and the seed now counts in it
        na = new_assign.clone()
        na[rows, cand] = kact
        new_assign = torch.where(any_good[:, None], na, new_assign)
        kact_new = kact + any_good.to(i32)

        # recompute centers: integer counts per (k, p, base)
        flat = ((rows[:, None, None] * K + new_assign[:, :, None].long())
                * (P * 4) + fslot_base)
        flat = torch.where(feat >= 0, flat, n_cnt).reshape(-1)
        cnt = torch.zeros((n_cnt + 1,), dtype=i32, device=dev)
        cnt.index_add_(0, flat, torch.ones_like(flat, dtype=i32))
        cnt = cnt[:-1].reshape(NL, K, P, 4)
        has = cnt.sum(dim=3) > 0
        cen_new = torch.where(has, torch.argmax(cnt, dim=3),
                              fallback[:, None, :].long()).to(torch.int8)
        cen_new = torch.where(kk[None, :, None] < kact_new[:, None, None],
                              cen_new, 0).to(torch.int8)
        changed = (new_assign != assign).any(dim=1) | any_good

        # converged leaves keep their state
        centers = torch.where(done[:, None, None], centers, cen_new)
        assign = torch.where(done[:, None], assign, new_assign)
        kact = torch.where(done, kact, kact_new)
        if counting:
            conv = torch.where(done | changed, conv, it + 1)
        done = done | ~changed

    if counting:
        trace.count("dp.block_iters", iters)
        trace.count("dp.leaf_iters", NL * iters)
        trace.count("dp.recount_adds", NL * M * P * iters)
        trace.count("dp.recount_inert_adds", (~cov).sum() * iters)
        trace.count("dp.frozen_leaf_iters", (iters - conv).sum())
        trace.count("dp.tail_iters", iters - conv.max() if NL else iters)

    # merge identical active centers, compact ids in first-seen order
    same = (centers[:, :, None, :] == centers[:, None, :, :]).all(dim=3)
    active = kk[None, :] < kact[:, None]                    # (NL, K)
    same = same & active[:, :, None] & active[:, None, :]
    # canon[k] = smallest j with same[k, j] (j <= k always qualifies via k==k)
    canon = torch.argmax(same.to(i32), dim=2).to(i32)       # (NL, K)
    keep = canon == kk[None, :]
    remap = torch.cumsum(keep.to(i32), dim=1).to(i32) - 1   # new id per kept k
    ca = torch.gather(canon, 1, assign.long())
    assign = torch.gather(remap, 1, ca.long())
    kact2 = keep.sum(dim=1, dtype=i32)
    # compact centers: kept centers in order
    order_key = torch.where(keep, kk[None, :], _BIG)
    order = torch.topk(order_key, K, dim=1, largest=False, sorted=True).values
    centers2 = centers[rows[:, None], torch.clamp(order, 0, K - 1).long()]
    centers2 = torch.where(kk[None, :, None] < kact2[:, None, None], centers2,
                           0).to(torch.int8)
    return DPMeansOut(assign=assign, centers=centers2, kact=kact2)
