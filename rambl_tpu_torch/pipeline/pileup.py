"""Node-space pileup accumulators and their per-leaf merge.

Port of `rambl_tpu/pipeline/pileup.py`, bit-identical to it. Each read
scatters its aligned bases into its bin node's (column, base) counts, and its
aligned span into a +1/-1 interval-difference row. A leaf bin's pileup is the
sum over the leaf's ancestor chain (reads are shared down the tree, within
share_depth ranks), the span rows cumsummed after the merge. Slot mode keeps
accumulators only for the nodes on active leaves' chains. A scatter takes
the reads in chunks of the reference's `_SCATTER_ROW_CHUNK` rows, each
added into the accumulators in place; integer `index_add_` is exact in
any order, so the chunks change no bit.
"""

from __future__ import annotations

import torch

from rambl_tpu_torch.index.taxonomy import MAX_DEPTH


#: reads a scatter pass takes at once (the reference's row chunk). A pass
#: holds ~33 B of temporaries a read column (int64 flat indices, int32
#: columns and bases, masks), so one pass over a 20 M-read retention asked
#: for ~84 GB and ran the 80 GB card out of memory (config 5, 20 M reads);
#: 512Ki rows bound them at ~2.2 GB.
_SCATTER_ROW_CHUNK = 1 << 19


def _scatter_rows(query, ref_col, bins, n_nodes: int, ref_len: int,
                  counts: torch.Tensor, span: torch.Tensor) -> None:
    """Add one chunk of reads into the flat accumulators, in place."""
    B, L = query.shape
    dev = query.device
    ref_col = ref_col.to(torch.int32)    # retention keeps it as int16
    ok = (ref_col >= 0) & (query < 4) & (bins[:, None] >= 0)
    node = torch.clamp(bins, 0, n_nodes - 1)[:, None].expand(B, L)
    col = torch.clamp(ref_col, 0, ref_len - 1)
    base = torch.clamp(query, 0, 3).to(torch.int32)

    n_cnt = n_nodes * ref_len * 4
    flat = ((node.to(torch.int64) * ref_len + col) * 4 + base)
    flat = torch.where(ok, flat, n_cnt).reshape(-1)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))

    # span: per read lo/hi of aligned columns
    has = ok.any(dim=1)
    masked_lo = torch.where(ok, ref_col, 1 << 30).amin(dim=1)
    masked_hi = torch.where(ok, ref_col, -1).amax(dim=1)
    node1 = torch.clamp(bins, 0, n_nodes - 1).to(torch.int64)
    sentinel = n_nodes * (ref_len + 1)
    lo_flat = torch.where(has, node1 * (ref_len + 1)
                          + torch.clamp(masked_lo, 0, ref_len), sentinel)
    hi_flat = torch.where(has, node1 * (ref_len + 1)
                          + torch.clamp(masked_hi + 1, 0, ref_len), sentinel)
    one = torch.ones((B,), dtype=torch.int32, device=dev)
    span.index_add_(0, lo_flat, one)
    span.index_add_(0, hi_flat, -one)


def _scatter_flat(query: torch.Tensor, ref_col: torch.Tensor,
                  bins: torch.Tensor, n_nodes: int, ref_len: int):
    """Scatter every read in flat index space, _SCATTER_ROW_CHUNK reads a
    pass -> (counts (n_nodes*ref_len*4+1,), span (n_nodes*(ref_len+1)+1,))
    int32; the last element of each is the inert overflow slot."""
    dev = query.device
    counts = torch.zeros((n_nodes * ref_len * 4 + 1,), dtype=torch.int32,
                         device=dev)
    span = torch.zeros((n_nodes * (ref_len + 1) + 1,), dtype=torch.int32,
                       device=dev)
    ck = _SCATTER_ROW_CHUNK
    for s in range(0, query.shape[0], ck):
        _scatter_rows(query[s:s + ck], ref_col[s:s + ck], bins[s:s + ck],
                      n_nodes, ref_len, counts, span)
    return counts, span


def node_pileup(query: torch.Tensor, ref_col: torch.Tensor,
                bins: torch.Tensor, n_nodes: int, ref_len: int):
    """Scatter reads into node space -> (counts (n_nodes, ref_len*4) int32,
    flat (column, base) rows; span_diff (n_nodes, ref_len+1) int32, the
    un-cumsummed interval-difference rows)."""
    counts, span = _scatter_flat(query, ref_col, bins, n_nodes, ref_len)
    return (counts[:-1].reshape(n_nodes, ref_len * 4),
            span[:-1].reshape(n_nodes, ref_len + 1))


def chain_use_mask(leaves: torch.Tensor, depth: torch.Tensor,
                   share_depth: int = MAX_DEPTH) -> torch.Tensor:
    """(NL, MAX_DEPTH) bool: which anc_path depths contribute to each leaf -
    depths in [depth(leaf) - share_depth, depth(leaf)] (the bounded
    share-down-the-tree window, oracle.binning.leaf_membership)."""
    dd = torch.arange(MAX_DEPTH, dtype=torch.int32, device=depth.device)
    dl = depth[leaves.long()][:, None]
    return (dd[None, :] <= dl) & (dd[None, :] >= dl - share_depth)


def _chain_sum(counts: torch.Tensor, span_diff: torch.Tensor,
               rows: torch.Tensor, use: torch.Tensor):
    """Sum the rows[l, d] with use[l, d] of the flat counts and span rows ->
    (leaf_counts (NL, ref_len, 4), leaf_span (NL, ref_len)) int32, the span
    cumsummed. Sums wrap to int32 as the reference's do."""
    NL = rows.shape[0]
    ref_len = counts.shape[1] // 4
    u = use[:, :, None].to(torch.int32)
    leaf_counts = (counts[rows] * u).sum(dim=1).to(torch.int32)
    leaf_span_diff = (span_diff[rows] * u).sum(dim=1).to(torch.int32)
    leaf_span = torch.cumsum(leaf_span_diff[:, :-1], dim=1).to(torch.int32)
    return leaf_counts.reshape(NL, ref_len, 4), leaf_span


def leaf_pileup(counts: torch.Tensor, span_diff: torch.Tensor,
                leaves: torch.Tensor, anc_path: torch.Tensor,
                depth: torch.Tensor, share_depth: int = MAX_DEPTH):
    """Merge ancestor-chain node pileups per leaf.

    counts (n_nodes, ref_len*4) flat `node_pileup` rows, span_diff
    (n_nodes, ref_len+1). Returns (leaf_counts (NL, ref_len, 4) int32,
    leaf_span (NL, ref_len) int32 cumulative span coverage).

    The ancestor chain of a leaf at depth d is anc_path[leaf, 0..d] (padding
    repeats the leaf itself, which must not be double counted - mask by
    depth index), bounded below by share_depth.
    """
    paths = anc_path[leaves.long()].long()              # (NL, D)
    use = chain_use_mask(leaves, depth, share_depth)
    return _chain_sum(counts, span_diff, paths, use)


def node_slot_pileup(query: torch.Tensor, ref_col: torch.Tensor,
                     bins: torch.Tensor, node2slot: torch.Tensor,
                     n_slots: int, ref_len: int):
    """node_pileup into a COMPACTED slot space.

    The dense (n_nodes, ref_len, 4) tensor is infeasible for a
    full-Greengenes-sized taxonomy (BASELINE configs 3/5: ~1e5-1e6 nodes x
    2048 cols would be terabytes); a sample only touches the nodes on its
    ACTIVE leaves' ancestor chains, so those get slots and everything else
    drops (reads at slotless nodes cannot contribute to any emitted leaf).
    Bit-identical to node_pileup restricted to slotted nodes."""
    slot = node2slot[torch.clamp(bins, 0, node2slot.shape[0] - 1).long()]
    slot = torch.where(bins >= 0, slot, -1)
    return node_pileup(query, ref_col, slot, n_slots, ref_len)


def leaf_pileup_slots(counts_s: torch.Tensor, span_s: torch.Tensor,
                      node2slot: torch.Tensor, leaves: torch.Tensor,
                      anc_path: torch.Tensor, depth: torch.Tensor,
                      share_depth: int = MAX_DEPTH):
    """leaf_pileup over slot-compacted accumulators (chain nodes without a
    slot contribute zero, exactly like zero-count nodes in the dense path)."""
    paths = anc_path[leaves.long()].long()              # (NL, D)
    slots = node2slot[paths]                            # (NL, D)
    use = chain_use_mask(leaves, depth, share_depth) & (slots >= 0)
    sidx = torch.clamp(slots, 0, counts_s.shape[0] - 1).long()
    return _chain_sum(counts_s, span_s, sidx, use)


def polymorphic_mask(leaf_counts: torch.Tensor, min_coverage: int,
                     poly_min_minor_count: int, poly_minor_frac_num: int,
                     poly_minor_frac_den: int,
                     max_poly_cols: int) -> torch.Tensor:
    """Bool (NL, ref_len) mask of the first max_poly_cols polymorphic columns
    per leaf (ascending column), matching oracle.cluster.polymorphic_cols.

    The fraction threshold is the integer-exact cross-multiplication
    minor * den >= num * max(tot, 1), in int32 like the reference's - no
    float arithmetic in any output-affecting path."""
    tot = leaf_counts.sum(dim=2).to(torch.int32)
    top = leaf_counts.amax(dim=2)
    minor = tot - top
    is_poly = (
        (tot >= min_coverage)
        & (minor >= poly_min_minor_count)
        & (minor * poly_minor_frac_den
           >= poly_minor_frac_num * torch.clamp(tot, min=1))
    )
    rank = torch.cumsum(is_poly.to(torch.int32), dim=1)
    return is_poly & (rank <= max_poly_cols)
