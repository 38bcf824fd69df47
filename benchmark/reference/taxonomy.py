"""Taxonomy paths, LCA binning and leaf membership.

anc_path[node, d] is the node's ancestor at depth d (root 0 at depth 0),
the node itself below its own depth. A read's bin is the LCA of the taxa of
every candidate pair that scores exactly its best score (and at least
`min_score`), -1 when unaligned. A leaf's members are the reads binned at
the leaf or at an ancestor at most `bin_share_depth` ranks above it."""

from __future__ import annotations

import numpy as np

MAX_DEPTH = 10


def anc_paths(tax_parent: np.ndarray, tax_depth: np.ndarray) -> np.ndarray:
    """(n_nodes, MAX_DEPTH) int64 ancestor at each depth."""
    n = tax_parent.shape[0]
    depth = tax_depth.astype(np.int64)
    anc = np.zeros((n, MAX_DEPTH), np.int64)
    cur = np.arange(n)
    for d in range(int(depth.max()), -1, -1):
        at = depth >= d
        # walk every node whose depth is above d up to depth d
        anc[at, d] = cur[at]
        cur = np.where(depth >= d, tax_parent[cur], cur)
    for d in range(MAX_DEPTH):
        below = d > depth
        anc[below, d] = np.arange(n)[below]
    return anc


def lca_of_set(anc, depth, nodes, valid):
    """(...,) LCA of each row's valid nodes (root 0 when none)."""
    paths = anc[nodes]
    first = np.argmax(valid, axis=-1)
    first_path = np.take_along_axis(
        paths, first[..., None, None].repeat(MAX_DEPTH, -1), axis=-2)[..., 0, :]
    eff = np.where(valid[..., None], paths, first_path[..., None, :])
    agree = (eff == first_path[..., None, :]).all(axis=-2)
    min_depth = np.minimum(np.where(valid, depth[nodes], 10 ** 9).min(-1),
                           MAX_DEPTH - 1)
    dd = np.arange(MAX_DEPTH)
    ok = np.cumprod(agree, axis=-1).astype(bool) & (dd <= min_depth[..., None])
    best_d = np.maximum(np.where(ok, dd, -1).max(-1), 0)
    lca = np.take_along_axis(first_path, best_d[..., None], -1)[..., 0]
    return np.where(valid.any(-1), lca, 0)


def bin_reads(al, anc, depth, ref_taxon, p) -> np.ndarray:
    tied = (al.pair_valid & (al.pair_score >= p.min_score)
            & (al.pair_score >= al.score[:, None] - p.bin_score_delta))
    taxa = ref_taxon[np.clip(al.pair_ref, 0, ref_taxon.shape[0] - 1)]
    return np.where(al.ref >= 0, lca_of_set(anc, depth, taxa, tied), -1)


def chain(leaf: int, anc, depth, share_depth: int) -> np.ndarray:
    """The nodes whose reads are a leaf's members."""
    dl = int(depth[leaf])
    return np.unique(anc[leaf, max(0, dl - share_depth):dl + 1])
