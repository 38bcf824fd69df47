"""Deterministic batched DP-means clustering (oracle).

Replaces the reference's sequential, order-dependent DP-means (SURVEY.md
section 3.3, hot loop #3) with a deterministic batched EM-style formulation -
the *same* algorithm the jitted path runs, so assignments agree bit-for-bit
(SURVEY.md section 7.4.4):

features : per read, its base at each of <= max_poly_cols polymorphic pileup
           columns of the bin (-1 where the read does not cover the column);
distance : mismatch count over covered feature columns, normalized by the
           coverage count - ALL comparisons are done in integer arithmetic
           (diff * lambda_den vs lambda_num * ncov) so no float rounding can
           ever differ between NumPy and the f32 device path. The cluster
           argmin needs no normalization at all: a read's coverage is the
           same against every center, so argmin(diff) == argmin(distance);
loop     : assign to nearest center (ties -> lowest cluster id); spawn at most
           ONE cluster per iteration, seeded from the first orphan (ascending
           read index, scanning at most dp_spawn_scan seeds) that has
           >= dp_spawn_min_orphans mutually consistent orphans - isolated
           single-error reads must not found clusters; recompute centers as
           per-cluster per-column argmax base (ties -> lowest base, empty
           columns inherit the bin consensus); iterate to fixpoint or
           dp_max_iters; finally merge clusters whose centers converged to
           identical vectors (ids compacted in first-seen order).

The port's copy of `rambl_tpu/oracle/cluster.py`, unchanged in behaviour.
"""

from __future__ import annotations

import numpy as np

from rambl_tpu_torch.config import PipelineConfig


def bin_pileup(
    query: np.ndarray, ref_col: np.ndarray, ref_len: int
) -> np.ndarray:
    """Base-count pileup (ref_len, 4) from aligned reads.

    query: (N, L) int8 codes of aligned orientation; ref_col: (N, L) int32
    global columns (-1 = unaligned position).
    """
    counts = np.zeros((ref_len, 4), dtype=np.int32)
    ok = (ref_col >= 0) & (query < 4)
    np.add.at(counts, (ref_col[ok], query[ok].astype(np.int64)), 1)
    return counts


def polymorphic_cols(counts: np.ndarray, cfg: PipelineConfig,
                     cap: bool = True) -> np.ndarray:
    """Polymorphic columns, ascending.

    cap=True limits to the first max_poly_cols (the static feature-matrix
    width for DP-means); consensus masks use cap=False - capping there would
    let early contamination columns crowd out real discriminating columns
    later in the gene.
    """
    tot = counts.sum(axis=1)
    top = counts.max(axis=1)
    minor = tot - top
    # integer-exact fraction test: minor/max(tot,1) >= num/den
    is_poly = (
        (tot >= cfg.min_coverage)
        & (minor >= cfg.poly_min_minor_count)
        & (minor.astype(np.int64) * cfg.poly_minor_frac_den
           >= cfg.poly_minor_frac_num * np.maximum(tot, 1).astype(np.int64))
    )
    cols = np.nonzero(is_poly)[0]
    if cap:
        cols = cols[: cfg.max_poly_cols]
    return cols.astype(np.int32)


def read_features(
    query: np.ndarray, ref_col: np.ndarray, poly_cols: np.ndarray
) -> np.ndarray:
    """(N, P) int8: read base at each polymorphic column, -1 if not covered."""
    N, L = query.shape
    P = poly_cols.shape[0]
    feat = np.full((N, P), -1, dtype=np.int8)
    if P == 0:
        return feat
    # map column -> feature slot
    col2slot = {int(c): s for s, c in enumerate(poly_cols)}
    ok = ref_col >= 0
    for n in range(N):
        cols = ref_col[n][ok[n]]
        bases = query[n][ok[n]]
        for c, b in zip(cols, bases):
            s = col2slot.get(int(c))
            if s is not None and b < 4:
                feat[n, s] = b
    return feat


def _consensus_of(feat: np.ndarray, member: np.ndarray, fallback: np.ndarray) -> np.ndarray:
    """Per-column argmax base over member reads; ties -> lowest base; empty ->
    fallback."""
    P = feat.shape[1]
    center = fallback.copy()
    if member.sum() == 0 or P == 0:
        return center
    f = feat[member]
    for p in range(P):
        col = f[:, p]
        col = col[col >= 0]
        if col.size:
            center[p] = np.argmax(np.bincount(col, minlength=4))
    return center


def _diffs(feat: np.ndarray, centers: np.ndarray):
    """Integer distance pieces: (diff (N, K), ncov (N,))."""
    cov = feat >= 0                                          # (N, P)
    diff = ((feat[:, None, :] != centers[None, :, :]) & cov[:, None, :]).sum(
        axis=2
    )                                                        # (N, K)
    return diff.astype(np.int64), cov.sum(axis=1).astype(np.int64)


def dp_means(feat: np.ndarray, cfg: PipelineConfig,
             can_seed: np.ndarray | None = None):
    """Deterministic DP-means. Returns (assign (N,), centers (K, P), K).

    can_seed (N,) bool restricts which reads may SEED or SUPPORT a spawn
    (assignment itself is unrestricted). The pipeline passes the
    leaf-exclusive mask: LCA-shared reads - including cross-species
    contamination shared down the tree - must not found variants of a bin
    they do not map best into.
    """
    N, P = feat.shape
    if can_seed is None:
        can_seed = np.ones((N,), bool)
    lam_n, lam_d = cfg.dp_lambda_num, cfg.dp_lambda_den
    fallback = np.zeros((P,), dtype=np.int8)
    # bin consensus as cluster-0 init
    all_members = np.ones((N,), bool)
    fallback = _consensus_of(feat, all_members, fallback)
    centers = [fallback]
    assign = np.zeros((N,), np.int32)
    if N == 0 or P == 0:
        return assign, np.asarray(centers, np.int8), 1

    for _ in range(cfg.dp_max_iters):
        K = len(centers)
        cen = np.asarray(centers, np.int8)
        diff, ncov = _diffs(feat, cen)                    # int
        new_assign = np.argmin(diff, axis=1).astype(np.int32)  # ties -> lowest
        dmin = diff[np.arange(N), new_assign]
        orphans = (dmin * lam_d > lam_n * ncov) & can_seed  # dist > lambda
        spawned = False
        if int(orphans.sum()) >= cfg.dp_spawn_min_orphans and K < cfg.max_clusters_per_bin:
            oidx = np.nonzero(orphans)[0]
            ofeat = feat[oidx]                            # (O, P)
            for cand in oidx[: cfg.dp_spawn_scan]:
                fv = feat[cand]
                common = (ofeat >= 0) & (fv >= 0)[None, :]
                ncom = common.sum(axis=1).astype(np.int64)
                dcand = ((ofeat != fv[None, :]) & common).sum(axis=1).astype(np.int64)
                support = int(((ncom > 0) & (dcand * lam_d <= lam_n * ncom)).sum())
                if support >= cfg.dp_spawn_min_orphans:
                    c = np.where(fv >= 0, fv, fallback).astype(np.int8)
                    centers.append(c)
                    new_assign[int(cand)] = K
                    spawned = True
                    break
        # recompute centers
        cen_new = []
        for k in range(len(centers)):
            cen_new.append(_consensus_of(feat, new_assign == k, fallback))
        changed = (new_assign != assign).any() or spawned
        assign = new_assign
        centers = cen_new
        if not changed:
            break

    # merge clusters whose centers converged to the same vector (error-seeded
    # clusters often collapse onto an existing variant): reassign members to
    # the lowest-index duplicate, then compact ids in first-seen order.
    cen = np.asarray(centers, np.int8)
    K = cen.shape[0]
    canon = np.arange(K)
    for k in range(1, K):
        for j in range(k):
            if (cen[k] == cen[j]).all():
                canon[k] = j
                break
    remap = -np.ones(K, np.int32)
    nxt = 0
    for k in range(K):
        if canon[k] == k:
            remap[k] = nxt
            nxt += 1
    assign = remap[canon[assign]]
    cen = cen[[k for k in range(K) if canon[k] == k]]
    return assign, cen, cen.shape[0]
