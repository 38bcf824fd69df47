"""One leaf's round-0 discovery: its members' pileup, polymorphic columns,
DP-means over the members' bases at those columns, each cluster's
consensus, and the minor-haplotype gene. A frozen copy of the repository's
NumPy specification (its `assemble_round` leaf loop), from the reads'
bins, aligned-orientation codes and projected columns.

Pileups use every member; clustering uses the first `max_bin_reads`
members by read index. All thresholds are integer-exact rationals.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.taxonomy import chain


def bin_pileup(q, rc, ref_len, dtype=np.int64):
    ok = (rc >= 0) & (q < 4)
    flat = rc[ok].astype(np.int64) * 4 + q[ok]
    return np.bincount(flat, minlength=ref_len * 4).reshape(
        ref_len, 4).astype(dtype)


def cluster_pileup(q, rc, ref_len, dtype=np.int64):
    counts = bin_pileup(q, rc, ref_len, dtype)
    span = np.zeros(ref_len + 1, np.int64)
    ok = (rc >= 0) & (q < 4)
    has = ok.any(1)
    if has.any():
        lo = np.where(ok, rc, 1 << 30).min(1)[has]
        hi = np.where(ok, rc, -1).max(1)[has]
        span += np.bincount(lo, minlength=ref_len + 1)
        span -= np.bincount(hi + 1, minlength=ref_len + 1)
    return counts, np.cumsum(span[:-1]).astype(dtype)


def polymorphic_cols(counts, p, cap=True):
    tot = counts.sum(1).astype(np.int64)
    minor = tot - counts.max(1)
    cols = np.nonzero((tot >= p.min_coverage)
                      & (minor >= p.poly_min_minor_count)
                      & (minor * p.poly_minor_frac_den
                         >= p.poly_minor_frac_num * np.maximum(tot, 1)))[0]
    return cols[:p.max_poly_cols] if cap else cols


def read_features(q, rc, poly):
    """(N, P) int8 base at each polymorphic column, -1 where not covered."""
    N = q.shape[0]
    feat = np.full((N, poly.shape[0]), -1, np.int8)
    if poly.shape[0] == 0:
        return feat
    slot = np.full(int(max(poly.max() + 1, 1)), -1, np.int64)
    slot[poly] = np.arange(poly.shape[0])
    s = np.where((rc >= 0) & (rc < slot.shape[0]),
                 slot[np.clip(rc, 0, slot.shape[0] - 1)], -1)
    ok = (s >= 0) & (q < 4)
    n = np.broadcast_to(np.arange(N)[:, None], q.shape)
    feat[n[ok], s[ok]] = q[ok]
    return feat


def _consensus_of(feat, member, fallback):
    center = fallback.copy()
    if member.sum() == 0 or feat.shape[1] == 0:
        return center
    f = feat[member]
    for j in range(feat.shape[1]):
        col = f[:, j]
        col = col[col >= 0]
        if col.size:
            center[j] = np.argmax(np.bincount(col, minlength=4))
    return center


def _diffs(feat, centers):
    cov = feat >= 0
    diff = ((feat[:, None, :] != centers[None, :, :]) & cov[:, None, :]).sum(2)
    return diff.astype(np.int64), cov.sum(1).astype(np.int64)


def dp_means(feat, p, can_seed):
    """(assign (N,), K): deterministic DP-means; only `can_seed` reads
    seed or support a spawn; converged duplicate centers merge into the
    lowest index, ids compacted in first-seen order."""
    N, P = feat.shape
    lam_n, lam_d = p.dp_lambda_num, p.dp_lambda_den
    fallback = _consensus_of(feat, np.ones(N, bool), np.zeros(P, np.int8))
    centers = [fallback]
    assign = np.zeros(N, np.int64)
    if N == 0 or P == 0:
        return assign, 1
    for _ in range(p.dp_max_iters):
        K = len(centers)
        diff, ncov = _diffs(feat, np.asarray(centers, np.int8))
        new = np.argmin(diff, axis=1)
        dmin = diff[np.arange(N), new]
        orphans = (dmin * lam_d > lam_n * ncov) & can_seed
        spawned = False
        if (int(orphans.sum()) >= p.dp_spawn_min_orphans
                and K < p.max_clusters_per_bin):
            oidx = np.nonzero(orphans)[0]
            ofeat = feat[oidx]
            for cand in oidx[:p.dp_spawn_scan]:
                fv = feat[cand]
                common = (ofeat >= 0) & (fv >= 0)[None, :]
                ncom = common.sum(1).astype(np.int64)
                dc = ((ofeat != fv[None, :]) & common).sum(1).astype(np.int64)
                if int(((ncom > 0) & (dc * lam_d <= lam_n * ncom)).sum()) \
                        >= p.dp_spawn_min_orphans:
                    centers.append(np.where(fv >= 0, fv, fallback).astype(
                        np.int8))
                    new[int(cand)] = K
                    spawned = True
                    break
        centers = [_consensus_of(feat, new == k, fallback)
                   for k in range(len(centers))]
        changed = (new != assign).any() or spawned
        assign = new
        if not changed:
            break
    cen = np.asarray(centers, np.int8)
    K = cen.shape[0]
    canon = np.arange(K)
    for k in range(1, K):
        for j in range(k):
            if (cen[k] == cen[j]).all():
                canon[k] = j
                break
    remap = -np.ones(K, np.int64)
    nxt = 0
    for k in range(K):
        if canon[k] == k:
            remap[k] = nxt
            nxt += 1
    return remap[canon[assign]], nxt


def call_consensus(counts, span_cover):
    """(seq int8, offset): emitted columns are covered, with deletions no
    more than bases, between the first and last covered column; the base
    is the argmax (ties to the lowest code)."""
    cover = counts.sum(1)
    covered = np.nonzero(cover > 0)[0]
    if covered.size == 0:
        return np.zeros(0, np.int8), 0
    lo, hi = int(covered[0]), int(covered[-1])
    emit = (cover > 0) & (span_cover - cover <= cover)
    emit[:lo] = False
    emit[hi + 1:] = False
    cols = np.nonzero(emit)[0]
    off = int(cols[0]) if cols.size else 0
    return np.argmax(counts[cols], axis=1).astype(np.int8), off


def discover(leaf, bins, rows, anc, depth, ref_len, p, dtype=np.int64):
    """{n_mem, kact, genes}: genes are (cluster, n_reads, offset, seq
    bytes), the clusters in order and then the minor-haplotype gene
    (cluster max_clusters_per_bin). `rows(idx)` gives the reads' (codes,
    columns). Counts are made in `dtype` (a narrower one is the control)."""
    members = np.nonzero(np.isin(bins, chain(leaf, anc, depth,
                                             p.bin_share_depth)))[0]
    n_mem = int(np.asarray(members.size).astype(dtype))
    if n_mem < p.min_cluster_reads:
        return dict(n_mem=n_mem, kact=None, genes=[])
    q_full, rc_full = rows(members)
    q_full = q_full.astype(np.int64)
    rc_full = rc_full.astype(np.int64)
    M = p.max_bin_reads
    q, rc = q_full[:M], rc_full[:M]
    counts_bin = bin_pileup(q_full, rc_full, ref_len, dtype)
    feat = read_features(q, rc, polymorphic_cols(counts_bin, p))
    assign, K = dp_means(feat, p, bins[members[:M]] == leaf)
    counts_all, span_all = cluster_pileup(q_full, rc_full, ref_len, dtype)
    poly_mask = np.zeros(ref_len, bool)
    poly_mask[polymorphic_cols(counts_bin, p, cap=False)] = True
    genes = []
    for k in range(K):
        mk = assign == k
        nk = int(mk.sum())
        if nk < p.min_cluster_reads:
            continue
        counts_k, span_k = cluster_pileup(q[mk], rc[mk], ref_len, dtype)
        srt = np.sort(counts_k, axis=1)
        dk = counts_k.sum(1).astype(np.int64)
        dall = counts_all.sum(1).astype(np.int64)
        strong = ((dk * p.vote_min_frac_den >= p.vote_min_frac_num * dall)
                  | (srt[:, -1] >= p.vote_min_abs))
        use = (poly_mask & (dk >= p.min_coverage) & strong
               & (srt[:, -1] > srt[:, -2]))
        seq, off = call_consensus(np.where(use[:, None], counts_k, counts_all),
                                  np.where(use, span_k, span_all))
        if seq.shape[0]:
            genes.append((k, nk, off, seq.tobytes()))
    excl = bins[members] == leaf
    c_ex = bin_pileup(q_full[excl], rc_full[excl], ref_len, dtype)
    tot = c_ex.sum(1).astype(np.int64)
    srt = np.sort(c_ex, axis=1).astype(np.int64)
    mm = srt[:, -2]
    qual = ((tot >= p.min_coverage) & (mm >= p.minorhap_min_abs)
            & (mm * p.minorhap_max_den <= p.minorhap_max_num * tot)
            & (mm * p.minorhap_frac_den >= p.minorhap_frac_num * tot)
            & (srt[:, -2] > srt[:, -3]))
    if int(qual.sum()) >= max(1, p.minorhap_min_cols):
        b1 = np.argmax(c_ex, axis=1)
        c2 = c_ex.astype(np.int64)
        c2[np.arange(c2.shape[0]), b1] = -1
        b2 = np.argmax(c2, axis=1)
        mh = counts_all.copy()
        qc = np.nonzero(qual)[0]
        mh[qc] = 0
        mh[qc, b2[qc]] = counts_all[qc].sum(1)
        seq, off = call_consensus(mh, span_all)
        nk = int(mm[qual].min())
        if seq.shape[0] and nk >= p.min_cluster_reads:
            genes.append((p.max_clusters_per_bin, nk, off, seq.tobytes()))
    return dict(n_mem=n_mem, kact=K, genes=genes)
