"""Cross-sample abundance-covariation phasing (BASELINE config 4): the port's
copy of `rambl_tpu/oracle/cohort.py`.

The measured single-sample wall (SURVEY.md section 8): at ~40x leaf depth the
per-column allele frequencies of co-binned strains smear into one continuum
(.28 vs .43 -> an unsplittable .31-.49 band, +-.07 sampling noise per column),
so neither DP-means (reads cannot link variant columns further apart than a
read length) nor single-sample frequency phasing (oracle/pipeline.py minorhap)
can separate more than the dominant strain. Across SAMPLES, however, strain
abundances vary independently (lognormal per sample), so each variant column's
per-sample minor-allele frequency VECTOR identifies the strain (subset)
carrying it: columns of the same strain share one vector, different strains'
vectors differ in every sample where their abundances differ.

Algorithm (deterministic and exact - the repo's integer-arithmetic invariant):

1. Per leaf, per sample: the leaf-EXCLUSIVE round-0 pileup (reads binned
   exactly at the leaf vs the original reference index - the same
   contamination-free evidence the polish pass uses, oracle/polish.py).
2. Columns qualify on the POOLED (summed over samples) pileup: depth,
   a unique second allele, pooled minor count >= cohort_min_abs and pooled
   minor fraction >= cohort_frac_num/cohort_frac_den (integer cross-multiplied).
3. Columns cluster by their per-sample (minor count, total depth) pairs with
   a DP-means-style loop whose distance is the mean per-sample POOLED
   TWO-PROPORTION CHI-SQUARE, computed as an exact Fraction:
       chi2 = (m1*t2 - m2*t1)^2 * (t1+t2) / (t1*t2*(m1+m2)*(t1+t2-m1-m2))
   A column joins the nearest group when mean chi2 <= cohort_tau (else spawns
   a new group); groups whose centroids are indistinguishable merge.
4. Each group emits one gene: the leaf's backbone gene with (a) the pooled
   MAJOR allele substituted at every qualifying column and (b) the group's
   minor alleles at its own columns. Gene bases address pileup columns through
   the same exact NW anchor map the polish pass uses (index/colmap._nw_map).
5. REVERSION groups - groups whose minor alleles are mostly the ANCHOR base -
   mark columns where some dominant strain's private allele is the pooled
   majority (pooled share > 1/2) and the ancestral base is the minor carried
   by everyone else. Their columns are substituted into every OTHER group's
   gene except the complemented dominant's (detected by the same chi-square:
   f_reversion ~ 1 - f_dominant), so minor-strain genes do not inherit the
   dominant's private alleles.

This module is pure host logic over host pileup tensors, shared verbatim by
the NumPy oracle and the device pipeline (exactly like oracle/polish.py):
device/oracle parity holds by construction once the input pileups match,
which tests/test_assembly_parity.py already enforces.

Prototype measurements (the build scripts in git history): at the exact
single-sample-failure shape (5 strains/leaf, 40x depth, 5 samples, lognormal
abundances) tau=3 recovers 98/100 strains with 0.975 column purity; 1 sample
recovers 8/100 (the known wall); 3 samples 80/100.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rambl_tpu_torch.config import PipelineConfig

_INF = Fraction(1 << 62)


def _chi2(m1: int, t1: int, m2: int, t2: int) -> Fraction:
    """Exact pooled two-proportion chi-square for (m1/t1) vs (m2/t2)."""
    if t1 == 0 or t2 == 0:
        return Fraction(0)
    num = (m1 * t2 - m2 * t1) ** 2 * (t1 + t2)
    den = t1 * t2 * (m1 + m2) * (t1 + t2 - m1 - m2)
    if den == 0:
        # all-minor or all-major on both sides: identical -> 0, else undefined
        # large (frequencies 1 vs <1 with no variance estimate)
        return Fraction(0) if num == 0 else _INF
    return Fraction(num, den)


def _group_dist(mc, tc, Mg, Tg, min_depth: int) -> Fraction:
    """Mean per-sample chi-square of column (mc, tc) vs group centroid
    (Mg, Tg), over samples where both sides have depth >= min_depth (falling
    back to depth > 0 when no sample qualifies)."""
    S = len(mc)
    for bound in (min_depth, 1):
        d = Fraction(0)
        n = 0
        for j in range(S):
            if tc[j] >= bound and Tg[j] >= bound:
                d += _chi2(int(mc[j]), int(tc[j]), int(Mg[j]), int(Tg[j]))
                n += 1
        if n:
            return d / n
    return _INF


def phase_columns(m: np.ndarray, t: np.ndarray,
                  cfg: PipelineConfig) -> np.ndarray:
    """Cluster variant columns by their cross-sample frequency vectors.

    m, t: (C, S) int arrays - per-column per-sample minor count / total depth.
    Returns (C,) int group ids, renumbered in first-column order.
    Deterministic: columns processed in index order, ties go to the
    lowest-index group, merges fold higher-index groups into lower."""
    C, S = m.shape
    m = m.astype(np.int64)
    t = t.astype(np.int64)
    tau = Fraction(cfg.cohort_tau_num, cfg.cohort_tau_den)
    assign = np.full(C, -1, np.int64)
    gm: List[np.ndarray] = []
    gt: List[np.ndarray] = []
    for _ in range(max(1, cfg.cohort_max_iters)):
        changed = False
        for c in range(C):
            best, bestd = -1, None
            for g in range(len(gm)):
                Mg, Tg = gm[g], gt[g]
                if assign[c] == g:
                    # leave-own-counts-out centroid; an own singleton stays
                    # put at zero cost (stable, DP-means convention)
                    Mg, Tg = Mg - m[c], Tg - t[c]
                    if int(Tg.sum()) == 0:
                        d = Fraction(0)
                    else:
                        d = _group_dist(m[c], t[c], Mg, Tg,
                                        cfg.cohort_min_depth)
                else:
                    if int(Tg.sum()) == 0:
                        continue
                    d = _group_dist(m[c], t[c], Mg, Tg, cfg.cohort_min_depth)
                if bestd is None or d < bestd:
                    best, bestd = g, d
            if bestd is not None and bestd <= tau:
                new = best
            else:
                new = len(gm)
                gm.append(np.zeros(S, np.int64))
                gt.append(np.zeros(S, np.int64))
            if new != assign[c]:
                if assign[c] >= 0:
                    gm[assign[c]] -= m[c]
                    gt[assign[c]] -= t[c]
                gm[new] += m[c]
                gt[new] += t[c]
                assign[c] = new
                changed = True
        if not changed:
            break
    # merge indistinguishable centroids (noise can split one strain in the
    # greedy first pass; with full group counts the test is far more powerful)
    live = [g for g in range(len(gm)) if int(gt[g].sum()) > 0]
    merged = True
    while merged:
        merged = False
        for i in range(len(live)):
            for j in range(i + 1, len(live)):
                a, b = live[i], live[j]
                if _group_dist(gm[b], gt[b], gm[a], gt[a],
                               cfg.cohort_min_depth) <= tau:
                    gm[a] = gm[a] + gm[b]
                    gt[a] = gt[a] + gt[b]
                    assign[assign == b] = a
                    live.pop(j)
                    merged = True
                    break
            if merged:
                break
    # renumber by first appearance
    remap: Dict[int, int] = {}
    out = np.zeros(C, np.int64)
    for c in range(C):
        g = int(assign[c])
        if g not in remap:
            remap[g] = len(remap)
        out[c] = remap[g]
    return out


def qualifying_columns(stack: np.ndarray, cfg: PipelineConfig):
    """Variant columns of a leaf from stacked per-sample exclusive pileups.

    stack: (S, ref_len, 4) int. Returns (cols, b1, b2, m, t):
    cols (C,) qualifying column indices (ascending, capped at
    cohort_max_cols), pooled major/minor base per column, and per-sample
    minor count m (C, S) / total depth t (C, S)."""
    pool = stack.sum(axis=0)                       # (L, 4)
    tot = pool.sum(axis=1)
    srt = np.sort(pool, axis=1)
    minor = srt[:, -2]
    tot64 = np.maximum(tot, 1).astype(np.int64)
    qual = (
        (tot >= cfg.min_coverage)
        & (minor >= cfg.cohort_min_abs)
        & (minor.astype(np.int64) * cfg.cohort_frac_den
           >= cfg.cohort_frac_num * tot64)
        & (2 * minor <= tot)                       # genuinely the minor allele
        & (srt[:, -2] > srt[:, -3])                # unique second allele
    )
    cols = np.nonzero(qual)[0][: cfg.cohort_max_cols].astype(np.int64)
    b1 = np.argmax(pool, axis=1)                   # major; ties -> lowest base
    p2 = pool.copy()
    p2[np.arange(p2.shape[0]), b1] = -1
    b2 = np.argmax(p2, axis=1)                     # minor (unique where qual)
    m = stack[:, cols, :][:, np.arange(cols.size), b2[cols]].T   # (C, S)
    t = stack[:, cols, :].sum(axis=2).T                          # (C, S)
    return cols, b1[cols].astype(np.int8), b2[cols].astype(np.int8), m, t


def _pick_backbone(geneses: Sequence[Sequence], taxon: int):
    """The cohort's backbone gene for a leaf: the sequence with the largest
    total read support across samples (ties: lexicographically smallest
    sequence bytes - deterministic)."""
    support: Dict[bytes, int] = {}
    rep: Dict[bytes, object] = {}
    for genes in geneses:
        for g in genes:
            if int(g.taxon) != int(taxon):
                continue
            kk = g.key()
            support[kk] = support.get(kk, 0) + int(g.n_reads)
            if kk not in rep:
                rep[kk] = g
    if not support:
        return None
    best = min(support, key=lambda k: (-support[k], k))
    return rep[best]


def cohort_genes_for_leaf(stack: np.ndarray, backbone, anchor_seq: np.ndarray,
                          cfg: PipelineConfig):
    """Phase one leaf. Returns a list of (seq, offset, per-sample n_reads,
    group id) for every emitted strain gene."""
    from rambl_tpu_torch.index.colmap import _nw_map

    S = stack.shape[0]
    cols, b1, b2, m, t = qualifying_columns(stack, cfg)
    if cols.size < max(1, cfg.cohort_min_cols):
        return []
    assign = phase_columns(m, t, cfg)
    n_groups = int(assign.max()) + 1

    # gene-base -> pileup-column map (exact NW onto the leaf anchor, the same
    # coordinate rule as oracle/polish.py - robust to interior emit holes)
    aseq = np.asarray(anchor_seq)
    gseq = np.asarray(backbone.seq)
    gcols = _nw_map(aseq, gseq)
    offset = int(backbone.offset)

    # POOLED edge extension (cfg.polish_extend_edges semantics with the
    # whole cohort's depth): the per-sample polish pass cannot extend edge
    # truncations the samples individually lack depth for (~40x: edge col 7
    # holds ~3 reads/sample), but the pooled stack (S x that) easily
    # qualifies - the r5 census measured EVERY remaining absent column of
    # the config-4 misses as such an edge. Same deep() rule as
    # oracle.polish.fill_gene_holes, on the pooled pileup.
    if cfg.polish_extend_edges and (gcols >= 0).any():
        pooled = stack.sum(axis=0)
        ptot = pooled.sum(axis=1)
        ptop = np.argmax(pooled, axis=1)

        def edge_base(c):
            # pooled winner at depth, anchor base otherwise (same
            # reference-guided rule as oracle.polish.fill_gene_holes edge
            # extension); a polymorphic edge column is safe to cross here
            # because the per-group substitution below overrides any
            # QUALIFYING column with the group's own allele
            if int(ptot[c]) >= cfg.polish_min_depth:
                return int(ptop[c])
            return int(aseq[c])

        mp = gcols[gcols >= 0]
        first, last = int(mp.min()), int(mp.max())
        hi_lim = min(aseq.shape[0], pooled.shape[0])
        left_c = list(range(0, first))
        left_b = [edge_base(c) for c in left_c]
        right_c = list(range(last + 1, hi_lim))
        right_b = [edge_base(c) for c in right_c]
        if left_b or right_b:
            gseq = np.concatenate([
                np.asarray(left_b, np.int8), gseq,
                np.asarray(right_b, np.int8)])
            gcols = np.concatenate([
                np.asarray(left_c, np.int32), gcols,
                np.asarray(right_c, np.int32)])
            offset -= len(left_b)

    pos_of: Dict[int, int] = {}
    for i, gcol in enumerate(gcols.tolist()):
        if gcol >= 0 and gcol not in pos_of:
            pos_of[gcol] = i

    # pooled-major backbone: qualifying columns forced to the pooled major
    # allele (removes any single strain's private alleles the per-sample
    # panel backbone may carry)
    seq0 = gseq.copy()
    mapped = np.array([c in pos_of for c in cols.tolist()])
    for ci in np.nonzero(mapped)[0].tolist():
        seq0[pos_of[int(cols[ci])]] = b1[ci]

    # group stats + reversion detection
    tau = Fraction(cfg.cohort_tau_num, cfg.cohort_tau_den)
    groups = []
    for g in range(n_groups):
        sel = assign == g
        groups.append(dict(
            cols=np.nonzero(sel)[0],
            M=m[sel].sum(axis=0).astype(np.int64),
            T=t[sel].sum(axis=0).astype(np.int64),
        ))
    anchor_base = np.array(
        [aseq[c] if c < aseq.shape[0] else 4 for c in cols.tolist()], np.int8)
    reversion = np.zeros(n_groups, bool)
    comp_of = np.full(n_groups, -1, np.int64)
    for g in range(n_groups):
        sel = groups[g]["cols"]
        rev = int((b2[sel] == anchor_base[sel]).sum())
        reversion[g] = 2 * rev > sel.size
        if not reversion[g]:
            continue
        # the complemented dominant: the group whose frequency vector is
        # ~ 1 - f_reversion (chi-square of M_g/T_g vs (T_d - M_d)/T_d)
        bestd, best = None, -1
        for d in range(n_groups):
            if d == g:
                continue
            dd = _group_dist(groups[g]["M"], groups[g]["T"],
                             groups[d]["T"] - groups[d]["M"],
                             groups[d]["T"], cfg.cohort_min_depth)
            if bestd is None or dd < bestd:
                bestd, best = dd, d
        if bestd is not None and bestd <= tau:
            comp_of[g] = best

    out = []
    for g in range(n_groups):
        own = groups[g]["cols"]
        own_mapped = own[mapped[own]]
        if own_mapped.size < max(1, cfg.cohort_min_cols):
            continue
        seq = seq0.copy()
        for ci in own_mapped.tolist():
            seq[pos_of[int(cols[ci])]] = b2[ci]
        # reversion columns belong to every strain except the complemented
        # dominant (see module docstring step 5)
        for h in range(n_groups):
            if h == g or not reversion[h] or comp_of[h] == g:
                continue
            hc = groups[h]["cols"]
            for ci in hc[mapped[hc]].tolist():
                seq[pos_of[int(cols[ci])]] = b2[ci]
        # per-sample strain depth estimate: lower median of the group's own
        # minor counts (integer, deterministic)
        sup = np.sort(m[own], axis=0)[(own.size - 1) // 2]
        out.append((seq.astype(np.int8), offset, sup.astype(np.int64), g))
    return out


def cohort_phase(geneses: List[List], counts_list: List[Dict[int, np.ndarray]],
                 anchor_seqs: Dict[int, np.ndarray],
                 cfg: PipelineConfig) -> List[List]:
    """Augment each sample's final gene panel with covariation-phased strain
    genes.

    geneses: per-sample gene lists (the assembly results' .genes).
    counts_list: per-sample {taxon: (ref_len, 4)} leaf-exclusive round-0
    pileups (oracle/polish.leaf_exclusive_counts semantics).
    anchor_seqs: {taxon: anchor reference sequence} (oracle/polish.py).
    Returns new per-sample gene lists; inputs are not mutated."""
    from rambl_tpu_torch.oracle.pipeline import Gene

    S = len(geneses)
    out = [list(genes) for genes in geneses]
    if S < 2 or not cfg.cohort_phase:
        return out
    taxa = sorted({int(g.taxon) for genes in geneses for g in genes})
    # COHORT-POOLED POLISH first: per-sample exclusive depth at a leaf is
    # often below polish_min_depth (the per-sample polish pass is blind
    # there), but the same strains underlie every sample, so the POOLED
    # exclusive pileup is decisive evidence for shared-backbone columns.
    # Same rules as oracle/polish.apply_polish (poly-guarded: variant
    # columns belong to phasing, not polish). Measured: backbone errors at
    # thin leaves (e.g. 7 wrong bases at pooled depth 6-19, per-sample 1-4)
    # are exactly this class.
    pooled: Dict[int, np.ndarray] = {}
    for t in taxa:
        acc = None
        for j in range(S):
            c = counts_list[j].get(t)
            if c is not None:
                acc = c.astype(np.int64) if acc is None else acc + c
        if acc is not None:
            pooled[t] = acc
    from rambl_tpu_torch.oracle.polish import apply_polish

    out = [apply_polish(genes, pooled, anchor_seqs, cfg)[0] for genes in out]
    geneses = out
    out = [list(genes) for genes in geneses]
    for taxon in taxa:
        backbone = _pick_backbone(geneses, taxon)
        aseq = anchor_seqs.get(taxon)
        if backbone is None or aseq is None:
            continue
        ref_len = None
        stack = []
        for j in range(S):
            c = counts_list[j].get(taxon)
            if c is not None:
                ref_len = c.shape[0]
            stack.append(c)
        if ref_len is None:
            continue
        zeros = np.zeros((ref_len, 4), np.int64)
        stack = np.stack([zeros if c is None else c.astype(np.int64)
                          for c in stack])
        emitted = cohort_genes_for_leaf(stack, backbone, aseq, cfg)
        for seq, offset, sup, g in emitted:
            kk = seq.tobytes()
            for j in range(S):
                if int(sup[j]) < cfg.min_cluster_reads:
                    continue
                if any(gg.key() == kk for gg in out[j]):
                    continue
                out[j].append(Gene(
                    seq=seq, n_reads=int(sup[j]), leaf=taxon,
                    cluster=cfg.max_clusters_per_bin + 1 + g,
                    round_born=-1, taxon=taxon, offset=offset))
    return out


def assemble_cohort(samples, ref_seqs, ref_lens, tables, cfg: PipelineConfig,
                    col_maps=None):
    """Oracle cohort assembly: per-sample oracle assemble + covariation
    phasing over per-sample leaf-exclusive round-0 pileups. The executable
    spec of pipeline.assemble.assemble_cohort."""
    from rambl_tpu_torch.oracle.pipeline import assemble
    from rambl_tpu_torch.oracle.polish import anchor_seqs_of, leaf_exclusive_counts

    results = [assemble(reads, lens, ref_seqs, ref_lens, tables, cfg,
                        col_maps=col_maps)
               for reads, lens in samples]
    if len(samples) < 2 or not cfg.cohort_phase:
        return results
    counts_list = [
        leaf_exclusive_counts(reads, lens, ref_seqs, ref_lens, tables, cfg,
                              col_maps=col_maps)
        for reads, lens in samples
    ]
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    geneses = cohort_phase([r.genes for r in results], counts_list, anchor, cfg)
    return [dataclasses.replace(r, genes=g)
            for r, g in zip(results, geneses)]
