"""One assembly round (oracle): the executable spec of
`rambl_tpu_torch.pipeline.assemble.assemble_round`.

The port's copy of `Gene` and `assemble_round` from
`rambl_tpu/oracle/pipeline.py`. Round 0 aligns reads against the reference
panel, bins them via taxonomy LCA, clusters each leaf bin with DP-means and
calls a consensus per cluster.

Cluster consensus uses variant-aware merging: at polymorphic columns the
cluster's own reads vote; elsewhere the whole bin's reads vote (strains share
the backbone, differ at SNPs) - this yields full-length variants immediately
rather than SNP-neighbourhood fragments.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.taxonomy import TaxonomyTables
from rambl_tpu_torch.oracle.align import align_reads
from rambl_tpu_torch.oracle.binning import bin_reads, leaf_membership
from rambl_tpu_torch.oracle.cluster import (
    bin_pileup,
    dp_means,
    polymorphic_cols,
    read_features,
)
from rambl_tpu_torch.oracle.consensus import call_consensus, cluster_pileup


@dataclasses.dataclass
class Gene:
    seq: np.ndarray       # int8 codes
    n_reads: int
    leaf: int             # bin node it came from (that round's taxonomy)
    cluster: int
    round_born: int
    taxon: int = 0        # ORIGINAL-taxonomy node this gene descends from
    offset: int = 0       # anchor column of the first base (offset-preserving
                          # panels keep all rounds' coordinates aligned)

    def key(self) -> bytes:
        return self.seq.tobytes()


def assemble_round(
    reads: np.ndarray,
    read_lens: np.ndarray,
    ref_seqs: np.ndarray,
    ref_lens: np.ndarray,
    tables: TaxonomyTables,
    cfg: PipelineConfig,
    round_idx: int,
    orig_taxon_of_node: Optional[np.ndarray] = None,
    n_bits: Optional[int] = None,
    col_maps: Optional[np.ndarray] = None,
) -> tuple[List[Gene], dict]:
    """One align -> bin -> cluster -> consensus round.

    orig_taxon_of_node maps current-tree nodes to original-taxonomy nodes for
    newborn gene provenance (identity when aligning vs the original reference).
    n_bits pins the hash geometry (must match the device path, which pins it
    for panel rounds so they share one compiled executable).
    col_maps overrides the pairwise-NW anchor column maps (real-Greengenes
    MSA coordinates, index.greengenes.col_maps_from_msa); shape/semantics of
    index.colmap.build_col_maps.
    """
    index = build_seed_index(ref_seqs, ref_lens, k=cfg.k, n_bits=n_bits)
    res = align_reads(reads, read_lens, ref_seqs, index, cfg)
    bins = bin_reads(res, tables, cfg)

    # project alignment columns into each leaf's anchor coordinate system so
    # pileups merged across same-leaf references stay column-consistent
    # (cross-taxon consistency comes from offset-preserving panels; see
    # index.colmap)
    from rambl_tpu_torch.index.colmap import build_col_maps

    col_map = (col_maps if col_maps is not None
               else build_col_maps(ref_seqs, ref_lens, tables.ref_taxon))
    refc = np.clip(res.ref, 0, ref_seqs.shape[0] - 1)
    rc = res.ref_col
    proj = np.where(
        rc >= 0,
        col_map[refc[:, None], np.clip(rc, 0, ref_seqs.shape[1] - 1)],
        -1,
    )
    res = dataclasses.replace(res, ref_col=proj.astype(np.int32))

    leaves = np.unique(tables.ref_taxon)
    genes: List[Gene] = []
    stats = dict(
        round=round_idx,
        aligned=int(res.aligned.sum()),
        n_leaves=int(leaves.size),
        bins_used=0,
    )
    for leaf in leaves.tolist():
        members = leaf_membership(
            bins, leaf, tables, cfg.bin_share_depth) & res.aligned
        n_mem = int(members.sum())
        if n_mem < cfg.min_cluster_reads:
            continue
        stats["bins_used"] += 1
        # pileups use ALL members; clustering uses the first max_bin_reads
        # members by read index (the device path's static member-table cap)
        q_full = res.query[members]
        rc_full = res.ref_col[members]
        midx = np.nonzero(members)[0][: cfg.max_bin_reads]
        q = res.query[midx]
        rc = res.ref_col[midx]
        counts_bin = bin_pileup(q_full, rc_full, ref_seqs.shape[1])
        poly = polymorphic_cols(counts_bin, cfg)          # capped: features
        feat = read_features(q, rc, poly)
        can_seed = bins[midx] == leaf                     # leaf-exclusive only
        assign, centers, K = dp_means(feat, cfg, can_seed)

        counts_all, span_all = cluster_pileup(q_full, rc_full, ref_seqs.shape[1])
        poly_mask = np.zeros((ref_seqs.shape[1],), bool)
        poly_mask[polymorphic_cols(counts_bin, cfg, cap=False)] = True
        for k in range(K):
            mem_k = assign == k
            nk = int(mem_k.sum())
            if nk < cfg.min_cluster_reads:
                continue
            counts_k, span_k = cluster_pileup(q[mem_k], rc[mem_k], ref_seqs.shape[1])
            # trust cluster votes only with real depth, a unique winner AND a
            # minimum fraction of the backbone depth (thin error-driven sets
            # must not rewrite polymorphic columns)
            srt = np.sort(counts_k, axis=1)
            dk = counts_k.sum(axis=1)
            dall = counts_all.sum(axis=1)
            strong = (
                (dk * cfg.vote_min_frac_den >= cfg.vote_min_frac_num * dall)
                | (srt[:, -1] >= cfg.vote_min_abs)
            )
            use_k = (
                poly_mask
                & (dk >= cfg.min_coverage)
                & strong
                & (srt[:, -1] > srt[:, -2])
            )
            counts_eff = np.where(use_k[:, None], counts_k, counts_all)
            # deletion evidence must come from the same population that voted
            # the bases, else thin cluster counts vs bin-wide span coverage
            # falsely flags every polymorphic column as deleted
            span_eff = np.where(use_k, span_k, span_all)
            seq, off = call_consensus(counts_eff, span_eff)
            if seq.shape[0] == 0:
                continue
            taxon = int(leaf) if orig_taxon_of_node is None else int(orig_taxon_of_node[leaf])
            genes.append(Gene(seq=seq, n_reads=nk, leaf=int(leaf),
                              cluster=k, round_born=round_idx, taxon=taxon,
                              offset=off))
        # minor-haplotype gene (frequency phasing): an unequal-abundance
        # strain pair fragments into per-column clusters (reads cannot link
        # variant columns >1 read length apart), so the minor strain never
        # assembles whole. In a 2-haplotype leaf every CLEAR minor allele
        # belongs to the same strain: one gene carrying the minor allele at
        # every qualifying column recovers it wholesale. Qualification uses
        # LEAF-EXCLUSIVE reads (contamination-free) and integer-exact
        # thresholds; equal-abundance pairs are gated out (no signal).
        excl = bins == leaf
        c_ex = bin_pileup(res.query[excl], res.ref_col[excl],
                          ref_seqs.shape[1])
        tot_ex = c_ex.sum(axis=1)
        srt_ex = np.sort(c_ex, axis=1)
        mm = srt_ex[:, -2]
        qual = (
            (tot_ex >= cfg.min_coverage)
            & (mm >= cfg.minorhap_min_abs)
            & (mm * cfg.minorhap_max_den <= cfg.minorhap_max_num * tot_ex)
            & (mm * cfg.minorhap_frac_den >= cfg.minorhap_frac_num * tot_ex)
            & (srt_ex[:, -2] > srt_ex[:, -3])
        )
        # max(1, ...) so a (mis)configured minorhap_min_cols of 0 with zero
        # qualifying columns cannot reach the empty-array mm[qual].min() below
        # (the device path would emit a bogus gene at the same edge)
        if int(qual.sum()) >= max(1, cfg.minorhap_min_cols):
            b1 = np.argmax(c_ex, axis=1)
            c2 = c_ex.copy()
            c2[np.arange(c2.shape[0]), b1] = -1
            b2 = np.argmax(c2, axis=1)                 # unique where qual
            counts_mh = counts_all.copy()
            qc = np.nonzero(qual)[0]
            counts_mh[qc] = 0
            counts_mh[qc, b2[qc]] = counts_all[qc].sum(axis=1)
            seq, off = call_consensus(counts_mh, span_all)
            nk_mh = int(mm[qual].min())
            if seq.shape[0] and nk_mh >= cfg.min_cluster_reads:
                taxon = (int(leaf) if orig_taxon_of_node is None
                         else int(orig_taxon_of_node[leaf]))
                genes.append(Gene(
                    seq=seq, n_reads=nk_mh, leaf=int(leaf),
                    cluster=cfg.max_clusters_per_bin, round_born=round_idx,
                    taxon=taxon, offset=off))
    # dedupe identical sequences: keep the one with most reads
    # (ties -> earliest in (leaf asc, cluster asc) order, which is list order)
    bykey: dict[bytes, Gene] = {}
    for g in genes:
        kk = g.key()
        if kk not in bykey or g.n_reads > bykey[kk].n_reads:
            if kk in bykey:
                g = dataclasses.replace(g, n_reads=max(g.n_reads, bykey[kk].n_reads))
            bykey[kk] = g
    genes = list(bykey.values())
    # cap panel: (n_reads desc, leaf asc, cluster asc)
    genes.sort(key=lambda g: (-g.n_reads, g.leaf, g.cluster))
    genes = genes[: cfg.max_genes]
    stats["genes"] = len(genes)
    return genes, stats
