"""End-to-end assembly pipeline (oracle): the executable spec of
`rambl_tpu_torch.pipeline.assemble` (`assemble_round` and `assemble`).

The port's copy of `rambl_tpu/oracle/pipeline.py`. Iterative
reconstruction loop:

  round 0: align reads vs the reference index, bin via taxonomy LCA,
           DP-means per leaf bin, consensus per cluster;
  round t: realign all reads vs the current consensus panel (each gene a
           reference of its provenance taxon), re-cluster, re-call consensus;
  stop when the panel repeats or at max_assembly_iters; then polish.

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


@dataclasses.dataclass
class AssemblyResult:
    genes: List[Gene]        # final output (polished when cfg.polish)
    n_rounds: int
    converged: bool
    round_stats: List[dict]
    # the loop-state panel BEFORE the final polish pass: checkpoints must save
    # this (resuming continues the loop, and the loop never sees polished
    # genes), so resume stays a bitwise continuation
    panel: List[Gene] = dataclasses.field(default_factory=list)

    def full_length(self, cfg: PipelineConfig) -> List[Gene]:
        return [g for g in self.genes if g.seq.shape[0] >= cfg.full_len_min]


def pad_panel(genes: List[Gene], ref_len_max: int):
    """Panel genes placed at their recorded anchor offsets (leading pad code
    4 never matches, so alignment lands in the real sequence) - keeps all
    panel coordinates mutually aligned across rounds."""
    seqs = np.full((len(genes), ref_len_max), 4, dtype=np.int8)
    lens = np.zeros((len(genes),), np.int32)
    for i, g in enumerate(genes):
        off = min(int(g.offset), ref_len_max - 1)
        L = min(g.seq.shape[0], ref_len_max - off)
        seqs[i, off : off + L] = g.seq[:L]
        lens[i] = off + L
    return seqs, lens


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


def panel_tables(genes: List[Gene], tables: TaxonomyTables) -> TaxonomyTables:
    """Taxonomy view for a consensus panel: the SAME tree, with each panel
    gene mapped directly to its provenance taxon as a reference.

    Later rounds are then full discovery rounds over the original bins:
    clustering re-separates variants with the whole bin's coverage every
    round. (The earlier per-gene-leaf + exclusive-read refinement could not
    disentangle near-duplicate chimeric panel genes: each gene's exclusive
    read set was thin and error-driven, and consensus degraded round over
    round - see git history.)
    """
    return TaxonomyTables(
        anc_path=tables.anc_path,
        depth=tables.depth,
        ref_taxon=np.array([g.taxon for g in genes], np.int32),
        n_nodes=tables.n_nodes,
    )


def assemble(
    reads: np.ndarray,
    read_lens: np.ndarray,
    ref_seqs: np.ndarray,
    ref_lens: np.ndarray,
    tables: TaxonomyTables,
    cfg: PipelineConfig,
    initial_panel: Optional[List[Gene]] = None,
    col_maps: Optional[np.ndarray] = None,
) -> AssemblyResult:
    """initial_panel resumes from a checkpointed panel: the discovery round is
    skipped and rounds continue deterministically on the given genes.
    col_maps: optional MSA-derived anchor maps for rounds against the
    ORIGINAL references (round 0 + polish); panel rounds keep NW maps."""
    round_stats: List[dict] = []
    if initial_panel is None:
        genes, stats = assemble_round(
            reads, read_lens, ref_seqs, ref_lens, tables, cfg, round_idx=0,
            col_maps=col_maps,
        )
        round_stats.append(stats)
    else:
        genes = list(initial_panel)
        round_stats.append(dict(round=0, resumed=True, genes=len(genes)))
    seen = {tuple(sorted(g.key() for g in genes))}
    converged = False
    for it in range(1, cfg.max_assembly_iters):
        if not genes:
            break
        pseqs, plens = pad_panel(genes, ref_seqs.shape[1])
        ptab = panel_tables(genes, tables)
        # same pinned hash geometry as the device panel rounds
        panel_bits = max(
            8, int(np.ceil(np.log2(2 * cfg.max_genes * cfg.ref_len_max + 1))))
        genes, stats = assemble_round(
            reads, read_lens, pseqs, plens, ptab, cfg, round_idx=it,
            n_bits=panel_bits,
        )
        round_stats.append(stats)
        new_key = tuple(sorted(g.key() for g in genes))
        # fixpoint OR cycle: rounds are deterministic, so revisiting any
        # previous panel means the loop will repeat forever - stop
        if new_key in seen:
            converged = True
            break
        seen.add(new_key)
    n_rounds = len(round_stats)
    panel = list(genes)
    if cfg.polish and genes:
        from rambl_tpu_torch.oracle.polish import polish_genes

        genes, n_changed = polish_genes(
            reads, read_lens, ref_seqs, ref_lens, genes, tables, cfg,
            col_maps=col_maps)
        round_stats.append(dict(round="polish", changed=n_changed))
    return AssemblyResult(
        genes=genes,
        n_rounds=n_rounds,
        converged=converged,
        round_stats=round_stats,
        panel=panel,
    )
