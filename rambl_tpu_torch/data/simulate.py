"""Synthetic 16S mock-community generator: the port's copy of
`simulate_dataset`, `toy_dataset` and `SimulatedDataset` from
`rambl_tpu/data/simulate.py`, with the cohort generator `simulate_cohort`.

A phylogeny of 16S-like genes with conserved/variable regions, a
Greengenes-style 7-rank taxonomy, and shotgun reads with substitution/indel
errors. Everything is deterministic given the seed, and the same seed gives
the reference's arrays (tests/test_torch_host_layers.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from rambl_tpu_torch.io.pack import decode_seq

# 16S-like region structure: alternating conserved (low mutation) and variable
# (high mutation) segments, mimicking V1..V9 hypervariable regions.
_REGIONS = [  # (length, per-branch substitution rate)
    (100, 0.002), (70, 0.06), (120, 0.002), (90, 0.08),
    (140, 0.002), (100, 0.10), (130, 0.002), (80, 0.08),
    (150, 0.002), (90, 0.06), (140, 0.002), (100, 0.10),
    (120, 0.002), (80, 0.06), (40, 0.002),
]  # total ~1550 bp

RANKS = ["domain", "phylum", "class", "order", "family", "genus", "species"]

_COMP_TABLE = np.array([3, 2, 1, 0, 4], dtype=np.int8)  # A<->T, C<->G, N->N


@dataclasses.dataclass
class SimulatedDataset:
    # references (the mock "Greengenes subset")
    ref_names: List[str]
    ref_seqs: np.ndarray          # (n_refs, ref_len_max) int8 codes, padded 4
    ref_lens: np.ndarray          # (n_refs,) int32
    # taxonomy: node 0 is the root; each ref maps to a leaf node
    tax_parent: np.ndarray        # (n_nodes,) int32 parent id (root -> 0)
    tax_depth: np.ndarray         # (n_nodes,) int32 (root = 0)
    tax_name: List[str]
    ref_taxon: np.ndarray         # (n_refs,) int32 leaf node per reference
    # reads
    read_names: List[str]
    reads: np.ndarray             # (n_reads, read_len_max) int8 codes
    read_lens: np.ndarray         # (n_reads,) int32
    read_quals: List[str]
    # ground truth
    true_ref: np.ndarray          # (n_reads,) int32 source reference index
    true_pos: np.ndarray          # (n_reads,) int32 0-based start on the ref
    true_strand: np.ndarray       # (n_reads,) int8 0=fwd 1=rc
    # abundance truth
    abundance: np.ndarray         # (n_refs,) float64 sampling weights

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)

    @property
    def n_reads(self) -> int:
        return len(self.read_names)

    def ref_fasta(self) -> List[Tuple[str, str]]:
        return [
            (n, decode_seq(self.ref_seqs[i, : self.ref_lens[i]]))
            for i, n in enumerate(self.ref_names)
        ]


def _mutate(seq: np.ndarray, region_rates: np.ndarray, rng: np.random.Generator,
            scale: float) -> np.ndarray:
    """Substitute bases with per-position rate * scale."""
    p = region_rates * scale
    mask = rng.random(seq.shape[0]) < p
    shift = rng.integers(1, 4, size=seq.shape[0])
    out = seq.copy()
    out[mask] = (out[mask] + shift[mask]) % 4
    return out


def _gen_reads(rng: np.random.Generator, ref_seqs: np.ndarray,
               ref_lens: np.ndarray, ab: np.ndarray, n_reads: int,
               read_len: int, read_len_max: int,
               sub_error: float, indel_error: float):
    """Shotgun reads from abundance-weighted references (the rng stream is
    the reference's: golden fixtures depend on it).
    Returns (reads, read_lens, true_ref, true_pos, true_strand)."""
    n_refs = ref_seqs.shape[0]
    # (vectorized; only the rare indel reads take a python loop)
    true_ref = rng.choice(n_refs, size=n_reads, p=ab).astype(np.int32)
    true_strand = rng.integers(0, 2, size=n_reads).astype(np.int8)
    span = np.maximum(ref_lens[true_ref] - read_len, 1)
    true_pos = (rng.random(n_reads) * span).astype(np.int32)
    cols = true_pos[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
    frags = ref_seqs[true_ref[:, None], cols].copy()        # (n_reads, read_len)
    # substitution errors
    emask = rng.random(frags.shape) < sub_error
    shift = rng.integers(1, 4, size=frags.shape).astype(np.int8)
    frags = np.where(emask, (frags + shift) % 4, frags)
    # indel errors: at most one short indel per read
    has_indel = rng.random(n_reads) < indel_error * read_len
    lens = np.full((n_reads,), read_len, np.int32)
    for i in np.nonzero(has_indel)[0]:
        frag = frags[i]
        ip = int(rng.integers(1, read_len - 2))
        if rng.random() < 0.5:  # deletion of 1 base
            frag = np.concatenate([frag[:ip], frag[ip + 1 :]])
            lens[i] = read_len - 1
            frags[i, : read_len - 1] = frag
            frags[i, read_len - 1] = 4
        else:  # insertion of 1 base
            frags[i] = np.concatenate(
                [frag[:ip], rng.integers(0, 4, size=1).astype(np.int8),
                 frag[: read_len]]
            )[:read_len]
    # reverse complement within each read's own length
    comp = _COMP_TABLE[frags]
    idx = lens[:, None] - 1 - np.arange(read_len, dtype=np.int32)[None, :]
    rc = np.take_along_axis(comp, np.clip(idx, 0, read_len - 1), axis=1)
    rc = np.where(idx >= 0, rc, np.int8(4))
    frags = np.where(true_strand[:, None] == 1, rc, frags)

    reads = np.full((n_reads, read_len_max), 4, dtype=np.int8)
    reads[:, :read_len] = frags
    # pad past each read's own length
    pastlen = np.arange(read_len_max, dtype=np.int32)[None, :] >= lens[:, None]
    reads = np.where(pastlen, np.int8(4), reads)
    return reads, lens, true_ref, true_pos, true_strand


def simulate_dataset(
    n_species: int = 20,
    refs_per_species: int = 1,
    n_reads: int = 10_000,
    read_len: int = 100,
    read_len_max: int = 128,
    ref_len_max: int = 2048,
    sub_error: float = 0.004,
    indel_error: float = 0.0005,
    seed: int = 0,
    skewed_abundance: bool = True,
    leaf_per_ref: bool = False,
    n_present: int | None = None,
) -> SimulatedDataset:
    """Build a mock community. Default sizes = BASELINE config 1 (BASELINE.json:7).

    leaf_per_ref gives every reference its OWN taxonomy leaf below its
    species node - the shape of a real Greengenes DB through the CLI's
    _load_taxonomy (each ref is a distinct OTU leaf); the default groups
    strains under one species leaf (the config-2 multi-strain shape).

    n_present restricts the community: reads are drawn from only that many
    randomly-chosen references (a gut sample vs the full DB - BASELINE
    config 3), all other refs exist only in the index."""
    rng = np.random.default_rng(seed)

    # --- per-position mutation rates from region structure ---
    rates = np.concatenate([np.full(l, r) for l, r in _REGIONS])
    gene_len = rates.shape[0]
    if gene_len > ref_len_max:
        raise ValueError(f"gene length {gene_len} > ref_len_max {ref_len_max}")

    # --- phylogeny: random binary-ish tree over species via successive splits ---
    root_seq = rng.integers(0, 4, size=gene_len).astype(np.int8)
    # Evolve: start with one lineage; repeatedly pick a lineage, fork it.
    lineages = [root_seq]
    while len(lineages) < n_species:
        i = int(rng.integers(0, len(lineages)))
        parent = lineages[i]
        child = _mutate(parent, rates, rng, scale=rng.uniform(1.0, 3.0))
        lineages[i] = _mutate(parent, rates, rng, scale=rng.uniform(0.2, 1.0))
        lineages.append(child)

    # --- taxonomy tree: 7 ranks; group species hierarchically by random merges.
    # Build by assigning each species a path of labels: coarse ranks shared by
    # neighbouring species (group sizes shrink with depth).
    tax_parent = [0]
    tax_depth = [0]
    tax_name = ["root"]
    node_index: dict[tuple, int] = {(): 0}

    def _node(path: tuple) -> int:
        if path in node_index:
            return node_index[path]
        parent = _node(path[:-1])
        nid = len(tax_parent)
        tax_parent.append(parent)
        tax_depth.append(len(path))
        tax_name.append("/".join(str(p) for p in path))
        node_index[path] = nid
        return nid

    # rank r groups the n_species species into `sizes[r]` buckets (finer with
    # depth); the species rank is one leaf per species.
    sizes = [2, (n_species + 1) // 2, (n_species + 2) // 3,
             (n_species + 4) // 5, (n_species + 7) // 8,
             (n_species + 11) // 12, n_species]
    species_leaf = []
    for s in range(n_species):
        path = tuple((r, s * sizes[r] // n_species) for r in range(7))
        species_leaf.append(_node(path))

    # --- references: refs_per_species strains per species ---
    ref_names, ref_seq_list, ref_taxon = [], [], []
    for s in range(n_species):
        for j in range(refs_per_species):
            strain = _mutate(lineages[s], rates, rng, scale=0.15) if j else lineages[s]
            ref_names.append(f"sp{s}_strain{j}")
            ref_seq_list.append(strain)
            if leaf_per_ref:
                # distinct OTU leaf per reference under the species node
                # (real-Greengenes shape; identity column maps)
                path = tuple((r, s * sizes[r] // n_species)
                             for r in range(7)) + (("ref", s, j),)
                ref_taxon.append(_node(path))
            else:
                ref_taxon.append(species_leaf[s])
    n_refs = len(ref_names)
    ref_seqs = np.full((n_refs, ref_len_max), 4, dtype=np.int8)
    ref_lens = np.zeros((n_refs,), dtype=np.int32)
    for i, sq in enumerate(ref_seq_list):
        ref_seqs[i, : sq.shape[0]] = sq
        ref_lens[i] = sq.shape[0]

    # --- abundances ---
    if skewed_abundance:
        ab = rng.lognormal(0.0, 1.0, size=n_refs)
    else:
        ab = np.ones(n_refs)
    if n_present is not None and n_present < n_refs:
        present = rng.choice(n_refs, size=n_present, replace=False)
        mask = np.zeros(n_refs, bool)
        mask[present] = True
        ab = np.where(mask, ab, 0.0)
    ab = ab / ab.sum()

    # --- reads ---
    reads, read_lens, true_ref, true_pos, true_strand = _gen_reads(
        rng, ref_seqs, ref_lens, ab, n_reads, read_len, read_len_max,
        sub_error, indel_error)
    read_names = [f"read{i}" for i in range(n_reads)]
    read_quals = ["I" * int(read_lens[i]) for i in range(n_reads)]

    return SimulatedDataset(
        ref_names=ref_names,
        ref_seqs=ref_seqs,
        ref_lens=ref_lens,
        tax_parent=np.asarray(tax_parent, dtype=np.int32),
        tax_depth=np.asarray(tax_depth, dtype=np.int32),
        tax_name=tax_name,
        ref_taxon=np.asarray(ref_taxon, dtype=np.int32),
        read_names=read_names,
        reads=reads,
        read_lens=read_lens,
        read_quals=read_quals,
        true_ref=true_ref,
        true_pos=true_pos,
        true_strand=true_strand,
        abundance=ab,
    )


def toy_dataset(seed: int = 0, n_reads: int = 10_000) -> SimulatedDataset:
    """BASELINE config 1: 10k 100bp reads vs ~100-sequence reference subset."""
    return simulate_dataset(
        n_species=20, refs_per_species=5, n_reads=n_reads, seed=seed
    )


@dataclasses.dataclass
class CohortDataset:
    """Multi-sample cohort (BASELINE config 4): one shared reference
    community, per-sample strain abundances, per-sample read sets."""
    ds: SimulatedDataset                 # shared refs/taxonomy (its own reads
                                         # are a vestigial 1-read set; ignore)
    samples: List[Tuple[np.ndarray, np.ndarray]]   # (reads, read_lens) per sample
    true_ref: List[np.ndarray]           # per-sample source ref of each read
    abundance: np.ndarray                # (n_samples, n_refs) sampling weights


def simulate_cohort(
    n_species: int = 5,
    refs_per_species: int = 3,
    n_samples: int = 4,
    reads_per_sample: int = 4000,
    read_len: int = 100,
    read_len_max: int = 128,
    ref_len_max: int = 2048,
    sub_error: float = 0.004,
    indel_error: float = 0.0005,
    seed: int = 0,
    abundance_sigma: float = 1.0,
) -> CohortDataset:
    """Cohort mock community: the SAME strain panel sequenced in n_samples
    metagenomes whose per-strain abundances vary lognormally per sample.

    This is the shape where single-sample frequency phasing is provably blind
    (strain allele frequencies overlap within any one sample) but cross-sample
    abundance COVARIATION separates strains (oracle/cohort.py)."""
    ds = simulate_dataset(
        n_species=n_species, refs_per_species=refs_per_species, n_reads=1,
        read_len=read_len, read_len_max=read_len_max, ref_len_max=ref_len_max,
        sub_error=sub_error, indel_error=indel_error, seed=seed,
        skewed_abundance=False,
    )
    rng = np.random.default_rng(seed + 1_000_003)
    ab = rng.lognormal(0.0, abundance_sigma, size=(n_samples, ds.n_refs))
    ab /= ab.sum(axis=1, keepdims=True)
    samples, true_refs = [], []
    for j in range(n_samples):
        rj = np.random.default_rng(seed * 1009 + 31 * j + 7)
        reads, lens, tr, _, _ = _gen_reads(
            rj, ds.ref_seqs, ds.ref_lens, ab[j], reads_per_sample,
            read_len, read_len_max, sub_error, indel_error)
        samples.append((reads, lens))
        true_refs.append(tr)
    return CohortDataset(ds=ds, samples=samples, true_ref=true_refs,
                         abundance=ab)
