"""The reference database of a deployment: a fixed 16S-like panel, its
taxonomy, and the port's prebuilt seed index and column maps.

The panel follows the semantics of the port's `data/simulate.py`
(`simulate_dataset`): a phylogeny of 16S-like genes with conserved and
variable regions, a 7-rank taxonomy, and `refs_per_species` strains a
species, optionally each its own OTU leaf (`leaf_per_ref`, the shape of a
real Greengenes database). The panel is drawn from a fixed panel seed in
the same random stream as `simulate_dataset`, so it is the panel that the
repository's scale runs use at that seed. The sample (which references are
present, their abundance, the reads) comes from the run's seed instead
(`harness.reads`).

A lab builds its database index once and assembles many samples against
it, so the index and column maps are built once per checkout by the port's
own build functions and cached as plain arrays (`allow_pickle=False`) under
`benchmark/_cache/`, which git ignores. The cache key covers the panel's
parameters, the generator's version and the source of the port's index,
column-map and taxonomy code, so a change to any of them builds anew.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

from benchmark.harness.spec import BENCH_DIR

GEN_VERSION = 1
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")

# (length, per-branch substitution rate) of the alternating conserved and
# variable segments (V1..V9), ~1550 bp: data/simulate.py's _REGIONS
_REGIONS = [
    (100, 0.002), (70, 0.06), (120, 0.002), (90, 0.08),
    (140, 0.002), (100, 0.10), (130, 0.002), (80, 0.08),
    (150, 0.002), (90, 0.06), (140, 0.002), (100, 0.10),
    (120, 0.002), (80, 0.06), (40, 0.002),
]

_PANEL = ("ref_seqs", "ref_lens", "tax_parent", "tax_depth", "ref_taxon")
_INDEX = ("bucket_start", "entry_key", "entry_ref", "entry_pos")


def _mutate(seq, rates, rng, scale):
    mask = rng.random(seq.shape[0]) < rates * scale
    shift = rng.integers(1, 4, size=seq.shape[0])
    out = seq.copy()
    out[mask] = (out[mask] + shift[mask]) % 4
    return out


def make_panel(n_species: int, refs_per_species: int, ref_len_max: int,
               leaf_per_ref: bool, panel_seed: int) -> dict:
    """The panel as plain arrays: ref_seqs (R, ref_len_max) int8 (pad 4),
    ref_lens (R,), tax_parent and tax_depth (n_nodes,), ref_taxon (R,)."""
    rng = np.random.default_rng(panel_seed)
    rates = np.concatenate([np.full(n, r) for n, r in _REGIONS])
    gene_len = rates.shape[0]
    if gene_len > ref_len_max:
        raise ValueError(f"gene length {gene_len} > ref_len_max {ref_len_max}")
    lineages = [rng.integers(0, 4, size=gene_len).astype(np.int8)]
    while len(lineages) < n_species:
        i = int(rng.integers(0, len(lineages)))
        parent = lineages[i]
        child = _mutate(parent, rates, rng, scale=rng.uniform(1.0, 3.0))
        lineages[i] = _mutate(parent, rates, rng, scale=rng.uniform(0.2, 1.0))
        lineages.append(child)

    parent_of, depth_of = [0], [0]
    node_index = {(): 0}

    def node(path):
        if path in node_index:
            return node_index[path]
        p = node(path[:-1])
        nid = len(parent_of)
        parent_of.append(p)
        depth_of.append(len(path))
        node_index[path] = nid
        return nid

    sizes = [2, (n_species + 1) // 2, (n_species + 2) // 3,
             (n_species + 4) // 5, (n_species + 7) // 8,
             (n_species + 11) // 12, n_species]

    def species_path(s):
        return tuple((r, s * sizes[r] // n_species) for r in range(7))

    species_leaf = [node(species_path(s)) for s in range(n_species)]
    seqs, taxon = [], []
    for s in range(n_species):
        for j in range(refs_per_species):
            seqs.append(_mutate(lineages[s], rates, rng, scale=0.15) if j
                        else lineages[s])
            taxon.append(node(species_path(s) + (("ref", s, j),))
                         if leaf_per_ref else species_leaf[s])
    R = len(seqs)
    ref_seqs = np.full((R, ref_len_max), 4, np.int8)
    ref_lens = np.zeros((R,), np.int32)
    for i, sq in enumerate(seqs):
        ref_seqs[i, :sq.shape[0]] = sq
        ref_lens[i] = sq.shape[0]
    return dict(ref_seqs=ref_seqs, ref_lens=ref_lens,
                tax_parent=np.asarray(parent_of, np.int32),
                tax_depth=np.asarray(depth_of, np.int32),
                ref_taxon=np.asarray(taxon, np.int32))


def _build_sources() -> bytes:
    import rambl_tpu_torch

    pkg = os.path.dirname(os.path.abspath(rambl_tpu_torch.__file__))
    out = b""
    for rel in ("index/builder.py", "index/colmap.py", "index/taxonomy.py"):
        with open(os.path.join(pkg, rel), "rb") as f:
            out += f.read()
    return out


def cache_key(panel_cfg: dict, k: int) -> str:
    h = hashlib.sha256(json.dumps(dict(panel_cfg, k=k, gen=GEN_VERSION),
                                  sort_keys=True).encode())
    h.update(_build_sources())
    return h.hexdigest()[:16]


class Database:
    """The deployment's reference database: panel arrays, the port's
    `SeedIndex`, its `TaxonomyTables` and column maps (host arrays)."""

    def __init__(self, arrays: dict, meta: dict):
        from rambl_tpu_torch.index.builder import SeedIndex
        from rambl_tpu_torch.index.taxonomy import TaxonomyTables

        for f in _PANEL:
            setattr(self, f, arrays[f])
        self.index = SeedIndex(k=meta["k"], n_bits=meta["n_bits"],
                               n_refs=meta["n_refs"],
                               max_bucket=meta["max_bucket"],
                               **{f: arrays[f"index_{f}"] for f in _INDEX})
        self.tables = TaxonomyTables(anc_path=arrays["anc_path"],
                                     depth=arrays["depth"],
                                     ref_taxon=arrays["ref_taxon"],
                                     n_nodes=int(arrays["depth"].shape[0]))
        self.col_map = arrays["col_map"]

    @property
    def n_refs(self) -> int:
        return int(self.ref_seqs.shape[0])


def _build(panel_cfg: dict, k: int, log) -> tuple:
    from rambl_tpu_torch.index.builder import build_seed_index
    from rambl_tpu_torch.index.colmap import build_col_maps
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables

    t0 = time.time()
    p = make_panel(**panel_cfg)
    log(f"panel: {p['ref_seqs'].shape[0]} references, "
        f"{p['tax_parent'].shape[0]} taxonomy nodes in {time.time() - t0:.1f} s")
    t0 = time.time()
    idx = build_seed_index(p["ref_seqs"], p["ref_lens"], k=k)
    log(f"index: {idx.n_entries} entries, 2^{idx.n_bits} buckets in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    tabs = build_taxonomy_tables(p["tax_parent"], p["tax_depth"],
                                 p["ref_taxon"])
    cmap = build_col_maps(p["ref_seqs"], p["ref_lens"], p["ref_taxon"])
    log(f"taxonomy tables and column maps in {time.time() - t0:.1f} s")
    arrays = dict(p, col_map=cmap, anc_path=tabs.anc_path, depth=tabs.depth,
                  **{f"index_{f}": getattr(idx, f) for f in _INDEX})
    meta = dict(k=idx.k, n_bits=idx.n_bits, n_refs=idx.n_refs,
                max_bucket=idx.max_bucket)
    return arrays, meta


def load_database(name: str, panel_cfg: dict, k: int, log=print) -> Database:
    """The deployment's database from its cache, built and cached first
    when absent. The cache directory is fixed by the key, so every run in
    a checkout after the first finds it."""
    path = os.path.join(CACHE_DIR, f"{name}-{cache_key(panel_cfg, k)}")
    if not os.path.exists(os.path.join(path, "meta.json")):
        arrays, meta = _build(panel_cfg, k, log)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for f, a in arrays.items():
            np.save(os.path.join(tmp, f + ".npy"), a, allow_pickle=False)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        log(f"database cache written: {path} ({size / 1e9:.3f} GB)")
        return Database(arrays, meta)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrays = {f[:-4]: np.load(os.path.join(path, f), allow_pickle=False)
              for f in sorted(os.listdir(path)) if f.endswith(".npy")}
    return Database(arrays, meta)
