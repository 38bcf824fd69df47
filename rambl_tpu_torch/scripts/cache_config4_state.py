"""Run the config-4 cohort once and keep everything its diagnoses read: the
port of scripts/cache_config4_state.py.

    python -m rambl_tpu_torch.scripts.cache_config4_state [out.npz]
        [--device D]

The cohort is `run_config4.cohort()`: `simulate_cohort(8 species x 5
strains, 5 samples of 5,120 reads, seed 11)`. It runs through
`pipeline.assemble.assemble_cohort` on the first CUDA card (or `--device`)
with the reference script's config (max_assembly_iters 4, batch 2,048,
max_genes 128, sw_rows 104; `run_config4.CONFIG` leaves sw_rows at 0), then
`leaf_counts_dict(taxa=every leaf of the panel)` per sample on the same
device against one shared index. `census_config4`, `diagnose_impure` and
`demonstrate_c4_ambiguity` read what is kept instead of running the cohort
again.

The state is one `.npz` of plain arrays (the reference pickles `rambl_tpu`
objects), loaded with `allow_pickle=False` by `load_state`: each sample's
reads and true sources, the panel (`ref_seqs`, `ref_lens`, `ref_names`,
`abundance`, `tax_parent`, `tax_depth`, `ref_taxon`), the config as JSON,
each sample's genes (`run_config3.gene_arrays`) and each sample's leaf
counts stacked as (samples, leaves, ref_len, 4) with their leaf ids. Its
default home is `build_scale_caches.cache_dir()`. `leaf_counts_dict` gives
every requested leaf, zeros where a sample has none, so each sample holds
counts for every leaf of the panel.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts import run_config4
from rambl_tpu_torch.scripts.run_config3 import gene_arrays, genes_of

CONFIG = dict(max_assembly_iters=4, batch_size=2048, max_genes=128,
              sw_rows=104)
_PANEL = ("ref_seqs", "ref_lens", "ref_names", "abundance", "tax_parent",
          "tax_depth", "ref_taxon")


@dataclasses.dataclass
class State:
    """The cohort's state: per sample its (reads, lens), its reads' true
    references, its final genes and its {leaf: (ref_len, 4) counts}; the
    shared panel's arrays and the config."""

    samples: list
    true_ref: list
    geneses: list
    counts_list: list
    ref_seqs: np.ndarray
    ref_lens: np.ndarray
    ref_names: np.ndarray
    abundance: np.ndarray
    tax_parent: np.ndarray
    tax_depth: np.ndarray
    ref_taxon: np.ndarray
    cfg: PipelineConfig

    @property
    def n_refs(self) -> int:
        return int(self.ref_seqs.shape[0])

    def tables(self):
        return build_taxonomy_tables(self.tax_parent, self.tax_depth,
                                     self.ref_taxon)


def state_path() -> str:
    """The default state file (the full-size cohort's)."""
    return os.path.join(caches.cache_dir(), "config4_torch_state.npz")


def _bounds(parts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum([len(p) for p in parts])]).astype(
        np.int64)


def save_state(path: str, st: State) -> None:
    """Write `st` as plain arrays, atomically (a temporary file renamed)."""
    taxa = sorted(st.counts_list[0]) if st.counts_list else []
    if any(sorted(c) != taxa for c in st.counts_list):
        raise ValueError("every sample must hold counts for the same leaves")
    arrays = {f: getattr(st, f) for f in _PANEL}
    arrays.update(
        reads=np.concatenate([r for r, _ in st.samples]),
        read_lens=np.concatenate([n for _, n in st.samples]),
        true_ref=np.concatenate(st.true_ref),
        sample_bounds=_bounds([n for _, n in st.samples]),
        config=np.array(st.cfg.to_json()),
        gene_sample_bounds=_bounds(st.geneses),
        count_taxa=np.asarray(taxa, np.int64),
        counts=np.stack([np.stack([c[t] for t in taxa]) for c in
                         st.counts_list]),
        **gene_arrays([g for genes in st.geneses for g in genes]))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_state(path: str) -> State:
    """Read `save_state`'s file (nothing is unpickled)."""
    with np.load(path, allow_pickle=False) as z:
        sb, gb = z["sample_bounds"], z["gene_sample_bounds"]
        reads, lens, true_ref = z["reads"], z["read_lens"], z["true_ref"]
        taxa, counts = z["count_taxa"].tolist(), z["counts"]
        n = sb.size - 1
        return State(
            samples=[(reads[sb[s]: sb[s + 1]], lens[sb[s]: sb[s + 1]])
                     for s in range(n)],
            true_ref=[true_ref[sb[s]: sb[s + 1]] for s in range(n)],
            geneses=[genes_of(z, lo=int(gb[s]), hi=int(gb[s + 1]))
                     for s in range(n)],
            counts_list=[{t: counts[s, i] for i, t in enumerate(taxa)}
                         for s in range(n)],
            cfg=PipelineConfig.from_json(str(z["config"])),
            **{f: z[f] for f in _PANEL})


def run(n_species: int = 8, n_samples: int = 5,
        reads_per_sample: int | None = None, *, path=None, device=None,
        co=None, results=None, overrides=None, out=print) -> State:
    """The cohort's state on `device` (the first CUDA card when None),
    written to `path` when given. `co` is the cohort when already
    simulated (`run_config4.cohort(...)`'s); `results`, `assemble_cohort`'s
    results for it under this config when already run; `overrides` replace
    config fields (tests)."""
    dev = resolve(device)
    if co is None:
        co = run_config4.cohort(n_species, n_samples, reads_per_sample)
    ds = co.ds
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = dataclasses.replace(PipelineConfig(**CONFIG), **(overrides or {}))
    if results is None:
        t0 = time.time()
        results = tassemble.assemble_cohort(co.samples, ds.ref_seqs,
                                            ds.ref_lens, tax, cfg, device=dev)
        out(f"cohort assembly: {time.time() - t0:.0f}s")
    t0 = time.time()
    shared_index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    taxa = np.unique(tax.ref_taxon)
    counts_list = [
        tassemble.leaf_counts_dict(reads, lens, ds.ref_seqs, ds.ref_lens,
                                   tax, cfg, taxa=taxa,
                                   shared_index=shared_index, device=dev)
        for reads, lens in co.samples]
    out(f"leaf counts: {time.time() - t0:.0f}s")
    st = State(samples=list(co.samples), true_ref=list(co.true_ref),
               geneses=[list(r.genes) for r in results],
               counts_list=counts_list, cfg=cfg,
               **{f: np.asarray(getattr(ds, f)) for f in _PANEL})
    if path is not None:
        save_state(path, st)
        out(f"state -> {path}")
    return st


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=None,
                    help="state file (default: config4_torch_state.npz in "
                    "$RAMBL_SCALE_CACHE or _scale_cache/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(path=args.out or state_path(), device=args.device,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
