"""Assembly-quality benchmark: recovery of known truth across scenarios, and
the recovery rules of the scale ladder. The port of scripts/quality_bench.py.

    python -m rambl_tpu_torch.scripts.quality_bench [--oracle] [--device D]

Tracks the biological quality metric (BASELINE.json:5, "identical 16S
assemblies", measured against simulated truth). Per scenario of
`SCENARIOS`: `recovered`, the references with >= 5x simulated coverage that
have a gene at > 95% 25-mer containment; `mean_cont`, the mean containment
of each detectable reference's best gene; `genes`, the panel size (an
over-splitting indicator). The assembly runs on the first CUDA card, or on
`--device`; `--oracle` runs the port's NumPy oracle instead (the
reference's `--jax` switch chose the device path, which is the port's
default).

Each runner of the ladder scores its genes with one rule of this module:

- `recovered`: this benchmark's (>= 5x from `true_ref`);
- `recovered_present`: run_config3's (present references at >= 3x true
  depth);
- `recovered_expected`: run_config5's (present references at >= 3x
  abundance-expected depth; its reads were drawn in chunks);
- `recovery`: run_config4's (>= 5x pooled over the cohort's samples).

A gene's best reference is the first, in ascending id, of those sharing
the most distinct 25-mers with it (the reference scripts' `max` over the
candidates); its containment is the shared count over the gene's distinct
25-mers. The counts come from one sparse product of 25-mer incidence
matrices, each 25-mer a base-5 integer of its codes (N included), so the
rules give the reference scripts' set arithmetic exactly, in seconds for
a 2,048-gene panel against 500 references.
"""

from __future__ import annotations

import argparse

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables

SCENARIOS = [
    # name, kwargs
    ("uniform-2strain", dict(n_species=5, refs_per_species=2, n_reads=1500,
                             seed=1, skewed_abundance=False)),
    ("skewed-2strain", dict(n_species=5, refs_per_species=2, n_reads=1500,
                            seed=2, skewed_abundance=True)),
    ("single-strain", dict(n_species=8, refs_per_species=1, n_reads=2000,
                           seed=3, skewed_abundance=False)),
    ("deep-uniform", dict(n_species=3, refs_per_species=1, n_reads=3000,
                          seed=4, skewed_abundance=False)),
]
CONFIG = dict(max_assembly_iters=4, batch_size=512)
K = 25


def kmers(s, k=K):
    """The distinct k-mers of a string (the reference scripts' helper)."""
    return set(s[i: i + k] for i in range(len(s) - k + 1))


def _kmer_keys(codes, k=K) -> np.ndarray:
    """The distinct k-mers of a code array as sorted base-5 int64 keys
    (codes clipped to 0..4 as `io.pack.decode_seq` does; 5^25 < 2^63)."""
    c = np.clip(np.asarray(codes, np.int64), 0, 4)
    n = c.size - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    key = np.zeros(n, np.int64)
    for j in range(k):
        key = key * 5 + c[j: j + n]
    return np.unique(key)


def shared_kmers(gene_seqs, ref_seqs, ref_lens, refs):
    """The distinct 25-mers each gene (code arrays) shares with each of
    `refs` -> (shared (n_genes, len(refs)) int, n_kmers (n_genes,) int64:
    each gene's distinct 25-mers, at least 1). A containment is
    shared / n_kmers, the reference scripts' float division."""
    from scipy import sparse

    refs = np.asarray(refs, np.int64)
    gk = [_kmer_keys(g) for g in gene_seqs]
    rk = [_kmer_keys(ref_seqs[r, : ref_lens[r]]) for r in refs]
    n_kmers = np.array([max(p.size, 1) for p in gk], np.int64)
    if not gk or not refs.size:
        return np.zeros((len(gk), refs.size), np.int64), n_kmers
    keys, col = np.unique(np.concatenate(gk + rk), return_inverse=True)

    def incidence(parts, cols):
        rows = np.repeat(np.arange(len(parts)), [p.size for p in parts])
        return sparse.csr_matrix(
            (np.ones(rows.size, np.int32), (rows, cols)),
            shape=(len(parts), max(keys.size, 1)))

    n_g = sum(p.size for p in gk)
    shared = (incidence(gk, col[:n_g]) @ incidence(rk, col[n_g:]).T).toarray()
    return shared, n_kmers


def best_matches(gene_seqs, ref_seqs, ref_lens, refs):
    """For each gene (code arrays), its best reference among `refs`
    (ascending ids; the first of those sharing the most 25-mers) and its
    containment: (best (n_genes,) ids, cont (n_genes,) float64)."""
    refs = np.asarray(refs, np.int64)
    shared, n_kmers = shared_kmers(gene_seqs, ref_seqs, ref_lens, refs)
    if not refs.size:
        return np.full(len(n_kmers), -1, np.int64), np.zeros(len(n_kmers))
    idx = np.argmax(shared, axis=1)
    n_shared = shared[np.arange(len(n_kmers)), idx]
    return refs[idx], np.array([int(a) / int(b)
                                for a, b in zip(n_shared, n_kmers)])


def best_containment(genes, ds, candidates, detectable):
    """{detectable ref: containment of its best gene} over `genes`, each
    gene scored against `candidates` (ascending ids)."""
    best = {int(r): 0.0 for r in detectable}
    ids, cont = best_matches([g.seq for g in genes], ds.ref_seqs, ds.ref_lens,
                             candidates)
    for r, c in zip(ids.tolist(), cont.tolist()):
        if r in best:
            best[r] = max(best[r], c)
    return best


def recovered(ds, genes, cov_min=5.0):
    """quality_bench's rule: references with >= cov_min x simulated coverage
    (from `true_ref`) and a gene at > 95% containment, every reference a
    candidate -> (recovered, detectable, mean_cont)."""
    best = best_containment(genes, ds, np.arange(ds.n_refs),
                            np.nonzero(coverage(ds) >= cov_min)[0])
    mc = np.mean(list(best.values())) if best else 0.0
    return sum(1 for c in best.values() if c > 0.95), len(best), float(mc)


def present_recovery(ds, genes, depth):
    """run_config3's and run_config5's sets: present references (abundance
    > 0) with `depth` >= 3x their length are detectable; a gene recovers
    the present reference it matches best when its containment is > 95%
    -> (recovered ids ascending, detectable, present)."""
    present = np.nonzero(ds.abundance > 0)[0]
    detectable = present[depth[present] >= 3 * ds.ref_lens[present]]
    ids, cont = best_matches([g.seq for g in genes], ds.ref_seqs, ds.ref_lens,
                             present)
    return np.unique(ids[cont > 0.95]), detectable, present


def _present_rule(ds, genes, depth):
    rec, detectable, present = present_recovery(ds, genes, depth)
    return (int(np.isin(rec, detectable).sum()), int(detectable.size),
            int(present.size))


def true_depth(ds, true_refs=None):
    """Each reference's simulated bases (its reads x 100), from
    `ds.true_ref` or pooled over `true_refs` (one array a sample)."""
    if true_refs is None:
        true_refs = [ds.true_ref]
    reads = sum(np.bincount(tr, minlength=ds.n_refs) for tr in true_refs)
    return reads * 100.0


def coverage(ds, true_refs=None):
    """Each reference's simulated coverage: `true_depth` / its length."""
    return true_depth(ds, true_refs) / ds.ref_lens


def recovered_present(ds, genes):
    """run_config3's rule (`present_recovery` at the true depth) ->
    (recovered, detectable, present)."""
    return _present_rule(ds, genes, true_depth(ds))


def recovered_expected(ds, genes, n_reads):
    """run_config5's rule: as `recovered_present`, with each present
    reference's abundance-expected depth (its share of n_reads x 100
    bases) in place of the true depth -> (recovered, detectable,
    present)."""
    present = np.nonzero(ds.abundance > 0)[0]
    depth = np.zeros(ds.n_refs)
    p = ds.abundance[present] / ds.abundance.sum()
    depth[present] = p * n_reads * 100.0
    return _present_rule(ds, genes, depth)


def recovery(ds, results, cov_min=5.0, true_refs=None):
    """run_config4's rule: references with >= cov_min x coverage pooled over
    the cohort's samples (`true_refs`, one array a sample) and a gene of
    any sample at > 95% containment -> (recovered, detectable,
    mean_cont)."""
    cov = coverage(ds, true_refs)
    best = best_containment([g for res in results for g in res.genes], ds,
                            np.arange(ds.n_refs),
                            np.nonzero(cov >= cov_min)[0])
    rec = sum(1 for c in best.values() if c > 0.95)
    return rec, len(best), float(np.mean(list(best.values()) or [0.0]))


def run(oracle: bool = False, *, device=None, out=print) -> dict:
    """Assemble every scenario (on `device`, or with the NumPy oracle) ->
    {"scenarios": {name: {recovered, detectable, mean_cont, genes, rounds,
    converged}}, "recovered", "detectable"}."""
    if oracle:
        from rambl_tpu_torch.oracle.pipeline import assemble

        def assemble_fn(*a):
            return assemble(*a)
    else:
        from rambl_tpu_torch.pipeline.assemble import assemble

        dev = resolve(device)

        def assemble_fn(*a):
            return assemble(*a, device=dev)

    cfg = PipelineConfig(**CONFIG)
    scen, total_rec, total_det = {}, 0, 0
    for name, kw in SCENARIOS:
        ds = simulate_dataset(**kw)
        tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
        res = assemble_fn(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens,
                          tax, cfg)
        rec, det, mc = recovered(ds, res.genes)
        total_rec += rec
        total_det += det
        scen[name] = dict(recovered=rec, detectable=det, mean_cont=mc,
                          genes=len(res.genes), rounds=res.n_rounds,
                          converged=res.converged)
        out(f"{name:18s}: recovered {rec}/{det} mean_cont {mc:.3f} genes "
            f"{len(res.genes)} rounds {res.n_rounds} conv {res.converged}")
    out(f"TOTAL recovered {total_rec}/{total_det}")
    return dict(scenarios=scen, recovered=total_rec, detectable=total_det)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--oracle", action="store_true",
                    help="assemble with the port's NumPy oracle (host)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(args.oracle, device=args.device,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
