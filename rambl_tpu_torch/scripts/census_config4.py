"""Config 4's miss census: where cohort phasing lost each strain it did not
recover. The port of scripts/census_config4.py.

    python -m rambl_tpu_torch.scripts.census_config4 [n_species] [n_samples]
        [reads_per_sample] [--device D]

As the reference does, `main` runs the cohort itself (`cache_config4_state.
run`: `assemble_cohort`, then `leaf_counts_dict` for every leaf of the
panel, on the first CUDA card or `--device`); `run` takes that state from
memory. A strain is detectable at >= 5x coverage pooled over the samples;
each gene goes to the reference it shares the most distinct 25-mers with
(the first of equals), and a strain is missed when its best gene's
containment is at most .95. Each miss lands in the first bucket whose test
it meets, in this order:

  no-backbone          its leaf has no gene in any sample
  few-true-cols        fewer than cohort_min_cols columns where the strain's
                       base differs from the pooled major (at depth)
  cols-not-qualifying  those columns exist but too few qualify with the
                       strain's base as the minor; the breakdown names the
                       gate each one failed (depth, min_abs, frac,
                       major-side, non-unique-2nd, cap/other, or
                       qual-but-other-allele)
  grouped-wrongly      `phase_columns` spreads them (the best group covers
                       < .6 of them, or < .6 of that group is theirs)
  emitted-low-support  the group's median per-sample support stays below
                       min_cluster_reads in every sample
  emitted-impure       a gene came from the group, below .95 containment

Strains are substitution-only mutants of their species, so a strain's
columns are its leaf pileup's columns.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np

from rambl_tpu_torch.oracle.cohort import phase_columns, qualifying_columns
from rambl_tpu_torch.scripts import cache_config4_state
from rambl_tpu_torch.scripts.quality_bench import best_containment, coverage


def leaf_stack(st, t: int) -> np.ndarray:
    """(samples, ref_len, 4) int64 counts of leaf `t`, zeros where a sample
    has none (the reference scripts' `.get`)."""
    zeros = np.zeros((st.ref_seqs.shape[1], 4), np.int64)
    return np.stack([c.get(t, zeros).astype(np.int64)
                     for c in st.counts_list])


def _gate(c: int, pool_srt, tot, cfg) -> str:
    """The qualifying gate a pooled column `c` fails first."""
    minor = pool_srt[c, -2]
    if tot[c] < cfg.min_coverage:
        return "depth"
    if minor < cfg.cohort_min_abs:
        return "min_abs"
    if minor * cfg.cohort_frac_den < cfg.cohort_frac_num * max(int(tot[c]), 1):
        return "frac"
    if 2 * minor > tot[c]:
        return "major-side"
    if pool_srt[c, -2] == pool_srt[c, -3]:
        return "non-unique-2nd"
    return "cap/other"


def run(st, out=print) -> Counter:
    """The census of `st` (`cache_config4_state.State`) -> its buckets."""
    cfg = st.cfg
    tax = st.tables()
    cov = coverage(st, st.true_ref)
    detectable = np.nonzero(cov >= 5.0)[0]
    genes = [g for gs in st.geneses for g in gs]
    best = best_containment(genes, st, np.arange(st.n_refs), detectable)
    rec = [r for r, c in best.items() if c > 0.95]
    missed = [r for r, c in best.items() if c <= 0.95]
    out(f"recovered {len(rec)}/{len(detectable)}; census of {len(missed)} "
        f"misses:")
    leaf_genes = Counter(int(g.taxon) for g in genes)

    buckets = Counter()
    for r in missed:
        t = int(tax.ref_taxon[r])
        head = f"  ref {r} (leaf {t}, cov {cov[r]:5.1f}x, cont {best[r]:.3f}):"
        stack = leaf_stack(st, t)
        if leaf_genes[t] == 0:
            buckets["no-backbone"] += 1
            out(f"{head} no-backbone")
            continue
        cols, b1, b2, m, tt = qualifying_columns(stack, cfg)
        pool = stack.sum(axis=0)
        tot = pool.sum(axis=1)
        pb1 = np.argmax(pool, axis=1)
        L = int(st.ref_lens[r])
        rseq = st.ref_seqs[r, :L]
        # the strain's private columns: its base is not the pooled major
        tv = np.nonzero((rseq != pb1[:L]) & (tot[:L] > 0))[0]
        if tv.size < max(1, cfg.cohort_min_cols):
            buckets["few-true-cols"] += 1
            out(f"{head} few-true-cols ({tv.size})")
            continue
        colset = {int(c): i for i, c in enumerate(cols.tolist())}
        qual_r = [c for c in tv.tolist()
                  if c in colset and int(b2[colset[c]]) == int(rseq[c])]
        if len(qual_r) < max(1, cfg.cohort_min_cols):
            srt = np.sort(pool, axis=1)
            gates = Counter("qual-but-other-allele" if c in colset
                            else _gate(c, srt, tot, cfg) for c in tv.tolist())
            buckets["cols-not-qualifying"] += 1
            out(f"{head} cols-not-qualifying (true {tv.size}, qual "
                f"{len(qual_r)}; gates {dict(gates)})")
            continue
        assign = phase_columns(m, tt, cfg)
        gcnt = Counter(int(assign[colset[c]]) for c in qual_r)
        g_best, g_hits = gcnt.most_common(1)[0]
        own = np.nonzero(assign == g_best)[0]
        purity = g_hits / max(own.size, 1)
        cover = g_hits / len(qual_r)
        supp = np.sort(m[own], axis=0)[(own.size - 1) // 2]   # the median
        if cover < 0.6 or purity < 0.6:
            buckets["grouped-wrongly"] += 1
            out(f"{head} grouped-wrongly (qual {len(qual_r)}, best grp "
                f"{g_best}: cover {cover:.2f} purity {purity:.2f}, grp "
                f"sizes {dict(gcnt)})")
        elif int(supp.max(initial=0)) < cfg.min_cluster_reads:
            buckets["emitted-low-support"] += 1
            out(f"{head} emitted-low-support (max/sample "
                f"{int(supp.max(initial=0))})")
        else:
            buckets["emitted-impure"] += 1
            out(f"{head} emitted-impure (cover {cover:.2f} purity "
                f"{purity:.2f}, own {own.size} cols)")
    out(f"census: {dict(buckets)}")
    return buckets


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_species", nargs="?", type=int, default=8)
    ap.add_argument("n_samples", nargs="?", type=int, default=5)
    ap.add_argument("reads_per_sample", nargs="?", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    def out(*a):
        print(*a, flush=True)

    st = cache_config4_state.run(args.n_species, args.n_samples,
                                 args.reads_per_sample, device=args.device,
                                 out=out)
    run(st, out=out)


if __name__ == "__main__":
    main()
