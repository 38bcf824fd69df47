"""Track each reference's best containment round by round, to see where
errors enter: the port of scripts/diagnose_rounds.py.

    python -m rambl_tpu_torch.scripts.diagnose_rounds [scenario ...]

For each scenario of `quality_bench.SCENARIOS` (all by default) it runs
the port's NumPy oracle's round loop as `oracle.pipeline.assemble` runs it
(round 0 on the references, then up to max_assembly_iters - 1 panel rounds
on `pad_panel` / `panel_tables`, each at the pinned hash geometry
max(8, ceil(log2(2 max_genes ref_len_max + 1)))), without its convergence
stop and without polish, and scores the panel after every round: each
gene goes to the reference it shares the most distinct 25-mers with (the
first of equals), and each reference at >= 5x coverage keeps the first of
its genes at the highest containment. It prints each reference's history
as containment/gene index, one column a round.

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.oracle.pipeline import (
    assemble_round,
    pad_panel,
    panel_tables,
)
from rambl_tpu_torch.scripts import quality_bench
from rambl_tpu_torch.scripts.diagnose_quality import CONFIG, coverage
from rambl_tpu_torch.scripts.quality_bench import best_matches


def score_panel(genes, ds, detectable) -> dict:
    """{detectable ref: (containment, gene index)} of its best gene, (0.0,
    -1) where none matches it best."""
    best = {int(r): (0.0, -1) for r in detectable}
    ids, conts = best_matches([g.seq for g in genes], ds.ref_seqs,
                              ds.ref_lens, np.arange(ds.n_refs))
    for gi, (b, c) in enumerate(zip(ids.tolist(), conts.tolist())):
        if b in best and c > best[b][0]:
            best[b] = (c, gi)
    return best


def rounds(ds, cfg: PipelineConfig, detectable) -> dict:
    """The round loop -> {detectable ref: [(containment, gene index) a
    round]}."""
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    genes, _ = assemble_round(ds.reads, ds.read_lens, ds.ref_seqs,
                              ds.ref_lens, tax, cfg, 0)
    hist = {int(r): [] for r in detectable}
    panel_bits = max(
        8, int(np.ceil(np.log2(2 * cfg.max_genes * cfg.ref_len_max + 1))))
    for it in range(cfg.max_assembly_iters):
        if it:
            if not genes:
                break
            pseqs, plens = pad_panel(genes, ds.ref_seqs.shape[1])
            genes, _ = assemble_round(ds.reads, ds.read_lens, pseqs, plens,
                                      panel_tables(genes, tax), cfg, it,
                                      n_bits=panel_bits)
        for r, b in score_panel(genes, ds, detectable).items():
            hist[r].append(b)
    return hist


def run(names=None, out=print) -> dict:
    """Each named scenario's round-by-round history (all by default) ->
    {name: {ref: [(containment, gene index), ...]}}."""
    scenarios = dict(quality_bench.SCENARIOS)
    cfg = PipelineConfig(**CONFIG)
    result = {}
    for name in names or list(scenarios):
        ds = simulate_dataset(**scenarios[name])
        cov = coverage(ds)
        detectable = np.nonzero(cov >= 5)[0]
        out(f"=== {name} ===")
        hist = rounds(ds, cfg, detectable)
        for r in detectable:
            row = " ".join(f"{c:.3f}/g{gi}" for c, gi in hist[int(r)])
            out(f"  ref {int(r):2d} cov {cov[r]:4.0f}x: {row}")
        result[name] = hist
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help="scenarios of quality_bench.SCENARIOS (default: all)")
    args = ap.parse_args(argv)
    run(args.names, out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
