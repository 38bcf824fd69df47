"""Driver config 2: a small mock community, ~20 taxa, 1 M reads, one card.
The port of scripts/run_config2.py.

    python -m rambl_tpu_torch.scripts.run_config2 [n_reads] [--device D]

Runs the whole assembly (`pipeline.assemble.assemble`) on the first CUDA
card (or `--device`; `cpu` runs the plain PyTorch path) and reports the
wall, reads/s, genes assembled an hour and truth recovery (references with
a gene at > 95% 25-mer containment). `RAMBL_MAX_GENES` sets the panel cap
(default 256: 100 refs x (variant + minor haplotype) genes). Beside the
reference's lines it prints each round's stages (with
RAMBL_STAGE_TIMING=1), col maps' build, launches and device memory
(`scripts.ladder`), each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import os
import signal
import time

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts.ladder import RoundRecorder
from rambl_tpu_torch.scripts.quality_bench import best_matches

N_READS = 1_000_000


def dataset(n_reads: int = N_READS):
    return simulate_dataset(n_species=20, refs_per_species=5,
                            n_reads=n_reads, seed=7)


def config(max_genes: int | None = None, **overrides) -> PipelineConfig:
    if max_genes is None:
        max_genes = int(os.environ.get("RAMBL_MAX_GENES", "256"))
    cfg = PipelineConfig(batch_size=16384, max_genes=max_genes,
                         max_clusters_per_bin=8, max_assembly_iters=4,
                         sw_rows=104)
    return dataclasses.replace(cfg, **overrides)


def run(n_reads: int = N_READS, *, device=None, max_genes=None, ds=None,
        overrides=None, out=print) -> dict:
    """Config 2 through the whole assembly on `device` (the first CUDA card
    when None). `ds` is the dataset when already built (it must be
    `dataset(n_reads)`); `overrides` replace config fields (tests). Returns
    {"result" (AssemblyResult), "cfg", "genes", "full_length", "recovered",
    "n_refs", "wall_s", "rounds" (RoundRecorder.summary()), "recorder",
    "card"}."""
    dev = resolve(device)
    card = card_line(dev)
    t0 = time.time()
    if ds is None:
        ds = dataset(n_reads)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    out(f"simulated {ds.reads.shape[0]} reads vs {ds.n_refs} refs in "
        f"{time.time() - t0:.0f}s")
    cfg = config(max_genes, **(overrides or {}))
    with RoundRecorder(dev) as rec:
        t1 = time.time()
        res = tassemble.assemble(ds.reads, ds.read_lens, ds.ref_seqs,
                                 ds.ref_lens, tax, cfg, device=dev)
        rec.sync()
        wall = time.time() - t1
    for s in res.round_stats:
        out(s)
    best, cont = best_matches([g.seq for g in res.genes], ds.ref_seqs,
                              ds.ref_lens, np.arange(ds.n_refs))
    recovered = set(best[cont > 0.95].tolist())
    n_full = len(res.full_length(cfg))
    aligns = sum(s.get("aligned", 0) for s in res.round_stats)
    out(f"wall {wall:.0f}s | rounds {res.n_rounds} converged {res.converged}"
        f" [{card}]")
    out(f"genes {len(res.genes)} full-length {n_full} "
        f"recovered>95% {len(recovered)}/{ds.n_refs}")
    out(f"effective alignment throughput {aligns / wall:.0f} reads/s "
        f"(incl all stages) [{card}]")
    out(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f} [{card}]")
    rec.report(card, out)
    return dict(result=res, cfg=cfg, genes=len(res.genes), full_length=n_full,
                recovered=len(recovered), n_refs=ds.n_refs, wall_s=wall,
                rounds=rec.summary(), recorder=rec, card=card)


def main(argv=None) -> None:
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=N_READS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(args.n_reads, device=args.device,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
