"""Driver config 3: a human-gut-shaped metagenome, ~10 M reads against a
full-Greengenes-sized index (~100k refs), one card (BASELINE.json:9). The
port of scripts/run_config3.py.

    python -m rambl_tpu_torch.scripts.run_config3 [n_reads] [n_refs] [--device D]

Shape choices match a real Greengenes DB through the CLI: every reference
is its own OTU leaf (identity column maps, as `cli._load_taxonomy` makes
them), the sample holds a few hundred present taxa with lognormal
abundance, and the index holds all the references. Exercises slot-compacted
node pileups (187,667 taxonomy nodes), int16 streaming retention and
DP-means in blocks of 512 leaves.

The dataset and index come from `scripts.build_scale_caches` (loaded from
its cache, or built and cached: 1-2 min of simulation and 1.5-2 min of
index build on the host at 10 M reads). `RAMBL_MAX_GENES` sets the panel cap (default
1024; 2048 is the cap of the recorded runs). Recovery counts the
detectable present references (>= 3x true depth) with a gene at > 95%
25-mer containment, scored after the wall (`quality_bench.
recovered_present`). Beside the reference's lines it prints each round's
stages (RAMBL_STAGE_TIMING=1), col maps' build, launches and device memory
(`scripts.ladder`) with the card's name and power limit. The reference's
panel dump for its miss diagnosis is not written: that diagnosis is not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import os
import signal
import time

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts.ladder import RoundRecorder
from rambl_tpu_torch.scripts.quality_bench import recovered_present

N_READS = 10_000_000


def config(n_reads: int, max_genes: int | None = None,
           **overrides) -> PipelineConfig:
    # the batch divides n_reads when it can (no padded tail)
    batch = 16000 if n_reads % 16000 == 0 else 16384
    # max_genes > n_present: 500 present refs saturate 256 and 1024 slots
    if max_genes is None:
        max_genes = int(os.environ.get("RAMBL_MAX_GENES", "1024"))
    cfg = PipelineConfig(batch_size=batch, max_genes=max_genes,
                         max_clusters_per_bin=16, max_assembly_iters=4,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    return dataclasses.replace(cfg, **overrides)


def describe(data, tax, t0, out):
    out(f"dataset: {data.n_reads} reads vs {data.n_refs} refs "
        f"({int((data.abundance > 0).sum())} present, {tax.n_nodes} "
        f"taxonomy nodes) in {time.time() - t0:.0f}s")
    idx = data.index
    out(f"index: {idx.n_entries} entries, 2^{idx.n_bits} buckets")


def run(n_reads: int = N_READS, n_refs: int = caches.N_REFS, *,
        n_present: int = caches.N_PRESENT, device=None, max_genes=None,
        data=None, cache_dir="", overrides=None, out=print) -> dict:
    """Config 3 through the whole assembly on `device` (the first CUDA card
    when None). `data` is the `build_scale_caches.ScaleData` when already
    built, else it comes from `build_scale_caches.config3` (`cache_dir`:
    "" its default directory, None no cache). `overrides` replace config
    fields (tests). Returns {"result", "cfg", "aux", "genes",
    "full_length", "recovered", "detectable", "present", "wall_s",
    "score_s", "rounds", "recorder", "card"}."""
    dev = resolve(device)
    card = card_line(dev)
    t0 = time.time()
    if data is None:
        data = caches.config3(n_reads, n_refs, n_present,
                              directory=cache_dir, out=out)
    tax = build_taxonomy_tables(data.tax_parent, data.tax_depth,
                                data.ref_taxon)
    describe(data, tax, t0, out)
    cfg = config(data.n_reads, max_genes, **(overrides or {}))
    aux = {}
    with RoundRecorder(dev) as rec:
        t1 = time.time()
        res = tassemble.assemble(data.reads, data.read_lens, data.ref_seqs,
                                 data.ref_lens, tax, cfg,
                                 shared_index=data.index, aux_out=aux,
                                 device=dev)
        rec.sync()
        wall = time.time() - t1
    for s in res.round_stats:
        out(s)
    t2 = time.time()
    rec_n, det, present = recovered_present(data, res.genes)
    score_s = time.time() - t2
    n_full = len(res.full_length(cfg))
    aligns = sum(s.get("aligned", 0) for s in res.round_stats)
    out(f"wall {wall:.0f}s | rounds {res.n_rounds} converged {res.converged}"
        f" [{card}]")
    out(f"genes {len(res.genes)} full-length {n_full} | recovered>95% "
        f"{rec_n}/{det} detectable ({present} present) (scored in "
        f"{score_s:.0f}s after the wall)")
    out(f"effective throughput {aligns / wall:.0f} reads/s (all stages, "
        f"{aligns} alignments) [{card}]")
    out(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f} [{card}]")
    rec.report(card, out)
    return dict(result=res, cfg=cfg, aux=aux, genes=len(res.genes),
                full_length=n_full, recovered=rec_n, detectable=det,
                present=present, wall_s=wall, score_s=score_s,
                rounds=rec.summary(), recorder=rec, card=card)


def main(argv=None) -> None:
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=N_READS)
    ap.add_argument("n_refs", nargs="?", type=int, default=caches.N_REFS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--cache-dir", default="",
                    help="dataset + index cache directory (default: "
                    "$RAMBL_SCALE_CACHE or _scale_cache/)")
    ap.add_argument("--no-cache", action="store_true",
                    help="build the dataset and index, and write no cache")
    args = ap.parse_args(argv)
    run(args.n_reads, args.n_refs, device=args.device,
        cache_dir=None if args.no_cache else args.cache_dir,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
