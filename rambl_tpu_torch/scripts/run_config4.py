"""Config-4 quality run: a multi-sample cohort with cross-sample covariation
phasing (BASELINE.json config 4). The port of scripts/run_config4.py.

    python -m rambl_tpu_torch.scripts.run_config4 [n_species] [n_samples]
        [reads_per_sample] [--device D]

The scenario is the single-sample wall's shape: 5 strains per species leaf
at ~40x leaf depth a sample with lognormal abundances, where frequency
phasing in one sample recovers only the dominant strains. The SAME
community is sequenced in N samples whose strain abundances vary a sample
(`simulate_cohort`, seed 11), and cohort phasing (`oracle/cohort.py`)
clusters variant columns by their cross-sample frequency vectors.

`assemble_cohort` runs on the first CUDA card (or `--device`) with phasing
off, then on; each prints its recovery (references with >= 5x coverage
pooled over the cohort that have a gene at > 95% 25-mer containment,
`quality_bench.recovery`) and wall. Beside the reference's lines it prints
each sample's rounds (stages with RAMBL_STAGE_TIMING=1, col maps' build,
launches, device memory; `scripts.ladder`) with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import signal
import time

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_cohort
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts.ladder import RoundRecorder
from rambl_tpu_torch.scripts.quality_bench import recovery

CONFIG = dict(max_assembly_iters=4, batch_size=2048, max_genes=128)


def cohort(n_species: int = 8, n_samples: int = 5,
           reads_per_sample: int | None = None):
    if reads_per_sample is None:
        reads_per_sample = n_species * 640     # ~40x leaf depth a sample
    return simulate_cohort(n_species=n_species, refs_per_species=5,
                           n_samples=n_samples,
                           reads_per_sample=reads_per_sample, seed=11)


def run(n_species: int = 8, n_samples: int = 5,
        reads_per_sample: int | None = None, *, device=None, co=None,
        overrides=None, out=print) -> dict:
    """The cohort with phasing off, then on, on `device` (the first CUDA
    card when None). `co` is the cohort when already simulated (it must be
    `cohort(...)`'s); `overrides` replace config fields (tests). Returns
    {"off", "on": {"results", "recovered", "detectable", "mean_cont",
    "wall_s", "rounds", "recorder"}, "card"}."""
    dev = resolve(device)
    card = card_line(dev)
    if co is None:
        co = cohort(n_species, n_samples, reads_per_sample)
    ds = co.ds
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = dataclasses.replace(PipelineConfig(**CONFIG), **(overrides or {}))
    out_modes = {}
    for mode, phase in (("off", False), ("on", True)):
        with RoundRecorder(dev) as rec:
            t0 = time.time()
            res = tassemble.assemble_cohort(
                co.samples, ds.ref_seqs, ds.ref_lens, tax,
                dataclasses.replace(cfg, cohort_phase=phase), device=dev)
            rec.sync()
            wall = time.time() - t0
        rec_n, det, mc = recovery(ds, res, true_refs=co.true_ref)
        label = "WITH phasing:   " if phase else "WITHOUT phasing:"
        out(f"cohort {label} {rec_n}/{det} recovered (mean cont {mc:.3f})  "
            f"[{wall:.0f}s] [{card}]")
        rec.report(card, out)
        out_modes[mode] = dict(results=res, recovered=rec_n, detectable=det,
                               mean_cont=mc, wall_s=wall,
                               rounds=rec.summary(), recorder=rec)
    on, off = out_modes["on"], out_modes["off"]
    out(f"phasing overhead: {on['wall_s'] - off['wall_s']:+.0f}s; "
        f"genes/sample {[len(r.genes) for r in on['results']]}")
    return dict(off=off, on=on, card=card)


def main(argv=None) -> None:
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_species", nargs="?", type=int, default=8)
    ap.add_argument("n_samples", nargs="?", type=int, default=5)
    ap.add_argument("reads_per_sample", nargs="?", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(args.n_species, args.n_samples, args.reads_per_sample,
        device=args.device, out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
