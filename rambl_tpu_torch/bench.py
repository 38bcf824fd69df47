"""Benchmark of the port on one card: the counterpart of bench.py.

    python -m rambl_tpu_torch.bench [--device D]

Measures, with the card's name and power limit beside each number:

- `align_batch` reads/s per GPU: config 1's mock community
  (`toy_dataset(n_reads=16384)`), batches of 8,192 reads, `sw_rows` 104; two
  batches alternated, 16 batches per trial, host clock around work that ends
  in a synchronize (the per-batch time with the host's gaps in it); the median
  of 3 trials, with the spread;
- K1 GCUPS at 131,072 pairs x 128 rows x 160 columns (the full 128-row sweep,
  comparable across rounds), behind a parity gate: the compiled kernel's
  first 256 pairs must equal the port's NumPy oracle; CUDA events, median of
  3 trials of 16 launches; GCUPS = pairs * L * W / s / 1e9, as bench.py.

- the whole assembly (`pipeline.assemble.assemble`: rounds and polish) on
  bench.py's end-to-end dataset and config
  (`simulate_dataset(n_species=5, refs_per_species=2, n_reads=4096, seed=3,
  skewed_abundance=False)`, `PipelineConfig(batch_size=2048,
  max_assembly_iters=3, sw_rows=104)`), once, host clock around the call
  (the kernels are built by then): `e2e_wall_s` and `genes_per_hour` =
  full-length genes / wall hours.

Prints one JSON line on stdout (progress goes to stderr), with bench.py's key
names for what it measures and the device it ran on. `vs_baseline` keeps
bench.py's yardstick: value / 20,000 reads/s, its documented estimate of a
16-thread BWA-MEM node. Numbers are not rounded.

Runs on the first CUDA card and raises where there is none, unless a device
is given (`--device cpu` runs the plain PyTorch path on the host clock).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset, toy_dataset
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.ops.seed import SeedTable
from rambl_tpu_torch.ops.sw_cuda import sw_score_cuda
from rambl_tpu_torch.oracle.sw import sw_batch
from rambl_tpu_torch.pipeline.align import align_batch
from rambl_tpu_torch.pipeline.assemble import assemble
from rambl_tpu_torch.utils.timing import median_spread, trial_times

BWA_NODE_READS_PER_S = 20_000.0  # bench.py's documented estimate


def run(*, device=None, n_reads: int = 16384, batch: int = 8192,
        pairs: int = 131072, trials: int = 3, batches: int = 16,
        check: int = 256, e2e_reads: int = 4096, e2e_batch: int = 2048,
        out=print) -> dict:
    """Measure and print progress lines through `out`; returns the dict of
    the JSON line. `e2e_reads` and `e2e_batch` size the end-to-end
    assembly (bench.py's 4,096 and 2,048 by default)."""
    dev = resolve(device)
    if n_reads < 2 * batch:
        raise ValueError(f"n_reads={n_reads} must hold two batches of {batch}")
    card = card_line(dev)
    cfg = PipelineConfig(batch_size=batch, sw_rows=104)
    ds = toy_dataset(n_reads=n_reads)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table = SeedTable.from_index(index, dev)
    refs = torch.from_numpy(ds.ref_seqs).to(dev)
    two = [(torch.from_numpy(ds.reads[s:s + batch].copy()).to(dev),
            torch.from_numpy(ds.read_lens[s:s + batch].copy()).to(dev))
           for s in (0, batch)]

    def align_batches():
        for k in range(batches):
            r, ln = two[k % 2]
            align_batch(r, ln, table, refs, cfg)

    # per-batch time: trial_times divides the trial by its one call
    per_batch = [t / batches for t in trial_times(
        align_batches, device=dev, trials=trials, iters=1, host_clock=True)]
    per, align_spread = median_spread(per_batch)
    reads_per_s = batch / (per * 1e-3)
    out(f"align_batch: {per:.3f} ms/batch({batch}) = {reads_per_s:.0f} "
        f"reads/s/GPU (trials {', '.join(f'{t:.3f}' for t in per_batch)} ms, "
        f"spread {align_spread:.1f}%) [{card}]")

    L, W = cfg.read_len_max, cfg.window_len
    rng = np.random.default_rng(0)
    qn = rng.integers(0, 5, (pairs, L)).astype(np.int8)
    wn = rng.integers(0, 4, (pairs, W)).astype(np.int8)
    q = torch.from_numpy(qn).to(dev)
    w = torch.from_numpy(wn).to(dev)
    got = sw_score_cuda(q, w, cfg.scoring)
    ref = sw_batch(qn[:check], wn[:check], cfg.scoring, want_dirs=False)[:3]
    for what, g, r in zip(("score", "i_end", "j_end"), got, ref):
        np.testing.assert_array_equal(
            r, g[:check].cpu().numpy(),
            err_msg=f"K1 {what} differs from the NumPy oracle")
    out(f"sw compiled-kernel parity: OK ({check} pairs vs the NumPy oracle)")
    sw_trials = trial_times(sw_score_cuda, q, w, cfg.scoring, device=dev,
                            trials=trials, iters=16)
    sw_per, sw_spread = median_spread(sw_trials)
    gcups = pairs * L * W / (sw_per * 1e-3) / 1e9
    out(f"sw_score_cuda: {sw_per:.3f} ms/{pairs} pairs = {gcups:.1f} GCUPS "
        f"(trials {', '.join(f'{t:.3f}' for t in sw_trials)} ms, spread "
        f"{sw_spread:.1f}%) [{card}]")

    # end-to-end assembly -> full-length 16S genes/hour (bench.py's dataset)
    ds2 = simulate_dataset(n_species=5, refs_per_species=2, n_reads=e2e_reads,
                           seed=3, skewed_abundance=False)
    tax2 = build_taxonomy_tables(ds2.tax_parent, ds2.tax_depth, ds2.ref_taxon)
    cfg2 = PipelineConfig(batch_size=e2e_batch, max_assembly_iters=3,
                          sw_rows=104)
    t0 = time.perf_counter()
    res2 = assemble(ds2.reads, ds2.read_lens, ds2.ref_seqs, ds2.ref_lens,
                    tax2, cfg2, device=dev)
    e2e_wall = time.perf_counter() - t0
    n_full = len(res2.full_length(cfg2))
    genes_per_hour = n_full / (e2e_wall / 3600.0)
    out(f"e2e assembly: {e2e_wall:.3f} s, {len(res2.genes)} genes "
        f"({n_full} full-length) = {genes_per_hour:.0f} genes/hour "
        f"({e2e_reads} reads, {res2.n_rounds} rounds + polish, host clock) "
        f"[{card}]")

    line = {
        "metric": "reads_aligned_per_s_per_chip",
        "value": reads_per_s,
        "unit": "reads/s",
        "vs_baseline": reads_per_s / BWA_NODE_READS_PER_S,
        "align_spread_pct": align_spread,
        "sw_gcups": gcups,
        "sw_gcups_spread_pct": sw_spread,
        "genes_per_hour": genes_per_hour,
        "e2e_wall_s": e2e_wall,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "card": card},
    }
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    line = run(device=args.device,
               out=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
