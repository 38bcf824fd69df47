"""K1 variant sweep on one card: the port of scripts/bench_sw_variants.py (S1).

    python -m rambl_tpu_torch.scripts.bench_sw_variants [--device D]

Runs the production K1 (`ops.sw_cuda.sw_score_cuda`) and every S1 variant
(`ops.sw_variants.VARIANTS`: strips a pair x warps a block x packed 16-bit
or 32-bit arithmetic, one instance of the strip kernel each) on 131,072 pairs x 128 query rows x 161 window columns of
random codes (seed 0; q in 0..4, w in 0..3, as the JAX script draws them).
Each is held against the port's NumPy oracle on its first 256 pairs before it
is timed; a mismatch raises. Times are CUDA events, the median of 3 trials of
8 launches with the spread; GCUPS = pairs * L * W / s / 1e9. Prints one line
per kernel, the winner, and the card's name and power limit beside them.

Runs on the first CUDA card and raises where there is none, unless a device
is given (`--device cpu` runs the plain PyTorch version on the host clock).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.ops.sw_cuda import sw_score_cuda
from rambl_tpu_torch.ops.sw_variants import VARIANTS, make_score_fn
from rambl_tpu_torch.oracle.sw import sw_batch
from rambl_tpu_torch.utils.timing import median_spread, trial_times

PAIRS, L, W = 131072, 128, 161


def run(pairs: int = PAIRS, L: int = L, W: int = W, *, device=None,
        trials: int = 3, iters: int = 8, check: int = 256, out=print) -> dict:
    """Sweep, check and time every kernel -> {"card", "cells", "results":
    {name: {"ms", "gcups", "spread_pct", "trials"}}, "winner"}."""
    dev = resolve(device)
    sc = ScoringParams()
    rng = np.random.default_rng(0)
    qn = rng.integers(0, 5, (pairs, L)).astype(np.int8)
    wn = rng.integers(0, 4, (pairs, W)).astype(np.int8)
    q = torch.from_numpy(qn).to(dev)
    w = torch.from_numpy(wn).to(dev)
    ref = sw_batch(qn[:check], wn[:check], sc, want_dirs=False)[:3]

    kernels = [("prod-K1", functools.partial(sw_score_cuda, sc=sc))]
    kernels += [(v.name, make_score_fn(sc, L, W, strips=v.strips,
                                       warps=v.warps, arith=v.arith))
                for v in VARIANTS]
    card = card_line(dev)
    cells = pairs * L * W
    out(f"S1 sweep: {pairs} pairs x {L} x {W} ({cells / 1e9:.2f} G cells), "
        f"median of {trials} trials of {iters} launches [{card}]")
    results = {}
    for name, fn in kernels:
        got = fn(q, w)
        for what, g, r in zip(("score", "i_end", "j_end"), got, ref):
            np.testing.assert_array_equal(
                r, g[:check].cpu().numpy(),
                err_msg=f"{name}: {what} differs from the NumPy oracle")
        times = trial_times(fn, q, w, device=dev, trials=trials, iters=iters)
        ms, spread = median_spread(times)
        gcups = cells / (ms * 1e-3) / 1e9
        results[name] = {"ms": ms, "gcups": gcups, "spread_pct": spread,
                         "trials": times}
        out(f"{name:14s} {ms:9.3f} ms {gcups:8.1f} GCUPS  (trials "
            f"{', '.join(f'{t:.3f}' for t in times)} ms, spread "
            f"{spread:.1f}%; oracle parity on {check} pairs OK)")
    winner = max(results, key=lambda k: results[k]["gcups"])
    out(f"winner: {winner} at {results[winner]['gcups']:.1f} GCUPS "
        f"({results[winner]['ms']:.3f} ms) [{card}]")
    return {"card": card, "cells": cells, "results": results,
            "winner": winner}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
