"""Split K1's input preparation from kernel time on one card: the port of
scripts/ablate_prep.py (S2).

    python -m rambl_tpu_torch.scripts.ablate_prep [--device D]

At 65,536 pairs x 128 query rows x 160 window columns of random codes (seed
0, as the JAX script draws them) it times, with CUDA events (median of 3
trials of 8 calls, spread printed):

- prep alone: `ops.sw_variants.prep`, the cast + transpose + pad of the
  inputs into the batch-minor int32 layout, in plain PyTorch;
- the S2 kernel alone (`score_pretransposed`) on inputs already in that
  layout;
- the full production K1 (`sw_score_cuda`) on the int8 pairs.

Before timing, the S2 kernel's decoded keys on the first 256 pairs are held
against the port's NumPy oracle (q in 0..4 against w in 0..3 matches exactly
where the oracle does). Prints each time and the card's name and power limit.

Runs on the first CUDA card and raises where there is none, unless a device
is given (`--device cpu` runs the plain PyTorch versions on the host clock).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.ops.sw_cuda import sw_score_cuda
from rambl_tpu_torch.ops.sw_variants import (
    decode_raw_key,
    prep,
    score_pretransposed,
)
from rambl_tpu_torch.oracle.sw import sw_batch
from rambl_tpu_torch.utils.timing import median_spread, trial_times

PAIRS, L, W = 65536, 128, 160


def run(pairs: int = PAIRS, L: int = L, W: int = W, *, device=None,
        trials: int = 3, iters: int = 8, check: int = 256, out=print) -> dict:
    """-> {"card", "cells", "prep", "kernel_only", "full"}, each time a dict
    {"ms", "spread_pct", "trials"}."""
    dev = resolve(device)
    sc = ScoringParams()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 5, (pairs, L)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(0, 4, (pairs, W)).astype(np.int8)).to(dev)
    qTn = rng.integers(0, 5, (L, pairs)).astype(np.int32)
    wTn = rng.integers(0, 4, (W + L + 1, pairs)).astype(np.int32)
    qT = torch.from_numpy(qTn).to(dev)
    wT = torch.from_numpy(wTn).to(dev)

    got = decode_raw_key(score_pretransposed(qT, wT, sc, W)[:check], W)
    ref = sw_batch(qTn[:, :check].T.astype(np.int8),
                   wTn[:W, :check].T.astype(np.int8), sc, want_dirs=False)
    for what, g, r in zip(("score", "i_end", "j_end"), got, ref[:3]):
        np.testing.assert_array_equal(
            r, g.cpu().numpy(), err_msg=f"S2: {what} differs from the oracle")

    card = card_line(dev)
    cells = pairs * L * W
    out(f"S2 prep ablation: {pairs} pairs x {L} x {W} ({cells / 1e9:.2f} G "
        f"cells), median of {trials} trials of {iters} calls [{card}]")
    res = {"card": card, "cells": cells}
    for key, label, fn, args in (
            ("prep", "prep (cast+transpose+pad)", prep, (q, w)),
            ("kernel_only", "kernel only (pre-T inputs)", score_pretransposed,
             (qT, wT, sc, W)),
            ("full", "full sw_score_cuda", sw_score_cuda, (q, w, sc))):
        times = trial_times(fn, *args, device=dev, trials=trials, iters=iters)
        ms, spread = median_spread(times)
        res[key] = {"ms": ms, "spread_pct": spread, "trials": times}
        out(f"{label:28s} {ms:9.3f} ms  (trials "
            f"{', '.join(f'{t:.3f}' for t in times)} ms, spread "
            f"{spread:.1f}%) [{card}]")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
