"""Seeded (query, window) pairs for checking the SW kernels against their twin.

Host numpy arrays of base codes (0-3 = ACGT, 4 = N/pad), shared by the CPU
parity tests, the card tests and `chip_smoke.py` so that all of them feed the
kernels, the twin and the JAX reference the same kinds of input.
"""

from __future__ import annotations

import numpy as np


def planted_pairs(seed: int, B: int, L: int, W: int):
    """Random q (B, L) and w (B, W) with homology planted in a third of rows."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, L)).astype(np.int8)
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    n = min(L, W) - 4
    w[::3, 2:2 + n] = q[::3, 1:1 + n]
    return q, w


def gapped_pairs(seed: int, B: int, L: int, W: int):
    """Planted homology with a deletion (rows 1 mod 3) or an insertion (rows
    2 mod 3) in the window copy, so that best paths carry gaps."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (B, L)).astype(np.int8)
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    n = min(L, W) - 6
    for b in range(B):
        frag = q[b, 1:1 + n]
        if b % 3 == 1 and n > 8:
            frag = np.concatenate([frag[:n // 2], frag[n // 2 + 1:]])
        if b % 3 == 2 and n > 8:
            frag = np.concatenate(
                [frag[:n // 2], rng.integers(0, 4, 1).astype(np.int8), frag])
        m = min(frag.shape[0], W - 2)
        w[b, 2:2 + m] = frag[:m]
    return q, w


def short_reads(seed: int, B: int, L: int, W: int, max_len: int,
                min_len: int = 8):
    """Reads of min_len..max_len bases padded with code 4 to L (the layout
    that a `rows` sweep of at least max_len rows handles exactly), half of
    them planted in w, a quarter with a mismatch mid-copy."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, B)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    q[np.arange(L)[None, :] >= lens[:, None]] = 4
    w = rng.integers(0, 5, (B, W)).astype(np.int8)
    for b in range(0, B, 2):
        n = int(lens[b]) - 4
        w[b, 3:3 + n] = q[b, 1:1 + n]
        if b % 4 == 0 and n > 10:
            w[b, 3 + n // 2] = (q[b, 1 + n // 2] + 1) % 4
    return q, w


#: the blocks of `adversarial_pairs`, in order
ADVERSARIAL = ("equal", "homopolymer-gaps", "ties", "n-against-n",
               "all-mismatch")


def adversarial_pairs(seed: int, L: int, W: int, per_case: int = 32):
    """`per_case` pairs of each case of ADVERSARIAL, in that order, for the
    score kernel's 16-bit arithmetic and its best-cell order (L >= 8,
    W >= max(L, 34)):

    - equal: the read is a stretch of its window (score L: the top of the
      range);
    - homopolymer-gaps: one base all along the read, the window the same
      base cut by a short run of another, so gaps of both kinds compete
      with restarts;
    - ties: a block of five equal bases (score 5, ending at i = 8) that the
      window repeats b % 4 + 1 times, so cells of several rows and columns
      tie in H; the first block's end (j = 7) must win;
    - n-against-n: code 4 in both, which never matches itself;
    - all-mismatch: no positive cell, (0, 0, 0).
    """
    rng = np.random.default_rng(seed)
    n = per_case
    q = rng.integers(0, 4, (5 * n, L)).astype(np.int8)
    w = rng.integers(0, 4, (5 * n, W)).astype(np.int8)
    q[:n] = w[:n, (W - L) // 2:(W - L) // 2 + L]
    q[n:2 * n], w[n:2 * n] = 2, 2
    for b in range(n, 2 * n):
        cut = rng.integers(2, W - 12)
        w[b, cut:cut + rng.integers(1, 10)] = 1
    q[2 * n:3 * n], w[2 * n:3 * n] = 4, 5
    for b in range(2 * n, 3 * n):
        q[b, 3:8] = 1
        for rep in range(b % 4 + 1):
            w[b, 2 + 9 * rep:7 + 9 * rep] = 1
    q[3 * n:4 * n, ::2], w[3 * n:4 * n, ::3] = 4, 4
    q[4 * n:], w[4 * n:] = 0, 1
    return q, w
