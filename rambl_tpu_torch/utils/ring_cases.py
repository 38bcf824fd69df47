"""Seeded per-rank tuples of arrays for checking K4, the ring rotation,
against the plain rotation: shared by the card tests and `chip_smoke.py` so
that both hand the kernel the same odd counts and unaligned views.
"""

from __future__ import annotations

import numpy as np
import torch

#: (word counts of a rank's tuple, which of its arrays are unaligned views):
#: 1 to 4 arrays in ONE launch a rank, odd word counts (scalar tails),
#: arrays smaller than a 16,384-word tile, several tiles a block, and views
#: whose addresses are not 16-byte aligned (all scalar)
TUPLE_CASES = (
    ((1,), ()), ((3,), ()), ((4,), ()), ((65_537,), ()),
    ((16_384 * 3 + 2, 7), ()), ((100_003, 12_291), (1,)),
    ((5, 70_001, 16_384), (0,)), ((33_333, 4, 50_001), (0, 2)),
    ((9, 8, 7, 6), ()), ((1 << 21, 3 * (1 << 20) + 1), ()))


def ring_tuples(dev, n: int, seed: int, words, misalign=()):
    """(host, state, out) for n ranks: host[r][a] a random int32 array of
    words[a] words, state[r][a] its copy on `dev`, out[r][a] a zeroed
    receive buffer there. Array a in `misalign` is, in state and in out, a
    view one word into a larger buffer, so its address is 4 past a 16-byte
    boundary."""
    rng = np.random.default_rng(seed)
    host = [[rng.integers(-2**31, 2**31 - 1, (w,), dtype=np.int64)
             .astype(np.int32) for w in words] for _ in range(n)]

    def place(x, a):
        if a not in misalign:
            return torch.from_numpy(x).to(dev)
        view = torch.zeros(x.size + 5, dtype=torch.int32,
                           device=dev)[1:1 + x.size]
        view.copy_(torch.from_numpy(x))
        if view.data_ptr() % 16 != 4 or not view.is_contiguous():
            raise AssertionError("the view is not 4 bytes past a boundary")
        return view

    state = [tuple(place(x, a) for a, x in enumerate(arrs)) for arrs in host]
    out = [tuple(place(np.zeros_like(x), a) for a, x in enumerate(arrs))
           for arrs in host]
    return host, state, out
