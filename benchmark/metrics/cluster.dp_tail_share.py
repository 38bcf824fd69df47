"""The share of DP-means' block iterations that ran after every leaf of
the block had converged (a whole iteration of the block that changes
nothing): the program's counts `dp.tail_iters` over `dp.block_iters` in
the traced window."""

from benchmark.harness import recorder


def read(rec):
    return recorder.share(rec, "dp.tail_iters", "dp.block_iters")
