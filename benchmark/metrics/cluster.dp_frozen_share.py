"""The share of DP-means' leaf iterations that ran after the leaf had
converged (its state frozen, the work thrown away): the program's counts
`dp.frozen_leaf_iters` over `dp.leaf_iters` in the traced window."""

from benchmark.harness import recorder


def read(rec):
    return recorder.share(rec, "dp.frozen_leaf_iters", "dp.leaf_iters")
