"""The share of DP-means' center-recount adds (`index_add_` of one per
(leaf, member, column) entry an iteration) that go to its one inert slot,
where every uncovered column and every padded member row lands: the
program's counts `dp.recount_inert_adds` over `dp.recount_adds` in the
traced window."""

from benchmark.harness import recorder


def read(rec):
    return recorder.share(rec, "dp.recount_inert_adds", "dp.recount_adds")
