"""The `cluster` traffic kind: round 0's `cluster_stage` a block of leaves
at a time, after the round's prelude in set-up (`cells.ClusterCell`)."""

from benchmark.harness.cells import ClusterCell as Cell  # noqa: F401
