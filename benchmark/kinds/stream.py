"""The `stream` traffic kind: whole `stream_align` passes over the sample
(`cells.StreamCell`)."""

from benchmark.harness.cells import StreamCell as Cell  # noqa: F401
