"""The share of the traced window the host spent in the stream's
preparation, the program's `stream.prepare` spans: from `stream_align`'s
entry to its first batch (the seed table's and the stream tables' uploads,
padding, pinning, the retention buffers), made again on every pass."""

from benchmark.harness import recorder


def read(rec):
    iv = recorder.spans(rec, "stream.prepare")
    if iv is None or rec["window_s"] <= 0:
        return None
    return 100.0 * recorder.length(iv) / (rec["window_s"] * 1e9)
