"""The share of the traced window in which the device ran nothing while
the stream's batch loop ran: the window's idle time (the window less the
union of device intervals) under the program's `stream.loop` spans
(`stream_batches`), over the window. At most `stream.idle_share`; the rest
of that is idle time outside the loop (the preparation, the pass's end)."""

from benchmark.harness import recorder


def read(rec):
    loop = recorder.spans(rec, "stream.loop")
    if loop is None or rec["window_s"] <= 0:
        return None
    idle = recorder.length(loop) - recorder.overlap(loop,
                                                    rec["trace"].merged)
    return 100.0 * idle / (rec["window_s"] * 1e9)
