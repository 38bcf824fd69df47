"""The share of the traced window in which the device ran nothing while
the stream's batch loop ran: the window's idle time (the window less the
union of device intervals) under the program's `stream.loop` spans
(`stream_batches`), over the window. On several cards it is the mean of
the cards' shares, as `stream.idle_share` is. At most `stream.idle_share`;
the rest of that is idle time outside the loop (the preparation, the
pass's end)."""

from benchmark.harness import recorder


def read(rec):
    loop = recorder.spans(rec, "stream.loop")
    if loop is None or rec["window_s"] <= 0:
        return None
    cards = rec["trace"].card_merged.values()
    idle = sum(recorder.length(loop) - recorder.overlap(loop, merged)
               for merged in cards) / len(cards)
    return 100.0 * idle / (rec["window_s"] * 1e9)
