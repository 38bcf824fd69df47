"""The share of the traced window the host spent after the mesh stream's
batch loop, in the program's `stream.merge` spans (the ranks' read counts,
or pileups, summed across the cards) and `stream.replicate` spans (the
per-read outputs gathered to the first card and copied to every card),
made again on every pass. A checkout without these spans reads None."""

from benchmark.harness import recorder


def read(rec):
    parts = [recorder.spans(rec, n) for n in ("stream.merge",
                                               "stream.replicate")]
    parts = [iv for iv in parts if iv is not None]
    if not parts or rec["window_s"] <= 0:
        return None
    merged = recorder.union([tuple(x) for iv in parts for x in iv])
    return 100.0 * recorder.length(merged) / (rec["window_s"] * 1e9)
