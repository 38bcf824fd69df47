"""The port's own spans and counters (`rambl_tpu_torch.utils.trace`) in a
traced window, for the per-layer metrics that read them.

The recorder keeps them in memory in the process that ran the window, on
the clock torch.profiler stamps its events with, so they are cut to the
window (`w0`, `w1` of the `Trace`) and compared with each card's device
intervals (`card_merged`) as they are. A checkout of the port without the
recorder, or a window in which it recorded none of a name, reads as None.
"""

from __future__ import annotations


def _recorder():
    try:
        from rambl_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def union(intervals) -> list:
    """Sorted, disjoint [lo, hi] covering the (lo, hi) given."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def length(merged) -> int:
    return sum(hi - lo for lo, hi in merged)


def overlap(a, b) -> int:
    """The length two sorted, disjoint interval lists share."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def spans(rec, name: str):
    """The union of the spans named `name`, cut to the window: sorted,
    disjoint [lo, hi] in ns; None when there is none."""
    tr = _recorder()
    if tr is None:
        return None
    w0, w1 = rec["trace"].w0, rec["trace"].w1
    cut = [(max(s, w0), min(t, w1)) for n, s, t, _ in tr.spans()
           if n == name and t > w0 and s < w1]
    return union(cut) or None


def total(rec, name: str):
    """The sum of the counts named `name` made inside the window; None when
    there is none."""
    tr = _recorder()
    if tr is None:
        return None
    w0, w1 = rec["trace"].w0, rec["trace"].w1
    vals = [n for m, t, n, _ in tr.counts() if m == name and w0 <= t <= w1]
    return sum(vals) if vals else None


def share(rec, part: str, whole: str):
    """100 * the counts `part` over the counts `whole` in the window."""
    p, w = total(rec, part), total(rec, whole)
    if p is None or not w:
        return None
    return 100.0 * p / w
