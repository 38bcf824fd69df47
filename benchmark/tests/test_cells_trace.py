"""The trace's reading (busy time as a union, the benchmark's own spans
left out, idle gaps named by the host's activity), on one card and on
several, and the per-layer readers, on synthetic profiles."""

import numpy as np
import pytest

from benchmark.harness import spec as S
from benchmark.harness.trace import WINDOW_SPAN, Trace

MS = 1_000_000


def _trace():
    ev = [(WINDOW_SPAN, False, 0, 100 * MS, None),
          ("bench.stream_align", True, 0, 100 * MS, 0),  # a span, not work
          ("sw_score_kernel(x)", True, 10 * MS, 30 * MS, 0),
          ("radixSort", True, 20 * MS, 40 * MS, 0),       # overlaps K1
          ("Memcpy HtoD", True, 60 * MS, 70 * MS, 0),
          ("aten::nonzero", False, 40 * MS, 60 * MS, None),
          ("cudaLaunchKernel", False, 9 * MS, 10 * MS, None),
          ("cudaLaunchKernel", False, 19 * MS, 20 * MS, None),
          ("bench.stream_align", False, 0, 100 * MS, None)]
    return Trace(ev)


def test_cells_trace_busy_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.040)       # 10-40 and 60-70 ms
    assert not tr.lost_records()
    assert tr.device_seconds("sw_score_kernel") == pytest.approx(0.020)
    assert [n for n, _ in tr.device_ops()][0] in ("sw_score_kernel(x)",
                                                  "radixSort")
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(0.020)
    assert sum(gaps.values()) == pytest.approx(0.060)


def test_cells_layer_readers():
    tr = _trace()
    rec = dict(trace=tr, work=1000, window_s=tr.window_s, busy_s=tr.busy_s,
               k1_launches=[(65536, 128, 160, 104)])
    assert S.reader("stream.idle_share")(rec) == pytest.approx(60.0)
    assert S.reader("cluster.idle_share")(rec) == pytest.approx(60.0)
    assert S.reader("align.device_ns_per_read")(rec) == pytest.approx(40000)
    k1 = S.reader("k1.roofline_share")(rec)
    # 65,536 x 104 x 160 cells at 3.5 ops over 132 x 64 x 1.98 G op/s
    least = 65536 * 104 * 160 * 3.5 / (132 * 64 * 1.98e9)
    assert least == pytest.approx(0.228e-3, rel=1e-3)
    assert k1 == pytest.approx(100 * least / 0.020)
    assert S.reader("k1.roofline_share")(dict(rec, k1_launches=[])) is None


def test_cells_trace_cards():
    """Three cards: each card's busy time is its own union, `busy_s` their
    mean, a card that recorded nothing is idle for the whole window, and
    the idle gaps are card-seconds named per card."""
    ev = [(WINDOW_SPAN, False, 0, 100 * MS, None),
          ("aten::add", False, 0, 50 * MS, None),
          ("aten::mul", False, 50 * MS, 100 * MS, None),
          ("k", True, 0, 40 * MS, 0),
          ("k", True, 30 * MS, 50 * MS, 0),                # overlaps
          ("k", True, 60 * MS, 100 * MS, 1),
          ("bench.span", True, 0, 100 * MS, 1)]             # a span
    tr = Trace(ev, cards=(0, 1, 2))
    assert tr.card_busy_s == pytest.approx({0: 0.050, 1: 0.040, 2: 0.0})
    assert tr.busy_s == pytest.approx(0.030)
    assert tr.card_merged == {0: [[0, 50 * MS]], 1: [[60 * MS, 100 * MS]],
                              2: []}
    assert dict(tr.device_ops()) == pytest.approx({"k": 0.100})
    gaps = dict(tr.idle_gaps())
    # card 0 idles 50-100 (mid in aten::mul), card 1 0-60 (mid in
    # aten::add), card 2 the whole window (mid at 50: aten::mul)
    assert gaps == pytest.approx({"aten::mul": 0.150, "aten::add": 0.060})
    assert sum(gaps.values()) == pytest.approx(
        3 * tr.window_s - sum(tr.card_busy_s.values()))
    with pytest.raises(AssertionError, match="card 1"):
        Trace(ev, cards=(0,))


def _parent_readings(events):
    """busy_s, merged (now the one card's `card_merged`), device_ops and
    idle_gaps as the one-card trace read them before cards: one union over
    every device interval."""
    w0, w1 = next((s, t) for n, d, s, t, _ in events if n == WINDOW_SPAN)
    dev = [(n, max(s, w0), min(t, w1)) for n, d, s, t, _ in events
           if d and t > w0 and s < w1 and not n.startswith("bench.")]
    busy, end, merged = 0, None, []
    for lo, hi in sorted((s, t) for _, s, t in dev):
        if end is None or lo > end:
            merged.append([lo, hi])
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            merged[-1][1] = hi
            end = hi
    tot = {}
    for n, s, t in dev:
        tot[n] = tot.get(n, 0) + (t - s)
    ops = [[n, v / 1e9] for n, v in
           sorted(tot.items(), key=lambda kv: -kv[1])[:10]]
    host = sorted(((n, s, t) for n, d, s, t, _ in events
                   if not d and t > w0 and s < w1 and n != WINDOW_SPAN),
                  key=lambda e: (e[1], -e[2]))
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    tot, stack, j = {}, [], 0
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        while j < len(host) and host[j][1] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = next((n for n, s_, t in reversed(stack) if t >= mid),
                     "(no host event)")
        tot[label] = tot.get(label, 0) + (ge - gs)
    idle = [[n, v / 1e9] for n, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:10]]
    return busy / 1e9, merged, ops, idle


@pytest.mark.parametrize("seed", range(6))
def test_cells_trace_one_card_reads_as_before(seed):
    """On one card every reading equals the one-union formulas, bit for
    bit, on random profiles with overlaps, spans and events past the
    window's edges."""
    rng = np.random.default_rng(seed)
    w0, w1 = 10**6, 10**6 + 10**9
    ev = [(WINDOW_SPAN, False, w0, w1, None)]
    for _ in range(400):
        s = int(rng.integers(0, w1 + 10**7))
        t = s + int(rng.integers(1, 10**7))
        on = bool(rng.random() < 0.6)
        name = str(rng.choice(["k1", "sort", "Memcpy HtoD", "bench.x",
                               "aten::add", "align.seed"]))
        ev.append((name, on, s, t, 0 if on else None))
    tr = Trace(ev)
    busy, merged, ops, idle = _parent_readings(ev)
    assert tr.busy_s == busy
    assert tr.card_merged == {0: merged}
    assert tr.device_ops() == ops
    assert tr.idle_gaps() == idle
