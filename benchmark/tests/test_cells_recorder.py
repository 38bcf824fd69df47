"""The readers of the port's own spans and counters (`stream.prepare_share`,
`stream.loop_idle_share` and the three DP-means shares) on a synthetic
`Trace` and synthetic recorder entries: entries outside the window are
ignored, the loop's idle share is at most the window's, and a window with
none of a reader's entries reads as None."""

import pytest

from benchmark.harness import recorder
from benchmark.harness import spec as S
from benchmark.harness.trace import WINDOW_SPAN, Trace
from rambl_tpu_torch.utils import trace as ptrace

MS = 1_000_000
T0 = 1_000_000 * MS          # the window opens here (epoch ns)


@pytest.fixture
def entries():
    """A clean port recorder, filled by the test and emptied after it."""
    ptrace.clear()
    yield ptrace.RECORDER
    ptrace.clear()


def _rec(dev_intervals):
    ev = [(WINDOW_SPAN, False, T0, T0 + 100 * MS, None)]
    ev += [("kernel", True, T0 + a * MS, T0 + b * MS, 0)
           for a, b in dev_intervals]
    tr = Trace(ev)
    return dict(trace=tr, work=1000, window_s=tr.window_s, busy_s=tr.busy_s,
                k1_launches=[])


def _span(r, name, a, b, parent=None):
    r.spans.append((name, T0 + a * MS, T0 + b * MS, parent))


def _count(r, name, at, n):
    r.counts.append([name, T0 + at * MS, n, "cluster.dp_means"])


def test_cells_recorder_stream_readers(entries):
    rec = _rec([(10, 30), (50, 60), (95, 99)])
    _span(entries, "stream.prepare", -20, 5)     # cut at the window's start
    _span(entries, "stream.prepare", 70, 75)
    _span(entries, "stream.prepare", 150, 160)   # after the window
    _span(entries, "stream.loop", 5, 70, "stream")
    _span(entries, "stream.loop", 75, 120, "stream")   # cut at its end
    prep = S.reader("stream.prepare_share")(rec)
    assert prep == pytest.approx(10.0)           # 5 + 5 ms of 100
    loop_idle = S.reader("stream.loop_idle_share")(rec)
    # loops 5-70 and 75-100 (90 ms) less the device's 20 + 10 + 4 ms
    assert loop_idle == pytest.approx(56.0)
    idle = S.reader("stream.idle_share")(rec)
    assert idle == pytest.approx(66.0)
    assert loop_idle <= idle


def test_cells_recorder_loop_idle_cards(entries):
    """On two cards the loop's idle share is the mean of the cards' own,
    as the window's idle share is the mean of theirs."""
    ev = [(WINDOW_SPAN, False, T0, T0 + 100 * MS, None),
          ("kernel", True, T0 + 10 * MS, T0 + 30 * MS, 0),
          ("kernel", True, T0 + 50 * MS, T0 + 90 * MS, 1)]
    tr = Trace(ev, cards=(0, 1))
    rec = dict(trace=tr, work=1000, window_s=tr.window_s, busy_s=tr.busy_s,
               k1_launches=[])
    _span(entries, "stream.loop", 0, 80, "stream")
    loop_idle = S.reader("stream.loop_idle_share")(rec)
    # card 0 idles 60 ms of the loop's 80, card 1 50 ms: a mean of 55
    assert loop_idle == pytest.approx(55.0)
    idle = S.reader("stream.idle_share")(rec)
    assert idle == pytest.approx(70.0)           # busy 20 and 40 ms
    assert loop_idle <= idle


def test_cells_recorder_cluster_readers(entries):
    rec = _rec([(0, 100)])
    for at in (10, 60):
        _count(entries, "dp.recount_adds", at, 1000)
        _count(entries, "dp.recount_inert_adds", at, 700)
        _count(entries, "dp.leaf_iters", at, 64)
        _count(entries, "dp.frozen_leaf_iters", at, 16)
        _count(entries, "dp.block_iters", at, 16)
        _count(entries, "dp.tail_iters", at, 4)
    for name in ("dp.recount_adds", "dp.leaf_iters", "dp.block_iters"):
        _count(entries, name, -5, 10 ** 6)       # before the window
        _count(entries, name, 101, 10 ** 6)      # after it
    assert S.reader("cluster.recount_inert_share")(rec) == pytest.approx(70.0)
    assert S.reader("cluster.dp_frozen_share")(rec) == pytest.approx(25.0)
    assert S.reader("cluster.dp_tail_share")(rec) == pytest.approx(25.0)


def test_cells_recorder_absent_reads_none(entries):
    rec = _rec([(10, 30)])
    names = ("stream.prepare_share", "stream.loop_idle_share",
             "cluster.recount_inert_share", "cluster.dp_frozen_share",
             "cluster.dp_tail_share")
    assert all(S.reader(n)(rec) is None for n in names)
    # entries of the names, all outside the window
    _span(entries, "stream.prepare", -30, -10)
    _span(entries, "stream.loop", 110, 130)
    _count(entries, "dp.recount_adds", -1, 5)
    _count(entries, "dp.recount_inert_adds", 101, 5)
    assert all(S.reader(n)(rec) is None for n in names)


def test_cells_recorder_absent_port(entries, monkeypatch):
    """A checkout of the port without the recorder reads as None."""
    import sys

    import rambl_tpu_torch.utils

    rec = _rec([(10, 30)])
    _span(entries, "stream.loop", 5, 70)
    _count(entries, "dp.block_iters", 50, 16)
    _count(entries, "dp.tail_iters", 50, 4)
    assert S.reader("cluster.dp_tail_share")(rec) == pytest.approx(25.0)
    monkeypatch.delattr(rambl_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rambl_tpu_torch.utils.trace", None)
    assert recorder.spans(rec, "stream.loop") is None
    assert recorder.total(rec, "dp.recount_adds") is None
    assert S.reader("stream.loop_idle_share")(rec) is None
    assert S.reader("cluster.dp_tail_share")(rec) is None


def test_cells_recorder_intervals():
    a = recorder.union([(5, 8), (0, 3), (2, 4), (8, 9)])
    assert a == [[0, 4], [5, 9]]
    assert recorder.length(a) == 8
    assert recorder.overlap(a, [[3, 6], [8, 20]]) == 3
    assert recorder.overlap([], a) == 0
