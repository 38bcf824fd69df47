"""The trace's reading (busy time as a union, the benchmark's own spans
left out, idle gaps named by the host's activity) and the per-layer
readers, on synthetic profiles."""

import pytest

from benchmark.harness import spec as S
from benchmark.harness.trace import WINDOW_SPAN, Trace

MS = 1_000_000


def _trace():
    ev = [(WINDOW_SPAN, False, 0, 100 * MS),
          ("bench.stream_align", True, 0, 100 * MS),     # a span, not work
          ("sw_score_kernel(x)", True, 10 * MS, 30 * MS),
          ("radixSort", True, 20 * MS, 40 * MS),          # overlaps K1
          ("Memcpy HtoD", True, 60 * MS, 70 * MS),
          ("aten::nonzero", False, 40 * MS, 60 * MS),
          ("cudaLaunchKernel", False, 9 * MS, 10 * MS),
          ("cudaLaunchKernel", False, 19 * MS, 20 * MS),
          ("bench.stream_align", False, 0, 100 * MS)]
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
