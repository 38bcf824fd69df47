"""On a card: the port's own spans and counters in traced windows. In a
traced window of `mock-hmp20.stream` and of a small cluster cell no device
event carries a program span's name, the benchmark's spans name under 5%
of the idle time, every per-layer metric of the cell reads a number, and
the run is correct; with the recorder off, the port's spans and counts add
no host sync. Skips without a card (decided inside each test). From the
repository root:

    python -m pytest benchmark/tests/test_cells_recorder_card.py -q
"""

import contextlib
import gc
import json

import pytest

from benchmark.harness import spec as S
from benchmark.harness.cells import Context
from benchmark.tests.test_cells_card import CLUSTER, _runner, card  # noqa: F401
from rambl_tpu_torch.utils import trace as ptrace

pytestmark = pytest.mark.cuda

NEW = {"stream.prepare_share", "stream.loop_idle_share",
       "cluster.recount_inert_share", "cluster.dp_frozen_share",
       "cluster.dp_tail_share"}


def _traced(d, seconds):
    from benchmark.harness.spans import K1Launches
    from benchmark.harness.trace import traced

    ptrace.clear()
    with K1Launches() as k1:
        work, tr = traced(lambda span: d.window(seconds, span))
    return dict(trace=tr, work=work, k1_launches=k1.launches,
                window_s=tr.window_s, busy_s=tr.busy_s)


def _check_window(rec, metrics, bench_span):
    tr = rec["trace"]
    names = {n for n, *_ in ptrace.spans()}
    assert names, "the recorder recorded nothing under the profiler"
    assert not names & {n for n, _, _ in tr.device}
    gaps = dict(tr.idle_gaps(top=10 ** 6))
    idle = sum(gaps.values())
    assert gaps.get(bench_span, 0.0) < 0.05 * idle, (bench_span, gaps)
    got = {m["name"]: S.reader(m["name"])(rec) for m in metrics}
    assert NEW & set(got)
    assert all(v is not None for v in got.values()), got
    for n in NEW & set(got):
        assert 0 <= got[n] <= 100, (n, got[n])
    return got


def test_cells_card_recorder_mock_stream(card):
    spec = S.load_spec()
    name = "mock-hmp20.stream"
    cell = S.cell(spec, name)
    config = S.read_json(S.config_entry(spec, cell["config"])["file"])
    with open(S.traffic_file(cell["traffic"])) as f:
        traffic = json.load(f)
    d = S.runner(traffic["kind"])(Context(
        cell=name, config_name=cell["config"], config=config,
        traffic=traffic, seed=2 ** 31 + 21, device=card, log=lambda m: None))
    d.setup()
    got = _check_window(_traced(d, 3.0), S.layer_metrics_of(spec, name),
                        "bench.stream_align")
    assert got["stream.loop_idle_share"] <= got["stream.idle_share"]
    assert got["stream.prepare_share"] > 0
    assert all(v <= lim for v, lim in d.check().values())


def test_cells_card_recorder_cluster(card):
    spec = S.load_spec()
    d = _runner("cluster", CLUSTER, card, 2 ** 31 + 22)
    metrics = [m for m in S.layer_metrics_of(spec, "gut-gg97.cluster")]
    got = _check_window(_traced(d, 3.0), metrics, "bench.cluster_stage")
    # the recount kernel (csrc/cluster.cu) adds covered entries only
    assert got["cluster.recount_inert_share"] == 0
    assert all(v <= lim for v, lim in d.check().values())


def test_cells_card_recorder_off_adds_no_sync(card, monkeypatch):
    from rambl_tpu_torch.utils.timing import syncs_of

    d = _runner("cluster", CLUSTER, card, 2 ** 31 + 23)
    assert not ptrace.on()

    def stream_and_block():
        d.out = d._pass(d.reads, d.lens)
        d._block(d.blocks[0])

    def port_syncs():
        # the syncs of the port's own lines (a finalizer that a garbage
        # collection runs may add one inside torch.cuda)
        gc.collect()
        _, at = syncs_of(stream_and_block)
        return {k: v for k, v in at.items() if not k.startswith("/")}

    stream_and_block()
    syncs = port_syncs()
    assert syncs and not [k for k in syncs if "utils/trace.py" in k]
    monkeypatch.setattr(ptrace, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(ptrace, "count", lambda name, n: None)
    monkeypatch.setattr(ptrace, "settle", lambda: None)
    monkeypatch.setattr(ptrace, "on", lambda: False)
    assert port_syncs() == syncs
