"""The port's span and counter recorder (`rambl_tpu_torch.utils.trace`) on
the CPU: nesting and parents, counts (ints and 0-d tensors read at
`settle`), nothing recorded and no torch operation when it is off, the
round's and polish's `t_*` stats under RAMBL_STAGE_TIMING=1, the spans'
host ranges in a CPU torch.profiler, and DP-means' waste counts against a
brute-force count from reruns of 1 to 16 iterations.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.pipeline import cluster as tcluster
from rambl_tpu_torch.utils import trace

STAGE_KEYS = {"t_index", "t_align", "t_slot_pileup", "t_cluster",
              "t_genes_host"}


@pytest.fixture(autouse=True)
def clean():
    """An empty recorder with nothing forcing it on, before and after."""
    trace.clear()
    assert trace.RECORDER.forced == 0 and not trace.RECORDER.open
    yield
    trace.clear()
    assert trace.RECORDER.forced == 0 and not trace.RECORDER.open


@pytest.fixture
def forced(monkeypatch):
    """The recorder on, as a round's clock under RAMBL_STAGE_TIMING=1 turns
    it on."""
    monkeypatch.setenv("RAMBL_STAGE_TIMING", "1")
    with trace.Stages():
        yield


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    ds = simulate_dataset(n_species=2, refs_per_species=2, n_reads=120,
                          seed=3, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(batch_size=64, max_assembly_iters=1,
                         pileup_slot_nodes=1, sw_rows=104)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    return ds, tax, cfg, index


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_trace_spans_nest_with_parents(forced):
    with trace.span("a"):
        with trace.span("a.b"):
            with trace.span("a.b.c"):
                pass
        with trace.span("a.d") as d:
            pass
    got = trace.spans()
    assert [(n, p) for n, _, _, p in got] == [
        ("a.b.c", "a.b"), ("a.b", "a"), ("a.d", "a"), ("a", None)]
    by = {n: (t0, t1) for n, t0, t1, _ in got}
    for child, parent in (("a.b", "a"), ("a.b.c", "a.b"), ("a.d", "a")):
        assert by[parent][0] <= by[child][0] <= by[child][1] \
            <= by[parent][1]
    assert by["a.d"][0] >= by["a.b"][1]
    assert d.seconds == (by["a.d"][1] - by["a.d"][0]) / 1e9
    with pytest.raises(ValueError):
        with trace.span("raises"):
            raise ValueError
    assert trace.spans()[-1][0] == "raises" and not trace.RECORDER.open


def test_trace_counts(forced):
    trace.count("outside", 3)
    with trace.span("s"):
        trace.count("n", 5)
        trace.count("t", torch.tensor(7, dtype=torch.int32))
        trace.count("t", torch.tensor([1, 2, 3]).sum())
    assert trace.RECORDER.held
    got = trace.counts()                       # settles the tensors
    assert not trace.RECORDER.held
    assert [(n, v, s) for n, _, v, s in got] == [
        ("outside", 3, None), ("n", 5, "s"), ("t", 7, "s"), ("t", 6, "s")]
    assert all(type(v) is int for _, _, v, _ in got)
    ts = [t for _, t, _, _ in got]
    assert ts == sorted(ts)


def test_trace_off_records_nothing_and_runs_no_op(tiny):
    ds, tax, cfg, index = tiny
    assert not trace.on()
    with _Ops() as mode:
        with trace.span("x"):
            trace.count("y", 5)
            trace.settle()
    assert mode.ops == []
    assert trace.span("x") is trace.span("y")  # one shared object
    res = tassemble.assemble(ds.reads, ds.read_lens, ds.ref_seqs,
                             ds.ref_lens, tax, cfg, shared_index=index,
                             device="cpu")
    assert res.genes and res.round_stats[-1]["round"] == "polish"
    assert not [k for st in res.round_stats for k in st
                if k.startswith("t_")]
    assert trace.spans() == [] and trace.counts() == []


def test_trace_stage_timing_keys(tiny, monkeypatch):
    """RAMBL_STAGE_TIMING=1 fills the round's t_* keys and polish's
    t_polish from the spans (without it neither appears: the test
    above)."""
    ds, tax, cfg, index = tiny
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax, cfg)
    monkeypatch.setenv("RAMBL_STAGE_TIMING", "1")
    res = tassemble.assemble(*args, shared_index=index, device="cpu")
    rnd, pol = res.round_stats[0], res.round_stats[-1]
    assert pol["round"] == "polish"
    assert STAGE_KEYS <= set(rnd) and "t_polish" in pol
    spans = trace.spans()
    names = collections.Counter(n for n, *_ in spans)
    for n in ("round", "round.index", "round.stream", "round.slot_pileup",
              "round.cluster", "round.genes", "polish", "stream.col_maps"):
        assert names[n] == 1, n
    dur = {n: (t1 - t0) / 1e9 for n, t0, t1, _ in spans}
    for n, k in (("round.stream", "t_align"), ("round.cluster", "t_cluster"),
                 ("polish", "t_polish")):
        assert (rnd if k != "t_polish" else pol)[k] == round(dur[n], 2)
    assert trace.RECORDER.forced == 0            # off again after polish


def test_trace_spans_are_profiler_host_ranges(tiny):
    """Under a CPU torch.profiler every span is also a host range of the
    profile, of the same name, starting within 1 ms of the span."""
    from torch.profiler import ProfilerActivity, profile

    ds, tax, cfg, index = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        tassemble.stream_align(ds.reads[:64], ds.read_lens[:64], index,
                               ds.ref_seqs, ds.ref_lens, tax, cfg,
                               device="cpu")
    assert not trace.on()
    spans = trace.spans()
    names = {n for n, *_ in spans}
    assert {"stream", "stream.prepare", "stream.index_upload",
            "stream.loop", "stream.batch", "align.seed", "align.score",
            "align.gapped", "align.bin", "stream.accumulate"} <= names
    host = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            host[e.name()].append(e.start_ns())
    for name in names:
        ours = sorted(t0 for n, t0, _, _ in spans if n == name)
        theirs = sorted(host[name])
        assert len(ours) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(ours, theirs)) < 1_000_000


def _planted(seed, NL=5, M=40, P=12):
    """Leaves of two or three haplotypes with noise, uncovered ends and
    padded member rows; the last leaf seeds nothing."""
    rng = np.random.default_rng(seed)
    feat = np.full((NL, M, P), -1, np.int8)
    for a in range(NL):
        haps = rng.integers(0, 4, (2 + a % 2, P))
        n = M - 4 * (a % 3)                    # the rest are padding
        for m in range(n):
            row = haps[rng.integers(len(haps))].copy()
            flip = rng.random(P) < 0.05
            row[flip] = rng.integers(0, 4, flip.sum())
            lo, hi = sorted(rng.integers(0, P + 1, 2))
            feat[a, m, lo:max(hi, lo + 4)] = row[lo:max(hi, lo + 4)]
    can_seed = rng.random((NL, M)) < 0.8
    can_seed[-1] = False
    return torch.from_numpy(feat), torch.from_numpy(can_seed)


@pytest.mark.parametrize("seed", [5, 6])
def test_trace_dp_means_counts(seed, monkeypatch):
    feat, can_seed = _planted(seed)
    NL, M, P = feat.shape
    cfg = PipelineConfig(max_clusters_per_bin=4, dp_spawn_scan=8)
    iters = cfg.dp_max_iters
    assert iters == 16
    with _Ops() as off_ops:
        off = tcluster.dp_means_leaves(feat, can_seed, cfg)
    assert trace.counts() == []
    monkeypatch.setenv("RAMBL_STAGE_TIMING", "1")
    with trace.Stages(), _Ops() as on_ops:
        on = tcluster.dp_means_leaves(feat, can_seed, cfg)
    assert len(off_ops.ops) < len(on_ops.ops)
    for name in off._fields:
        assert torch.equal(getattr(off, name), getattr(on, name)), name
    got = {n: v for n, _, v, _ in trace.counts()}

    # brute force: a leaf converged at the first iteration j whose outputs
    # equal those of j - 1 iterations (iters when none does)
    runs = []
    for j in range(iters + 1):
        r = tcluster.dp_means_leaves(
            feat, can_seed, PipelineConfig(max_clusters_per_bin=4,
                                           dp_spawn_scan=8,
                                           dp_max_iters=j))
        runs.append([(r.assign[a], r.centers[a], r.kact[a])
                     for a in range(NL)])
    conv = []
    for a in range(NL):
        same = [j for j in range(1, iters + 1)
                if all(torch.equal(x, y) for x, y in zip(runs[j][a],
                                                         runs[j - 1][a]))]
        conv.append(same[0] if same else iters)
    want = {"dp.block_iters": iters,
            "dp.leaf_iters": NL * iters,
            "dp.recount_adds": NL * M * P * iters,
            "dp.recount_inert_adds": int((feat < 0).sum()) * iters,
            "dp.frozen_leaf_iters": sum(iters - c for c in conv),
            "dp.tail_iters": iters - max(conv)}
    assert got == want
    assert 0 < want["dp.frozen_leaf_iters"] < want["dp.leaf_iters"]
    assert max(conv) > 1                       # some leaf spawned
