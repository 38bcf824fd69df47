"""The plain reference against the port's CPU path at a tiny size, the
control of each comparison, and the faults each cell can have: with the
timed path broken underneath, the rest of a run reads `correct` false.

Each test drives a traffic runner as a run does (set-up, a window, the
check) on the CPU, with a tiny deployment whose every read and leaf is
checked."""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.harness import spec as S
from benchmark.harness.cells import Context

SAMPLE = {"n_reads": 600, "abundance_sigma": 1.0, "read_len": 100,
          "read_len_max": 128, "sub_error": 0.004, "indel_error": 0.0005}
STREAM = {
    "panel": {"n_species": 5, "refs_per_species": 3, "leaf_per_ref": False,
              "ref_len_max": 2048, "panel_seed": 3},
    "sample": SAMPLE,
    "settings": {"batch_size": 256, "max_genes": 16, "sw_rows": 104},
}
# round 0 in slot mode, as the full Greengenes-sized deployment runs it;
# strains share their species' leaf, so DP-means finds several clusters
CLUSTER = {
    "panel": {"n_species": 3, "refs_per_species": 3, "leaf_per_ref": False,
              "ref_len_max": 2048, "panel_seed": 3},
    "sample": dict(SAMPLE, n_reads=1500),
    "settings": {"batch_size": 1024, "max_genes": 16, "sw_rows": 104,
                 "pileup_slot_nodes": 1, "cluster_leaf_block": 2,
                 "max_bin_reads": 128},
}
TRAFFIC = {"stream": {"kind": "stream", "rate_metric": "reads_per_s",
                      "unit": "reads", "check_reads": 100000},
           "cluster": {"kind": "cluster", "rate_metric": "leaves_per_s",
                       "unit": "leaves", "check_leaves": 1000,
                       "check_reads": 100000}}


def drive(kind, config, seed=2 ** 31 + 11):
    """Set-up, a window over every block or one pass, and the check."""
    ctx = Context(cell="tiny", config_name=f"tiny-{kind}", config=config,
                  traffic=TRAFFIC[kind], seed=seed, device=torch.device("cpu"),
                  log=lambda m: None)
    d = S.runner(kind)(ctx)
    d.setup()
    for _ in range(len(getattr(d, "blocks", [None]))):
        d.window(0.0, contextlib.nullcontext)
    return d


def correct(compared) -> bool:
    return all(v <= lim for v, lim in compared.values())


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    from benchmark.harness import panel

    old = panel.CACHE_DIR
    panel.CACHE_DIR = str(tmp_path_factory.mktemp("cache"))
    yield
    panel.CACHE_DIR = old


def test_cells_stream_reference_equals_port(cache):
    d = drive("stream", STREAM)
    got = d.check()
    assert set(got) == {"rows_differing", "read_count_nodes_differing",
                        "pileup_nodes_differing"}
    assert correct(got), got
    # the control: the reference with its columns in int8 is not correct
    ctl = d.check(control=True)
    assert ctl["rows_differing"][0] > 0


def test_cells_cluster_reference_equals_port(cache):
    d = drive("cluster", CLUSTER)
    assert sum(lb.size for lb, _ in d.done) == sum(b.size for b in d.blocks)
    assert max(int(res[1].max()) for _, res in d.done) > 1
    got = d.check()
    assert correct(got), got
    assert not correct(d.check(control=True))


def _alter_score(real):
    """An answer altered where it is produced: one read's score a batch."""
    def step(*a, **kw):
        q, proj, bins, score, ref, strand = real(*a, **kw)
        score = score.clone()
        score[0] += 1
        return q, proj, bins, score, ref, strand
    return step


def _half_batch(real):
    """Half of each batch left out: its second half never aligned."""
    def step(reads, lens, *a, **kw):
        h = reads.shape[0] // 2
        outs = real(reads[:h], lens[:h], *a, **kw)
        pad = [torch.full((reads.shape[0] - h, *o.shape[1:]),
                          0 if k in (0, 3, 5) else -1, dtype=o.dtype)
               for k, o in enumerate(outs)]
        return tuple(torch.cat([o, p]) for o, p in zip(outs, pad))
    return step


@pytest.mark.parametrize("fault", ["unchanged_counts", "half_batch",
                                   "altered_answer"])
def test_cells_stream_faults_read_not_correct(cache, monkeypatch, fault):
    from rambl_tpu_torch.pipeline import assemble

    if fault == "unchanged_counts":
        # a step that returns its state unchanged: the accumulators
        monkeypatch.setattr(assemble, "_pileup_accum",
                            lambda *a, **kw: None)
        monkeypatch.setattr(assemble, "_read_count_accum",
                            lambda *a, **kw: None)
    elif fault == "half_batch":
        monkeypatch.setattr(assemble, "_align_bin_batch",
                            _half_batch(assemble._align_bin_batch))
    else:
        monkeypatch.setattr(assemble, "_align_bin_batch",
                            _alter_score(assemble._align_bin_batch))
    assert not correct(drive("stream", STREAM).check())


@pytest.mark.parametrize("fault", ["dp_unchanged", "altered_answer"])
def test_cells_cluster_faults_read_not_correct(cache, monkeypatch, fault):
    from rambl_tpu_torch.pipeline import assemble

    real = assemble.cluster_stage
    if fault == "dp_unchanged":
        # a step that returns its state unchanged: DP-means leaves every
        # member in its first cluster
        from rambl_tpu_torch.pipeline.cluster import DPMeansOut

        def dp(feat, can_seed, cfg):
            NL, M = can_seed.shape
            return DPMeansOut(
                assign=torch.zeros((NL, M), dtype=torch.int32),
                centers=torch.zeros((NL, 1, feat.shape[2]), dtype=torch.int8),
                kact=torch.ones((NL,), dtype=torch.int32))
        monkeypatch.setattr(assemble, "dp_means_leaves", dp)
    else:
        def stage(*a, **kw):
            cons, kact, n_mem, mh = real(*a, **kw)
            called = cons.called.copy()
            em = np.argmax(cons.emit[0, 0])
            called[0, 0, em] = (called[0, 0, em] + 1) % 4
            return cons._replace(called=called), kact, n_mem, mh
        monkeypatch.setattr(assemble, "cluster_stage", stage)
    assert not correct(drive("cluster", CLUSTER).check())
