"""The `mesh_stream` traffic kind and the mesh cell's readers.

On four CPU ranks at a tiny panel, with the plain rotation (K4 has no CPU
mode): the kind reads correct, its control does not, and each planted
fault (one rank's retained column, a shard left one hop round the ring,
one replica's read count) reads not correct. On a card: the same kind with
K4 on four cards reads correct (skips below four). The three readers of
the mesh cell (`k4.roofline_share`, `mesh.ring_share`,
`mesh.merge_share`) on a synthetic `Trace` and synthetic recorder entries.
From the repository root:

    python -m pytest benchmark/tests/test_cells_mesh.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.harness import spec as S
from benchmark.harness.cells import Context
from benchmark.harness.trace import WINDOW_SPAN, Trace
from rambl_tpu_torch.utils import trace as ptrace

PANEL = {"n_species": 20, "refs_per_species": 5, "leaf_per_ref": True,
         "ref_len_max": 2048, "panel_seed": 7}
SAMPLE = {"n_reads": 1500, "n_present": 40, "abundance_sigma": 1.0,
          "read_len": 100, "read_len_max": 128, "sub_error": 0.004,
          "indel_error": 0.0005}
SETTINGS = {"batch_size": 512, "max_genes": 64, "sw_rows": 104,
            "shard_index": True, "shard_positions": True,
            "ring_impl": "ppermute", "pileup_slot_nodes": 1}
TRAFFIC = {"kind": "mesh_stream", "rate_metric": "reads_per_s",
           "unit": "reads", "check_reads": 128}


def _runner(devices, settings, seed):
    config = {"panel": PANEL, "sample": SAMPLE, "settings": settings}
    d = S.runner("mesh_stream")(Context(
        cell="mesh", config_name="mesh-test", config=config,
        traffic=TRAFFIC, seed=seed, device=devices[0], log=lambda m: None,
        devices=tuple(devices)))
    d.setup()
    d.window(0.0, contextlib.nullcontext)
    return d


def _differing(d, control=False):
    return {k: v for k, (v, _) in d.check(control=control).items()}


@pytest.fixture(scope="module")
def cpu_cell(tmp_path_factory):
    from benchmark.harness import panel

    keep = panel.CACHE_DIR
    panel.CACHE_DIR = str(tmp_path_factory.mktemp("cache"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _runner([torch.device("cpu")] * 4, SETTINGS, 2 ** 31 + 41)
    finally:
        torch.set_num_threads(n)
        panel.CACHE_DIR = keep


def test_cells_mesh_correct_and_control(cpu_cell):
    d = cpu_cell
    assert d.mesh.size == 4
    assert _differing(d) == {"rows_differing": 0,
                             "read_count_nodes_differing": 0,
                             "shards_differing": 0}
    ctl = _differing(d, control=True)
    assert ctl["rows_differing"] > 0
    assert ctl["shards_differing"] == 0


def test_cells_mesh_planted_column(cpu_cell):
    d = cpu_cell
    g = int(d._sample(TRAFFIC["check_reads"])[-1])
    b, r, row = (int(x[0]) for x in d._owner(np.array([g])))
    assert r == (g % 512) // 128
    col = d.out[0]["ref_col"][r]
    keep = col[b, row, 0].clone()
    col[b, row, 0] += 1
    try:
        assert _differing(d)["rows_differing"] == 1
    finally:
        col[b, row, 0] = keep
    assert _differing(d)["rows_differing"] == 0


def test_cells_mesh_planted_shard(cpu_cell):
    d = cpu_cell
    d.shards.rotate("ppermute")
    try:
        assert _differing(d)["shards_differing"] == 4
    finally:
        for _ in range(3):
            d.shards.rotate("ppermute")
    assert _differing(d)["shards_differing"] == 0


def test_cells_mesh_planted_read_count(cpu_cell):
    d = cpu_cell
    # ranks of one device share one replica: give rank 2 its own
    keep = d.out[3][2]
    d.out[3][2] = keep.clone()
    d.out[3][2][int(torch.argmax(keep))] += 1
    try:
        got = _differing(d)
        assert got["read_count_nodes_differing"] == 1
        assert got["rows_differing"] == 0
    finally:
        d.out[3][2] = keep
    assert _differing(d)["read_count_nodes_differing"] == 0


def test_cells_mesh_refuses_dense_mode(tmp_path, monkeypatch):
    from benchmark.harness import panel

    monkeypatch.setattr(panel, "CACHE_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="slot mode"):
        _runner([torch.device("cpu")] * 4,
                dict(SETTINGS, pileup_slot_nodes=4096), 2 ** 31 + 42)


@pytest.mark.cuda
def test_cells_mesh_k4_on_four_cards(tmp_path, monkeypatch):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 4:
        pytest.skip(f"needs four CUDA cards; {n} visible")
    from benchmark.harness import panel
    from rambl_tpu_torch.parallel import ring_dma

    monkeypatch.setattr(panel, "CACHE_DIR", str(tmp_path))
    ring_dma.reset_launches()
    d = _runner([torch.device("cuda", i) for i in range(4)],
                dict(SETTINGS, ring_impl="dma", batch_size=8192),
                2 ** 31 + 43)
    # two passes (set-up's and the window's), 2 strands x 4 hops a batch,
    # one launch a rank a hop
    batches = -(-SAMPLE["n_reads"] // 8192)
    assert ring_dma.LAUNCHES["ring"] == 2 * batches * 8 * 4
    assert [t.device for t in d.out[3]] == [torch.device("cuda", i)
                                            for i in range(4)]
    assert _differing(d) == {"rows_differing": 0,
                             "read_count_nodes_differing": 0,
                             "shards_differing": 0}
    assert _differing(d, control=True)["rows_differing"] > 0


# ---- the readers ----------------------------------------------------------

MS = 1_000_000
T0 = 1_000_000 * MS          # the window opens here (epoch ns)


@pytest.fixture
def entries():
    """A clean port recorder, filled by the test and emptied after it."""
    ptrace.clear()
    yield ptrace.RECORDER
    ptrace.clear()


def _rec(device_events, cards=(0, 1, 2, 3)):
    ev = [(WINDOW_SPAN, False, T0, T0 + 100 * MS, None)]
    ev += [(n, True, T0 + a * MS, T0 + b * MS, c)
           for n, a, b, c in device_events]
    tr = Trace(ev, cards=cards)
    return dict(trace=tr, work=1000, window_s=tr.window_s, busy_s=tr.busy_s,
                k1_launches=[])


def test_cells_mesh_ring_readers(entries):
    k4 = "void ring_copy_kernel(CopyTable, int, int*, int*)"
    # each card busy 40 ms, 10 of them in K4
    rec = _rec([(k4, 0, 10, c) for c in range(4)]
               + [("sw_score_kernel", 10, 40, c) for c in range(4)])
    # 900 M words sent in the window: 3.6 GB at 450 GB/s = 8 card-ms of the
    # 40 card-ms K4 took
    for at in (20, 30, 40):
        entries.counts.append(["ring.words", T0 + at * MS, 300_000_000,
                               "ring.rotate"])
    entries.counts.append(["ring.words", T0 + 150 * MS, 10 ** 12,
                           "ring.rotate"])            # after the window
    assert S.reader("k4.roofline_share")(rec) == pytest.approx(20.0)
    assert S.reader("mesh.ring_share")(rec) == pytest.approx(25.0)
    # no K4 in the window, or no counts: None
    bare = _rec([("sw_score_kernel", 10, 40, c) for c in range(4)])
    assert S.reader("k4.roofline_share")(bare) is None
    assert S.reader("mesh.ring_share")(bare) is None
    entries.clear()
    assert S.reader("k4.roofline_share")(rec) is None


def test_cells_mesh_merge_reader(entries):
    rec = _rec([("kernel", 0, 50, c) for c in range(4)])
    assert S.reader("mesh.merge_share")(rec) is None
    for name, a, b in (("stream.merge", 60, 70), ("stream.replicate", 70, 75),
                       ("stream.merge", -20, 5),      # cut at the start
                       ("stream.replicate", 98, 130)):  # cut at the end
        entries.spans.append((name, T0 + a * MS, T0 + b * MS, "stream"))
    # 10 + 5 + 5 + 2 ms of 100
    assert S.reader("mesh.merge_share")(rec) == pytest.approx(22.0)
