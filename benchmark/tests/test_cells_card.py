"""On a card: the program against the plain reference and the control of
each comparison, at sizes a test run holds, and a traced window read back.
Skips without a card (decided inside each test). From the repository
root:

    python -m pytest benchmark/tests/test_cells_card.py -q
"""

import contextlib

import pytest
import torch

from benchmark.harness import spec as S
from benchmark.harness.cells import Context

pytestmark = pytest.mark.cuda

SAMPLE = {"abundance_sigma": 1.0, "read_len": 100, "read_len_max": 128,
          "sub_error": 0.004, "indel_error": 0.0005}
STREAM = {"panel": {"n_species": 20, "refs_per_species": 5,
                    "leaf_per_ref": False, "ref_len_max": 2048,
                    "panel_seed": 7},
          "sample": dict(SAMPLE, n_reads=200_000),
          "settings": {"batch_size": 8192, "max_genes": 64, "sw_rows": 104}}
CLUSTER = {"panel": {"n_species": 2000, "refs_per_species": 5,
                     "leaf_per_ref": True, "ref_len_max": 2048,
                     "panel_seed": 13},
           "sample": dict(SAMPLE, n_reads=1_000_000, n_present=100),
           "settings": {"batch_size": 16000, "max_genes": 2048,
                        "max_clusters_per_bin": 16, "bin_share_depth": 3,
                        "cluster_leaf_block": 512, "sw_rows": 104,
                        "pileup_slot_nodes": 1}}
TRAFFIC = {"stream": {"kind": "stream", "rate_metric": "reads_per_s",
                      "unit": "reads", "check_reads": 256},
           "cluster": {"kind": "cluster", "rate_metric": "leaves_per_s",
                       "unit": "leaves", "check_leaves": 4,
                       "check_reads": 128}}


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from benchmark.harness import panel

    monkeypatch.setattr(panel, "CACHE_DIR", str(tmp_path))
    return torch.device("cuda", 0)


def _runner(kind, config, dev, seed):
    d = S.runner(kind)(Context(cell="card", config_name=f"card-{kind}",
                               config=config, traffic=TRAFFIC[kind],
                               seed=seed, device=dev, log=lambda m: None))
    d.setup()
    return d


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_cells_card_stream_and_control(card, seed):
    d = _runner("stream", STREAM, card, seed)
    d.window(0.0, contextlib.nullcontext)
    assert all(v == 0 for v, _ in d.check().values())
    # at this size no node holds more reads than int16 does: the control's
    # int8 columns fail the rows (its counts fail at the cells' sizes)
    ctl = d.check(control=True)
    assert ctl["rows_differing"][0] > 0


@pytest.mark.parametrize("seed", [2 ** 31 + 4, 2 ** 31 + 5, 2 ** 31 + 6])
def test_cells_card_cluster_and_control(card, seed):
    d = _runner("cluster", CLUSTER, card, seed)
    d.window(3.0, contextlib.nullcontext)
    assert all(v == 0 for v, _ in d.check().values())
    assert any(v > 0 for v, _ in d.check(control=True).values())


def test_cells_card_traced_window(card):
    from benchmark.harness.spans import K1Launches
    from benchmark.harness.trace import traced

    d = _runner("stream", STREAM, card, 2 ** 31 + 7)
    with K1Launches() as k1:
        work, tr = traced(lambda span: d.window(1.0, span))
    assert work >= STREAM["sample"]["n_reads"]
    assert 0 < tr.busy_s <= tr.window_s
    rec = dict(trace=tr, work=work, k1_launches=k1.launches,
               window_s=tr.window_s, busy_s=tr.busy_s)
    share = S.reader("k1.roofline_share")(rec)
    assert 0 < share < 100
    assert tr.device_ops() and tr.idle_gaps()
