"""On several cards: a cell of the test kind `kinds/cards.py` runs through
`run.run` on every visible card, four at most. Card i holds (i + 1) x 256
MB and streams through it as often as card 0 through its own, so its work
grows with i + 1. The traced run reads every card busy, `busy_s` as the
mean of the cards' busy times and the busiest card the last; the untraced
run reads `peak_gb` as the fullest card's allocation, to within 1%. Skips
below two cards (decided inside the fixture). From the repository root:

    python -m pytest benchmark/tests/test_cells_cards_card.py -q
"""

import types

import pytest
import torch

from benchmark import run as brun
from benchmark.harness import trace as T
from benchmark.tests.test_cells_spec import cards_root

pytestmark = pytest.mark.cuda

ALLOC = 256_000_000
CONFIG = {"alloc_bytes": ALLOC, "adds": 20}


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards; {n} visible")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def _run(root, devs, trace):
    args = types.SimpleNamespace(workload="cards.load", seed=2 ** 31 + 31,
                                 seconds=3.0, trace=trace, control=0)
    return brun.run(args, devs, root=root, log=lambda m: None)


def test_cells_cards_busy_and_peak_per_card(cards, tmp_path, monkeypatch):
    root = cards_root(tmp_path, len(cards), CONFIG)
    line = _run(root, cards, 0)
    assert line["correct"] is True
    assert line["device"]["count"] == len(cards)
    fullest = len(cards) * ALLOC
    assert line["metrics"]["peak_gb"]["value"] == pytest.approx(
        fullest / 1e9, rel=0.01)
    assert line["device"]["memory_peak_bytes"] == pytest.approx(fullest,
                                                                rel=0.01)

    traces = []

    class Kept(T.Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            traces.append(self)

    monkeypatch.setattr(T, "Trace", Kept)
    line = _run(root, cards, 1)
    assert line["correct"] is True
    tr = traces[-1]
    busy = [tr.card_busy_s[d.index] for d in cards]
    assert sorted(tr.card_busy_s) == [d.index for d in cards]
    assert all(b > 0 for b in busy), busy
    assert busy[-1] > 1.5 * busy[0], busy
    dev = line["device"]
    assert dev["busy_s"] == pytest.approx(sum(busy) / len(busy))
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["metrics"]["cards.idle_share"]["value"] == pytest.approx(
        100 * (1 - dev["busy_s"] / dev["window_s"]))
