"""quality_bench's near-miss diagnoses (`rambl_tpu_torch/scripts/
diagnose_quality.py` and `diagnose_rounds.py`), held to the reference
scripts `scripts/diagnose_quality.py` and `scripts/diagnose_rounds.py`
(loaded by path): the printed lines of each pair must be equal, whole.

Both sides run their own scripts over one cut scenario put in place of
`SCENARIOS` on both sides: one species of three strains, 250 reads with
1% indel errors (seed 3), where one strain has no gene, others miss with
substitutions at strain columns. A planted copy of that assembly (its
first gene and the missed one, which loses three interior bases and gains
two) gives the DELETED and INSERTION lines. Every kind of line is
asserted to occur.

Both scripts assemble with a NumPy oracle (the port's `oracle.pipeline`,
the reference's `rambl_tpu.oracle.pipeline`), whose parity is held in
`test_torch_host_oracle.py`. To stay inside the suite's time, each
oracle's Smith-Waterman (`oracle.align.sw_batch`) is computed once for
each distinct input; each side is handed its own package's result, and
where both sides align one input the two results are held equal.
"""

import dataclasses
import os

import numpy as np
import pytest
from test_torch_scale_runners import REPO, _script

import rambl_tpu.oracle.align as jalign
import rambl_tpu_torch.oracle.align as talign
from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.oracle.pipeline import assemble
from rambl_tpu_torch.scripts import (
    diagnose_quality,
    diagnose_rounds,
    quality_bench,
)

SCENARIO = dict(n_species=1, refs_per_species=3, n_reads=250, seed=3,
                skewed_abundance=False, indel_error=0.01)



@pytest.fixture(scope="module", autouse=True)
def memo_sw():
    """Each oracle's Smith-Waterman, once a distinct input (the port's and
    the reference's results of one input held equal), and the cut scenario
    on both sides."""
    memo = {}

    def memoized(side, real):
        def sw_batch(q, w, sc, want_dirs=True):
            seen = memo.setdefault((q.shape, w.shape, q.tobytes(),
                                    w.tobytes(), dataclasses.astuple(sc),
                                    want_dirs), {})
            if side not in seen:
                seen[side] = real(q, w, sc, want_dirs=want_dirs)
                for other in seen.values():
                    for x, y in zip(seen[side], other, strict=True):
                        np.testing.assert_array_equal(x, y)
            return seen[side]
        return sw_batch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(talign, "sw_batch", memoized("port", talign.sw_batch))
        mp.setattr(jalign, "sw_batch",
                   memoized("reference", jalign.sw_batch))
        mp.setattr(quality_bench, "SCENARIOS", [("cut", SCENARIO)])
        yield


@pytest.fixture(scope="module")
def cut():
    ds = simulate_dataset(**SCENARIO)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    res = assemble(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
                   PipelineConfig(**diagnose_quality.CONFIG))
    return ds, res


def _lines(capsys, fn, *args, **kw):
    """`fn`'s printed lines (and what it returns, when asked)."""
    capsys.readouterr()
    got = fn(*args, **kw)
    lines = capsys.readouterr().out.splitlines()
    return (lines, got) if kw else lines


def _reference_quality(monkeypatch, assemble_result=None):
    mod = _script("diagnose_quality")
    monkeypatch.setattr(mod, "SCENARIOS", {"cut": SCENARIO})
    if assemble_result is not None:
        monkeypatch.setattr(mod, "assemble", lambda *a: assemble_result)
    monkeypatch.setattr("sys.argv", ["diagnose_quality.py"])
    return mod.main


def test_diagnose_quality_matches_reference(cut, monkeypatch, capsys):
    want = _lines(capsys, _reference_quality(monkeypatch))
    got, result = _lines(capsys, diagnose_quality.run, out=print)
    assert got == want
    text = "\n".join(got)
    for word in ("ok cont", "NO GENE", "MISS", "SUB", "STRAIN-COL",
                 "backbone"):
        assert word in text, word
    records = result["cut"]
    assert {r["status"] for r in records} == {"ok", "NO GENE", "MISS"}
    miss = [r for r in records if r["status"] == "MISS"]
    assert all(r["subs"] for r in miss)
    assert sum(len(r["subs"]) for r in miss) == text.count(" SUB ")


def test_planted_indels_match_reference(cut, monkeypatch, capsys):
    ds, res = cut
    miss = next(r for r in diagnose_quality.diagnose("cut", ds, res,
                                                     lambda *a: None)
                if r["status"] == "MISS")
    g = res.genes[miss["gene"]]
    seq = np.concatenate([g.seq[:500], g.seq[503:900], [2, 3], g.seq[900:]])
    # the first gene and the missed one, edited: no other gene competes
    genes = [res.genes[0], dataclasses.replace(g, seq=seq.astype(np.int8))]
    planted = dataclasses.replace(res, genes=genes)
    want = _lines(capsys, _reference_quality(monkeypatch, planted))
    monkeypatch.setattr(diagnose_quality, "assemble", lambda *a: planted)
    got, result = _lines(capsys, diagnose_quality.run, out=print)
    assert got == want
    text = "\n".join(got)
    for word in ("MISS", "SUB", "STRAIN-COL", "DELETED", "INSERTION"):
        assert word in text, word
    (rec,) = [r for r in result["cut"] if r.get("gene") == 1]
    assert len(rec["dels"]) >= 3 and len(rec["ins"]) >= 2


def test_diagnose_rounds_matches_reference(cut, monkeypatch, capsys):
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    mod = _script("diagnose_rounds")
    monkeypatch.setattr(mod, "SCENARIOS", {"cut": SCENARIO})
    monkeypatch.setattr("sys.argv", ["diagnose_rounds.py"])
    want = _lines(capsys, mod.main)
    got, result = _lines(capsys, diagnose_rounds.run, out=print)
    assert got == want
    hist = result["cut"]
    cfg = PipelineConfig(**diagnose_quality.CONFIG)
    assert hist and all(len(h) == cfg.max_assembly_iters
                        for h in hist.values())
    assert len(got) == 1 + len(hist)
