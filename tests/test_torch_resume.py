"""Checkpoint and resume of the port's assembly (its counterpart of
tests/test_faults.py).

On the dataset of tests/test_faults.py (three rounds allowed; the loop
reaches a fixpoint in its third), the port's `assemble(device="cpu")`:

- killed right after round 1 leaves round 0's checkpoint, whose resumed
  continuation reaches the uninterrupted run's final genes;
- a torn checkpoint file raises and never half-loads;
- resumed from its final checkpoint with the `.aux` sidecar, it skips the
  round-0 re-stream (the crash's resume above re-streams) and gives the
  uninterrupted run's genes; a sidecar under another config raises.

Resume across packages: tests/test_torch_resume_cross.py. No tolerance.
"""

import dataclasses
import os

import numpy as np
import pytest
from test_torch_assemble import gene_fields, one_thread

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.utils.checkpoint import (
    load_aux_evidence,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["one_thread"]      # the fixture shared with that module

FAULTS = dict(max_assembly_iters=3, batch_size=128)


@pytest.fixture(scope="module")
def prob():
    ds = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    return PipelineConfig(**FAULTS), ds, tax


def run(prob, **kw):
    cfg, ds, tax = prob
    return tassemble.assemble(ds.reads, ds.read_lens, ds.ref_seqs,
                              ds.ref_lens, tax, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def full(prob, tmp_path_factory):
    """The uninterrupted run, checkpointed: (result, checkpoint path)."""
    ck = str(tmp_path_factory.mktemp("full") / "panel.ckpt")
    return run(prob, checkpoint_path=ck), ck


def test_crash_after_round_resumes_bitwise(prob, full, tmp_path,
                                           monkeypatch):
    ck = str(tmp_path / "panel.ckpt")

    class Boom(RuntimeError):
        pass

    real_round = tassemble.assemble_round
    calls = {"n": 0}

    def dying_round(*a, **kw):
        out = real_round(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:          # round 0 + round 1 done -> crash
            raise Boom()
        return out

    monkeypatch.setattr(tassemble, "assemble_round", dying_round)
    with pytest.raises(Boom):
        run(prob, checkpoint_path=ck)
    monkeypatch.setattr(tassemble, "assemble_round", real_round)

    header, panel = load_checkpoint(ck)
    assert header["round"] == 0 and panel
    assert all(type(g) is Gene for g in panel)
    assert os.path.exists(ck + ".aux")
    resumed = run(prob, initial_panel=panel)
    want = full[0]
    assert resumed.round_stats[0] == dict(round=0, resumed=True,
                                          genes=len(panel),
                                          aux_restored=False)
    assert (resumed.n_rounds, resumed.converged) == (want.n_rounds,
                                                     want.converged)
    assert want.converged
    assert gene_fields(resumed.genes) == gene_fields(want.genes)


def test_torn_checkpoint_rejected(prob, tmp_path):
    cfg = prob[0]
    genes = [Gene(seq=np.zeros(100, np.int8), n_reads=5, leaf=1, cluster=0,
                  round_born=0, taxon=1, offset=3)]
    ck = str(tmp_path / "panel.ckpt")
    save_checkpoint(ck, cfg, genes, 1)
    raw = open(ck, "rb").read()
    torn = str(tmp_path / "torn.ckpt")
    with open(torn, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(Exception):
        load_checkpoint(torn)
    header, back = load_checkpoint(ck)
    assert header["round"] == 1 and len(back) == 1
    assert gene_fields(back) == gene_fields(genes)


def test_resumed_polish_with_aux_sidecar_bitwise(prob, full):
    cfg = prob[0]
    want, ck = full
    assert os.path.exists(ck + ".aux"), "aux sidecar not written"
    header, panel = load_checkpoint(ck)
    assert header["round"] == want.n_rounds - 1
    assert gene_fields(panel) == gene_fields(want.panel)
    aux = load_aux_evidence(ck + ".aux", cfg)
    assert list(aux) == ["node_counts"]
    assert isinstance(aux["node_counts"], np.ndarray)
    with_aux = run(prob, initial_panel=panel, initial_aux=aux)
    assert with_aux.round_stats[0]["aux_restored"] is True
    assert gene_fields(with_aux.genes, born=False) == gene_fields(
        want.genes, born=False)
    assert with_aux.converged and with_aux.n_rounds == 2

    other = dataclasses.replace(cfg, min_score=cfg.min_score + 1)
    with pytest.raises(ValueError, match="different config"):
        load_aux_evidence(ck + ".aux", other)
