"""The scale ladder's runners == the JAX reference, gene for gene, on the CPU.

- `run_config3.run` at a tiny config-3 shape (a leaf per reference, 8 of
  20 references present, slot mode forced, `cluster_leaf_block` 8 so round
  0 clusters more than one block, `bin_share_depth` 3): n_rounds,
  converged, every round's stats, the pre-polish panel, polish's `changed`
  and every final gene equal `assemble_jax`'s on the reference's dataset
  and index.
- `run_config5.run`'s two phases (the discovery round with a checkpoint,
  then a resume from disk with the `.aux` sidecar) through a checkpoint in
  `tmp_path`: the same as the uninterrupted port run and `assemble_jax` on
  the reference script's chunked reads.

The runners' default batch would pad the tiny datasets to one 16,384-read
batch, so the tests run them at batch 128. No tolerance.
"""

import dataclasses

import numpy as np
import pytest
from test_torch_assemble import gene_fields, one_thread, round_fields
from test_torch_scale_runners import (
    _reference_config3,
    _reference_config5_reads,
)

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.index.taxonomy import build_taxonomy_tables as jtables
from rambl_tpu.pipeline.assemble import assemble_jax
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts import run_config3, run_config5

__all__ = ["one_thread"]      # the fixture shared with that module

N_READS, N_REFS, N_PRESENT = 300, 20, 8
TINY = dict(batch_size=128, pileup_slot_nodes=1, cluster_leaf_block=8)


def jconfig(cfg):
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})


def jax_run(ds, reads, lens, index, cfg):
    tax = jtables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    return assemble_jax(reads, lens, ds.ref_seqs, ds.ref_lens, tax,
                        jconfig(cfg), shared_index=index)


def same(got, want, rounds_from=0):
    assert (got.n_rounds, got.converged) == (want.n_rounds, want.converged)
    assert round_fields(got)[rounds_from:] == round_fields(want)[rounds_from:]
    assert gene_fields(got.panel) == gene_fields(want.panel)
    pol = got.round_stats[-1]
    assert pol["round"] == "polish"
    assert pol["changed"] == want.round_stats[-1]["changed"]
    assert got.genes and gene_fields(got.genes) == gene_fields(want.genes)


def test_run_config3_equals_assemble_jax():
    ref_cfg = run_config3.config(10_000_000, 2048)
    assert (ref_cfg.batch_size, ref_cfg.max_genes, ref_cfg.max_clusters_per_bin,
            ref_cfg.max_assembly_iters, ref_cfg.bin_share_depth,
            ref_cfg.cluster_leaf_block, ref_cfg.sw_rows) == (
                16000, 2048, 16, 4, 3, 512, 104)
    out = run_config3.run(N_READS, N_REFS, n_present=N_PRESENT, device="cpu",
                          cache_dir=None,
                          overrides=dict(TINY, max_assembly_iters=2),
                          out=lambda *a: None)
    cfg = out["cfg"]
    got = out["result"]
    ds, index = _reference_config3(N_READS, N_REFS, N_PRESENT)
    want = jax_run(ds, ds.reads, ds.read_lens, index, cfg)
    same(got, want)
    # slot mode, and round 0 clustered in more than one leaf block
    assert list(out["aux"]) == ["slot_counts"]
    assert got.round_stats[0]["n_leaves"] > cfg.cluster_leaf_block
    assert [r["round"] for r in out["rounds"]] == [0, 1]
    assert out["present"] == N_PRESENT
    assert 0 < out["detectable"] == out["recovered"]
    assert out["genes"] == len(want.genes)


@pytest.fixture(scope="module")
def config5_data():
    return caches.config5(N_READS, N_REFS, N_PRESENT, directory=None,
                          out=lambda *a: None)


def test_run_config5_resumes_to_the_uninterrupted_run(config5_data,
                                                      tmp_path):
    out = run_config5.run(N_READS, N_REFS, device="cpu", data=config5_data,
                          ckpt_dir=str(tmp_path),
                          overrides=dict(TINY, max_assembly_iters=2),
                          out=lambda *a: None)
    cfg, got = out["cfg"], out["result"]
    assert run_config5.config(N_READS).max_assembly_iters == 3
    assert (tmp_path / "config5.ckpt").exists()
    assert (tmp_path / "config5.ckpt.aux").exists()
    assert out["header"]["round"] == 0 and out["aux_restored"]
    assert got.round_stats[0] == dict(round=0, resumed=True,
                                      genes=len(out["result_a"].panel),
                                      aux_restored=True)
    assert [r["round"] for r in out["rounds_a"]] == [0]
    assert [r["round"] for r in out["rounds_b"]] == list(
        range(1, got.n_rounds))
    d = config5_data
    tax = build_taxonomy_tables(d.tax_parent, d.tax_depth, d.ref_taxon)
    whole = tassemble.assemble(d.reads, d.read_lens, d.ref_seqs, d.ref_lens,
                               tax, cfg, shared_index=d.index, device="cpu")
    same(got, whole, rounds_from=1)
    assert gene_fields(got.genes) == gene_fields(whole.genes)
    panel, index = _reference_config3(1, N_REFS, N_PRESENT)
    reads, lens = _reference_config5_reads(panel, N_READS, caches.CHUNK)
    np.testing.assert_array_equal(reads, d.reads)
    same(whole, jax_run(panel, reads, lens, index, cfg))
    assert out["detectable"] > 0 and out["recovered"] == out["detectable"]
