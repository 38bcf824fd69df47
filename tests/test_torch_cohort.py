"""The port's cohort assembly == the JAX reference, bit for bit.

`rambl_tpu_torch.pipeline.assemble.assemble_cohort(device="cpu")` against
the JAX package's `assemble_cohort` on a tiny 2-sample cohort (2 species x
3 strains, 300 reads a sample, seed 5): per sample n_rounds, converged, the
round stats, the pre-polish panel and every final gene (sequence, n_reads,
leaf, cluster, taxon, offset, round_born), the covariation-phased genes
(round_born -1) included. No tolerance.
"""

import pytest
from test_torch_assemble import gene_fields, one_thread, round_fields

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.data.simulate import simulate_cohort
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["one_thread"]      # the fixture shared with that module

COHORT = dict(max_assembly_iters=2, batch_size=300, max_genes=32)


@pytest.fixture(scope="module")
def cohort():
    co = simulate_cohort(n_species=2, refs_per_species=3, n_samples=2,
                         reads_per_sample=300, seed=5)
    tax = build_taxonomy_tables(co.ds.tax_parent, co.ds.tax_depth,
                                co.ds.ref_taxon)
    return co.samples, co.ds.ref_seqs, co.ds.ref_lens, tax


@pytest.fixture(scope="module")
def results(cohort):
    ref = jassemble.assemble_cohort(*cohort, JConfig(**COHORT))
    got = tassemble.assemble_cohort(*cohort, TConfig(**COHORT), device="cpu")
    return ref, got


def test_cohort_matches_jax(results):
    ref, got = results
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert (g.n_rounds, g.converged) == (r.n_rounds, r.converged)
        assert round_fields(g) == round_fields(r)
        assert gene_fields(g.panel) == gene_fields(r.panel)
        assert gene_fields(g.genes) == gene_fields(r.genes)
    assert all(any(x.round_born == -1 for x in r.genes) for r in got), \
        "the cohort must exercise phased-gene emission"


def test_one_sample_is_not_phased(cohort, results):
    """One sample: no phasing; its rounds and panel are the cohort run's
    for that sample (the per-sample loops are independent) and its genes
    the plain polished panel, with no phased gene."""
    samples, ref_seqs, ref_lens, tax = cohort
    got = tassemble.assemble_cohort(samples[:1], ref_seqs, ref_lens, tax,
                                    TConfig(**COHORT), device="cpu")
    both = results[1][0]
    assert len(got) == 1
    assert got[0].round_stats == both.round_stats
    assert gene_fields(got[0].panel) == gene_fields(both.panel)
    assert not any(g.round_born == -1 for g in got[0].genes)
    assert len(got[0].genes) == len(both.panel)
