"""The port's NumPy oracle of the whole assembly == its `rambl_tpu`
original, on the same seeds: `oracle.pipeline.assemble` (rounds, polish,
resume from a panel) and `oracle.cohort.assemble_cohort`, gene by gene.
The port holds its card against this oracle (chip_smoke.py phase 13).
The oracle is slow, so the inputs are small. No tolerance.
"""

import dataclasses

import pytest
from test_torch_host_layers import _assert_same

from rambl_tpu import config as jconfig
from rambl_tpu.data import simulate as jsim
from rambl_tpu.index import taxonomy as jtax
from rambl_tpu.oracle import cohort as jcohort
from rambl_tpu.oracle import pipeline as jopipe
from rambl_tpu_torch import config as tconfig
from rambl_tpu_torch.oracle import cohort as tcohort
from rambl_tpu_torch.oracle import pipeline as topipe

N_READS = 150


def _same_results(ref, got):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert type(g) is topipe.AssemblyResult
        assert (g.n_rounds, g.converged) == (r.n_rounds, r.converged)
        _assert_same(r.round_stats, g.round_stats, "round_stats")
        for name in ("genes", "panel"):
            a, b = getattr(r, name), getattr(g, name)
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert type(y) is topipe.Gene
                _assert_same(dataclasses.asdict(x), dataclasses.asdict(y),
                             name)


@pytest.mark.parametrize("resume", [False, True], ids=["run", "resume"])
def test_oracle_assemble(resume):
    ds = jsim.simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                               seed=2, skewed_abundance=False)
    tax = jtax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth,
                                     ds.ref_taxon)
    args = (ds.reads[:N_READS], ds.read_lens[:N_READS], ds.ref_seqs,
            ds.ref_lens, tax)
    fields = dict(max_assembly_iters=2, batch_size=128)
    panel = None
    if resume:      # one round's panel, then the loop resumed from it
        fields["max_assembly_iters"] = 1
        one = topipe.assemble(*args, tconfig.PipelineConfig(
            **dict(fields, polish=False)))
        panel, fields["max_assembly_iters"] = one.genes, 2
        assert panel
    ref = jopipe.assemble(*args, jconfig.PipelineConfig(**fields),
                          initial_panel=panel)
    got = topipe.assemble(*args, tconfig.PipelineConfig(**fields),
                          initial_panel=panel)
    assert ref.genes and ref.round_stats[-1]["round"] == "polish"
    _same_results([ref], [got])


def test_oracle_assemble_cohort():
    kw = dict(n_species=2, refs_per_species=2, n_samples=2,
              reads_per_sample=80, seed=5)
    co = jsim.simulate_cohort(**kw)
    tax = jtax.build_taxonomy_tables(co.ds.tax_parent, co.ds.tax_depth,
                                     co.ds.ref_taxon)
    fields = dict(max_assembly_iters=1, batch_size=128, max_genes=32,
                  min_cluster_reads=2)
    args = (co.samples, co.ds.ref_seqs, co.ds.ref_lens, tax)
    ref = jcohort.assemble_cohort(*args, jconfig.PipelineConfig(**fields))
    got = tcohort.assemble_cohort(*args, tconfig.PipelineConfig(**fields))
    assert all(r.genes for r in ref)
    _same_results(ref, got)
