"""The port's whole assembly == the JAX reference, bit for bit (dense mode).

`rambl_tpu_torch.pipeline.assemble.assemble(device="cpu")` against
`assemble_jax` on the dataset of tests/test_assembly_parity.py: n_rounds,
converged, the pre-polish panel, every round's stats (genes, aligned,
n_leaves), polish's `changed`, and every final gene's sequence, n_reads,
leaf, cluster, taxon, offset and round_born; polish on and off. The port
leaves out the reference's 32-gene panel padding (`_pad_panel_bucket`): a
panel round on the padded panel gives the same genes as on the bare one.
Forced slot mode: tests/test_torch_assemble_slot.py. Every output is an
integer: no tolerance.
"""

import pytest
import torch

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.oracle.pipeline import pad_panel, panel_tables
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import assemble as tassemble

PARITY = dict(max_assembly_iters=2, batch_size=128)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch: the suite's other workers hold the
    cores, and an oversubscribed torch runs these small CPU paths many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    ds = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    return ds, tax


def args_of(ds, tax):
    return ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax


def gene_fields(genes, born=True):
    """Each gene's fields; born=False leaves out round_born, which a run
    resumed from a later round's panel counts from its own round 0."""
    return [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon, g.offset)
            + ((g.round_born,) if born else ()) for g in genes]


def round_fields(result):
    return [(s["round"], s["genes"], s.get("aligned"), s.get("n_leaves"))
            for s in result.round_stats if s["round"] != "polish"]


def check_result(ref, got, polished=True):
    """`got` (the port's AssemblyResult) equals `ref` (assemble_jax's with
    cfg.polish on). With polished=False `got` ran with polish off: the
    reference's rounds do not read cfg.polish, so its genes are `ref`'s
    pre-polish panel."""
    assert got.n_rounds == ref.n_rounds
    assert got.converged == ref.converged
    assert round_fields(got) == round_fields(ref)
    assert gene_fields(got.panel) == gene_fields(ref.panel)
    assert got.panel and ref.round_stats[-1]["round"] == "polish"
    if polished:
        pol = got.round_stats[-1]
        assert pol["round"] == "polish"
        assert pol["changed"] == ref.round_stats[-1]["changed"] > 0
        assert pol["nw_tier"] in ("native", "numpy")
        assert gene_fields(got.genes) == gene_fields(ref.genes)
        assert gene_fields(got.genes) != gene_fields(got.panel)
    else:
        assert got.round_stats[-1]["round"] != "polish"
        assert gene_fields(got.genes) == gene_fields(ref.panel)


@pytest.fixture(scope="module")
def jax_dense(tiny):
    return jassemble.assemble_jax(*args_of(*tiny), JConfig(**PARITY))


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "no_polish"])
def test_assemble_dense(tiny, jax_dense, polish):
    got = tassemble.assemble(*args_of(*tiny), TConfig(**PARITY, polish=polish),
                             device="cpu")
    check_result(jax_dense, got, polished=polish)
    assert got.n_rounds == 2 and len(got.round_stats) == 2 + polish


def test_aux_out_and_panel_padding(tiny, jax_dense):
    """Round 0 alone (max_assembly_iters 1, polish off) fills aux_out with
    its dense accumulator (flat rows, as the reference's) and gives the
    round-0 panel. The reference's round 1 ran on that panel padded to a
    32-gene bucket (all-N pad refs); the port's round on the padded panel
    gives the reference's round-1 genes and stats, as the bare panel does
    in test_assemble_dense: the padding is not needed."""
    ds, tax = tiny
    aux = {}
    cfg = TConfig(**dict(PARITY, max_assembly_iters=1, polish=False))
    r0 = tassemble.assemble(*args_of(ds, tax), cfg, aux_out=aux, device="cpu")
    assert list(aux) == ["node_counts"]
    counts = aux["node_counts"]
    assert isinstance(counts, torch.Tensor)
    assert tuple(counts.shape) == (tax.n_nodes, ds.ref_seqs.shape[1] * 4)
    assert (r0.n_rounds, r0.converged) == (1, False)
    assert round_fields(r0) == round_fields(jax_dense)[:1]
    genes = r0.genes
    seqs, lens = pad_panel(genes, ds.ref_seqs.shape[1])
    pseqs, plens, ptab, n = jassemble._pad_panel_bucket(
        seqs, lens, panel_tables(genes, tax), JConfig(**PARITY))
    assert n == len(genes) < pseqs.shape[0] == 32
    bits = tassemble._panel_bits(cfg)
    assert bits == jassemble._panel_bits(JConfig(**PARITY))
    got, stats = tassemble.assemble_round(ds.reads, ds.read_lens, pseqs,
                                          plens, ptab, cfg, 1, n_bits=bits,
                                          device="cpu")
    assert gene_fields(got) == gene_fields(jax_dense.panel)
    assert stats == jax_dense.round_stats[1]
