"""The port's round 0 == the JAX reference in its other modes, bit for bit.

`assemble_round(device="cpu")` against `assemble_round_jax`, gene by gene,
with stats and aux_out, on the dataset of tests/test_assembly_parity.py in
forced slot mode (pileup_slot_nodes=1) and with leaf blocks
(cluster_leaf_block 8 and 1), and on the zero-exclusive collapse dataset of
tests/test_scale_paths.py. Dense mode, stream-level checks and the helpers:
tests/test_torch_round.py.
"""

import pytest
from test_torch_round import (
    BASE,
    _both_rounds,
    _check_round,
    _genes,
    one_thread,
    tiny,
)

from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.taxonomy import build_taxonomy_tables

__all__ = ["one_thread", "tiny"]      # fixtures shared with that module


@pytest.mark.parametrize("extra", [dict(pileup_slot_nodes=1),
                                   dict(cluster_leaf_block=8),
                                   dict(cluster_leaf_block=1)],
                         ids=["slot", "block8", "block1"])
def test_assemble_round_mode(tiny, extra):
    ds, tax = tiny
    _check_round(*_both_rounds(ds, tax, dict(BASE, **extra)))


def test_zero_exclusive_leaf_collapse():
    """Slot-mode round 0 collapses zero-exclusive duplicate leaves: the
    port's genes equal the reference's while n_leaves falls below the
    count of refs."""
    ds = simulate_dataset(n_species=6, refs_per_species=4, n_reads=600,
                          seed=7, leaf_per_ref=True, n_present=5)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    fields = dict(max_assembly_iters=2, batch_size=256, pileup_slot_nodes=1,
                  bin_share_depth=3)
    ref, got = _both_rounds(ds, tax, fields)
    assert _genes(got[0]) == _genes(ref[0])
    assert got[1] == ref[1]
    assert got[1]["n_leaves"] < ds.n_refs
