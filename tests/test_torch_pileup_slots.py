"""The port's per-leaf pileup merge and slot-compacted pileups == the JAX
reference, bit for bit.

`rambl_tpu_torch.pipeline.pileup.{chain_use_mask, leaf_pileup,
node_slot_pileup, leaf_pileup_slots, polymorphic_mask}` against their
`rambl_tpu.pipeline.pileup` namesakes on random reads over the toy taxonomy
of tests/test_scale_paths.py (root -> a, b; a -> leaves 3, 4; b -> leaf 5):
every node as a leaf, share depths MAX_DEPTH, 3, 1 and 0, int16 and int32
ref_col, and slot maps that leave chain nodes without a slot; the scatter
in row chunks of 7, 300 and 512Ki reads. Torch runs on CPU tensors; every
output is an integer or a bool: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.index.taxonomy import MAX_DEPTH
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.pipeline import pileup as jpileup
from rambl_tpu_torch.pipeline import pileup as tpileup

REF_LEN = 64
SHARES = [MAX_DEPTH, 3, 1, 0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(ref, got, what=""):
    r = np.asarray(ref)
    g = got.numpy()
    assert r.dtype == g.dtype, (what, r.dtype, g.dtype)
    np.testing.assert_array_equal(r, g, err_msg=what)


@pytest.fixture(scope="module")
def toy():
    parent = np.array([0, 0, 0, 1, 1, 2], np.int32)
    depth = np.array([0, 1, 1, 2, 2, 2], np.int32)
    tax = build_taxonomy_tables(parent, depth, np.array([3, 4, 5], np.int32))
    rng = np.random.default_rng(21)
    B, L = 300, 16
    query = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    ref_col = np.sort(rng.integers(-1, REF_LEN, size=(B, L)).astype(np.int32),
                      axis=1)
    bins = rng.integers(-1, tax.n_nodes, size=(B,)).astype(np.int32)
    return tax, query, ref_col, bins


@pytest.fixture(scope="module")
def node_counts(toy):
    tax, q, rc, bins = toy
    ref = jpileup.node_pileup(jnp.asarray(q), jnp.asarray(rc),
                              jnp.asarray(bins), tax.n_nodes, REF_LEN)
    got = tpileup.node_pileup(_t(q), _t(rc), _t(bins), tax.n_nodes, REF_LEN)
    return ref, got


def _tables(tax):
    return ((jnp.asarray(tax.anc_path), jnp.asarray(tax.depth)),
            (_t(tax.anc_path), _t(tax.depth)))


@pytest.mark.parametrize("share", SHARES)
def test_chain_use_mask(toy, share):
    tax = toy[0]
    (ja, jd), (ta, td) = _tables(tax)
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    _same(jpileup.chain_use_mask(jnp.asarray(nodes), jd, share),
          tpileup.chain_use_mask(_t(nodes), td, share), "chain_use_mask")


@pytest.mark.parametrize("share", SHARES)
def test_leaf_pileup_every_node(toy, node_counts, share):
    tax = toy[0]
    (ja, jd), (ta, td) = _tables(tax)
    (jc, js), (tc, ts) = node_counts
    _same(jc, tc, "node counts")
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    ref = jpileup.leaf_pileup(jc, js, jnp.asarray(nodes), ja, jd, share)
    got = tpileup.leaf_pileup(tc, ts, _t(nodes), ta, td, share)
    _same(ref[0], got[0], "leaf_counts")
    _same(ref[1], got[1], "leaf_span")


def _slot_map(tax, bins, drop):
    """Slots for the nodes holding reads, less the nodes in `drop`."""
    own = np.bincount(bins[bins >= 0], minlength=tax.n_nodes)
    ids = np.array([n for n in np.nonzero(own > 0)[0] if n not in drop],
                   np.int32)
    node2slot = np.full(tax.n_nodes, -1, np.int32)
    node2slot[ids] = np.arange(ids.size, dtype=np.int32)
    return node2slot, max(ids.size, 1)


@pytest.mark.parametrize("rc_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("drop", [(), (1,), (0, 4)],
                         ids=["all", "no_a", "no_root_no_4"])
def test_node_slot_pileup(toy, rc_dtype, drop):
    tax, q, rc, bins = toy
    node2slot, n_slots = _slot_map(tax, bins, drop)
    rc = rc.astype(rc_dtype)
    ref = jpileup.node_slot_pileup(jnp.asarray(q), jnp.asarray(rc),
                                   jnp.asarray(bins), jnp.asarray(node2slot),
                                   n_slots, REF_LEN)
    got = tpileup.node_slot_pileup(_t(q), _t(rc), _t(bins), _t(node2slot),
                                   n_slots, REF_LEN)
    _same(ref[0], got[0], "slot counts")
    _same(ref[1], got[1], "slot span")


@pytest.mark.parametrize("chunk", [7, 300, 1 << 19])
def test_scatter_in_row_chunks(toy, node_counts, monkeypatch, chunk):
    """The scatter takes at most `chunk` reads a pass and still equals the
    JAX node_pileup and node_slot_pileup bit for bit. One pass over every
    retained read held ~33 B of temporaries a read column and ran the 80 GB
    card out of memory at config 5's 20 M reads (phase B's slot pileup)."""
    tax, q, rc, bins = toy
    monkeypatch.setattr(tpileup, "_SCATTER_ROW_CHUNK", chunk)
    sizes = []
    real = torch.Tensor.index_add_

    def spy(self, dim, index, source, **kw):
        sizes.append(index.numel())
        return real(self, dim, index, source, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    got = tpileup.node_pileup(_t(q), _t(rc), _t(bins), tax.n_nodes, REF_LEN)
    B, L = q.shape
    passes = -(-B // chunk)
    # each pass: one cell scatter of <= chunk x L, two span scatters
    assert len(sizes) == 3 * passes
    assert max(sizes[0::3]) == min(chunk, B) * L
    ref = node_counts[0]
    _same(ref[0], got[0], "counts")
    _same(ref[1], got[1], "span")
    node2slot, n_slots = _slot_map(tax, bins, (1,))
    ref = jpileup.node_slot_pileup(jnp.asarray(q), jnp.asarray(rc),
                                   jnp.asarray(bins), jnp.asarray(node2slot),
                                   n_slots, REF_LEN)
    got = tpileup.node_slot_pileup(_t(q), _t(rc), _t(bins), _t(node2slot),
                                   n_slots, REF_LEN)
    _same(ref[0], got[0], "slot counts")
    _same(ref[1], got[1], "slot span")


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("drop", [(), (1,), (0, 4)],
                         ids=["all", "no_a", "no_root_no_4"])
def test_leaf_pileup_slots(toy, share, drop):
    tax, q, rc, bins = toy
    (ja, jd), (ta, td) = _tables(tax)
    node2slot, n_slots = _slot_map(tax, bins, drop)
    jcs, jss = jpileup.node_slot_pileup(
        jnp.asarray(q), jnp.asarray(rc), jnp.asarray(bins),
        jnp.asarray(node2slot), n_slots, REF_LEN)
    tcs, tss = tpileup.node_slot_pileup(_t(q), _t(rc), _t(bins),
                                        _t(node2slot), n_slots, REF_LEN)
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    ref = jpileup.leaf_pileup_slots(jcs, jss, jnp.asarray(node2slot),
                                    jnp.asarray(nodes), ja, jd, share)
    got = tpileup.leaf_pileup_slots(tcs, tss, _t(node2slot), _t(nodes), ta,
                                    td, share)
    _same(ref[0], got[0], "leaf_counts")
    _same(ref[1], got[1], "leaf_span")
    if not drop:
        # every node with reads has a slot: the dense merge's integers
        jc, js = jpileup.node_pileup(jnp.asarray(q), jnp.asarray(rc),
                                     jnp.asarray(bins), tax.n_nodes, REF_LEN)
        dense = jpileup.leaf_pileup(jc, js, jnp.asarray(nodes), ja, jd, share)
        _same(dense[0], got[0], "dense leaf_counts")


@pytest.mark.parametrize("params", [(2, 1, 1, 10, 5), (3, 2, 3, 20, 64),
                                    (1, 1, 1, 2, 1), (4, 1, 0, 1, 3)])
def test_polymorphic_mask(toy, node_counts, params):
    tax = toy[0]
    (ja, jd), (ta, td) = _tables(tax)
    (jc, js), (tc, ts) = node_counts
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    jl = jpileup.leaf_pileup(jc, js, jnp.asarray(nodes), ja, jd)[0]
    tl = tpileup.leaf_pileup(tc, ts, _t(nodes), ta, td)[0]
    ref = jpileup.polymorphic_mask(jl, *params)
    got = tpileup.polymorphic_mask(tl, *params)
    _same(ref, got, "polymorphic_mask")
    assert got.any()
