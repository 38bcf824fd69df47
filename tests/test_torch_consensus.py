"""The port's consensus calling == the JAX reference, bit for bit.

`rambl_tpu_torch.pipeline.consensus.{call_consensus, _use_cluster,
cluster_consensus_leaves, minor_haplotype_leaves, _chain_read_count}`
against `rambl_tpu.pipeline.consensus.{call_consensus_jax, ...}` on the same
numpy inputs from a seed: counts with ties and empty columns, member
tensors with invalid members and unaligned positions, and the cases of
tests/test_minorhap.py. Torch runs on CPU tensors: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.index.taxonomy import MAX_DEPTH, build_taxonomy_tables
from rambl_tpu.pipeline import consensus as jcons
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import consensus as tcons

_cluster_leaves = jax.jit(jcons.cluster_consensus_leaves, static_argnums=(7,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(ref, got, what=""):
    r = np.asarray(ref)
    g = got.numpy()
    assert r.dtype == g.dtype, (what, r.dtype, g.dtype)
    np.testing.assert_array_equal(r, g, err_msg=what)


def _counts(seed, shape, hi=6, p_zero=0.3):
    """Small counts (many ties) with whole empty columns."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, hi, shape + (4,)).astype(np.int32)
    c[rng.random(shape) < p_zero] = 0
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_call_consensus(seed):
    c = _counts(seed, (3, 5, 40))
    rng = np.random.default_rng(seed + 10)
    span = (c.sum(-1) + rng.integers(-2, 8, c.shape[:-1])).astype(np.int32)
    c[0, 0] = 0                       # a row with no coverage at all
    c[0, 1, :] = 0
    c[0, 1, 17] = [3, 3, 0, 3]        # one covered column, a three-way tie
    ref = jcons.call_consensus_jax(jnp.asarray(c), jnp.asarray(span))
    got = tcons.call_consensus(_t(c), _t(span))
    _same(ref[0], got[0], "called")
    _same(ref[1], got[1], "emit")
    assert int(got[0][0, 1, 17]) == 0 and not got[1][0, 0].any()


@pytest.mark.parametrize("fields", [{}, dict(min_coverage=2, vote_min_abs=3,
                                             vote_min_frac_num=1,
                                             vote_min_frac_den=2)])
def test_use_cluster_and_unique_top(fields):
    ck = _counts(3, (4, 8, 50))
    ca = ck.sum(1) + _counts(4, (4, 50))
    pm = np.random.default_rng(5).random((4, 50)) < 0.6
    ref = jcons._use_cluster(jnp.asarray(pm[:, None]), jnp.asarray(ck),
                             jnp.asarray(ca[:, None]), JConfig(**fields))
    got = tcons._use_cluster(_t(pm[:, None]), _t(ck), _t(ca[:, None]),
                             TConfig(**fields))
    _same(ref, got, "use_cluster")
    _same(jcons._unique_top(jnp.asarray(ck)), tcons._unique_top(_t(ck)),
          "unique_top")


def _members(seed, NL=4, M=40, L=24, ref_len=48, K=8):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (NL, M, L)).astype(np.int8)
    rc = np.full((NL, M, L), -1, np.int32)
    for a in range(NL):
        for m in range(M):
            lo = int(rng.integers(0, ref_len - L))
            n = int(rng.integers(0, L + 1))
            rc[a, m, :n] = lo + np.arange(n)
            rc[a, m, rng.random(L) < 0.1] = -1     # deletions in the read
    valid = rng.random((NL, M)) < 0.85
    assign = rng.integers(0, 3, (NL, M)).astype(np.int32)
    assign[0] = 0
    assign[1, :3] = K + 2                          # clipped ids
    return q, rc, valid, assign


@pytest.mark.parametrize("seed", [6, 7])
def test_cluster_consensus_leaves(seed):
    q, rc, valid, assign = _members(seed)
    NL, ref_len = q.shape[0], 48
    # backbone = all valid members' pileup + extra reads
    bb = _counts(seed + 1, (NL, ref_len), hi=3)
    ok = (rc >= 0) & (q < 4) & valid[:, :, None]
    for a in range(NL):
        np.add.at(bb[a], (rc[a][ok[a]], q[a][ok[a]].astype(int)), 1)
    span = (bb.sum(-1) + 1).astype(np.int32)
    pm = np.random.default_rng(seed + 2).random((NL, ref_len)) < 0.5
    for fields in ({}, dict(min_coverage=1, vote_min_abs=2)):
        ref = _cluster_leaves(jnp.asarray(q), jnp.asarray(rc),
                              jnp.asarray(valid), jnp.asarray(assign),
                              jnp.asarray(pm), jnp.asarray(bb),
                              jnp.asarray(span), JConfig(**fields))
        got = tcons.cluster_consensus_leaves(
            _t(q), _t(rc), _t(valid), _t(assign), _t(pm), _t(bb), _t(span),
            TConfig(**fields))
        assert got._fields == ref._fields
        for name in ref._fields:
            _same(getattr(ref, name), getattr(got, name), f"{name} {fields}")


def _mh_counts(cols):
    c = np.zeros((1, len(cols), 4), np.int32)
    for i, d in enumerate(cols):
        for b, n in d.items():
            c[0, i, b] = n
    return c


MINORHAP_CASES = {
    "skewed_minor_columns_flip": (
        [{0: 32}, {0: 25, 1: 7}, {0: 32}, {0: 25, 1: 7}, {0: 32}], None),
    "equal_abundance_gated_out": (
        [{0: 32}, {0: 16, 1: 16}, {0: 16, 1: 16}, {0: 32}], None),
    "thin_minor_and_ambiguous_second_gated_out": (
        [{0: 30, 1: 3}, {0: 100, 1: 5}, {0: 24, 1: 4, 2: 4}, {0: 25, 1: 7}],
        None),
    "backbone_from_leaf_counts_not_exclusive": (
        [{0: 10}, {0: 25, 1: 7}, {0: 10}, {0: 25, 1: 7}],
        [{2: 40}, {0: 25, 1: 7}, {2: 40}, {0: 25, 1: 7}]),
    "minor_at_a_higher_base": (
        [{3: 25, 2: 7}, {1: 7, 3: 25}, {0: 20}], None),
}


@pytest.mark.parametrize("case", sorted(MINORHAP_CASES))
def test_minor_haplotype_leaves(case):
    ex_cols, leaf_cols = MINORHAP_CASES[case]
    ex = _mh_counts(ex_cols)
    leaf = ex if leaf_cols is None else _mh_counts(leaf_cols)
    span = leaf.sum(-1)
    ref = jcons.minor_haplotype_leaves(jnp.asarray(ex), jnp.asarray(leaf),
                                       jnp.asarray(span), JConfig())
    got = tcons.minor_haplotype_leaves(_t(ex), _t(leaf), _t(span), TConfig())
    assert got._fields == ref._fields
    for name in ref._fields:
        _same(getattr(ref, name), getattr(got, name), name)


def test_minor_haplotype_leaves_random():
    rng = np.random.default_rng(8)
    ex = rng.integers(0, 30, (6, 60, 4)).astype(np.int32)
    ex[rng.random((6, 60)) < 0.5, 1:] = 0
    ex[:, ::7, 1] = ex[:, ::7, 0] // 4 + 4       # clear minors
    leaf = ex + rng.integers(0, 5, ex.shape).astype(np.int32)
    span = leaf.sum(-1).astype(np.int32)
    ref = jcons.minor_haplotype_leaves(jnp.asarray(ex), jnp.asarray(leaf),
                                       jnp.asarray(span), JConfig())
    got = tcons.minor_haplotype_leaves(_t(ex), _t(leaf), _t(span), TConfig())
    for name in ref._fields:
        _same(getattr(ref, name), getattr(got, name), name)
    assert got.n_cols.max() > 0


@pytest.mark.parametrize("share", [None, MAX_DEPTH, 3, 1, 0])
def test_chain_read_count(share):
    parent = np.array([0, 0, 0, 1, 1, 2, 3, 3], np.int32)
    depth = np.array([0, 1, 1, 2, 2, 2, 3, 3], np.int32)
    tax = build_taxonomy_tables(parent, depth,
                                np.array([4, 5, 6, 7], np.int32))
    rc = np.random.default_rng(9).integers(0, 50, tax.n_nodes).astype(
        np.int32)
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    ref = jcons._chain_read_count(jnp.asarray(rc), jnp.asarray(nodes),
                                  jnp.asarray(tax.anc_path),
                                  jnp.asarray(tax.depth), share)
    got = tcons._chain_read_count(_t(rc), _t(nodes), _t(tax.anc_path),
                                  _t(tax.depth), share)
    _same(ref, got, "chain read count")
