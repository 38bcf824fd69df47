"""The port's DP-means clustering stage == the JAX reference, bit for bit.

`rambl_tpu_torch.pipeline.cluster.{bin_sort, member_table_ranges,
leaf_features_dense, dp_means_leaves}` against their
`rambl_tpu.pipeline.cluster` namesakes (and the dense `member_table`, which
the port does not carry) on the same numpy inputs from a seed: ties and
unaligned reads in the sort, every taxonomy node as a leaf (windows clipped
at the root) at several member caps and share depths, projected columns
that collide within a member, invalid polymorphic columns, leaves that spawn
several clusters, leaves that may seed nothing, and argmax/argmin ties.
Torch runs on CPU tensors: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.index.taxonomy import MAX_DEPTH, build_taxonomy_tables
from rambl_tpu.pipeline import cluster as jcluster
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import cluster as tcluster


# jitted once a shape: op-by-op dispatch of these in eager JAX is slow
_ranges = jax.jit(jcluster.member_table_ranges, static_argnums=(6, 7))
_dense = jax.jit(jcluster.member_table, static_argnums=(4, 5))
_dp = jax.jit(jcluster.dp_means_leaves, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(ref, got, what=""):
    r = np.asarray(ref)
    g = got.numpy()
    assert r.dtype == g.dtype, (what, r.dtype, g.dtype)
    np.testing.assert_array_equal(r, g, err_msg=what)


@pytest.fixture(scope="module")
def toy_tax():
    # root(0) -> a(1), b(2); a -> leaves 3,4 ; b -> leaf 5
    parent = np.array([0, 0, 0, 1, 1, 2], np.int32)
    depth = np.array([0, 1, 1, 2, 2, 2], np.int32)
    return build_taxonomy_tables(parent, depth, np.array([3, 4, 5], np.int32))


@pytest.fixture(scope="module")
def bins500(toy_tax):
    rng = np.random.default_rng(0)
    return rng.integers(-1, toy_tax.n_nodes, size=(500,)).astype(np.int32)


def test_bin_sort_ties_and_unaligned(toy_tax, bins500):
    ref = jcluster.bin_sort(jnp.asarray(bins500), toy_tax.n_nodes)
    got = tcluster.bin_sort(_t(bins500), toy_tax.n_nodes)
    for r, g, what in zip(ref, got, ("order", "node_start", "node_end")):
        _same(r, g, what)
    order = got[0].numpy()
    n_unaligned = int((bins500 < 0).sum())
    assert n_unaligned > 0
    assert (bins500[order[:n_unaligned]] == -1).all()
    # a node absent from the reads has an empty range
    sparse = np.where(bins500 == 2, 0, bins500).astype(np.int32)
    ref = jcluster.bin_sort(jnp.asarray(sparse), toy_tax.n_nodes)
    got = tcluster.bin_sort(_t(sparse), toy_tax.n_nodes)
    for r, g in zip(ref, got):
        _same(r, g, "sparse")
    assert int(got[1][2]) == int(got[2][2])


@pytest.mark.parametrize("M", [4, 32, 1024])
@pytest.mark.parametrize("share", [MAX_DEPTH, 3, 1, 0])
def test_member_table_ranges_every_node(toy_tax, bins500, M, share):
    B = bins500.shape[0]
    anc, dep = toy_tax.anc_path, toy_tax.depth
    order = jcluster.bin_sort(jnp.asarray(bins500), toy_tax.n_nodes)
    torder = tcluster.bin_sort(_t(bins500), toy_tax.n_nodes)
    for lv in (np.array([3, 4, 5], np.int32),
               np.arange(toy_tax.n_nodes, dtype=np.int32)):
        ref = _ranges(
            *order, jnp.asarray(lv), jnp.asarray(anc), jnp.asarray(dep), M,
            share)
        got = tcluster.member_table_ranges(*torder, _t(lv), _t(anc),
                                           _t(dep), M, share)
        _same(ref[0], got[0], "idx")
        _same(ref[1], got[1], "valid")
        dense = _dense(
            jnp.asarray(bins500), jnp.asarray(lv), jnp.asarray(anc),
            jnp.asarray(dep), M, share)
        n = min(M, B)   # the dense table caps its width at B
        np.testing.assert_array_equal(np.asarray(dense[0])[:, :n],
                                      got[0].numpy()[:, :n])
        np.testing.assert_array_equal(np.asarray(dense[1])[:, :n],
                                      got[1].numpy()[:, :n])


def _members(seed, NL=5, M=12, L=32, ref_len=64, collide=True):
    """Random member tensors: strictly increasing columns per read, some
    positions unaligned, codes 0..5 (N = 4 and junk 5 included); with
    `collide`, some reads put two positions on one projected column with
    different bases, as col_map can."""
    rng = np.random.default_rng(seed)
    qm = rng.integers(0, 6, (NL, M, L)).astype(np.int8)
    rcm = np.full((NL, M, L), -1, np.int32)
    for a in range(NL):
        for m in range(M):
            npos = int(rng.integers(0, L))
            cols = np.sort(rng.choice(ref_len, npos, replace=False))
            pos = np.sort(rng.choice(L, npos, replace=False))
            rcm[a, m, pos] = cols
            if collide and npos >= 2 and m % 3 == 0:
                rcm[a, m, pos[1]] = rcm[a, m, pos[0]]
                qm[a, m, pos[0]], qm[a, m, pos[1]] = 1, 2
    mv = rng.random((NL, M)) < 0.8
    pc = rng.integers(0, ref_len + 8, (NL, 8)).astype(np.int32)   # some OOB
    pv = rng.random((NL, 8)) < 0.7
    if collide:
        # every leaf asks for a colliding column
        for a in range(NL):
            m = 0
            hit = rcm[a, m][rcm[a, m] >= 0]
            if hit.size:
                pc[a, 0], pv[a, 0] = hit[0], True
    return qm, rcm, mv, pc, pv


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("rc16", [False, True])
def test_leaf_features_dense(seed, rc16):
    ref_len = 64
    qm, rcm, mv, pc, pv = _members(seed, ref_len=ref_len)
    rc_in = rcm.astype(np.int16) if rc16 else rcm
    ref = jcluster.leaf_features_dense(
        jnp.asarray(qm), jnp.asarray(rc_in), jnp.asarray(mv),
        jnp.asarray(pc), jnp.asarray(pv), ref_len, chunk=2)
    got = tcluster.leaf_features_dense(_t(qm), _t(rc_in), _t(mv), _t(pc),
                                       _t(pv), ref_len)
    _same(ref, got, "feat")
    # the planted collision (bases 1 and 2 on one column) keeps the larger
    assert (got.numpy()[:, 0, 0][mv[:, 0]] == 2).any()


def test_leaf_features_dense_without_collisions_matches_sorted():
    ref_len = 64
    qm, rcm, mv, pc, pv = _members(9, ref_len=ref_len, collide=False)
    pc = np.clip(pc, 0, ref_len - 1)
    mc, mb = jax.vmap(jcluster.sorted_col_base)(jnp.asarray(qm),
                                                jnp.asarray(rcm))
    ref = jcluster.leaf_features(mc, mb, jnp.asarray(mv), jnp.asarray(pc),
                                 jnp.asarray(pv))
    got = tcluster.leaf_features_dense(_t(qm), _t(rcm), _t(mv), _t(pc),
                                       _t(pv), ref_len)
    _same(ref, got, "feat vs the sorted formulation")


def _planted(seed, NL=6, M=96, P=16, err=0.02):
    """Per leaf 1..4 haplotypes over P columns, reads covering a random
    stretch of columns with errors; leaf 0 is two equally abundant
    haplotypes (column counts tie, reads equidistant from both), and some
    member rows are invalid (all -1)."""
    rng = np.random.default_rng(seed)
    feat = np.full((NL, M, P), -1, np.int8)
    for a in range(NL):
        n_hap = 2 if a == 0 else int(rng.integers(1, 5))
        haps = rng.integers(0, 4, (n_hap, P))
        if a == 0:
            haps = np.stack([np.zeros(P, int), np.ones(P, int)])
        for m in range(M):
            h = haps[m % n_hap if a == 0 else int(rng.integers(0, n_hap))]
            lo = int(rng.integers(0, P - 2))
            hi = int(rng.integers(lo + 2, P + 1))
            row = h.copy()
            flip = rng.random(P) < err
            row[flip] = rng.integers(0, 4, flip.sum())
            feat[a, m, lo:hi] = row[lo:hi]
        if a == 0:
            # equidistant reads: half of each haplotype
            feat[a, :4] = np.r_[np.zeros(P // 2), np.ones(P // 2)]
        feat[a, M - 5:] = -1                       # invalid member rows
    can_seed = rng.random((NL, M)) < 0.7
    can_seed[NL - 1] = False                       # a leaf that seeds nothing
    return feat, can_seed


@pytest.fixture(scope="module", params=[11, 12])
def dp_case(request):
    feat, can_seed = _planted(request.param)
    fields = dict(max_clusters_per_bin=4, dp_spawn_scan=8, dp_leaf_vmap=4)
    ref = _dp(jnp.asarray(feat), jnp.asarray(can_seed),
                                   JConfig(**fields))
    got = tcluster.dp_means_leaves(_t(feat), _t(can_seed), TConfig(**fields))
    return feat, can_seed, ref, got, fields


def test_dp_means_leaves(dp_case):
    feat, can_seed, ref, got, _ = dp_case
    assert got._fields == ref._fields
    for name in ref._fields:
        _same(getattr(ref, name), getattr(got, name), name)
    kact = got.kact.numpy()
    assert kact.max() >= 2                         # leaves spawned clusters
    assert kact[-1] == 1                           # can_seed all false
    assert (got.assign.numpy()[-1] == 0).all()


def test_dp_means_single_leaf_and_consensus_counts(dp_case):
    """Each leaf alone gives its row of the block, and the integer base
    counts equal the reference's float ones."""
    feat, can_seed, _, got, fields = dp_case
    cfg = TConfig(**fields)
    for a in (0, feat.shape[0] - 1):
        one = tcluster.dp_means_leaves(_t(feat[a:a + 1]),
                                       _t(can_seed[a:a + 1]), cfg)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(one, name).numpy()[0],
                                          getattr(got, name).numpy()[a])
        ref = jcluster._consensus_counts(jnp.asarray(feat[a]),
                                         jnp.ones(feat.shape[1]))
        cnt = tcluster._consensus_counts(_t(feat[a]))
        np.testing.assert_array_equal(np.asarray(ref).astype(np.int32),
                                      cnt.numpy())


def test_dp_means_ties():
    """Ties at every argmax/argmin: fallback (equal base counts), the
    nearest center (equidistant reads), the spawn seed (several good seeds)
    and the center recount; and merging of identical centers."""
    P, M = 4, 24
    feat = np.full((3, M, P), -1, np.int8)
    # leaf 0: 12 reads of 0000, 12 of 1111 -> fallback ties to base 0
    feat[0, :12] = 0
    feat[0, 12:] = 1
    # leaf 1: 0011 and 1100 reads, and reads equidistant from both
    feat[1, :10] = [0, 0, 1, 1]
    feat[1, 10:20] = [1, 1, 0, 0]
    feat[1, 20:] = [0, 1, 0, 1]
    # leaf 2: two identical groups that spawn, then collapse onto cluster 0
    feat[2, :8] = [2, 2, 2, 2]
    feat[2, 8:16] = [3, 3, 3, 3]
    feat[2, 16:] = [2, 2, 3, 3]
    can_seed = np.ones((3, M), bool)
    for fields in (dict(max_clusters_per_bin=4),
                   dict(max_clusters_per_bin=2, dp_spawn_min_orphans=1),
                   dict(max_clusters_per_bin=8, dp_lambda_num=1,
                        dp_lambda_den=10, dp_spawn_min_orphans=2)):
        ref = _dp(jnp.asarray(feat),
                                       jnp.asarray(can_seed),
                                       JConfig(**fields))
        got = tcluster.dp_means_leaves(_t(feat), _t(can_seed),
                                       TConfig(**fields))
        for name in ref._fields:
            _same(getattr(ref, name), getattr(got, name),
                  f"{name} {fields}")
