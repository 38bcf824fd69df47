"""The port's `scripts/profile_cluster.py` pieces against the JAX package's
cluster-stage functions, bit for bit, on CPU tensors.

`make_inputs` at a tiny shape (5,000 reads over 17 x 8 leaves of 3,000
nodes, ref_len 256, reads of 32, 256 slots; max_bin_reads 32, so some
leaves are capped) feeds `pieces(..., device="cpu")`; the same host arrays
go through `rambl_tpu/pipeline/{cluster,pileup,consensus}.py` in the
reference script's order (bin_sort, member table + row gathers, slot leaf
pileups + polymorphic mask + top-k columns + dense features, DP-means,
cluster consensus + minor haplotypes), and every output of every piece is
equal. `run(device="cpu")` at a small size gives every piece a time on the
host clock and sums them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_assemble import one_thread

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.pipeline import cluster as jcluster
from rambl_tpu.pipeline import consensus as jcons
from rambl_tpu.pipeline import pileup as jpileup
from rambl_tpu_torch.scripts import profile_cluster

__all__ = ["one_thread"]      # the fixture shared with that module

SHAPE = dict(n_nodes=3000, ref_len=256, L=32, n_slots=256, seed=1)
FIELDS = dict(max_bin_reads=32)


@functools.partial(jax.jit, static_argnames=("cfg", "ref_len"))
def _jax_pieces(bins, query, ref_col, leaves, anc, dep, counts, span,
                node2slot, cfg, ref_len):
    """The reference script's pieces, composed."""
    n_nodes = anc.shape[0]
    share = cfg.bin_share_depth
    order, ns, ne = jcluster.bin_sort(bins, n_nodes)
    midx, mvalid = jcluster.member_table_ranges(
        order, ns, ne, leaves, anc, dep, cfg.max_bin_reads, share)
    qm, rcm = query[midx], ref_col[midx].astype(jnp.int32)
    lc, lsp = jpileup.leaf_pileup_slots(counts, span, node2slot, leaves, anc,
                                        dep, share)
    pm = jpileup.polymorphic_mask(lc, cfg.min_coverage,
                                  cfg.poly_min_minor_count,
                                  cfg.poly_minor_frac_num,
                                  cfg.poly_minor_frac_den, ref_len)
    cols = jnp.arange(ref_len, dtype=jnp.int32)
    key = jnp.where(pm, cols[None, :], jnp.int32(1 << 30))
    pol_cols = -jax.lax.top_k(-key, cfg.max_poly_cols)[0]
    pol_valid = pol_cols < (1 << 30)
    pol_cols = jnp.where(pol_valid, pol_cols, 0)
    feat = jcluster.leaf_features_dense(qm, rcm, mvalid, pol_cols, pol_valid,
                                        ref_len)
    can_seed = (bins[midx] == leaves[:, None]) & mvalid
    dp = jcluster.dp_means_leaves(feat, can_seed, cfg)
    cons = jcons.cluster_consensus_leaves(qm, rcm, mvalid, dp.assign, pm, lc,
                                          lsp, cfg)
    ls = node2slot[leaves]
    excl = jnp.where((ls >= 0)[:, None, None],
                     counts[jnp.clip(ls, 0, counts.shape[0] - 1)].reshape(
                         -1, ref_len, 4), 0)
    mh = jcons.minor_haplotype_leaves(excl, lc, lsp, cfg)
    return {"bin_sort": (order, ns, ne),
            "member_gather": (qm, rcm, midx, mvalid),
            "pileup_feat": (lc, lsp, pm, feat),
            "dp_means": tuple(dp),
            "consensus": (*cons, *mh)}


@pytest.fixture(scope="module")
def both():
    inputs = profile_cluster.make_inputs(5000, 8, **SHAPE)
    cfg = dataclasses.replace(profile_cluster.config(), **FIELDS)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg) if f.name != "scoring"})
    got = profile_cluster.pieces(inputs, cfg, "cpu")
    x = {f.name: jnp.asarray(getattr(inputs, f.name))
         for f in dataclasses.fields(inputs)}
    ref = _jax_pieces(x["bins"], x["query"], x["ref_col"], x["leaves"],
                      x["anc_path"], x["depth"], x["counts"], x["span"],
                      x["node2slot"], cfg=jcfg, ref_len=inputs.ref_len)
    return inputs, got, ref


def test_inputs_have_the_reference_shapes(both):
    inputs, got, _ = both
    assert inputs.query.dtype == np.int8 and inputs.query.shape == (5000, 32)
    assert inputs.ref_col.dtype == np.int16
    assert inputs.counts.shape == (256, 256 * 4)
    assert inputs.span.shape == (256, 257)
    # reads spread over 17 x 8 leaves in the upper half of the node ids
    assert np.unique(inputs.bins).size == 17 * 8
    assert (inputs.bins >= SHAPE["n_nodes"] // 2).all()
    assert (inputs.depth == inputs.anc_path.shape[1] - 1).all()
    mvalid = got[1].out[3].numpy()
    assert mvalid.all(axis=1).any()              # some leaves at the cap


@pytest.mark.parametrize("name", profile_cluster.PIECES)
def test_piece_matches_jax(both, name):
    _, got, ref = both
    assert [p.name for p in got] == list(profile_cluster.PIECES)
    piece = got[profile_cluster.PIECES.index(name)]
    outs = piece.out
    if name == "consensus":
        outs = (*outs[0], *outs[1])
    assert len(outs) == len(ref[name])
    for j, (r, g) in enumerate(zip(ref[name], outs)):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype, (name, j, r.dtype, g.dtype)
        np.testing.assert_array_equal(r, g, err_msg=f"{name} output {j}")
    rerun = piece.fn(*piece.args)                # a piece reruns alike
    if name == "consensus":
        rerun = (*rerun[0], *rerun[1])
    for a, b in zip(outs, rerun):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pieces_see_real_work(both):
    """Polymorphic columns exist, members cover them, consensus emits (the
    random content spawns no second cluster: DP-means still runs its
    fixed dp_max_iters for every leaf)."""
    _, got, _ = both
    _, _, pm, feat = got[2].out
    assert pm.any(dim=1).all() and (feat >= 0).any()
    assert got[4].out[0].emit.any()


def test_run_on_cpu_times_every_piece():
    lines = []
    res = profile_cluster.run(400, 2, device="cpu", trials=1,
                              out=lines.append)
    assert list(res["pieces"]) == list(profile_cluster.PIECES)
    assert all(r["ms"] > 0 and r["busy_share"] is None
               for r in res["pieces"].values())
    assert res["sum_ms"] == pytest.approx(
        sum(r["ms"] for r in res["pieces"].values()))
    assert res["card"] == "cpu, host clock" and "sort_cols" in res["absent"]
    assert res["shapes"]["M"] == 4096 and res["shapes"]["NL"] == 2
    assert "sum of the pieces" in lines[-1]


def test_kernel_records_count_launches_and_kernels():
    """`utils.timing.kernel_records` (which `profiled` uses to rerun a run
    whose device records were lost) counts the host's launch calls and the
    device's kernels, leaving the device's copies and sets out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from rambl_tpu_torch.utils.timing import kernel_records

    def ev(device_type, name):
        return SimpleNamespace(device_type=device_type, name=name)

    host = [ev(DeviceType.CPU, n) for n in (
        "aten::index_add_", "cudaLaunchKernel", "cudaLaunchKernel",
        "cuLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")]
    card = [ev(DeviceType.CUDA, n) for n in (
        "void at::native::indexFuncLargeIndex<int>", "sw_score_kernel",
        "Memcpy HtoD (Pinned -> Device)", "Memset (Device)")]
    whole = SimpleNamespace(events=lambda: host + card + card[:1])
    lost = SimpleNamespace(events=lambda: host + card)
    assert kernel_records(whole) == (3, 3)
    assert kernel_records(lost) == (3, 2)
