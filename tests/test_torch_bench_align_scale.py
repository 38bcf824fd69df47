"""The port's `scripts/bench_align_scale.py` prefixes against the JAX
package, bit for bit, on CPU tensors.

On two batches of 64 reads of a leaf-per-reference community: prefix A
(`revcomp` + `seed_candidates` on both strands) equals
`seed_candidates_jax`'s candidate refs, B (+ `gather_windows`) equals
`gather_windows_jax`, C (`align_batch`) equals the JAX `align_batch`'s
score, ref and ref_col, and FULL (`_align_bin_batch`) equals the JAX
`_align_bin_batch`; the JAX side builds its entries its own way (the
128-lane packed rows). D's stream loop retains, for the same batches, the
rows and read counts `stream_align` gives, in buffers larger than the
batches (the rest stays zero). `run(device="cpu")` times every prefix on
the host clock.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assemble import one_thread

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.ops import seed as jseed
from rambl_tpu.pipeline import align as jalign
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import bench_align_scale as bas

__all__ = ["one_thread"]      # the fixture shared with that module

B, NB = 64, 3


@pytest.fixture(scope="module")
def data():
    ds = simulate_dataset(n_species=6, refs_per_species=2, n_reads=300,
                          seed=4, leaf_per_ref=True, n_present=8)
    cfg = bas.config(B)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    table, st, tax = bas.tables_of(ds, index, cfg, "cpu")
    return ds, index, cfg, table, st, tax


def _jcfg(cfg):
    return JConfig(batch_size=cfg.batch_size, max_genes=cfg.max_genes,
                   max_clusters_per_bin=cfg.max_clusters_per_bin,
                   max_assembly_iters=cfg.max_assembly_iters,
                   bin_share_depth=cfg.bin_share_depth,
                   cluster_leaf_block=cfg.cluster_leaf_block,
                   sw_rows=cfg.sw_rows)


@pytest.fixture(scope="module")
def both(data):
    ds, index, cfg, table, st, tax = data
    jcfg = _jcfg(cfg)
    tbl = jseed.SeedTable.from_index(index)
    refs = jnp.asarray(ds.ref_seqs)
    r, ln = jnp.asarray(ds.reads[:B]), jnp.asarray(ds.read_lens[:B])

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def jax_prefixes(r, ln, bs, ent, refs, rt, anc, dep, cm, cfg):
        t = jseed.SeedTable(bs, ent, index.n_bits)
        rc = jseed.revcomp_jax(r, ln)
        cf = jseed.seed_candidates_jax(r, ln, t, cfg)
        cr = jseed.seed_candidates_jax(rc, ln, t, cfg)
        cref = jnp.concatenate([cf["cand_ref"], cr["cand_ref"]], axis=1)
        cws = jnp.concatenate([cf["cand_wstart"], cr["cand_wstart"]],
                              axis=1)
        res = jalign.align_batch(r, ln, t, refs, cfg)
        return {"A": (cf["cand_ref"], cr["cand_ref"]),
                "B": (jseed.gather_windows_jax(refs, cref, cws,
                                               cfg.window_len, cfg),),
                "C": (res.score, res.ref, res.ref_col),
                "FULL": jassemble._align_bin_batch(
                    r, ln, bs, ent, refs, rt, anc, dep, cm, cfg=cfg,
                    n_bits=index.n_bits)}

    ref = jax_prefixes(r, ln, tbl.bucket_start, tbl.entries, refs,
                       *(jnp.asarray(x.numpy()) for x in (
                           st.ref_taxon, st.anc_path, st.depth, st.col_map)),
                       cfg=jcfg)
    fns = bas.prefixes(table, st, cfg)
    tr, tl = torch.from_numpy(ds.reads[:B]), torch.from_numpy(ds.read_lens[:B])
    got = {name: fn(tr, tl) for name, fn in fns.items()}
    return ref, got


@pytest.mark.parametrize("name", bas.PREFIXES)
def test_prefix_matches_jax(both, name):
    ref, got = both
    assert len(got[name]) == len(ref[name])
    for j, (r, g) in enumerate(zip(ref[name], got[name])):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype, (name, j, r.dtype, g.dtype)
        np.testing.assert_array_equal(r, g, err_msg=f"{name} output {j}")
    if name == "C":
        assert (got["C"][1] >= 0).float().mean() > 0.8   # aligned


def test_stream_loop_retains_what_stream_align_does(data):
    ds, index, cfg, table, st, tax = data
    rows = NB * B + 40
    bufs, rc = bas.stream_loop(ds.reads, ds.read_lens, table, st, cfg,
                               tax.n_nodes, rows, NB, torch.device("cpu"))
    n = NB * B
    merged, _, _, want_rc = tassemble.stream_align(
        ds.reads[:n], ds.read_lens[:n], index, ds.ref_seqs, ds.ref_lens, tax,
        cfg, col_maps=st.col_map.numpy(), device="cpu")
    for k, v in merged.items():
        assert bufs[k].dtype == v.dtype, k
        assert torch.equal(bufs[k][:n], v), k
        assert not bufs[k][n:].any(), k
    assert torch.equal(rc, want_rc)
    with pytest.raises(ValueError, match="retention rows"):
        bas.stream_loop(ds.reads, ds.read_lens, table, st, cfg, tax.n_nodes,
                        n - 1, NB, torch.device("cpu"))


def test_run_on_cpu(data):
    ds, index = data[:2]
    lines = []
    res = bas.run(B, None, 2, ds=ds, index=index, device="cpu", reps=2,
                  out=lines.append)
    for name in bas.PREFIXES:
        assert res[name]["ms"] > 0
        assert res[name]["device_ms"] is res[name]["busy_share"] is None
    assert res["D"]["ms"] > 0
    assert res["D"]["device_ms"] is res["D"]["idle_share"] is None
    assert res["D"]["spread"] == 0.0        # one loop on the host clock
    assert (res["rows"], res["nb"], res["entries"]) == (
        ds.reads.shape[0], 2, index.n_entries)
    assert lines[-1].startswith("D") and "cpu, host clock" in lines[-1]
