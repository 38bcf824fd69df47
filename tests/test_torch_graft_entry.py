"""The port's entry hooks (`rambl_tpu_torch.graft_entry`) against the JAX
package, bit for bit, on CPU tensors.

`entry(device="cpu")`'s align step on the toy problem equals the JAX
`align_batch` on the reference hook's own toy problem (`__graft_entry__.
_toy_problem`), field for field. `dryrun_multichip(n, device="cpu")` at
n = 2 and 4: each mode's step outputs (replicated and ring-sharded index)
equal the JAX `make_align_pileup_step` on the first n of the 8 CPU devices
that tests/conftest.py forces (the JAX `dryrun_multichip` returns nothing,
so its steps are rebuilt here), and a tampered mode makes the hook raise.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assemble import one_thread

from rambl_tpu.ops.seed import SeedTable as JSeedTable
from rambl_tpu.parallel import mesh as jmesh
from rambl_tpu.parallel import ring as jring
from rambl_tpu.parallel import steps as jsteps
from rambl_tpu.pipeline import align as jalign
from rambl_tpu_torch import graft_entry
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["one_thread"]      # the fixture shared with that module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_hooks():
    spec = importlib.util.spec_from_file_location(
        "reference_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax_align_batch():
    fn, (reads, lens) = graft_entry.entry(device="cpu")
    got = fn(reads, lens)
    cfg, ds, index, _ = _reference_hooks()._toy_problem()
    B = cfg.batch_size
    ref = jalign.align_batch(jnp.asarray(ds.reads[:B]),
                             jnp.asarray(ds.read_lens[:B]),
                             JSeedTable.from_index(index),
                             jnp.asarray(ds.ref_seqs), cfg)
    assert reads.device.type == "cpu" and tuple(reads.shape) == (
        B, ds.reads.shape[1])
    assert got._fields == ref._fields
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    assert int((got.ref >= 0).sum()) > B // 2


def _jax_steps(n):
    """The reference's two distributed steps on n CPU devices, on the toy
    problem of 16 n reads, with the port's column maps."""
    jcfg, ds, index, tax = _reference_hooks()._toy_problem(n_reads=16 * n)
    jm = jmesh.data_mesh(n)
    B = 16 * n
    reads = jmesh.put_sharded(ds.reads[:B], jm)
    lens = jmesh.put_sharded(ds.read_lens[:B], jm)
    cmap = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    repl = [jmesh.put_replicated(np.asarray(x), jm) for x in
            (ds.ref_seqs, tax.ref_taxon, tax.anc_path, tax.depth, cmap)]
    ref_len = ds.ref_seqs.shape[1]
    table = JSeedTable.from_index(index)
    step = jsteps.make_align_pileup_step(jm, jcfg, index.n_bits, tax.n_nodes,
                                         ref_len)
    out = step(reads, lens, *[jmesh.put_replicated(np.asarray(x), jm)
                              for x in (table.bucket_start, table.entries)],
               *repl)
    shards = jring.build_ring_shards(index, n)
    ring_step = jsteps.make_align_pileup_step(
        jm, jcfg, index.n_bits, tax.n_nodes, ref_len, ring=True)
    out2 = ring_step(reads, lens, *[jmesh.put_sharded(shards[k], jm)
                                    for k in ("bucket_start", "entries")],
                     *repl)
    return {"replicated": [np.asarray(x) for x in out],
            "ring": [np.asarray(x) for x in out2]}


def _spy(monkeypatch, tamper=None):
    """Record the port hook's step outputs by mode; `tamper` changes the
    ring mode's score on rank 0."""
    seen = {}
    real = graft_entry.make_align_pileup_step

    def make(*args, ring=False, **kw):
        step = real(*args, ring=ring, **kw)

        def recorded(*a):
            out = step(*a)
            if ring and tamper == "step":
                out[3][0] = out[3][0] + 1
            seen["ring" if ring else "replicated"] = out
            return out

        return recorded

    monkeypatch.setattr(graft_entry, "make_align_pileup_step", make)
    return seen


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_steps_match_jax(monkeypatch, n):
    seen = _spy(monkeypatch)
    graft_entry.dryrun_multichip(n, device="cpu")
    ref = _jax_steps(n)
    names = ("query", "proj", "bins", "score", "counts", "span_diff",
             "read_count")
    for mode in ("replicated", "ring"):
        got = seen[mode]
        for j, name in enumerate(names):
            ranks = got[j]
            assert len(ranks) == n and all(x.device.type == "cpu"
                                           for x in ranks)
            if j < 4:                  # each rank's rows, in rank order
                g = torch.cat(ranks).numpy()
                assert g.dtype == ref[mode][j].dtype, (mode, name)
                np.testing.assert_array_equal(ref[mode][j], g,
                                              err_msg=f"{mode} {name}")
            else:                      # merged, on every rank
                for x in ranks:
                    np.testing.assert_array_equal(
                        ref[mode][j], x.numpy(), err_msg=f"{mode} {name}")
    assert int((torch.cat(seen["ring"][2]) >= 0).sum()) > 0


@pytest.mark.parametrize("tamper", ["step", "assembly"])
def test_tampered_mode_raises(monkeypatch, tamper):
    _spy(monkeypatch, tamper)
    if tamper == "assembly":
        real = tassemble.assemble

        def assemble(*args, **kw):
            res = real(*args, **kw)
            if args[5].shard_index:     # the ring-sharded run loses a gene
                res.genes.pop()
            return res

        monkeypatch.setattr(graft_entry, "assemble", assemble)
    with pytest.raises(AssertionError, match="ring"):
        graft_entry.dryrun_multichip(2, device="cpu")
