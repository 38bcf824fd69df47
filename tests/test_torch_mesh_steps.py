"""The port's slot-pileup, leaf-sharded cluster and align + pileup steps ==
the JAX package's shard_map steps, bit for bit, on CPU ranks.

`rambl_tpu_torch.parallel.steps.{make_slot_pileup_step, make_cluster_step}`
on 3 CPU ranks against `rambl_tpu.parallel.steps`' on the 8 fake CPU
devices that tests/conftest.py forces (tests/test_cluster_step.py drives
the reference's cluster step the same way). Both consume one retention:
the port's mesh stream over the shared `small_ds` community, whose rank
shards joined are the reference's RETAIN3 / RETAIN2 arrays. Its 5 leaves
split 1 / 2 / 2 over the 3 ranks (the reference pads them to a multiple of
its 8 devices); with 2 leaves a rank gets none. The port gathers each
member row from its owner rank (`gather_members`); the reference's masked
local gather + psum gives the same rows. `make_align_pileup_step` on 4
CPU ranks (replicated index, ring-sharded index, position-sharded merge)
against the reference's replicated step on one batch of `small_ds` (the
reference's modes give the same global arrays: tests/test_distributed.py).
Everything is integer: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from test_torch_assemble import one_thread

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.ops.seed import SeedTable as JSeedTable
from rambl_tpu.parallel import mesh as jmesh
from rambl_tpu.parallel import steps as jsteps
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.ops.seed import SeedTable
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.parallel import ring as tring
from rambl_tpu_torch.parallel import steps as tsteps
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.pipeline.cluster import bin_sort, member_table_ranges

__all__ = ["one_thread"]      # the fixture shared with that module

N = 3                         # the port's ranks
FIELDS = dict(batch_size=24 * N, sw_rows=104)
N_READS = 300


@pytest.fixture(scope="module")
def stream(small_ds, small_index, small_tax):
    """The port's mesh stream over small_ds on 3 CPU ranks."""
    mesh = tmesh.data_mesh(devices=["cpu"] * N)
    out = tassemble.stream_align(
        small_ds.reads[:N_READS], small_ds.read_lens[:N_READS], small_index,
        small_ds.ref_seqs, small_ds.ref_lens, small_tax, TConfig(**FIELDS),
        mesh=mesh)
    return mesh, out


@pytest.fixture(scope="module")
def jax_side(stream):
    """The same retention as the reference's sharded arrays on 8 devices."""
    mesh, (rec, counts, span, rc) = stream
    jm = jmesh.data_mesh(8)

    def sharded(per_rank, spec):
        return jax.device_put(jnp.asarray(torch.cat(per_rank, 1).numpy()),
                              NamedSharding(jm, spec))

    return jm, dict(q=sharded(rec["query"], jsteps.RETAIN3),
                    rc=sharded(rec["ref_col"], jsteps.RETAIN3),
                    bins_sh=sharded(rec["bins_sh"], jsteps.RETAIN2))


@pytest.fixture(scope="module")
def slots(stream, small_tax, small_ds):
    """Slots for the nodes holding reads, and the port's merged slot
    accumulators over them."""
    mesh, (rec, _, _, rc) = stream
    rc = rc[0].numpy()
    ids = np.nonzero(rc > 0)[0].astype(np.int32)
    node2slot = np.full(small_tax.n_nodes, -1, np.int32)
    node2slot[ids] = np.arange(ids.size, dtype=np.int32)
    n_slots = max(64, -(-ids.size // 64) * 64)
    n2s = tmesh.put_replicated(node2slot, mesh)
    step = tsteps.make_slot_pileup_step(mesh, n_slots,
                                        small_ds.ref_seqs.shape[1])
    counts, span = step(rec["query"], rec["ref_col"], rec["bins_sh"], n2s)
    return node2slot, n_slots, n2s, counts, span


def test_slot_pileup_step(stream, jax_side, slots, small_ds):
    mesh, (rec, _, _, _) = stream
    jm, j = jax_side
    node2slot, n_slots, _, counts, span = slots
    ref = jsteps.make_slot_pileup_step(jm, n_slots, small_ds.ref_seqs.shape[1])(
        j["q"], j["rc"], j["bins_sh"], jmesh.put_replicated(node2slot, jm))
    for r, got in zip(ref, (counts, span)):
        assert len(got) == N
        for g in got:                                   # replicated
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert int(counts[0].sum()) > 0


@pytest.fixture(scope="module")
def jax_clusters(stream, jax_side, slots, small_tax):
    """The reference's cluster step on its 8 devices, dense (spawn and
    light) and slot-compacted, on the 5 leaves padded with leaf 0 to 8."""
    mesh, (rec, counts, span, rc) = stream
    jm, j = jax_side
    node2slot, _, _, counts_s, span_s = slots
    leaves = np.unique(small_tax.ref_taxon).astype(np.int32)
    padded = np.concatenate([leaves, np.zeros(8 - leaves.size, np.int32)])
    bins_j, rc_j, *tail = [jmesh.put_replicated(np.asarray(x), jm) for x in (
        rec["bins"][0].numpy(), rc[0].numpy(), padded, small_tax.anc_path,
        small_tax.depth)]
    out = {}
    for case, (spawn, slot) in CASES.items():
        c, s = ((counts_s[0], span_s[0]) if slot else (counts[0], span[0]))
        args = [j["q"], j["rc"], bins_j,
                jmesh.put_replicated(c.numpy(), jm),
                jmesh.put_replicated(s.numpy(), jm), rc_j, *tail]
        if slot:
            args.append(jmesh.put_replicated(node2slot, jm))
        step = jsteps.make_cluster_step(jm, JConfig(**FIELDS), slots=slot,
                                        spawn=spawn)
        res = step(*args)
        out[case] = [np.asarray(x)[:leaves.size]
                     for x in jax.tree_util.tree_leaves(res)]
    return leaves, out


CASES = {"spawn": (True, False), "light": (False, False),
         "slot": (True, True)}


@pytest.mark.parametrize("n_leaves", [5, 2], ids=["uneven", "idle_rank"])
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_step(stream, slots, jax_clusters, small_tax, case,
                      n_leaves):
    mesh, (rec, counts, span, rc) = stream
    leaves, ref = jax_clusters
    spawn, slot = CASES[case]
    n2s = None
    if slot:
        _, _, n2s, counts, span = slots
    anc, dep = (tmesh.put_replicated(x, mesh)
                for x in (small_tax.anc_path, small_tax.depth))
    step = tsteps.make_cluster_step(mesh, TConfig(**FIELDS), slots=slot,
                                    spawn=spawn)
    outs = step(rec["query"], rec["ref_col"], rec["bins"], counts, span, rc,
                leaves[:n_leaves], anc, dep, n2s)
    sizes = [hi - lo for lo, hi in tsteps.leaf_slices(n_leaves, N)]
    assert sizes == ([1, 2, 2] if n_leaves == 5 else [0, 1, 1])
    assert [o is None for o in outs] == [s == 0 for s in sizes]
    got = [torch.cat([t for o in outs if o is not None
                      for t in [jax.tree_util.tree_leaves(o)[i]]])
           for i in range(len(ref[case]))]
    for i, (r, g) in enumerate(zip(ref[case], got)):
        assert r.dtype == g.numpy().dtype, i
        np.testing.assert_array_equal(r[:n_leaves], g.numpy(), err_msg=str(i))
    if spawn and not slot and n_leaves == 5:
        assert int(got[3].max()) >= 2, "no leaf spawned a second cluster"


def test_member_gather_is_the_masked_psum(stream, small_tax):
    """Each member row from its owner rank == the reference's form: every
    rank gathers at clamped local rows, zeroes what it does not own, and
    the psum adds the one owner's row to zeros."""
    mesh, (rec, _, _, _) = stream
    bins = rec["bins"][0]
    leaves = torch.from_numpy(np.unique(small_tax.ref_taxon).astype(np.int32))
    order, nstart, nend = bin_sort(bins, small_tax.n_nodes)
    midx, mvalid = member_table_ranges(
        order, nstart, nend, leaves, torch.from_numpy(small_tax.anc_path),
        torch.from_numpy(small_tax.depth), bins.shape[0],
        TConfig().bin_share_depth)
    nb, bl, L = rec["query"][0].shape
    bs = bl * N
    bi, row = midx.long() // bs, midx.long() % bs
    owners = row // bl
    assert set(owners[mvalid].unique().tolist()) == set(range(N))
    qs, rcs = [], []
    for o in range(N):
        lo = o * bl
        own = ((row >= lo) & (row < lo + bl))[..., None]
        rl = torch.clamp(row - lo, 0, bl - 1)
        qs.append(torch.where(own, rec["query"][o][bi, rl], 0))
        rcs.append(torch.where(own, rec["ref_col"][o][bi, rl], 0))
    want_q = tmesh.psum(qs, mesh)
    want_rc = tmesh.psum(rcs, mesh)
    for r in range(N):
        qm, rcm = tsteps.gather_members(mesh, rec["query"], rec["ref_col"],
                                        midx, r)
        assert qm.dtype == torch.int8 and rcm.dtype == torch.int32
        assert torch.equal(qm, want_q[r])
        assert torch.equal(rcm, want_rc[r].to(torch.int32))


# ---- make_align_pileup_step ------------------------------------------------

B = 128                       # one batch: 16 rows a device, 32 a port rank
ALIGN_CASES = {"replicated": {}, "ring": dict(ring=True),
               "positions": dict(shard_positions=True)}


@pytest.fixture(scope="module")
def jax_align_pileup(small_ds, small_index, small_tax):
    ds, tax = small_ds, small_tax
    col_map = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    jm = jmesh.data_mesh(8)
    step = jsteps.make_align_pileup_step(
        jm, JConfig(**FIELDS), small_index.n_bits, tax.n_nodes,
        ds.ref_seqs.shape[1])
    table = JSeedTable.from_index(small_index)
    args = [jmesh.put_replicated(np.asarray(x), jm) for x in (
        table.bucket_start, table.entries, ds.ref_seqs, tax.ref_taxon,
        tax.anc_path, tax.depth, col_map)]
    out = step(jmesh.put_sharded(ds.reads[:B], jm),
               jmesh.put_sharded(ds.read_lens[:B], jm), *args)
    return col_map, [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_pileup_step(small_ds, small_index, small_tax,
                           jax_align_pileup, case):
    ds, tax = small_ds, small_tax
    col_map, ref = jax_align_pileup
    n, ref_len = 4, ds.ref_seqs.shape[1]
    kw = ALIGN_CASES[case]
    mesh = tmesh.data_mesh(devices=["cpu"] * n)
    table = (tring.RingShards(tring.build_ring_shards(small_index, n), mesh)
             if kw.get("ring") else [SeedTable.from_index(small_index, "cpu")]
             * n)
    st = [tassemble.StreamTables.from_host(ds.ref_seqs, tax, col_map,
                                           "cpu")] * n
    step = tsteps.make_align_pileup_step(mesh, TConfig(**FIELDS),
                                         small_index.n_bits, tax.n_nodes,
                                         ref_len, **kw)
    got = step(tmesh.put_sharded(ds.reads[:B], mesh),
               tmesh.put_sharded(ds.read_lens[:B], mesh), table, st)
    q, proj, bins, score, counts, span, rcount = got
    for name, r, g in zip(("query", "proj", "bins", "score"), ref, got):
        assert [tuple(x.shape)[:1] for x in g] == [(B // n,)] * n, name
        g = torch.cat(g).numpy()
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    for x in rcount:                                     # replicated
        np.testing.assert_array_equal(ref[6], x.numpy())
    if kw.get("shard_positions"):
        assert [c.shape[1] for c in counts] == [ref_len * 4 // n] * n
        assert [s.shape[1] for s in span] == [(ref_len + n) // n] * n
        np.testing.assert_array_equal(ref[4], torch.cat(counts, 1).numpy())
        joined = torch.cat(span, 1).numpy()
        np.testing.assert_array_equal(ref[5], joined[:, :ref_len + 1])
        assert not joined[:, ref_len + 1:].any()
    else:
        for c, s_ in zip(counts, span):
            np.testing.assert_array_equal(ref[4], c.numpy())
            np.testing.assert_array_equal(ref[5], s_.numpy())
    assert int(ref[4].sum()) > 0 and int(rcount[0].sum()) > 0
