"""The port's round 0 == the JAX reference, bit for bit.

`rambl_tpu_torch.pipeline.assemble.cluster_round0_core` against
`rambl_tpu.pipeline.assemble.cluster_round0_core` on the port's stream
outputs for the shared `small_ds` community (spawn and light paths, dense
and slot-compacted accumulators), and `assemble_round(device="cpu")`
against `assemble_round_jax`, gene by gene (sequence, n_reads, leaf,
cluster, taxon, offset), on the dataset of tests/test_assembly_parity.py
(dense, forced slot mode, leaf blocks), on the zero-exclusive collapse
dataset of tests/test_scale_paths.py and with a non-identity
orig_taxon_of_node. Every output is an integer: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.data.simulate import simulate_dataset
from rambl_tpu.index.taxonomy import build_taxonomy_tables
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu.pipeline import pileup as jpileup
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.pipeline import pileup as tpileup

_core = jax.jit(jassemble.cluster_round0_core,
                static_argnames=("cfg", "spawn"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for torch: the suite's other workers hold the
    cores, and an oversubscribed torch runs these small CPU paths many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _genes(genes):
    return [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon, g.offset,
             g.round_born) for g in genes]


# ---------------------------------------------------------------------------
# cluster_round0_core on stream outputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream(small_ds, small_index, small_tax):
    """The port's stream over small_ds on CPU, as host arrays."""
    cfg = TConfig(batch_size=256)
    rec, counts, span, rc = tassemble.stream_align(
        small_ds.reads, small_ds.read_lens, small_index, small_ds.ref_seqs,
        small_ds.ref_lens, small_tax, cfg, device="cpu")
    rec = {k: v.numpy() for k, v in rec.items()}
    return rec, counts.numpy(), span.numpy(), rc.numpy()


@pytest.fixture(scope="module")
def slots(stream, small_tax, small_ds):
    """A slot map for the nodes holding reads, less one chain node (the
    root), and both packages' slot accumulators over it."""
    rec, _, _, rc = stream
    ids = np.nonzero(rc > 0)[0]
    ids = ids[ids != 0].astype(np.int32)
    node2slot = np.full(small_tax.n_nodes, -1, np.int32)
    node2slot[ids] = np.arange(ids.size, dtype=np.int32)
    n_slots = max(64, -(-ids.size // 64) * 64)
    ref_len = small_ds.ref_seqs.shape[1]
    jc, js = jpileup.node_slot_pileup(
        jnp.asarray(rec["query"]), jnp.asarray(rec["ref_col"]),
        jnp.asarray(rec["bins"]), jnp.asarray(node2slot), n_slots, ref_len)
    tc, ts = tpileup.node_slot_pileup(
        _t(rec["query"]), _t(rec["ref_col"]), _t(rec["bins"]),
        _t(node2slot), n_slots, ref_len)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    return node2slot, tc.numpy(), ts.numpy()


@pytest.mark.parametrize("spawn", [True, False])
@pytest.mark.parametrize("slot", [False, True], ids=["dense", "slot"])
def test_cluster_round0_core(stream, slots, small_tax, spawn, slot):
    rec, counts, span, rc = stream
    node2slot = None
    if slot:
        node2slot, counts, span = slots
    leaves = np.unique(small_tax.ref_taxon).astype(np.int32)
    fields = dict(batch_size=256)
    args = (rec["query"], rec["ref_col"], rec["bins"], counts, span, rc,
            leaves, small_tax.anc_path, small_tax.depth)
    ref = _core(*map(jnp.asarray, args), JConfig(**fields),
                None if node2slot is None else jnp.asarray(node2slot),
                spawn=spawn)
    got = tassemble.cluster_round0_core(
        *map(_t, args), TConfig(**fields),
        None if node2slot is None else _t(node2slot), spawn=spawn)
    names = ("cons", "kact", "n_mem", "mh")
    for name, r, g in zip(names, ref, got):
        for a, b in zip(jax.tree_util.tree_leaves(r),
                        g if isinstance(g, tuple) else (g,)):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, name
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    if spawn:
        assert int(got[1].max()) >= 2, "no leaf spawned a second cluster"



# ---------------------------------------------------------------------------
# assemble_round end to end (the other modes: test_torch_round_modes.py)
# ---------------------------------------------------------------------------

def _both_rounds(ds, tax, fields, **kw):
    """Round 0 of both packages on the same inputs; each gets an aux_out
    dict, returned beside its genes and stats."""
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax)
    aux_ref, aux_got = {}, {}
    ref = jassemble.assemble_round_jax(*args, JConfig(**fields), 0,
                                       aux_out=aux_ref, **kw)
    got = tassemble.assemble_round(*args, TConfig(**fields), 0,
                                   aux_out=aux_got, **kw, device="cpu")
    return (*ref, aux_ref), (*got, aux_got)


def _check_aux(aux_ref, aux_got):
    if "node_counts" in aux_ref:
        assert list(aux_got) == ["node_counts"]
        np.testing.assert_array_equal(np.asarray(aux_ref["node_counts"]),
                                      aux_got["node_counts"].numpy())
    else:
        assert list(aux_got) == ["slot_counts"] == list(aux_ref)
        for a, b in zip(aux_ref["slot_counts"], aux_got["slot_counts"]):
            np.testing.assert_array_equal(
                np.asarray(a), b.numpy() if torch.is_tensor(b) else b)


def _check_round(ref, got):
    g_ref, s_ref, aux_ref = ref
    g_got, s_got, aux_got = got
    assert len(g_ref) > 3
    assert _genes(g_got) == _genes(g_ref)
    for a, b in zip(g_ref, g_got):
        assert b.seq.dtype == a.seq.dtype
    assert s_got == s_ref
    _check_aux(aux_ref, aux_got)


@pytest.fixture(scope="module")
def tiny():
    """The dataset of tests/test_assembly_parity.py."""
    ds = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    return ds, tax


BASE = dict(max_assembly_iters=2, batch_size=128)


def test_assemble_round_dense(tiny):
    ds, tax = tiny
    _check_round(*_both_rounds(ds, tax, BASE))


def test_assemble_round_orig_taxon(tiny):
    ds, tax = tiny
    rng = np.random.default_rng(5)
    orig = rng.permutation(tax.n_nodes).astype(np.int32) + 1000
    ref, got = _both_rounds(ds, tax, BASE, orig_taxon_of_node=orig)
    _check_round(ref, got)
    assert all(g.taxon == orig[g.leaf] for g in got[0])
