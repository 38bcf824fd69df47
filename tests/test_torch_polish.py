"""The port's polish pass == the JAX reference, bit for bit.

- `leaf_counts_dict` on its three evidence paths: retained dense counts
  (a torch tensor, flat rows), retained slot counts with their node2slot
  map (zeros for a taxon without a slot), and the recompute that
  re-streams the reads (dense and slot configs), against the reference's
  `leaf_counts_dict` and the oracle's `leaf_exclusive_counts`;
- `polish` against `polish_jax` on one panel, from retained counts and
  by recompute;
- the copy of `colmap._nw_map_batch` on both tiers (native C++ and numpy)
  against the reference's and the sequential `_nw_map`;
- `oracle.polish.apply_polish` on the synthetic votes of
  tests/test_polish.py, one case each.

No tolerance: every output is an integer.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_assemble import gene_fields, one_thread, tiny

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.index import colmap as jcolmap
from rambl_tpu.oracle import pipeline as jopipe
from rambl_tpu.oracle import polish as jpolish
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.index import colmap as tcolmap
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.oracle import pipeline as topipe
from rambl_tpu_torch.oracle import polish as tpolish
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.pipeline.pileup import node_slot_pileup

__all__ = ["one_thread", "tiny"]      # fixtures shared with that module

N_READS = 256
BASE = dict(batch_size=128)


def _same_counts(ref: dict, got: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.fixture(scope="module")
def evid(tiny):
    """The first reads of the parity dataset, the port's dense stream
    accumulators over them, and slot accumulators over the leaves holding
    reads less one."""
    ds, tax = tiny
    reads, lens = ds.reads[:N_READS], ds.read_lens[:N_READS]
    cfg = TConfig(**BASE)
    rec, counts, _, rc = tassemble.stream_align(
        reads, lens, build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k),
        ds.ref_seqs, ds.ref_lens, tax, cfg, device="cpu")
    leaves = np.unique(tax.ref_taxon)
    ids = leaves[rc.numpy()[leaves] > 0][1:].astype(np.int32)
    node2slot = np.full(tax.n_nodes, -1, np.int32)
    node2slot[ids] = np.arange(ids.size, dtype=np.int32)
    slot_counts, _ = node_slot_pileup(rec["query"], rec["ref_col"],
                                      rec["bins"], torch.from_numpy(node2slot),
                                      64, ds.ref_seqs.shape[1])
    return ds, tax, reads, lens, counts, (slot_counts, node2slot)


def _args(evid):
    ds, tax, reads, lens = evid[:4]
    return reads, lens, ds.ref_seqs, ds.ref_lens, tax


def test_leaf_counts_dict_retained(evid):
    ds, tax, _, _, counts, (slot_c, node2slot) = evid
    taxa = np.unique(tax.ref_taxon)
    got = tassemble.leaf_counts_dict(*_args(evid), TConfig(**BASE), taxa,
                                     node_counts=counts, device="cpu")
    ref = jassemble.leaf_counts_dict(*_args(evid), JConfig(**BASE), taxa,
                                     node_counts=counts.numpy())
    _same_counts(ref, got)
    assert sum(int(c.sum()) for c in got.values()) > 0
    got = tassemble.leaf_counts_dict(
        *_args(evid), TConfig(**BASE), taxa, slot_counts=(slot_c, node2slot),
        device="cpu")
    ref = jassemble.leaf_counts_dict(
        *_args(evid), JConfig(**BASE), taxa,
        slot_counts=(slot_c.numpy(), node2slot))
    _same_counts(ref, got)
    assert (node2slot[taxa] < 0).any()          # a taxon without a slot ...
    assert not got[int(taxa[node2slot[taxa] < 0][0])].any()  # ... is zeros


@pytest.mark.parametrize("slot", [False, True], ids=["dense", "slot"])
def test_leaf_counts_dict_recompute(evid, slot):
    tax = evid[1]
    fields = dict(BASE, pileup_slot_nodes=1) if slot else BASE
    taxa = np.unique(tax.ref_taxon)[::-1]
    got = tassemble.leaf_counts_dict(*_args(evid), TConfig(**fields), taxa,
                                     device="cpu")
    ref = jassemble.leaf_counts_dict(*_args(evid), JConfig(**fields), taxa)
    _same_counts(ref, got)
    oracle = tpolish.leaf_exclusive_counts(*_args(evid), TConfig(**fields))
    _same_counts({k: oracle[k] for k in sorted(oracle)}, got)


def test_polish_matches_polish_jax(evid):
    ds, tax, reads, lens, counts, _ = evid
    genes, _ = topipe.assemble_round(*_args(evid), TConfig(**BASE), 0)
    jgenes = [jopipe.Gene(**dataclasses.asdict(g)) for g in genes]
    assert len(genes) > 2
    got, n = tassemble.polish(reads, lens, genes, ds.ref_seqs, ds.ref_lens,
                              tax, TConfig(**BASE), node_counts=counts,
                              device="cpu")
    ref, n_ref = jassemble.polish_jax(reads, lens, jgenes, ds.ref_seqs,
                                      ds.ref_lens, tax, JConfig(**BASE),
                                      node_counts=counts.numpy())
    assert n == n_ref > 0
    assert gene_fields(got) == gene_fields(ref)
    again, n2 = tassemble.polish(reads, lens, genes, ds.ref_seqs,
                                 ds.ref_lens, tax, TConfig(**BASE),
                                 device="cpu")
    assert n2 == n and gene_fields(again) == gene_fields(ref)
    assert tassemble.polish(reads, lens, [], ds.ref_seqs, ds.ref_lens, tax,
                            TConfig(**BASE), device="cpu") == ([], 0)


def _nw_pairs():
    """The pairs of tests/test_polish.py::test_nw_map_batch_parity."""
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(40):
        La = int(rng.integers(5, 220))
        a = rng.integers(0, 4, La).astype(np.int8)
        b = a.copy()
        for _ in range(int(rng.integers(0, 8))):
            b[rng.integers(0, b.shape[0])] = rng.integers(0, 4)
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, b.shape[0]))
            if rng.random() < 0.5:
                b = np.delete(b, p)
            else:
                b = np.insert(b, p, rng.integers(0, 4))
        pairs.append((a, b.astype(np.int8)))
    pairs.append((pairs[0][0], pairs[0][0].copy()))      # identical
    pairs.append((pairs[1][0], pairs[1][0][:3].copy()))  # tiny b
    a = rng.integers(0, 4, 2048).astype(np.int8)         # near the int16 bound
    pairs.append((a, np.delete(a, [5, 900, 1500]).astype(np.int8)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_nw_map_batch(native):
    a_list, b_list = _nw_pairs()
    kw = dict(native=native, budget_bytes=64 << 10)
    got = tcolmap._nw_map_batch(a_list, b_list, **kw)
    ref = jcolmap._nw_map_batch(a_list, b_list, **kw)
    assert len(got) == len(a_list)
    for a, b, g, r in zip(a_list, b_list, got, ref):
        assert g.dtype == r.dtype == np.int32
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, tcolmap._nw_map(a, b))
    assert tcolmap._nw_map_batch([], []) == []
    if native:
        assert tcolmap.nw_tier() == (
            "native" if jcolmap._nw_native() is not None else "numpy")


# ---------------------------------------------------------------------------
# apply_polish on the synthetic votes of tests/test_polish.py
# ---------------------------------------------------------------------------

def _gene(seq, taxon=7, offset=0):
    return dict(seq=np.asarray(seq, np.int8), n_reads=10, leaf=taxon,
                cluster=0, round_born=0, taxon=taxon, offset=offset)


def _votes(seq, depth, ref_len):
    c = np.zeros((ref_len, 4), np.int32)
    c[np.arange(len(seq)), np.asarray(seq)] = depth
    return c


def _case(name):
    """-> (genes, {taxon: counts}, {taxon: anchor}, config fields)."""
    a4 = np.asarray([0, 1, 2, 3], np.int8)
    if name == "decisive":
        c = _votes(a4, 10, 8)
        c[2] = 0
        c[2, 0] = 9
        return [_gene(a4)], {7: c}, {7: a4}, {}
    if name == "polymorphic":
        c = _votes(a4, 30, 8)
        c[2] = 0
        c[2, 0], c[2, 2] = 20, 10
        return [_gene(a4)], {7: c}, {7: a4}, {}
    if name == "thin_or_indecisive":
        c = _votes(a4, 10, 8)
        c[1] = 0
        c[1, 0] = TConfig().polish_min_depth - 1
        c[3] = 0
        c[3, 0], c[3, 1] = 5, 4
        return [_gene(a4)], {7: c}, {7: a4}, {}
    if name == "unmapped_and_foreign":
        c = np.zeros((8, 4), np.int32)
        c[0, 3] = 10
        return ([_gene([0, 1]), _gene([2, 3], taxon=9)], {7: c},
                {7: np.asarray([1], np.int8)}, {})
    if name == "offset_kept":
        c = np.zeros((8, 4), np.int32)
        c[2:6, 3] = 10
        return [_gene(a4, offset=2)], {7: c}, {7: a4}, {}
    anchor8 = np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    if name == "interior_hole":
        c = _votes(anchor8, 10, 8)
        c[6] = 0
        c[6, 0] = 9
        return ([_gene([0, 1, 2, 0, 1, 2, 3])], {7: c}, {7: anchor8},
                dict(polish_fill_holes=False))
    anchor10 = np.asarray([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.int8)
    if name.startswith("holes_"):
        c = _votes(anchor10, 10, 10)
        c[3] = 0
        c[3, 3] = 9
        c[6] = 0
        fields = {}
        if name == "holes_shallow_edges":
            c[0] = 0
            c[9] = 0
        elif name == "holes_disagreeing_edge":
            c[0] = 0
            c[0, 3] = 9
        elif name == "holes_tied_edge":
            c[0] = 0
            c[0, 2], c[0, 3] = 6, 6
        elif name == "holes_no_edge_extension":
            fields = dict(polish_extend_edges=False)
        return ([_gene([1, 2, 0, 1, 3, 0], offset=1)], {7: c},
                {7: anchor10}, fields)
    if name == "unplaceable_dropped":
        anchor = np.asarray([3, 2, 2, 1, 1, 0, 0, 0, 0, 3, 2, 3, 2, 2, 3, 2,
                             2, 2, 2, 3], np.int8)
        g = [3, 2, 2, 1, 0, 0, 0, 0, 3, 2, 3, 2, 2, 3, 2, 2, 0, 2, 2, 2, 3]
        return ([_gene(g)], {7: np.zeros((20, 4), np.int32)}, {7: anchor},
                {})
    raise KeyError(name)


CASES = ["decisive", "polymorphic", "thin_or_indecisive",
         "unmapped_and_foreign", "offset_kept", "interior_hole",
         "holes_deep_edges", "holes_shallow_edges", "holes_disagreeing_edge",
         "holes_tied_edge", "holes_no_edge_extension", "unplaceable_dropped"]


@pytest.mark.parametrize("name", CASES)
def test_apply_polish_synthetic_votes(name):
    genes, counts, anchors, fields = _case(name)
    got, n = tpolish.apply_polish([topipe.Gene(**g) for g in genes], counts,
                                  anchors, TConfig(**fields))
    ref, n_ref = jpolish.apply_polish([jopipe.Gene(**g) for g in genes],
                                      counts, anchors, JConfig(**fields))
    assert n == n_ref
    assert gene_fields(got) == gene_fields(ref)
    assert all(type(g) is topipe.Gene for g in got)
