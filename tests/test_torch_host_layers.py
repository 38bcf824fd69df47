"""The port's own host layers == their `rambl_tpu` originals, on the same seeds.

`rambl_tpu_torch` imports nothing of `rambl_tpu`; it carries copies of the
JAX-free modules it needs (config, utils.errors, io.pack, index.{builder,
taxonomy,colmap}, data.simulate, oracle.{sw,seed,align,binning,cluster,
consensus,pipeline}). Each copy is held here against its original: same
inputs, identical outputs, no tolerance.
"""

import dataclasses

import numpy as np
import pytest

from rambl_tpu import config as jconfig
from rambl_tpu.data import simulate as jsim
from rambl_tpu.index import builder as jbuilder
from rambl_tpu.index import colmap as jcolmap
from rambl_tpu.index import taxonomy as jtax
from rambl_tpu.io import pack as jpack
from rambl_tpu.oracle import align as jalign
from rambl_tpu.oracle import binning as jobin
from rambl_tpu.oracle import cluster as jocluster
from rambl_tpu.oracle import consensus as jocons
from rambl_tpu.oracle import pipeline as jopipe
from rambl_tpu.oracle import seed as jseed
from rambl_tpu.oracle import sw as jsw
from rambl_tpu.utils.errors import UserError as JUserError
from rambl_tpu_torch import config as tconfig
from rambl_tpu_torch.data import simulate as tsim
from rambl_tpu_torch.index import builder as tbuilder
from rambl_tpu_torch.index import colmap as tcolmap
from rambl_tpu_torch.index import taxonomy as ttax
from rambl_tpu_torch.io import pack as tpack
from rambl_tpu_torch.oracle import align as talign
from rambl_tpu_torch.oracle import binning as tobin
from rambl_tpu_torch.oracle import cluster as tocluster
from rambl_tpu_torch.oracle import consensus as tocons
from rambl_tpu_torch.oracle import pipeline as topipe
from rambl_tpu_torch.oracle import seed as tseed
from rambl_tpu_torch.oracle import sw as tsw
from rambl_tpu_torch.utils.errors import UserError as TUserError
from rambl_tpu_torch.utils.sw_cases import gapped_pairs, planted_pairs

SIM_CASES = {
    "strains": dict(n_species=4, refs_per_species=2, n_reads=300, seed=5),
    "leaf_per_ref": dict(n_species=3, refs_per_species=2, n_reads=120,
                         seed=6, leaf_per_ref=True, skewed_abundance=False),
    "n_present": dict(n_species=6, refs_per_species=1, n_reads=150, seed=7,
                      n_present=3),
}


def _assert_same(a, b, what=""):
    """Equal values of equal types: arrays by dtype, shape and content."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], what
        for name in fa:
            _assert_same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    else:
        assert a == b, what


@pytest.fixture(scope="module", params=sorted(SIM_CASES))
def both_ds(request):
    kw = SIM_CASES[request.param]
    return jsim.simulate_dataset(**kw), tsim.simulate_dataset(**kw)


def test_simulate_dataset(both_ds):
    ref, got = both_ds
    _assert_same(ref, got, "dataset")
    assert got.ref_fasta() == ref.ref_fasta()


def test_toy_dataset():
    _assert_same(jsim.toy_dataset(seed=2, n_reads=200),
                 tsim.toy_dataset(seed=2, n_reads=200), "toy")


@pytest.mark.parametrize("n_bits", [None, 9])
def test_build_seed_index(both_ds, n_bits):
    ds, _ = both_ds
    ref = jbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=15,
                                    n_bits=n_bits)
    got = tbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=15,
                                    n_bits=n_bits)
    _assert_same(ref, got, "index")
    for r, g in zip(ref.padded_entries(16), got.padded_entries(16)):
        _assert_same(r, g, "padded_entries")
    keys = np.arange(0, 1 << 30, 7919, dtype=np.int64)
    _assert_same(jbuilder.hash_kmer(keys, 20), tbuilder.hash_kmer(keys, 20))


def test_taxonomy_tables_and_lca(both_ds):
    ds, _ = both_ds
    ref = jtax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    got = ttax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    _assert_same(ref, got, "taxonomy")
    assert ttax.MAX_DEPTH == jtax.MAX_DEPTH
    rng = np.random.default_rng(3)
    nodes = rng.integers(0, got.n_nodes, (40, 6)).astype(np.int32)
    valid = rng.random((40, 6)) < 0.5
    valid[:3] = False
    _assert_same(jtax.lca_of_set(ref, nodes, valid),
                 ttax.lca_of_set(got, nodes, valid), "lca_of_set")
    assert got.lca_pair(1, got.n_nodes - 1) == ref.lca_pair(1, ref.n_nodes - 1)


def test_build_col_maps(both_ds):
    ds, _ = both_ds
    args = (ds.ref_seqs, ds.ref_lens, ds.ref_taxon)
    got = tcolmap.build_col_maps(*args)
    _assert_same(jcolmap.build_col_maps(*args), got, "col_maps")
    _assert_same(jcolmap.anchor_of_leaf(ds.ref_taxon),
                 tcolmap.anchor_of_leaf(ds.ref_taxon), "anchors")


@pytest.mark.parametrize("case", ["planted", "gapped"])
def test_oracle_sw_batch_and_traceback(case):
    make = planted_pairs if case == "planted" else gapped_pairs
    q, w = make(9, 48, 24, 40)
    jsc, tsc = jconfig.ScoringParams(), tconfig.ScoringParams()
    ref = jsw.sw_batch(q, w, jsc, want_dirs=True)
    got = tsw.sw_batch(q, w, tsc, want_dirs=True)
    for r, g in zip(ref, got):
        _assert_same(r, g, "sw_batch")
    _assert_same(jsw.traceback_batch(ref[3], ref[1], ref[2], 24),
                 tsw.traceback_batch(got[3], got[1], got[2], 24), "traceback")
    assert tsw.sw_batch(q, w, tsc, want_dirs=False)[3] is None


def test_oracle_seed_and_align(both_ds):
    ds, _ = both_ds
    n = 64
    jcfg, tcfg = jconfig.PipelineConfig(), tconfig.PipelineConfig()
    jidx = jbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=jcfg.k)
    tidx = tbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=tcfg.k)
    reads, lens = ds.reads[:n], ds.read_lens[:n]
    _assert_same(jseed.seed_candidates(reads, lens, jidx, jcfg),
                 tseed.seed_candidates(reads, lens, tidx, tcfg), "seed")
    ref = jalign.align_reads(reads, lens, ds.ref_seqs, jidx, jcfg, chunk=40)
    got = talign.align_reads(reads, lens, ds.ref_seqs, tidx, tcfg, chunk=40)
    _assert_same(ref, got, "align_reads")
    assert (got.ref >= 0).mean() > 0.9


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets(name):
    ref, got = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    assert (got.window_len, got.n_diag_bins) == (ref.window_len,
                                                 ref.n_diag_bins)
    assert tconfig.PipelineConfig.from_json(got.to_json()) == got
    assert got.to_json() == ref.to_json()


def test_config_defaults_and_scoring():
    assert dataclasses.asdict(jconfig.PipelineConfig()) == dataclasses.asdict(
        tconfig.PipelineConfig())
    sc = tconfig.ScoringParams()
    assert dataclasses.asdict(sc) == dataclasses.asdict(
        jconfig.ScoringParams())
    assert sc.neg_inf == jconfig.ScoringParams().neg_inf
    legacy = '{"poly_min_minor_frac": 0.15, "scoring": {"match": 2}}'
    ref = jconfig.PipelineConfig.from_json(legacy)
    got = tconfig.PipelineConfig.from_json(legacy)
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)


def test_pack_and_errors():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, (30, 50)).astype(np.int8)
    lens = rng.integers(0, 51, 30).astype(np.int32)
    _assert_same(jpack.revcomp_codes(codes, lens),
                 tpack.revcomp_codes(codes, lens), "revcomp 2-D")
    _assert_same(jpack.revcomp_codes(codes[0]), tpack.revcomp_codes(codes[0]))
    assert tpack.decode_seq(codes[1]) == jpack.decode_seq(codes[1])
    _assert_same(jpack.BASE_TO_CODE, tpack.BASE_TO_CODE)
    assert issubclass(TUserError, ValueError)
    assert TUserError is not JUserError


def test_oracle_assemble_round(both_ds):
    ds, _ = both_ds
    tax = jtax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth,
                                     ds.ref_taxon)
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax)
    g_ref, s_ref = jopipe.assemble_round(*args, jconfig.PipelineConfig(), 0)
    g_got, s_got = topipe.assemble_round(*args, tconfig.PipelineConfig(), 0)
    assert len(g_ref) > 0
    _assert_same(s_ref, s_got, "stats")
    assert [f.name for f in dataclasses.fields(topipe.Gene)] == [
        f.name for f in dataclasses.fields(jopipe.Gene)]
    assert len(g_got) == len(g_ref)
    for r, g in zip(g_ref, g_got):
        assert type(g) is topipe.Gene
        _assert_same(dataclasses.asdict(r), dataclasses.asdict(g), "gene")
        assert g.key() == r.key()


N_LEAF_READS = 150


@pytest.fixture(scope="module")
def leaf_inputs(both_ds):
    """The first reads of a dataset aligned and binned by the original
    oracle, and for each leaf its members' (query, ref_col)."""
    ds, _ = both_ds
    jcfg = jconfig.PipelineConfig()
    tax = jtax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth,
                                     ds.ref_taxon)
    idx = jbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=jcfg.k)
    n = N_LEAF_READS
    res = jalign.align_reads(ds.reads[:n], ds.read_lens[:n], ds.ref_seqs,
                             idx, jcfg)
    bins = jobin.bin_reads(res, tax, jcfg)
    return ds, tax, res, bins


def test_oracle_binning(leaf_inputs):
    ds, tax, res, bins = leaf_inputs
    ttax = ttax_tables(ds)
    tres = talign.AlignmentResult(**dataclasses.asdict(res))
    _assert_same(bins, tobin.bin_reads(tres, ttax, tconfig.PipelineConfig()),
                 "bin_reads")
    for leaf in np.unique(tax.ref_taxon).tolist() + [0]:
        for share in (None, 3, 1, 0):
            _assert_same(jobin.leaf_membership(bins, leaf, tax, share),
                         tobin.leaf_membership(bins, leaf, ttax, share),
                         f"leaf_membership {leaf} {share}")


def ttax_tables(ds):
    return ttax.build_taxonomy_tables(ds.tax_parent, ds.tax_depth,
                                      ds.ref_taxon)


@pytest.mark.parametrize("fields", [{}, dict(
    max_poly_cols=4, min_coverage=2, poly_min_minor_count=1,
    poly_minor_frac_num=1, poly_minor_frac_den=20, dp_spawn_min_orphans=2)])
def test_oracle_cluster_and_consensus(leaf_inputs, fields):
    ds, tax, res, bins = leaf_inputs
    jcfg = jconfig.PipelineConfig(**fields)
    tcfg = tconfig.PipelineConfig(**fields)
    ref_len = ds.ref_seqs.shape[1]
    n_poly = 0
    for leaf in np.unique(tax.ref_taxon).tolist():
        mem = jobin.leaf_membership(bins, leaf, tax) & res.aligned
        q, rc = res.query[mem], res.ref_col[mem]
        counts = jocluster.bin_pileup(q, rc, ref_len)
        _assert_same(counts, tocluster.bin_pileup(q, rc, ref_len), "pileup")
        for cap in (True, False):
            poly = jocluster.polymorphic_cols(counts, jcfg, cap=cap)
            _assert_same(poly, tocluster.polymorphic_cols(counts, tcfg,
                                                          cap=cap), "poly")
        n_poly += poly.size
        feat = jocluster.read_features(q, rc, poly)
        _assert_same(feat, tocluster.read_features(q, rc, poly), "features")
        can_seed = bins[mem] == leaf
        for cs in (can_seed, None):
            ref = jocluster.dp_means(feat, jcfg, cs)
            got = tocluster.dp_means(feat, tcfg, cs)
            _assert_same(ref[0], got[0], "assign")
            _assert_same(ref[1], got[1], "centers")
            assert ref[2] == got[2]
        c_ref, s_ref = jocons.cluster_pileup(q, rc, ref_len)
        c_got, s_got = tocons.cluster_pileup(q, rc, ref_len)
        _assert_same(c_ref, c_got, "cluster_pileup counts")
        _assert_same(s_ref, s_got, "cluster_pileup span")
        for span in (s_ref, s_ref - 3 * (np.arange(ref_len) % 2)):
            seq, off = jocons.call_consensus(c_ref, span)
            seq2, off2 = tocons.call_consensus(c_ref, span)
            _assert_same(seq, seq2, "call_consensus")
            assert off == off2
    if fields:      # thresholds low enough for 150 reads to vary
        assert n_poly > 0
