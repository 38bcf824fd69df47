"""The port's own host layers == their `rambl_tpu` originals, on the same seeds.

`rambl_tpu_torch` imports nothing of `rambl_tpu`; it carries copies of the
JAX-free modules it needs (config, utils.{errors,checkpoint,metrics},
io.{pack,fasta,loader}, index.{builder,taxonomy,colmap,greengenes},
data.simulate, oracle.{sw,seed,align,binning,cluster,consensus,pipeline,
polish,cohort}). Each copy is held here against its original: same inputs,
identical outputs, no tolerance. The oracle's whole assembly and cohort
run: tests/test_torch_host_oracle.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from rambl_tpu import config as jconfig
from rambl_tpu.data import simulate as jsim
from rambl_tpu.index import builder as jbuilder
from rambl_tpu.index import colmap as jcolmap
from rambl_tpu.index import greengenes as jgg
from rambl_tpu.index import taxonomy as jtax
from rambl_tpu.io import fasta as jfasta
from rambl_tpu.io import loader as jloader
from rambl_tpu.io import pack as jpack
from rambl_tpu.oracle import align as jalign
from rambl_tpu.oracle import binning as jobin
from rambl_tpu.oracle import cluster as jocluster
from rambl_tpu.oracle import cohort as jcohort
from rambl_tpu.oracle import consensus as jocons
from rambl_tpu.oracle import pipeline as jopipe
from rambl_tpu.oracle import polish as jpolish
from rambl_tpu.oracle import seed as jseed
from rambl_tpu.oracle import sw as jsw
from rambl_tpu.utils import checkpoint as jckpt
from rambl_tpu.utils import metrics as jmetrics
from rambl_tpu.utils.errors import UserError as JUserError
from rambl_tpu_torch import config as tconfig
from rambl_tpu_torch.data import simulate as tsim
from rambl_tpu_torch.index import builder as tbuilder
from rambl_tpu_torch.index import colmap as tcolmap
from rambl_tpu_torch.index import greengenes as tgg
from rambl_tpu_torch.index import taxonomy as ttax
from rambl_tpu_torch.io import fasta as tfasta
from rambl_tpu_torch.io import loader as tloader
from rambl_tpu_torch.io import pack as tpack
from rambl_tpu_torch.oracle import align as talign
from rambl_tpu_torch.oracle import binning as tobin
from rambl_tpu_torch.oracle import cluster as tocluster
from rambl_tpu_torch.oracle import cohort as tcohort
from rambl_tpu_torch.oracle import consensus as tocons
from rambl_tpu_torch.oracle import pipeline as topipe
from rambl_tpu_torch.oracle import polish as tpolish
from rambl_tpu_torch.oracle import seed as tseed
from rambl_tpu_torch.oracle import sw as tsw
from rambl_tpu_torch.utils import checkpoint as tckpt
from rambl_tpu_torch.utils import metrics as tmetrics
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


@pytest.mark.parametrize("shape", [(37,), (16,), (0,), (5, 33), (2, 3, 48)])
def test_pack_2bit(shape):
    codes = np.random.default_rng(sum(shape) + 1).integers(
        0, 5, shape).astype(np.int8)
    ref = jpack.pack_2bit(codes)
    got = tpack.pack_2bit(codes)
    _assert_same(ref, got, "pack_2bit")
    n = shape[-1]
    _assert_same(jpack.unpack_2bit(ref, n), tpack.unpack_2bit(got, n),
                 "unpack_2bit")
    np.testing.assert_array_equal(tpack.unpack_2bit(got, n), codes & 3)


@pytest.mark.parametrize("k", [1, 5, 15, 31])
def test_kmer_keys(k):
    rng = np.random.default_rng(k)
    for n in (0, k - 1, k, 200):
        codes = rng.integers(0, 5, n).astype(np.int8)
        ref, got = jpack.kmer_keys(codes, k), tpack.kmer_keys(codes, k)
        for r, g in zip(ref, got):
            _assert_same(r, g, f"kmer_keys k={k} n={n}")


@pytest.mark.parametrize("case", ["planted", "gapped"])
def test_oracle_sw_scalar_and_traceback_scalar(case):
    """The scalar DP and walk equal their originals, and the port's batched
    oracle row by row (the pairs take both E and F gaps, and ties)."""
    make = planted_pairs if case == "planted" else gapped_pairs
    q, w = make(13, 6, 14, 24)
    q[0, :3] = 4                       # N never matches, even N vs N
    w[0, :3] = 4
    jsc, tsc = jconfig.ScoringParams(), tconfig.ScoringParams()
    score, ie, je, dirs = tsw.sw_batch(q, w, tsc, want_dirs=True)
    walks = tsw.traceback_batch(dirs, ie, je, q.shape[1])
    for b in range(q.shape[0]):
        ref = jsw.sw_scalar(q[b], w[b], jsc)
        got = tsw.sw_scalar(q[b], w[b], tsc)
        for r, g in zip(ref, got):
            _assert_same(np.asarray(r), np.asarray(g), "sw_scalar")
        assert got[:3] == (int(score[b]), int(ie[b]), int(je[b]))
        walk = tsw.traceback_scalar(*got[3:], got[1], got[2], q.shape[1])
        _assert_same(jsw.traceback_scalar(*ref[3:], ref[1], ref[2],
                                          q.shape[1]), walk, "traceback")
        _assert_same(walks[b], walk, "traceback_scalar vs traceback_batch")


def test_oracle_mapping_quality(both_ds):
    """The oracle's MAPQ margin equals its original, and the port's
    `pipeline.align.mapping_quality` on the align step's records, as the
    reference's two are equal."""
    from rambl_tpu_torch.ops.seed import SeedTable
    from rambl_tpu_torch.pipeline import align as tpalign

    ds, _ = both_ds
    n = 96
    jcfg, tcfg = jconfig.PipelineConfig(), tconfig.PipelineConfig()
    jidx = jbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=jcfg.k)
    tidx = tbuilder.build_seed_index(ds.ref_seqs, ds.ref_lens, k=tcfg.k)
    reads, lens = ds.reads[:n], ds.read_lens[:n]
    ref = jalign.align_reads(reads, lens, ds.ref_seqs, jidx, jcfg, chunk=48)
    got = talign.align_reads(reads, lens, ds.ref_seqs, tidx, tcfg, chunk=48)
    mq = talign.mapping_quality(got)
    _assert_same(jalign.mapping_quality(ref), mq, "mapping_quality")
    recs = tpalign.align_batch(torch.from_numpy(reads),
                               torch.from_numpy(lens),
                               SeedTable.from_index(tidx, "cpu"),
                               torch.from_numpy(ds.ref_seqs), tcfg)
    _assert_same(mq, tpalign.mapping_quality(recs).numpy(),
                 "oracle vs pipeline mapping_quality")
    assert (mq > 0).any() and (mq == 0).any()


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


# ---------------------------------------------------------------------------
# the copies of the whole assembly's host layers
# ---------------------------------------------------------------------------

def _jgene(g):
    return jopipe.Gene(**dataclasses.asdict(g))


def test_simulate_cohort():
    kw = dict(n_species=2, refs_per_species=2, n_samples=3,
              reads_per_sample=60, seed=9)
    ref, got = jsim.simulate_cohort(**kw), tsim.simulate_cohort(**kw)
    assert type(got) is tsim.CohortDataset
    _assert_same(ref.ds, got.ds, "cohort ds")
    assert len(got.samples) == len(ref.samples) == 3
    for j, (r, g) in enumerate(zip(ref.samples, got.samples)):
        _assert_same(r[0], g[0], f"sample {j} reads")
        _assert_same(r[1], g[1], f"sample {j} lens")
        _assert_same(ref.true_ref[j], got.true_ref[j], "true_ref")
    _assert_same(ref.abundance, got.abundance, "abundance")


def test_encode_batch_fasta_and_loader(tmp_path):
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACGTNacgtx"), int(n)))
            for n in rng.integers(0, 90, 12)]
    for length in (40, 128):
        r, g = jpack.encode_batch(seqs, length), tpack.encode_batch(seqs,
                                                                    length)
        _assert_same(r[0], g[0], "codes")
        _assert_same(r[1], g[1], "lens")
    _assert_same(jpack.encode_seq(seqs[0]), tpack.encode_seq(seqs[0]))
    fa, fq = str(tmp_path / "a.fasta"), str(tmp_path / "a.fastq.gz")
    recs = [(f"s{i} desc", s) for i, s in enumerate(seqs)]
    tfasta.write_fasta(fa, recs, width=33)
    jfasta.write_fasta(fa + ".ref", recs, width=33)
    assert open(fa).read() == open(fa + ".ref").read()
    tfasta.write_fastq(fq, [(n, s, "I" * len(s)) for n, s in recs])
    assert tfasta.read_fasta(fa) == jfasta.read_fasta(fa)
    assert tfasta.read_fastq(fq) == jfasta.read_fastq(fq)
    assert list(tfasta.iter_fastq(fq)) == list(jfasta.iter_fastq(fq))
    assert tloader.native_available() == jloader.native_available()
    for load in ("load_fasta_codes", "load_fastq_codes"):
        path = fa if "fasta" in load else fq
        r = getattr(jloader, load)(path, 64)
        g = getattr(tloader, load)(path, 64)
        _assert_same(r[0], g[0], load)
        _assert_same(r[1], g[1], load)
    codes, lens = tpack.encode_batch(seqs, 90)
    _assert_same(jloader.revcomp_batch_native(codes, lens),
                 tloader.revcomp_batch_native(codes, lens), "revcomp")
    with pytest.raises(FileNotFoundError):
        tloader.load_fastq_codes(str(tmp_path / "absent.fastq"), 64)


def test_greengenes(tmp_path):
    tax = tmp_path / "gg_taxonomy.txt"
    tax.write_text(
        "4001\tk__Bacteria; p__Firmicutes; c__Bacilli; o__; f__; g__; s__\n"
        "4002\tk__Bacteria; p__Firmicutes; c__Bacilli; o__; f__; g__; s__\n"
        "4003\tk__Bacteria; p__Proteo; c__Gamma; o__Entero; f__F; g__G; s__S\n"
        "\n")
    names = ["4001", "4002", "4003", "unlisted"]
    _assert_same(jgg.load_gg_taxonomy(str(tax), names),
                 tgg.load_gg_taxonomy(str(tax), names), "gg taxonomy")
    assert tgg.parse_gg_lineage("k__A; p__; c__C") == ["k__A"]
    aln = tmp_path / "gg.fasta"
    aln.write_text(">4001\n..AC-GT..\nA-C\n>4002\nA.CG--TAC.\n"
                   ">4003\n-ACGTAC--\n")
    msa_r = jgg.load_gg_msa(str(aln), names, 12)
    msa_g = tgg.load_gg_msa(str(aln), names, 12)
    _assert_same(msa_r, msa_g, "msa")
    lens = np.array([6, 6, 6, 0], np.int32)
    taxon = np.array([5, 5, 6, 7], np.int32)
    _assert_same(jgg.col_maps_from_msa(msa_r, lens, taxon),
                 tgg.col_maps_from_msa(msa_g, lens, taxon), "msa maps")


def test_checkpoint_and_metrics(tmp_path, both_ds):
    ds, _ = both_ds
    rng = np.random.default_rng(2)
    genes = [topipe.Gene(seq=rng.integers(0, 4, int(n)).astype(np.int8),
                         n_reads=int(n), leaf=3, cluster=i, round_born=1,
                         taxon=7 + i, offset=i)
             for i, n in enumerate(rng.integers(10, 80, 4))]
    cfg_t, cfg_j = tconfig.PRESETS["small"], jconfig.PRESETS["small"]
    assert tckpt.config_fingerprint(cfg_t) == jckpt.config_fingerprint(cfg_j)
    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
    mine, ref = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    stats = [dict(round=0, genes=4)]
    tckpt.save_checkpoint(mine, cfg_t, genes, 2, stats)
    jckpt.save_checkpoint(ref, cfg_j, [_jgene(g) for g in genes], 2, stats)
    for path in (mine, ref):
        for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
            header, back = load(path)
            assert header == jckpt.load_checkpoint(ref)[0]
            for a, b in zip(back, genes):
                _assert_same(dataclasses.asdict(a), dataclasses.asdict(b))
    assert tckpt.load_checkpoint(ref)[1][0].__class__ is topipe.Gene
    tckpt.save_checkpoint(mine, cfg_t, [], 0)
    assert tckpt.load_checkpoint(mine)[1] == []
    n2s = np.full(20, -1, np.int32)
    n2s[[3, 5]] = [0, 1]
    slot = rng.integers(0, 9, (64, 40)).astype(np.int32)
    for aux in (dict(node_counts=torch.from_numpy(slot)),
                dict(slot_counts=(torch.from_numpy(slot), n2s))):
        tckpt.save_aux_evidence(mine + ".aux", cfg_t, aux)
        jckpt.save_aux_evidence(ref + ".aux", cfg_j, {
            k: (v.numpy() if isinstance(v, torch.Tensor)
                else (v[0].numpy(), v[1])) for k, v in aux.items()})
        for path in (mine + ".aux", ref + ".aux"):
            r = jckpt.load_aux_evidence(path, cfg_j)
            g = tckpt.load_aux_evidence(path, cfg_t)
            assert list(r) == list(g) == list(aux)
            for x, y in zip(jax_tree(r), jax_tree(g)):
                _assert_same(x, y, "aux")
    other = dataclasses.replace(cfg_t, min_score=cfg_t.min_score + 1)
    with pytest.raises(ValueError, match="different config"):
        tckpt.load_aux_evidence(ref + ".aux", other)
    assert tckpt.load_aux_evidence(str(tmp_path / "none.aux"), cfg_t) is None
    tckpt.save_aux_evidence(str(tmp_path / "empty.aux"), cfg_t, {})
    assert not os.path.exists(tmp_path / "empty.aux")

    logs = []
    for mod in (tmetrics, jmetrics):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        with mod.MetricsLogger(path, quiet=True) as m:
            rec = m.log("round", sample=0, genes=3, nw_tier="numpy")
        logs.append([{k: v for k, v in json.loads(x).items() if k != "t"}
                     for x in open(path)])
        assert rec["stage"] == "round"
    assert logs[0] == logs[1] == [dict(stage="round", sample=0, genes=3,
                                       nw_tier="numpy")]


def jax_tree(aux):
    """The arrays of a loaded aux dict, in order."""
    out = []
    for v in aux.values():
        out += list(v) if isinstance(v, tuple) else [v]
    return out


def test_oracle_panel_helpers(both_ds):
    ds, _ = both_ds
    tax = ttax_tables(ds)
    rng = np.random.default_rng(6)
    genes = [topipe.Gene(seq=rng.integers(0, 4, int(n)).astype(np.int8),
                         n_reads=3, leaf=1, cluster=0, round_born=0,
                         taxon=int(t), offset=int(o))
             for n, t, o in zip(rng.integers(50, 300, 5),
                                tax.ref_taxon[:5], [0, 3, 1900, 2047, 7])]
    for r, g in zip(jopipe.pad_panel([_jgene(x) for x in genes], 2048),
                    topipe.pad_panel(genes, 2048)):
        _assert_same(r, g, "pad_panel")
    _assert_same(jopipe.panel_tables(genes, tax),
                 topipe.panel_tables(genes, tax), "panel_tables")
    assert [f.name for f in dataclasses.fields(topipe.AssemblyResult)] == [
        f.name for f in dataclasses.fields(jopipe.AssemblyResult)]
    res = topipe.AssemblyResult(genes=genes, n_rounds=1, converged=False,
                                round_stats=[])
    cfg = tconfig.PipelineConfig(full_len_min=200)
    assert res.full_length(cfg) == [g for g in genes if g.seq.shape[0] >= 200]
    anchors_t = tpolish.anchor_seqs_of(ds.ref_seqs, ds.ref_lens, ds.ref_taxon)
    anchors_j = jpolish.anchor_seqs_of(ds.ref_seqs, ds.ref_lens, ds.ref_taxon)
    _assert_same(anchors_j, anchors_t, "anchor_seqs_of")


def test_oracle_polish_copies(leaf_inputs):
    """leaf_exclusive_counts on the first reads, and fill_gene_holes on
    genes cut from the anchors with interior holes, unplaceable bases and
    short edges."""
    ds, tax, _, _ = leaf_inputs
    n = N_LEAF_READS // 2
    args = (ds.reads[:n], ds.read_lens[:n], ds.ref_seqs, ds.ref_lens)
    ref = jpolish.leaf_exclusive_counts(*args, tax, jconfig.PipelineConfig())
    got = tpolish.leaf_exclusive_counts(*args, ttax_tables(ds),
                                        tconfig.PipelineConfig())
    _assert_same(ref, got, "leaf_exclusive_counts")
    anchors = tpolish.anchor_seqs_of(ds.ref_seqs, ds.ref_lens, ds.ref_taxon)
    rng = np.random.default_rng(3)
    for taxon, aseq in anchors.items():
        seq = np.delete(aseq[40:-30], rng.integers(0, aseq.size - 80, 5))
        seq = np.insert(seq, 100, [0, 1]).astype(np.int8)
        g = dict(seq=seq, n_reads=4, leaf=taxon, cluster=0, round_born=1,
                 taxon=taxon, offset=40)
        for fields in ({}, dict(polish_extend_edges=False)):
            r = jpolish.fill_gene_holes(jopipe.Gene(**g), ref[taxon], aseq,
                                        jconfig.PipelineConfig(**fields))
            t = tpolish.fill_gene_holes(topipe.Gene(**g), got[taxon], aseq,
                                        tconfig.PipelineConfig(**fields))
            assert t[1] == r[1] > 0
            _assert_same(dataclasses.asdict(r[0]), dataclasses.asdict(t[0]))


def test_nw_map_batch_copy():
    rng = np.random.default_rng(11)
    a = [rng.integers(0, 4, int(n)).astype(np.int8)
         for n in rng.integers(5, 120, 9)]
    b = [np.delete(x, rng.integers(0, x.size, 2)).astype(np.int8) for x in a]
    for native in (True, False):
        for r, g in zip(jcolmap._nw_map_batch(a, b, native=native),
                        tcolmap._nw_map_batch(a, b, native=native)):
            _assert_same(r, g, "_nw_map_batch")


def _cohort_leaf(dom_share):
    """tests/test_cohort.py's leaf: an all-A anchor, a dominant strain with
    T at columns 4..7 and a minor one with C at 10..13, 3 samples."""
    L, S, depth = 40, 3, 200
    stack = np.zeros((S, L, 4), np.int64)
    stack[:, :, 0] = depth
    for cols, base, shares in ((range(4, 8), 3, [dom_share] * S),
                               (range(10, 14), 1, [0.20, 0.30, 0.25])):
        for c in cols:
            for j in range(S):
                m = int(depth * shares[j])
                stack[j, c, 0], stack[j, c, base] = depth - m, m
    anchor = np.zeros(L, np.int8)
    backbone = dict(seq=anchor.copy(), n_reads=100, leaf=1, cluster=0,
                    round_born=0, taxon=1, offset=0)
    return stack, anchor, backbone


@pytest.mark.parametrize("dom_share", [0.40, 0.60])
def test_oracle_cohort_copies(dom_share):
    jcfg, tcfg = jconfig.PipelineConfig(), tconfig.PipelineConfig()
    rng = np.random.default_rng(0)
    t = rng.poisson(60, size=(12, 4)).astype(np.int64)
    f = np.where((np.arange(12) < 6)[:, None], [0.30, 0.10, 0.45, 0.25],
                 [0.40, 0.35, 0.15, 0.30])
    m = rng.binomial(t, f)
    _assert_same(jcohort.phase_columns(m, t, jcfg),
                 tcohort.phase_columns(m, t, tcfg), "phase_columns")
    assert tcohort._chi2(3, 10, 5, 12) == jcohort._chi2(3, 10, 5, 12)
    stack, anchor, bb = _cohort_leaf(dom_share)
    for r, g in zip(jcohort.qualifying_columns(stack, jcfg),
                    tcohort.qualifying_columns(stack, tcfg)):
        _assert_same(r, g, "qualifying_columns")
    r = jcohort.cohort_genes_for_leaf(stack, jopipe.Gene(**bb), anchor, jcfg)
    g = tcohort.cohort_genes_for_leaf(stack, topipe.Gene(**bb), anchor, tcfg)
    assert len(g) == len(r) > 0
    for x, y in zip(r, g):
        for a, b in zip(x, y):
            _assert_same(a, b, "cohort_genes_for_leaf")
    counts = [{1: stack[j]} for j in range(3)]
    rout = jcohort.cohort_phase([[jopipe.Gene(**bb)]] * 3, counts, {1: anchor},
                                jcfg)
    gout = tcohort.cohort_phase([[topipe.Gene(**bb)]] * 3, counts,
                                {1: anchor}, tcfg)
    assert [len(x) for x in gout] == [len(x) for x in rout]
    for rs, gs in zip(rout, gout):
        for a, b in zip(rs, gs):
            assert type(b) is topipe.Gene
            _assert_same(dataclasses.asdict(a), dataclasses.asdict(b))
