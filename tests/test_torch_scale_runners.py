"""The scale ladder's host parts (`rambl_tpu_torch/scripts/`), held to the
reference scripts and the JAX package's host layers; no assembly runs here.

- `build_scale_caches`: the `.npz` round trip at a tiny size equals a fresh
  `rambl_tpu` `simulate_dataset` + `build_seed_index`; the cache name keys
  n_reads, n_refs, k, the generator version and the seed; the loader
  refuses a pickle; config 5's chunked reads equal the reference script's
  loop over `rambl_tpu.data.simulate._gen_reads`.
- `quality_bench`'s rules: the cohort rule equals
  `scripts/run_config4.py::recovery` (loaded by path); the benchmark's rule
  gives chip_smoke.py's former `recovered` numbers; the config-3 and
  config-5 rules on constructed cases (a gene equal to a reference, one
  below 95% containment, the 3x detectability edges), and equal to the
  reference scripts' set arithmetic.

No tolerance: every count is an integer, every containment the same
float division as the reference's.
"""

import importlib.util
import os
import pickle
import types

import numpy as np
import pytest

from rambl_tpu.data import simulate as jsim
from rambl_tpu.index.builder import build_seed_index as jbuild_index
from rambl_tpu.io.pack import decode_seq
from rambl_tpu_torch.data.simulate import simulate_cohort, simulate_dataset
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts import quality_bench as qb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_reads=300, n_refs=20, n_present=8)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_config3(n_reads, n_refs, n_present):
    ds = jsim.simulate_dataset(n_species=n_refs // 5, refs_per_species=5,
                               n_reads=n_reads, seed=13, leaf_per_ref=True,
                               n_present=n_present)
    return ds, jbuild_index(ds.ref_seqs, ds.ref_lens, k=15)


def _reference_config5_reads(ds, n_reads, chunk):
    """scripts/run_config5.py's loop, on the JAX package's generator."""
    reads = np.empty((n_reads, 128), np.int8)
    lens = np.empty((n_reads,), np.int32)
    for i, lo in enumerate(range(0, n_reads, chunk)):
        hi = min(lo + chunk, n_reads)
        rng = np.random.default_rng(977 + 13 * i)
        r, ln, _, _, _ = jsim._gen_reads(rng, ds.ref_seqs, ds.ref_lens,
                                         ds.abundance, hi - lo, 100, 128,
                                         0.004, 0.0005)
        reads[lo:hi] = r
        lens[lo:hi] = ln
    return reads, lens


def _same_index(got, want):
    assert (got.k, got.n_bits, got.n_refs, got.max_bucket) == (
        want.k, want.n_bits, want.n_refs, want.max_bucket)
    for f in ("bucket_start", "entry_key", "entry_ref", "entry_pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _same_panel(got, want):
    for f in ("ref_seqs", "ref_lens", "tax_parent", "tax_depth", "ref_taxon",
              "abundance"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_config3_cache_round_trip(tmp_path):
    lines = []
    built = caches.config3(**TINY, directory=str(tmp_path), out=lines.append)
    path = tmp_path / caches.cache_name("config3", 300, 20, 15)
    assert path.exists() and lines[-1].startswith("wrote ")
    loaded = caches.config3(**TINY, directory=str(tmp_path),
                            out=lines.append)
    assert lines[-1].startswith("loaded cached dataset+index")
    ds, index = _reference_config3(300, 20, 8)
    for data in (built, loaded):
        _same_panel(data, ds)
        np.testing.assert_array_equal(data.reads, ds.reads)
        np.testing.assert_array_equal(data.read_lens, ds.read_lens)
        np.testing.assert_array_equal(data.true_ref, ds.true_ref)
        _same_index(data.index, index)
    assert caches.config3(**TINY, directory=str(tmp_path), load=False,
                          out=lines.append) is None
    assert lines[-1].startswith("config3 cache exists")


def test_config5_cache_round_trip(tmp_path):
    built = caches.config5(250, 20, 8, directory=str(tmp_path), chunk=100,
                           out=lambda *a: None)
    loaded = caches.load_cache(
        str(tmp_path / caches.cache_name("config5", 250, 20, 15)))
    panel, index = _reference_config3(1, 20, 8)
    reads, lens = _reference_config5_reads(panel, 250, 100)
    for data in (built, loaded):
        _same_panel(data, panel)
        np.testing.assert_array_equal(data.reads, reads)
        np.testing.assert_array_equal(data.read_lens, lens)
        assert data.true_ref is None
        _same_index(data.index, index)


def test_cache_name_keys_its_inputs():
    base = caches.cache_name("config3", 10_000_000, 100_000, 15)
    assert base == "config3_torch_cache_10000000_100000_k15_v3_seed13.npz"
    others = [caches.cache_name("config3", 10_000_000, 100_000, 13),
              caches.cache_name("config3", 10_000_000, 100_000, 15, gen_v=4),
              caches.cache_name("config3", 20_000_000, 100_000, 15),
              caches.cache_name("config3", 10_000_000, 50_000, 15),
              caches.cache_name("config3", 10_000_000, 100_000, 15, seed=7),
              caches.cache_name("config5", 10_000_000, 100_000, 15)]
    assert len({base, *others}) == 1 + len(others)


def test_loader_refuses_a_pickle(tmp_path):
    path = tmp_path / caches.cache_name("config3", 300, 20, 15)
    with open(path, "wb") as f:
        pickle.dump({"reads": np.zeros(3)}, f)
    with pytest.raises(ValueError, match="pickle"):
        caches.load_cache(str(path))
    with pytest.raises(ValueError, match="pickle"):
        caches.config3(**TINY, directory=str(tmp_path))
    np.save(tmp_path / "plain.npy", np.zeros(3))
    with pytest.raises(ValueError, match="not an .npz"):
        caches.load_cache(str(tmp_path / "plain.npy"))


@pytest.mark.parametrize("n_reads,chunk", [(250, 100), (200, 200), (7, 3)])
def test_config5_chunks_equal_the_reference_loop(n_reads, chunk):
    ds = simulate_dataset(n_species=4, refs_per_species=5, n_reads=1,
                          seed=13, leaf_per_ref=True, n_present=8)
    reads, lens = caches.config5_reads(ds, n_reads, chunk)
    want = _reference_config5_reads(ds, n_reads, chunk)
    np.testing.assert_array_equal(reads, want[0])
    np.testing.assert_array_equal(lens, want[1])


# ---- recovery rules ---------------------------------------------------

def _genes_about(ds, seed):
    """Genes of every kind of containment against ds's references: equal,
    cut, lightly and heavily mutated, with an N, random, shorter than a
    k-mer and empty. Every third reference gets only a heavily mutated
    copy, so some references stay unrecovered."""
    rng = np.random.default_rng(seed)
    seqs = []
    for r in range(ds.n_refs):
        s = ds.ref_seqs[r, : ds.ref_lens[r]].copy()
        if r % 3:
            seqs.append(s)
            seqs.append(s[100:900].copy())
        for rate in (0.001, 0.003, 0.02)[(0 if r % 3 else 2):]:
            m = s.copy()
            hit = rng.random(m.size) < rate
            m[hit] = (m[hit] + 1) % 4
            seqs.append(m)
    seqs[3][50] = 4
    seqs += [rng.integers(0, 4, 1500).astype(np.int8),
             ds.ref_seqs[0, :20].copy(), np.zeros(0, np.int8)]
    order = rng.permutation(len(seqs))
    return [Gene(seq=seqs[i], n_reads=1, leaf=0, cluster=0, round_born=0,
                 taxon=0) for i in order]


def _old_recovered(ds, genes):
    """chip_smoke.py's `recovered` before it imported quality_bench's."""
    kmers = qb.kmers
    refk = [kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in range(ds.n_refs)]
    cov = np.bincount(ds.true_ref, minlength=ds.n_refs) * 100 / ds.ref_lens
    best = {int(r): 0.0 for r in np.nonzero(cov >= 5)[0]}
    for g in genes:
        gk = kmers(decode_seq(g.seq))
        r = max(range(ds.n_refs), key=lambda x: len(gk & refk[x]))
        if r in best:
            best[r] = max(best[r], len(gk & refk[r]) / max(len(gk), 1))
    return sum(c > 0.95 for c in best.values()), len(best)


@pytest.mark.parametrize("name", [n for n, _ in qb.SCENARIOS])
def test_quality_rule_gives_the_former_numbers(name):
    ds = simulate_dataset(**dict(qb.SCENARIOS)[name])
    genes = _genes_about(ds, 5)
    rec, det, mc = qb.recovered(ds, genes)
    assert (rec, det) == _old_recovered(ds, genes)
    assert 0 < rec < det or det == rec > 0
    assert 0.0 < mc <= 1.0
    assert qb.recovered(ds, genes[:0]) == (0, det, 0.0)


def test_cohort_rule_equals_run_config4_recovery():
    ref = _script("run_config4")
    co = simulate_cohort(n_species=2, refs_per_species=5, n_samples=3,
                         reads_per_sample=600, seed=11)
    genes = _genes_about(co.ds, 9)
    results = [types.SimpleNamespace(genes=genes[i::3]) for i in range(3)]
    want = ref.recovery(co.ds, results, true_refs=co.true_ref)
    got = qb.recovery(co.ds, results, true_refs=co.true_ref)
    assert got == want and 0 < got[0] < got[1]
    assert (qb.recovery(co.ds, results, cov_min=50.0, true_refs=co.true_ref)
            == ref.recovery(co.ds, results, cov_min=50.0,
                            true_refs=co.true_ref))


def _constructed(ref_lens, abundance, true_counts, seed=0):
    """A dataset of random references of the given lengths (+ a padding
    column), abundances and true_ref counts."""
    rng = np.random.default_rng(seed)
    n = len(ref_lens)
    seqs = np.full((n, max(ref_lens) + 1), 4, np.int8)
    for r, ln in enumerate(ref_lens):
        seqs[r, :ln] = rng.integers(0, 4, ln)
    true_ref = np.repeat(np.arange(n), true_counts).astype(np.int32)
    return types.SimpleNamespace(
        ref_seqs=seqs, ref_lens=np.asarray(ref_lens, np.int32),
        abundance=np.asarray(abundance, float), true_ref=true_ref, n_refs=n)


def _gene(seq):
    return Gene(seq=np.asarray(seq, np.int8), n_reads=1, leaf=0, cluster=0,
                round_born=0, taxon=0)


def _below_95(seq, k=25):
    """`seq` with substitutions every 400 columns: 25-mer containment
    just below 95% for a 1,000-column reference (3 x 25 = 75 of ~976
    k-mers touched: 92.3%)."""
    m = np.array(seq, np.int8)
    m[[100, 500, 900]] = (m[[100, 500, 900]] + 1) % 4
    return m


def _reference_present_rule(ds, genes, depth):
    """run_config3.py's and run_config5.py's scoring, with sets (the
    reference scripts' `kmers`, which quality_bench keeps)."""
    kmers = qb.kmers
    present = np.nonzero(ds.abundance > 0)[0]
    detectable = present[depth[present] >= 3 * ds.ref_lens[present]]
    refk = {int(r): kmers(decode_seq(ds.ref_seqs[r, : ds.ref_lens[r]]))
            for r in present}
    recovered = set()
    for g in genes:
        gk = kmers(decode_seq(g.seq))
        best = max(refk, key=lambda r: len(gk & refk[r]))
        if len(gk & refk[best]) / max(len(gk), 1) > 0.95:
            recovered.add(best)
    return (len(recovered & set(int(x) for x in detectable)),
            int(detectable.size), int(present.size))


def test_config3_rule_on_constructed_cases():
    # refs 0-2 present; 0 at exactly 3x true depth (30 reads x 100 bases on
    # 1,000 columns), 1 one column short of it (1,001 columns), 2 deep;
    # ref 3 absent (abundance 0) though reads name it
    ds = _constructed([1000, 1001, 1000, 1000], [0.2, 0.3, 0.5, 0.0],
                      [30, 30, 90, 40])
    seq = [ds.ref_seqs[r, : ds.ref_lens[r]] for r in range(4)]
    depth = np.bincount(ds.true_ref, minlength=4) * 100.0
    cases = {
        "equal, detectable": ([_gene(seq[0])], (1, 2, 3)),
        "below 95%": ([_gene(_below_95(seq[0]))], (0, 2, 3)),
        "equal, not detectable": ([_gene(seq[1])], (0, 2, 3)),
        "absent reference": ([_gene(seq[3])], (0, 2, 3)),
        "both detectable": ([_gene(seq[2]), _gene(seq[0][:600])],
                            (2, 2, 3)),
    }
    for what, (genes, want) in cases.items():
        assert qb.recovered_present(ds, genes) == want, what
        assert _reference_present_rule(ds, genes, depth) == want, what


def test_config5_rule_on_constructed_cases():
    # expected depth = abundance share x n_reads x 100: at 120 reads ref 0
    # (share 0.25, 1,000 columns) sits exactly at 3x, ref 1 (0.25, 1,001
    # columns) just under; true_ref is not read
    ds = _constructed([1000, 1001, 1000, 1000], [0.25, 0.25, 0.5, 0.0],
                      [0, 0, 0, 500])
    seq = [ds.ref_seqs[r, : ds.ref_lens[r]] for r in range(4)]
    p = ds.abundance / ds.abundance.sum()
    depth = p * 120 * 100.0
    cases = {
        "equal, detectable": ([_gene(seq[0])], (1, 2, 3)),
        "below 95%": ([_gene(_below_95(seq[2]))], (0, 2, 3)),
        "equal, not detectable": ([_gene(seq[1])], (0, 2, 3)),
        "absent reference": ([_gene(seq[3])], (0, 2, 3)),
    }
    for what, (genes, want) in cases.items():
        assert qb.recovered_expected(ds, genes, 120) == want, what
        assert _reference_present_rule(ds, genes, depth) == want, what
    assert qb.recovered_expected(ds, [_gene(seq[1])], 121) == (1, 3, 3)


def test_present_rules_equal_the_reference_on_a_panel():
    """A config-3-shaped panel (leaf per reference, 8 present) and genes of
    every containment: both rules equal the reference scripts'."""
    ds = simulate_dataset(n_species=4, refs_per_species=5, n_reads=300,
                          seed=13, leaf_per_ref=True, n_present=8)
    genes = _genes_about(ds, 3)
    depth = np.bincount(ds.true_ref, minlength=ds.n_refs) * 100.0
    assert (qb.recovered_present(ds, genes)
            == _reference_present_rule(ds, genes, depth))
    present = np.nonzero(ds.abundance > 0)[0]
    exp = np.zeros(ds.n_refs)
    exp[present] = ds.abundance[present] / ds.abundance.sum() * 300 * 100.0
    got = qb.recovered_expected(ds, genes, 300)
    assert got == _reference_present_rule(ds, genes, exp) and got[0] > 0
