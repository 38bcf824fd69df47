"""The port's seeding == the JAX reference, bit for bit.

Hash, query k-mers, CSR probe + vote selection, window gather and reverse
complement of `rambl_tpu_torch.ops.seed` against `rambl_tpu.ops.seed` on the
same numpy inputs (the shared `small_ds` mock community and seeded random
arrays); the port gets its own config class with the reference's defaults.
All outputs are integers: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.index.builder import hash_kmer as hash_kmer_np
from rambl_tpu.ops import seed as jseed
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.ops import seed as tseed

TCFG = TConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_bits", [1, 13, 20, 31])
def test_hash_kmer_wraps_like_uint32(n_bits):
    rng = np.random.default_rng(n_bits)
    keys = rng.integers(0, 1 << 30, 4096).astype(np.int32)
    # keys whose product with the multiplier overflows 32 bits many times
    keys[:6] = [0, 1, 2, (1 << 30) - 1, (1 << 29) + 12345, 0x2AAAAAAA]
    got = tseed.hash_kmer(_t(keys), n_bits).numpy()
    ref = np.asarray(jseed.hash_kmer_jax(jnp.asarray(keys), n_bits))
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(hash_kmer_np(keys, n_bits), got)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < (1 << n_bits)


def test_query_kmers(small_ds, cfg):
    reads, lens = small_ds.reads[:200].copy(), small_ds.read_lens[:200].copy()
    reads[3, 10] = 4                      # an N inside a read
    lens[5] = 7                           # shorter than k: no valid k-mer
    keys, valid = tseed.query_kmers(_t(reads), _t(lens), TCFG)
    rk, rv = jseed.query_kmers_jax(jnp.asarray(reads), jnp.asarray(lens), cfg)
    np.testing.assert_array_equal(np.asarray(rk), keys.numpy())
    np.testing.assert_array_equal(np.asarray(rv), valid.numpy())
    assert not valid[5].any()


def _both_tables(index):
    return jseed.SeedTable.from_index(index), tseed.SeedTable.from_index(
        index, "cpu")


def test_seed_candidates(small_ds, small_index, cfg):
    reads, lens = small_ds.reads, small_ds.read_lens
    jt, tt = _both_tables(small_index)
    rc = np.asarray(jseed.revcomp_jax(jnp.asarray(reads), jnp.asarray(lens)))
    for q in (reads, rc):
        ref = jseed.seed_candidates_jax(jnp.asarray(q), jnp.asarray(lens), jt,
                                        cfg)
        got = tseed.seed_candidates(_t(q), _t(lens), tt, TCFG)
        assert set(got) == set(ref)
        for k in ("cand_ref", "cand_wstart", "cand_votes", "cand_valid"):
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(),
                                          err_msg=k)
        assert got["cand_valid"].any()


def test_probe_hits_match_chunk_row_probe(small_ds, small_index, cfg):
    # the plain CSR probe and the reference's 128-lane chunk-row probe find
    # the same hits (the reference has extra always-miss slots)
    reads, lens = small_ds.reads[:64], small_ds.read_lens[:64]
    jt, tt = _both_tables(small_index)
    keys, valid = tseed.query_kmers(_t(reads), _t(lens), TCFG)
    bucket = tseed.hash_kmer(keys, tt.n_bits)
    got = tseed.probe(keys, valid, bucket, tt, TCFG).numpy()
    ref = np.asarray(jseed.probe(jnp.asarray(keys.numpy()),
                                 jnp.asarray(valid.numpy()),
                                 jnp.asarray(bucket.numpy()),
                                 jt.bucket_start, jt.entries, cfg))
    assert got.shape[-1] == cfg.bucket_cap
    for b in range(reads.shape[0]):
        g = np.sort(got[b][got[b] != tseed.BIGK])
        r = np.sort(ref[b][ref[b] != tseed.BIGK])
        np.testing.assert_array_equal(r, g)


def test_select_candidates_vote_ties(cfg):
    # equal vote counts order by ascending key; runs split by BIGK misses
    BIG = tseed.BIGK
    rows = [
        [7, 7, 3, 3, 9, 9, 5, BIG, BIG, 1, 1, 1, 50, 50, 8, BIG],
        [BIG] * 16,
        [4, 2, 4, 2, 6, 6, 6, 6, 1, 3, 5, 11, 13, 12, 10, 0],
        [100, 99, 98, 97, 96, 95, 94, 93, 100, 99, 98, 97, 96, 95, 94, 93],
    ]
    ckey = np.array(rows, np.int32).reshape(4, 2, 8)
    ref = jseed.select_candidates(jnp.asarray(ckey), cfg)
    got = tseed.select_candidates(_t(ckey), TCFG)
    for k in ("cand_ref", "cand_wstart", "cand_votes", "cand_valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(),
                                      err_msg=k)
    assert got["cand_votes"][0].tolist() == [3, 2, 2, 2]
    assert not got["cand_valid"][1].any()


def test_gather_windows(small_ds, cfg):
    rng = np.random.default_rng(5)
    R = small_ds.ref_seqs.shape[0]
    W = cfg.window_len
    refs = rng.integers(0, R, (50, 8)).astype(np.int32)
    dbin = rng.integers(0, cfg.n_diag_bins, (50, 8))
    s0 = -cfg.read_len_max + cfg.diag_bin // 2 - cfg.window_margin
    on_grid = (dbin * cfg.diag_bin + s0).astype(np.int32)
    got = tseed.gather_windows(_t(small_ds.ref_seqs), _t(refs), _t(on_grid), W)
    # on-grid starts: the reference's strided table path
    ref = jseed.gather_windows_jax(jnp.asarray(small_ds.ref_seqs),
                                   jnp.asarray(refs), jnp.asarray(on_grid),
                                   W, cfg)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # arbitrary starts, both edges: the general branch
    off = rng.integers(-W - 5, small_ds.ref_seqs.shape[1] + 5,
                       (50, 8)).astype(np.int32)
    got = tseed.gather_windows(_t(small_ds.ref_seqs), _t(refs), _t(off), W)
    ref = jseed.gather_windows_jax(jnp.asarray(small_ds.ref_seqs),
                                   jnp.asarray(refs), jnp.asarray(off), W)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert (got.numpy() == 4).any()


def test_revcomp(small_ds):
    reads = small_ds.reads[:100].copy()
    lens = small_ds.read_lens[:100].copy()
    lens[:3] = [0, 1, reads.shape[1]]
    reads[2] = np.random.default_rng(0).integers(0, 5, reads.shape[1])
    got = tseed.revcomp(_t(reads), _t(lens)).numpy()
    ref = np.asarray(jseed.revcomp_jax(jnp.asarray(reads), jnp.asarray(lens)))
    np.testing.assert_array_equal(ref, got)
    assert got.dtype == np.int8
