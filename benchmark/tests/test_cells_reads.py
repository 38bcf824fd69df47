"""The device read generator: deterministic in the seed, and the read model
of the port's `data/simulate.py`."""

import numpy as np
import pytest

from benchmark.harness.panel import make_panel
from benchmark.harness.reads import abundances, make_reads

SAMPLE = {"n_reads": 20000, "abundance_sigma": 1.0, "read_len": 100,
          "read_len_max": 128, "sub_error": 0.004, "indel_error": 0.0005}


@pytest.fixture(scope="module")
def panel():
    return make_panel(n_species=6, refs_per_species=3, ref_len_max=2048,
                      leaf_per_ref=True, panel_seed=5)


def test_cells_panel_is_simulate_dataset_panel(panel):
    """The panel of a seed is `simulate_dataset`'s at that seed."""
    from rambl_tpu_torch.data.simulate import simulate_dataset

    ds = simulate_dataset(n_species=6, refs_per_species=3, n_reads=1, seed=5,
                          leaf_per_ref=True)
    for f in ("ref_seqs", "ref_lens", "tax_parent", "tax_depth",
              "ref_taxon"):
        np.testing.assert_array_equal(panel[f], getattr(ds, f))


def test_cells_reads_deterministic_in_seed(panel):
    a = make_reads(panel["ref_seqs"], panel["ref_lens"], SAMPLE, 2 ** 33 + 1,
                   "cpu")
    b = make_reads(panel["ref_seqs"], panel["ref_lens"], SAMPLE, 2 ** 33 + 1,
                   "cpu")
    c = make_reads(panel["ref_seqs"], panel["ref_lens"], SAMPLE, 2 ** 33 + 2,
                   "cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert (a[0] != c[0]).any()
    ab1 = abundances(50, 7, 10, 1.0)
    assert (ab1 > 0).sum() == 10 and abs(ab1.sum() - 1) < 1e-12
    np.testing.assert_array_equal(ab1, abundances(50, 7, 10, 1.0))


def test_cells_reads_follow_the_read_model(panel):
    seqs, lens = panel["ref_seqs"], panel["ref_lens"]
    reads, rlens, ref, pos, strand = make_reads(seqs, lens, SAMPLE, 9, "cpu",
                                                truth=True)
    n, L = SAMPLE["n_reads"], SAMPLE["read_len"]
    assert reads.shape == (n, 128) and reads.dtype == np.int8
    assert set(np.unique(rlens)) <= {L - 1, L}
    assert (reads[:, L:] == 4).all()
    assert ((pos >= 0) & (pos + L <= lens[ref])).all()
    # back to the forward strand, within each read's own length
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    fwd = reads[:, :L].copy()
    for i in np.nonzero(strand == 1)[0]:
        fwd[i, :rlens[i]] = comp[reads[i, :rlens[i]]][::-1]
    frag = seqs[ref[:, None], pos[:, None] + np.arange(L)]
    deleted = rlens == L - 1
    # reads without an indel differ from their fragment by substitutions
    plain = ~deleted & ((fwd == frag).mean(1) > 0.9)
    subs = (fwd[plain] != frag[plain]).mean()
    assert 0.003 < subs < 0.005
    assert abs(strand.mean() - 0.5) < 0.02
    # one indel in 5% of reads, half of them deletions of one base
    assert 0.015 < deleted.mean() < 0.035
    i = np.nonzero(deleted)[0][0]
    same = fwd[i, :L - 1] == frag[i, :L - 1]
    ip = int(np.argmin(same)) if not same.all() else L - 1
    assert (fwd[i, ip:L - 1] == frag[i, ip + 1:L]).mean() > 0.9
    # sampling follows the abundances
    ab = abundances(seqs.shape[0], 9, None, 1.0)
    share = np.bincount(ref, minlength=seqs.shape[0]) / n
    assert np.abs(share - ab).max() < 0.02
