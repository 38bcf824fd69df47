"""The port's align step, binning, pileup and read stream == the JAX
reference, bit for bit.

`rambl_tpu_torch.pipeline.{align,binning,pileup,assemble}` against
`rambl_tpu.pipeline.{align,binning,pileup}` and
`rambl_tpu.pipeline.assemble._stream_align` on the shared `small_ds` mock
community (600 reads of 100 bp, 10 references, 28 taxonomy nodes). Each
package gets its own config class built from the same fields. Torch runs on
CPU tensors, where the SW wrappers take their plain PyTorch twins. All
outputs are integers: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.ops.seed import SeedTable as JSeedTable
from rambl_tpu.pipeline import align as jalign
from rambl_tpu.pipeline import binning as jbinning
from rambl_tpu.pipeline import pileup as jpileup
from rambl_tpu.pipeline.assemble import _stream_align
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.ops.seed import SeedTable as TSeedTable
from rambl_tpu_torch.parallel.mesh import data_mesh
from rambl_tpu_torch.pipeline import align as talign
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.pipeline import binning as tbinning
from rambl_tpu_torch.pipeline import pileup as tpileup
from rambl_tpu_torch.utils.errors import UserError

N_ALIGN = 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _align_both(ds, index, **cfg_fields):
    reads, lens = ds.reads[:N_ALIGN], ds.read_lens[:N_ALIGN]
    ref = jalign.align_batch(jnp.asarray(reads), jnp.asarray(lens),
                             JSeedTable.from_index(index),
                             jnp.asarray(ds.ref_seqs), JConfig(**cfg_fields))
    got = talign.align_batch(_t(reads), _t(lens),
                             TSeedTable.from_index(index, "cpu"),
                             _t(ds.ref_seqs), TConfig(**cfg_fields))
    return ref, got


def _assert_records_equal(ref, got):
    assert got._fields == ref._fields
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)


@pytest.fixture(scope="module")
def records(small_ds, small_index):
    """JAX and port records of the first 256 reads, and how many best pairs
    the port sent through the gapped (direction-bit) traceback."""
    calls = []
    real = talign.sw_align_traceback_cuda

    def counting(q, *a):
        calls.append(q.shape[0])
        return real(q, *a)

    talign.sw_align_traceback_cuda = counting
    try:
        ref, got = _align_both(small_ds, small_index)
    finally:
        talign.sw_align_traceback_cuda = real
    return ref, got, sum(calls)


def test_align_batch_records(records):
    ref, got, n_gapped = records
    _assert_records_equal(ref, got)
    assert got.aligned.float().mean() > 0.9
    assert n_gapped > 0          # the K2 + K3 branch ran
    np.testing.assert_array_equal(np.asarray(jalign.mapping_quality(ref)),
                                  talign.mapping_quality(got).numpy())


def test_align_batch_sw_rows(small_ds, small_index):
    # the presets' 104-row sweep over 128-padded 100 bp reads is exact
    _assert_records_equal(*_align_both(small_ds, small_index, sw_rows=104))


def test_align_batch_row_check_only_for_direct_callers(small_ds, small_index,
                                                       small_tax):
    # a direct caller's batch is checked on the device; the stream checks
    # its host lengths once and passes check_rows=False (no sync a batch)
    reads, lens = small_ds.reads[:8].copy(), small_ds.read_lens[:8].copy()
    lens[3] = 110
    args = (_t(reads), _t(lens), TSeedTable.from_index(small_index, "cpu"),
            _t(small_ds.ref_seqs), TConfig(sw_rows=104))
    with pytest.raises(UserError, match="sw_rows=104"):
        talign.align_batch(*args)
    talign.align_batch(*args, check_rows=False)
    calls = []
    real = talign.check_sw_rows
    talign.check_sw_rows = lambda *a: calls.append(a)
    try:
        tassemble.stream_align(small_ds.reads[:80], small_ds.read_lens[:80],
                               small_index, small_ds.ref_seqs,
                               small_ds.ref_lens, small_tax,
                               TConfig(batch_size=32, sw_rows=104),
                               device="cpu")
        talign.align_batch(*args)
    finally:
        talign.check_sw_rows = real
    assert len(calls) == 1                      # the direct call's only
    with pytest.raises(UserError, match="sw_rows=104"):
        tassemble.stream_align(reads, lens, small_index, small_ds.ref_seqs,
                               small_ds.ref_lens, small_tax,
                               TConfig(batch_size=32, sw_rows=104),
                               device="cpu")


def test_check_sw_rows():
    cfg = TConfig(sw_rows=104)
    talign.check_sw_rows(torch.tensor([100, 104], dtype=torch.int32), cfg)
    with pytest.raises(UserError, match="sw_rows=104"):
        talign.check_sw_rows(torch.tensor([100, 105], dtype=torch.int32), cfg)
    talign.check_sw_rows(torch.tensor([200], dtype=torch.int32),
                         TConfig())


def test_lca_of_set_ties(small_tax):
    rng = np.random.default_rng(2)
    nodes = rng.integers(0, small_tax.n_nodes, (64, 8)).astype(np.int32)
    valid = rng.random((64, 8)) < 0.4
    valid[:4] = False                    # no valid candidate -> 0
    nodes[4:8] = nodes[4:8, :1]          # one node repeated -> that node
    valid[4:8] = True
    ref = jbinning.lca_of_set_jax(jnp.asarray(small_tax.anc_path),
                                  jnp.asarray(small_tax.depth),
                                  jnp.asarray(nodes), jnp.asarray(valid))
    got = tbinning.lca_of_set(_t(small_tax.anc_path), _t(small_tax.depth),
                              _t(nodes), _t(valid))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert (got[:4] == 0).all()
    np.testing.assert_array_equal(got[4:8].numpy(), nodes[4:8, 0])


def test_bin_batch(records, small_tax, cfg):
    ref, got, _ = records
    tax = small_tax
    rb = jbinning.bin_batch(ref, jnp.asarray(tax.ref_taxon),
                            jnp.asarray(tax.anc_path), jnp.asarray(tax.depth),
                            cfg)
    gb = tbinning.bin_batch(got, _t(tax.ref_taxon), _t(tax.anc_path),
                            _t(tax.depth), TConfig())
    np.testing.assert_array_equal(np.asarray(rb), gb.numpy())
    assert gb.dtype == torch.int32 and (gb >= 0).any()


@pytest.mark.parametrize("rc_dtype", [np.int32, np.int16])
def test_node_pileup(records, small_ds, small_tax, cfg, rc_dtype):
    ref, _, _ = records
    tax = small_tax
    bins = np.array(jbinning.bin_batch(
        ref, jnp.asarray(tax.ref_taxon), jnp.asarray(tax.anc_path),
        jnp.asarray(tax.depth), cfg))
    bins[::7] = -1                       # unbinned reads scatter nothing
    query = np.asarray(ref.query)
    ref_col = np.asarray(ref.ref_col).astype(rc_dtype)
    n_nodes, ref_len = tax.n_nodes, small_ds.ref_seqs.shape[1]
    rc, rs = jpileup.node_pileup(jnp.asarray(query), jnp.asarray(ref_col),
                                 jnp.asarray(bins), n_nodes, ref_len)
    gc, gs = tpileup.node_pileup(_t(query), _t(ref_col), _t(bins), n_nodes,
                                 ref_len)
    np.testing.assert_array_equal(np.asarray(rc), gc.numpy())
    np.testing.assert_array_equal(np.asarray(rs), gs.numpy())
    assert gc.dtype == gs.dtype == torch.int32
    ok = (ref_col >= 0) & (query < 4) & (bins[:, None] >= 0)
    assert int(gc.sum()) == int(ok.sum()) > 0
    assert int(gs.sum()) == 0            # every +1 has its -1


@pytest.mark.parametrize("mode", ["dense", "slot"])
def test_stream_align(small_ds, small_index, small_tax, mode):
    # 600 reads in batches of 256: the last batch is padded with empty reads
    ds = small_ds
    fields = dict(batch_size=256, sw_rows=104)
    if mode == "slot":
        fields["pileup_slot_nodes"] = small_tax.n_nodes - 1
    ref = _stream_align(ds.reads, ds.read_lens, small_index, ds.ref_seqs,
                        ds.ref_lens, small_tax, JConfig(**fields))
    got = tassemble.stream_align(ds.reads, ds.read_lens, small_index,
                                 ds.ref_seqs, ds.ref_lens, small_tax,
                                 TConfig(**fields), device="cpu")
    merged_r, merged_g = ref[0], got[0]
    assert list(merged_g) == list(merged_r)
    for k in merged_r:
        r, g = np.asarray(merged_r[k]), merged_g[k].numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, k
        np.testing.assert_array_equal(r, g, err_msg=k)
    assert merged_g["ref_col"].dtype == torch.int16
    if mode == "slot":
        assert ref[1] is ref[2] is got[1] is got[2] is None
    for r, g in zip(ref[1:], got[1:]):
        if r is not None:
            np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert int(got[3].sum()) == int((merged_g["bins"] >= 0).sum())


def test_stream_align_guards(small_ds, small_index, small_tax):
    ds = small_ds
    cfg = TConfig(batch_size=64, sw_rows=96)
    with pytest.raises(UserError, match="sw_rows=96"):
        tassemble.stream_align(ds.reads, ds.read_lens, small_index,
                               ds.ref_seqs, ds.ref_lens, small_tax, cfg,
                               device="cpu")
    # the mesh stream splits every batch evenly over the ranks
    with pytest.raises(UserError, match="must divide the 3-rank mesh"):
        tassemble.stream_align(ds.reads, ds.read_lens, small_index,
                               ds.ref_seqs, ds.ref_lens, small_tax,
                               TConfig(batch_size=64), mesh=data_mesh(
                                   devices=["cpu"] * 3))

