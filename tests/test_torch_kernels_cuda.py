"""The hand-written CUDA SW kernels == their plain PyTorch twin, on the card:
K1-K3 (`ops.sw_cuda`) and the bench kernels S1 (every variant) and S2
(`ops.sw_variants`).

Needs an NVIDIA GPU (sm_90a) and nvcc; every test here skips with a reason
elsewhere. The file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Kernel and twin get the same inputs on the card and must agree bit for bit;
256 pairs are also held against the port's NumPy oracle
`rambl_tpu_torch.oracle.sw`.
"""

import numpy as np
import pytest
import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.oracle.sw import sw_batch, traceback_batch
from rambl_tpu_torch.ops import sw as tsw
from rambl_tpu_torch.ops import sw_cuda
from rambl_tpu_torch.ops import sw_variants as sv
from rambl_tpu_torch.utils.sw_cases import (
    gapped_pairs,
    planted_pairs,
    short_reads,
)

SC = ScoringParams()
L, W, ROWS = 128, 160, 104           # the align step's shapes at sw_rows=104

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (their CPU twins are tested in test_torch_sw.py)")
    return torch.device("cuda", 0)


def _on(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("rows", [0, ROWS])
def test_score_kernel_matches_twin(dev, rows):
    if rows:
        q, w = short_reads(0, 4096, L, W, rows, min_len=60)
    else:
        q, w = planted_pairs(0, 4096, L, W)
    qt, wt = _on(dev, q, w)
    before = sw_cuda.LAUNCHES["score"]
    got = sw_cuda.sw_score_cuda(qt, wt, SC, rows=rows)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES["score"] == before + 1
    _equal(got, tsw.sw_score(qt[:, :rows or L], wt, SC))


def test_score_kernel_matches_oracle(dev):
    q, w = planted_pairs(1, 256, L, W)
    got = sw_cuda.sw_score_cuda(*_on(dev, q, w), SC)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(r, g.cpu().numpy())


def test_align_traceback_kernels_match_twin(dev):
    q, w = gapped_pairs(2, 1024, ROWS, W)
    q = np.concatenate([q, np.full((1024, L - ROWS), 4, np.int8)], axis=1)
    q = np.concatenate([q, np.full((128, L), 4, np.int8)])     # all-N block
    w = np.concatenate([w, np.full((128, W), 4, np.int8)])
    qt, wt = _on(dev, q, w)
    s, ie, je, dirs = sw_cuda.sw_align_cuda(qt, wt, SC, ROWS)
    ref = tsw.sw_align(qt[:, :ROWS], wt, SC)
    _equal((s, ie, je, dirs.permute(0, 2, 1)), ref)
    rc = sw_cuda.sw_traceback_cuda(dirs, ie, je, L, W)
    _equal([rc], [tsw.sw_traceback(ref[3], ref[1], ref[2], L, W)])
    assert (s[-128:] == 0).all() and (rc[-128:] == -1).all()
    got = sw_cuda.sw_align_traceback_cuda(qt, wt, SC, ROWS, L, W)
    _equal(got, (s, ie, je, rc))


def test_traceback_kernel_matches_oracle(dev):
    q, w = gapped_pairs(3, 256, L, W)
    _, _, _, rc = sw_cuda.sw_align_traceback_cuda(*_on(dev, q, w), SC, 0, L, W)
    _, ie, je, dirp = sw_batch(q, w, SC, want_dirs=True)
    np.testing.assert_array_equal(traceback_batch(dirp, ie, je, L),
                                  rc.cpu().numpy())


def test_kernel_wrappers_reject_bad_inputs(dev):
    q, w = _on(dev, *planted_pairs(4, 8, L, W))
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_score_cuda(q.to(torch.int32), w, SC)
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_score_cuda(q.t().contiguous().t(), w, SC)
    with pytest.raises(ValueError, match="different devices"):
        sw_cuda.sw_score_cuda(q, w.cpu(), SC)
    with pytest.raises(ValueError, match="multiples of 4"):
        sw_cuda.sw_score_cuda(q[:, :126].contiguous(), w, SC)
    _, ie, je, dirs = sw_cuda.sw_align_cuda(q, w, SC)
    with pytest.raises(ValueError, match="int32"):
        sw_cuda.sw_traceback_cuda(dirs, ie.long(), je, L, W)


S1_L, S1_W = 128, 161                # the S1 sweep's shapes (odd W)


@pytest.mark.parametrize("variant", sv.VARIANTS, ids=lambda v: v.name)
def test_variant_kernel_matches_twin(dev, variant):
    q, w = planted_pairs(5, 4096 + 37, S1_L, S1_W)   # a ragged last block
    qt, wt = _on(dev, q, w)
    fn = sv.make_score_fn(SC, S1_L, S1_W, threads=variant.threads,
                          unroll=variant.unroll, stage_q=variant.stage_q)
    before = sv.LAUNCHES["variant"]
    got = fn(qt, wt)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["variant"] == before + 1
    _equal(got, tsw.sw_score(qt, wt, SC))
    for g, r in zip(got, sw_batch(q[:256], w[:256], SC, want_dirs=False)):
        np.testing.assert_array_equal(r, g[:256].cpu().numpy())


def test_pretransposed_kernel_matches_twin(dev):
    rng = np.random.default_rng(6)
    n, W = 4096 + 37, 160
    qT = rng.integers(0, 5, (L, n)).astype(np.int32)
    wT = rng.integers(0, 4, (W + L + 1, n)).astype(np.int32)
    wT[2:L - 6, : n // 3] = qT[1:L - 7, : n // 3] % 4     # planted homology
    qT[:, -64:] = 4                                      # no positive cell
    qt, wt = _on(dev, qT, wT)
    before = sv.LAUNCHES["pretransposed"]
    key = sv.score_pretransposed(qt, wt, SC, W)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["pretransposed"] == before + 1
    _equal([key], [tsw.sw_raw_key(qt.t().contiguous(),
                                  wt[:W].t().contiguous(), SC)])
    assert (key[-64:] == key[-1]).all() and int(key[-1]) < 0
    ref = sw_batch(qT[:, :256].T.astype(np.int8), wT[:W, :256].T.astype(
        np.int8), SC, want_dirs=False)
    for g, r in zip(sv.decode_raw_key(key[:256], W), ref[:3]):
        np.testing.assert_array_equal(r, g.cpu().numpy())


def test_bench_wrappers_reject_bad_inputs(dev):
    q, w = _on(dev, *planted_pairs(7, 8, S1_L, S1_W))
    fn = sv.make_score_fn(SC, S1_L, S1_W)
    with pytest.raises(ValueError, match="int8"):
        fn(q.to(torch.int32), w)
    with pytest.raises(ValueError, match="different devices"):
        fn(q, w.cpu())
    qT, wT = sv.prep(q[:, :L].contiguous(), w[:, :W].contiguous())
    with pytest.raises(ValueError, match="int32"):
        sv.score_pretransposed(qT.to(torch.int8), wT, SC, W)
    with pytest.raises(ValueError, match="int32"):
        sv.score_pretransposed(qT.t().contiguous().t(), wT, SC, W)
