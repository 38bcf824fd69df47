"""The bench kernels' plain versions == the Pallas kernels in interpret mode.

S1: the plain path of `rambl_tpu_torch.ops.sw_variants.make_score_fn`'s
`score` against `make_score_fn(...)(q, w, interpret=True)` of
`scripts/bench_sw_variants.py` (loaded by path, unedited) for several TPU
variant settings, and against the NumPy oracle. S2: `score_pretransposed`'s
plain raw key against a `pl.pallas_call` of `rambl_tpu.ops.sw_pallas.
_score_kernel` in interpret mode, built as `scripts/ablate_prep.py` builds it.
Same numpy inputs made from a seed; integers only, no tolerance. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rambl_tpu.config import ScoringParams as JScoring
from rambl_tpu.ops.sw_pallas import TILE, _score_kernel
from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.oracle.sw import sw_batch
from rambl_tpu_torch.ops import sw_variants as sv
from rambl_tpu_torch.utils.sw_cases import planted_pairs

SC, JSC = ScoringParams(), JScoring()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_sweep():
    spec = importlib.util.spec_from_file_location(
        "bench_sw_variants_tpu",
        os.path.join(REPO, "scripts", "bench_sw_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def s1_pairs():
    # B 256 (two of the TPU kernel's 128-pair tiles), L 16, W 25 (odd);
    # w carries code 4, which must never match, even against q's 4
    q, w = planted_pairs(21, 256, 16, 25)
    q[:8] = 4
    w[:4] = 4
    return q, w


@pytest.mark.parametrize("knobs", [
    dict(preshift=False, phases=False, rowkey=False),
    dict(preshift=True, phases=True, rowkey=False, tile=256),
    dict(preshift=True, phases=True, rowkey=True, mid_unroll=True),
], ids=["plain", "pre+ph-t256", "all3+mu"])
def test_s1_plain_matches_pallas_interpret(tpu_sweep, s1_pairs, knobs):
    q, w = s1_pairs
    ref = tpu_sweep.make_score_fn(JSC, 16, 25, **knobs)(
        jnp.asarray(q), jnp.asarray(w), interpret=True)
    fn = sv.make_score_fn(SC, 16, 25, threads=128, unroll=8, stage_q=True)
    got = fn(torch.from_numpy(q), torch.from_numpy(w))
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert (got[0][:8] == 0).all() and (got[1][:8] == 0).all()


@pytest.mark.parametrize("variant", sv.VARIANTS[::5], ids=lambda v: v.name)
def test_s1_plain_matches_oracle(s1_pairs, variant):
    q, w = s1_pairs
    fn = sv.make_score_fn(SC, 16, 25, threads=variant.threads,
                          unroll=variant.unroll, stage_q=variant.stage_q)
    got = fn(torch.from_numpy(q), torch.from_numpy(w))
    for r, g in zip(sw_batch(q, w, SC, want_dirs=False)[:3], got):
        np.testing.assert_array_equal(r, g.numpy())


def _pallas_raw_key(qT, wT, L, W):
    """`scripts/ablate_prep.py::kernel_only`, in interpret mode: the raw
    best key of every pair (row 0 of each output tile)."""
    nb = qT.shape[1] // TILE
    kern = functools.partial(_score_kernel, sc=JSC, L=L, W=W)
    out = pl.pallas_call(
        kern,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec((L, TILE), lambda t: (0, t), memory_space=pltpu.VMEM),
            pl.BlockSpec((W + L + 1, TILE), lambda t: (0, t),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 8, TILE), lambda t: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nb, 8, TILE), jnp.int32),
        scratch_shapes=[pltpu.VMEM((L, TILE), jnp.int32)] * 6,
        interpret=True,
    )(jnp.asarray(qT), jnp.asarray(wT))
    return np.asarray(out)[:, 0, :].reshape(-1)


@pytest.mark.parametrize("L,W", [(16, 24), (8, 30)])
def test_s2_raw_key_matches_pallas_interpret(L, W):
    rng = np.random.default_rng(L + W)
    qT = rng.integers(0, 5, (L, TILE)).astype(np.int32)
    wT = rng.integers(0, 5, (W + L + 1, TILE)).astype(np.int32)
    n = min(L, W) - 2
    wT[1:1 + n, :40] = qT[:n, :40]          # planted homology
    qT[:, -16:] = 4                          # against w without 4s below:
    wT[:, -16:] %= 4                         # no positive cell at all
    ref = _pallas_raw_key(qT, wT, L, W)
    key = sv.score_pretransposed(torch.from_numpy(qT), torch.from_numpy(wT),
                                 SC, W)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(ref, key.numpy())
    assert (key[-16:] == key[-1]).all() and int(key[-1]) < 0
    # decoded, and where w holds no code 4 (S2 matches 4 against 4), the
    # oracle's (score, i_end, j_end)
    got = sv.decode_raw_key(key, W)
    ok = (wT[:W] < 4).all(axis=0)
    ref_d = sw_batch(qT.T.astype(np.int8), wT[:W].T.astype(np.int8), SC,
                     want_dirs=False)
    for r, g in zip(ref_d[:3], got):
        np.testing.assert_array_equal(r[ok], g.numpy()[ok])
    assert ok.sum() >= 16


def test_prep_is_the_scripts_prep():
    rng = np.random.default_rng(8)
    q = rng.integers(0, 5, (12, 16)).astype(np.int8)
    w = rng.integers(0, 5, (12, 20)).astype(np.int8)
    qT, wT = sv.prep(torch.from_numpy(q), torch.from_numpy(w))
    np.testing.assert_array_equal(qT.numpy(), q.astype(np.int32).T)
    np.testing.assert_array_equal(
        wT.numpy(), np.concatenate([w.astype(np.int32),
                                    np.full((12, 17), 4, np.int32)], 1).T)
    assert qT.is_contiguous() and wT.is_contiguous()


def test_variants_and_input_validation():
    assert len(sv.VARIANTS) == 12 and len({v.name for v in sv.VARIANTS}) == 12
    with pytest.raises(ValueError, match="no S1 kernel"):
        sv.make_score_fn(SC, 16, 25, threads=96)
    with pytest.raises(ValueError, match="no S1 kernel"):
        sv.make_score_fn(SC, 16, 25, unroll=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        sv.make_score_fn(SC, 18, 25)
    with pytest.raises(ValueError, match="best-key overflow"):
        sv.make_score_fn(SC, 128, 255)
    with pytest.raises(ValueError, match="shared memory"):
        sv.make_score_fn(SC, 224, 100, threads=256, stage_q=True)
    fn = sv.make_score_fn(SC, 16, 25)
    q = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        fn(q, torch.zeros((4, 24), dtype=torch.int8))
    with pytest.raises(ValueError, match="pair counts"):
        fn(q, torch.zeros((3, 25), dtype=torch.int8))
    qT = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        sv.score_pretransposed(qT, torch.zeros((20, 4), dtype=torch.int32),
                               SC, 24)
    with pytest.raises(ValueError, match=r"\(L, B\)"):
        sv.score_pretransposed(qT, torch.zeros((40, 5), dtype=torch.int32),
                               SC, 24)
