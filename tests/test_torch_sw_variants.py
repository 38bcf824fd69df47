"""The bench kernels' plain versions == the Pallas kernels in interpret mode.

S1: the plain path of `rambl_tpu_torch.ops.sw_variants.make_score_fn`'s
`score` against `make_score_fn(...)(q, w, interpret=True)` of
`scripts/bench_sw_variants.py` (loaded by path, unedited) for several TPU
variant settings, and against the NumPy oracle. S2: `score_pretransposed`'s
plain raw key against a `pl.pallas_call` of `rambl_tpu.ops.sw_pallas.
_score_kernel` in interpret mode, built as `scripts/ablate_prep.py` builds it.
The strip kernel's schedule in its 16-bit arithmetic (`ops.sw.
sw_score_strips`, 1, 2 and 4 strips) against all of them: ties, all-N pairs,
rows that are not whole q words, and S2's codes compared as given (4 == 4,
-1, 256 against 0, 1000 on both sides). Same numpy inputs made from a seed;
integers only, no tolerance. The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_kernels_cuda.py).
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
from rambl_tpu_torch.ops import sw as tsw
from rambl_tpu_torch.ops import sw_variants as sv
from rambl_tpu_torch.utils.sw_cases import adversarial_pairs, planted_pairs

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
    fn = sv.make_score_fn(SC, 16, 25, strips=4, warps=4, arith="s32")
    got = fn(torch.from_numpy(q), torch.from_numpy(w))
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert (got[0][:8] == 0).all() and (got[1][:8] == 0).all()


@pytest.mark.parametrize("variant", sv.VARIANTS[::5], ids=lambda v: v.name)
def test_s1_plain_matches_oracle(s1_pairs, variant):
    q, w = s1_pairs
    fn = sv.make_score_fn(SC, 16, 25, strips=variant.strips,
                          warps=variant.warps, arith=variant.arith)
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
    assert {v.block_pairs for v in sv.VARIANTS} == {8, 16, 32, 64, 128, 256}
    assert sv.S2_VARIANT.block_pairs == 32
    # the layout of csrc/sw_variants.cu::StripLayout at 128 rows
    assert sv.Variant(2, 1, "s16x2").smem_bytes(128) == (
        129 * 16 * 8 + 2 * 2 * 17 * 16 * 4 + 32 * 36)
    assert sv.Variant(4, 4, "s32").smem_bytes(128) == (
        4 * (131 * 8 * 8 + 4 * 9 * 8 * 4) + 32 * 36)
    assert sv.S2_VARIANT.smem_bytes(128) == (
        4 * (135 * 4 * 8 + 2 * 8 * 5 * 4 * 4) + 32 * 36)
    with pytest.raises(ValueError, match="no S1 kernel"):
        sv.make_score_fn(SC, 16, 25, strips=3)
    with pytest.raises(ValueError, match="no S1 kernel"):
        sv.make_score_fn(SC, 16, 25, warps=2)
    with pytest.raises(ValueError, match="no S1 kernel"):
        sv.make_score_fn(SC, 16, 25, arith="s8")
    for old in (dict(threads=128), dict(unroll=4), dict(stage_q=True)):
        with pytest.raises(ValueError, match="strips, warps and arith"):
            sv.make_score_fn(SC, 16, 25, **old)
    with pytest.raises(ValueError, match="multiple of 4"):
        sv.make_score_fn(SC, 18, 25)
    with pytest.raises(ValueError, match="best-key overflow"):
        sv.make_score_fn(SC, 128, 255)
    with pytest.raises(ValueError, match="16-bit"):
        sv.make_score_fn(ScoringParams(match=300), 128, 100)
    with pytest.raises(ValueError, match="shared memory"):
        sv.make_score_fn(ScoringParams(match=0), 224, 100, strips=1, warps=4)
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
    with pytest.raises(ValueError, match="16-bit"):
        sv.score_pretransposed(qT, torch.zeros((40, 4), dtype=torch.int32),
                               ScoringParams(match=300), 24)


# ---- the strip kernel's schedule (ops.sw.sw_score_strips) ------------------

def _tie_pairs(B, L, W):
    """A block of five equal bases in q (rows 4-8) that w repeats, so that
    cells of several rows and columns tie in H; the first copy must win."""
    q = np.full((B, L), 4, np.int8)
    w = np.full((B, W), 5, np.int8)
    q[:, 3:8] = 1
    for b in range(B):
        for rep in range(min(b % 3 + 1, (W - 2) // 9)):
            w[b, 2 + 9 * rep:7 + 9 * rep] = 1
    return q, w


def _strip_pairs(L, W):
    """Planted pairs, ties, all-N pairs and, where the shape allows,
    utils.sw_cases.adversarial_pairs."""
    q, w = planted_pairs(L * 7 + W, 24, L, W)
    q[:4] = 4                                   # all-N queries
    w[4:6] = 4                                  # all-N windows
    qt, wt = _tie_pairs(8, L, W)
    parts = [(q, w), (qt, wt)]
    if W >= max(L, 34):
        parts.append(adversarial_pairs(L + W, L, W, per_case=4))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("strips,L,W", [
    (1, 16, 24), (2, 16, 24), (4, 16, 24), (1, 16, 25), (2, 16, 25),
    (4, 16, 25), (1, 128, 161), (2, 104, 160), (4, 128, 161), (4, 104, 160),
])
def test_strip_schedule_matches_twin_and_oracle(strips, L, W):
    q, w = _strip_pairs(L, W)
    got = tsw.sw_score_strips(torch.from_numpy(q), torch.from_numpy(w), SC,
                              strips)
    want = tsw.sw_score(torch.from_numpy(q), torch.from_numpy(w), SC)
    oracle = sw_batch(q, w, SC, want_dirs=False)[:3]
    for g, t, o in zip(got, want, oracle):
        assert g.dtype == torch.int32
        assert torch.equal(g, t)
        np.testing.assert_array_equal(o, g.numpy())
    assert (got[0][:4] == 0).all() and (got[0][24:32] == 5).all()
    assert (got[1][24:32] == 8).all() and (got[2][24:32] == 7).all()


@pytest.fixture(scope="module")
def s1_interpret(tpu_sweep, s1_pairs):
    q, w = s1_pairs
    return [np.asarray(r) for r in tpu_sweep.make_score_fn(
        JSC, 16, 25, preshift=False, phases=False, rowkey=False)(
            jnp.asarray(q), jnp.asarray(w), interpret=True)]


@pytest.mark.parametrize("strips", [1, 2, 4])
def test_strip_schedule_matches_s1_pallas_interpret(s1_pairs, s1_interpret,
                                                    strips):
    q, w = s1_pairs
    got = tsw.sw_score_strips(torch.from_numpy(q), torch.from_numpy(w), SC,
                              strips)
    for r, g in zip(s1_interpret, got):
        np.testing.assert_array_equal(r, g.numpy())


def _s2_trap_codes(L, W):
    """Batch-minor int32 codes of one Pallas tile with S2's traps: 4 == 4,
    -1 == -1, 256 against 0 (equal in a byte, not as codes), 1000 on both
    sides, plus planted homology and pairs with no positive cell."""
    rng = np.random.default_rng(L * 3 + W)
    qT = rng.integers(0, 5, (L, TILE)).astype(np.int32)
    wT = rng.integers(0, 5, (W + L + 1, TILE)).astype(np.int32)
    n = min(L, W) - 2
    qT[:, :32] %= 4                             # the oracle's codes
    wT[:, :32] %= 4
    wT[1:1 + n, :32] = qT[:n, :32]              # planted homology
    qT[:, 32:40], wT[:, 32:40] = 4, 4           # 4 == 4 matches in S2
    qT[:, 40:48], wT[:, 40:48] = -1, -1
    qT[:, 48:56], wT[:, 48:56] = 256, 0         # never equal
    qT[::2, 56:64], wT[::3, 56:64] = 1000, 1000
    qT[:, -16:], wT[:, -16:] = 7, 9             # no positive cell
    return qT, wT


@pytest.fixture(scope="module", params=[(16, 24), (14, 25)],
                ids=["L16-W24", "L14-W25"])
def s2_case(request):
    L, W = request.param
    qT, wT = _s2_trap_codes(L, W)
    return L, W, qT, wT, _pallas_raw_key(qT, wT, L, W)


@pytest.mark.parametrize("strips", [1, 2, 4, 8])
def test_strip_schedule_raw_key_matches_s2_pallas_interpret(s2_case, strips):
    L, W, qT, wT, ref = s2_case
    q, w = torch.from_numpy(qT.T.copy()), torch.from_numpy(wT[:W].T.copy())
    got = tsw.sw_score_strips(q, w, SC, strips, raw_key=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref, got.numpy())
    assert torch.equal(got, tsw.sw_raw_key(q, w, SC))
    assert torch.equal(got, sv.score_pretransposed(
        torch.from_numpy(qT), torch.from_numpy(wT), SC, W))
    assert (got[-16:] == -(W + 2)).all()
    assert (got[48:56] == -(W + 2)).all()       # 256 never equals 0
    assert (got[32:48] > 0).all()               # 4 == 4 and -1 == -1 score
    # decoded, and where the codes are the oracle's, its best cells
    ok = ((qT >= 0) & (qT < 4)).all(axis=0) & ((wT[:W] >= 0)
                                                 & (wT[:W] < 4)).all(axis=0)
    ref_d = sw_batch(qT.T.astype(np.int8), wT[:W].T.astype(np.int8), SC,
                     want_dirs=False)
    for r, g in zip(ref_d[:3], sv.decode_raw_key(got, W)):
        np.testing.assert_array_equal(r[ok], g.numpy()[ok])
    assert ok.sum() >= 32
