"""The fused K2 + K3 kernel's schedule in plain PyTorch == the references.

`rambl_tpu_torch.ops.sw.sw_align_traceback_lanes` runs the CUDA kernel
`csrc/sw.cu::sw_align_traceback_kernel` step for step: a warp a pair, R
rows a lane (4 or 8), the row above a lane's strip handed on in one packed
word, the direction codes in a padded [column][lane] buffer, a best key a
lane and the walk over that buffer. Here it is held, at R = 4 and R = 8,
against the port's twins (`ops.sw.sw_align` + `sw_traceback`), the JAX
package's Pallas kernels in interpret mode (`sw_align_pallas` +
`sw_traceback_packed`) and the NumPy oracle (`rambl_tpu.oracle.sw`), on the
same numpy inputs made from a seed. All outputs are integers: no tolerance.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rambl_tpu.config import ScoringParams as JScoring
from rambl_tpu.ops.sw_pallas import sw_align_pallas, sw_traceback_packed
from rambl_tpu.oracle.sw import sw_batch, traceback_batch
from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.ops import sw as tsw
from rambl_tpu_torch.utils.sw_cases import (
    ADVERSARIAL,
    adversarial_pairs,
    gapped_pairs,
    short_reads,
)

SC = ScoringParams()
JSC = JScoring()


def _case(name):
    """(q, w, rows) numpy int8 codes; rows = 0 sweeps every query row."""
    if name == "gapped":
        return (*gapped_pairs(0, 48, 24, 32), 0)
    if name == "gapped-rows16":
        return (*gapped_pairs(1, 40, 24, 32), 16)
    if name == "short-rows8":
        return (*short_reads(2, 40, 16, 24, 8, min_len=4), 8)
    if name == "short-last-lane":         # 20 rows: 3 lanes of 8, the last 4
        return (*gapped_pairs(3, 33, 20, 28), 0)
    if name == "one-pair":
        return (*gapped_pairs(4, 1, 24, 32), 0)
    if name == "odd-n-all-n":             # 37 pairs, the last three all N
        q, w = gapped_pairs(5, 37, 16, 24)
        q[-3:], w[-3:] = 4, 4
        return q, w, 0
    k = ADVERSARIAL.index(name)
    q, w = adversarial_pairs(6, 16, 40, per_case=12)
    return q[k * 12:(k + 1) * 12], w[k * 12:(k + 1) * 12], 0


CASES = ["gapped", "gapped-rows16", "short-rows8", "short-last-lane",
         "one-pair", "odd-n-all-n", *ADVERSARIAL]


def _lanes(q, w, rows, R):
    L = q.shape[1]
    return [t.numpy() for t in tsw.sw_align_traceback_lanes(
        torch.from_numpy(np.ascontiguousarray(q[:, :rows or L])),
        torch.from_numpy(w), SC, R, L=L)]


def _twins(q, w, rows):
    L, W = q.shape[1], w.shape[1]
    s, ie, je, dirs = tsw.sw_align(
        torch.from_numpy(np.ascontiguousarray(q[:, :rows or L])),
        torch.from_numpy(w), SC)
    return [t.numpy() for t in (s, ie, je,
                                tsw.sw_traceback(dirs, ie, je, L, W))]


def _assert_all_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("case", CASES)
def test_lanes_match_twins_and_oracle(case, R):
    q, w, rows = _case(case)
    got = _lanes(q, w, rows, R)
    assert all(g.dtype == np.int32 for g in got)
    _assert_all_equal(_twins(q, w, rows), got)
    qr = np.ascontiguousarray(q[:, :rows or q.shape[1]])
    s, ie, je, dirs = sw_batch(qr, w, SC, want_dirs=True)
    _assert_all_equal([s, ie, je, traceback_batch(dirs, ie, je, q.shape[1])],
                      got)
    if case in ("odd-n-all-n", "all-mismatch"):
        n = 3 if case == "odd-n-all-n" else len(q)
        assert not got[0][-n:].any() and (got[3][-n:] == -1).all()
    if case == "equal":
        assert (got[0] == 16).all()
    if case == "ties":                  # the first block's end cell wins
        assert (got[1] == 8).all() and (got[2] == 7).all()


@pytest.mark.parametrize("R,seed,L,W,rows", [(4, 6, 24, 24, 0),
                                             (8, 7, 32, 40, 24)])
def test_lanes_match_pallas_interpret(R, seed, L, W, rows):
    # as tests/test_torch_sw.py runs the TPU kernels: 128 pairs (one tile)
    if rows:
        q, w = short_reads(seed, 128, L, W, rows - 8)
    else:
        q, w = gapped_pairs(seed, 128, L, W)
    s, ie, je, packed = sw_align_pallas(q, w, JSC, interpret=True, rows=rows)
    rc = sw_traceback_packed(packed, ie, je, L, W)
    _assert_all_equal([np.asarray(x) for x in (s, ie, je, rc)],
                      _lanes(q, w, rows, R))


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 9),
       rows=st.integers(1, 12).map(lambda k: 4 * k),
       W=st.integers(4, 40), R=st.sampled_from([4, 8]))
def test_lanes_sweep(seed, n, rows, W, R):
    q, w = gapped_pairs(seed, n, rows, W)
    _assert_all_equal(_twins(q, w, 0), _lanes(q, w, 0, R))


@pytest.mark.parametrize("R", [4, 8])
def test_nib_stride_meets_no_bank_twice(R):
    # at step t lane l writes word (t - l) * S + l of R * 4 bits; the 32
    # lanes' 4-byte words must fall in 32 different banks
    for lanes in range(1, 33):
        S = tsw.nib_stride(lanes, R)
        assert lanes <= S <= lanes + 3
        for t in range(40):
            words = [((t - l) * S + l) * R * 4 // 32 for l in range(32)]
            assert len({x % 32 for x in words}) == 32, (lanes, t)


def test_lanes_contract():
    q = torch.zeros((2, 12), dtype=torch.int8)
    w = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="does not fit a warp"):
        tsw.sw_align_traceback_lanes(q, w, SC, 6)
    with pytest.raises(ValueError, match="does not fit a warp"):
        tsw.sw_align_traceback_lanes(torch.zeros((1, 132), dtype=torch.int8),
                                     w[:1], SC, 4)
