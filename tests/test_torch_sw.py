"""The port's Smith-Waterman twins == the JAX reference, bit for bit.

`rambl_tpu_torch.ops.sw` (the plain PyTorch twin of kernels K1-K3) and the
CPU path of the `ops.sw_cuda` wrappers are held against `rambl_tpu.ops.sw`
(the lax.scan path) and against the Pallas kernels in interpret mode, on the
same numpy inputs made from a seed. All outputs are integers: no tolerance.
"""

import numpy as np
import pytest
import torch

from rambl_tpu.config import ScoringParams as JScoring
from rambl_tpu.ops import sw as jsw
from rambl_tpu.ops.sw_pallas import (
    sw_align_pallas,
    sw_score_pallas,
    sw_traceback_packed,
)
from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.ops import sw as tsw
from rambl_tpu_torch.ops import sw_cuda
from rambl_tpu_torch.utils.sw_cases import (
    ADVERSARIAL,
    adversarial_pairs,
    gapped_pairs,
    planted_pairs,
    short_reads,
)

SC = ScoringParams()      # the port's scoring
JSC = JScoring()          # the same fields, for the JAX package


def _np(*ts):
    return [np.asarray(t) for t in ts]


def _assert_all_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case,seed,B,L,W", [
    ("planted", 0, 96, 32, 48),
    ("planted", 1, 64, 16, 24),
    ("gapped", 2, 96, 40, 56),
    ("all_n", 0, 32, 16, 24),
    ("short", 3, 64, 48, 64),
])
def test_twin_matches_scan(case, seed, B, L, W):
    if case == "all_n":
        q = np.full((B, L), 4, np.int8)
        w = np.full((B, W), 4, np.int8)
    elif case == "short":
        q, w = short_reads(seed, B, L, W, 30)
    else:
        make = planted_pairs if case == "planted" else gapped_pairs
        q, w = make(seed, B, L, W)
    ref_j = jsw.sw_align(q, w, JSC)
    ref = _np(*ref_j)
    got = [t.numpy() for t in tsw.sw_align(torch.from_numpy(q),
                                           torch.from_numpy(w), SC)]
    _assert_all_equal(ref, got)
    _assert_all_equal(ref[:3], [t.numpy() for t in tsw.sw_score(
        torch.from_numpy(q), torch.from_numpy(w), SC)])
    rc_ref = np.asarray(jsw.sw_traceback(ref_j[3], ref_j[1], ref_j[2], L, W))
    rc = tsw.sw_traceback(torch.from_numpy(got[3]), torch.from_numpy(got[1]),
                          torch.from_numpy(got[2]), L, W)
    np.testing.assert_array_equal(rc_ref, rc.numpy())
    if case == "all_n":
        assert (got[0] == 0).all() and (got[1] == 0).all() and (got[2] == 0).all()
        assert (rc.numpy() == -1).all()


@pytest.mark.parametrize("seed,L,W", [(0, 32, 48), (1, 16, 24)])
def test_score_wrapper_matches_pallas_interpret(seed, L, W):
    q, w = planted_pairs(seed, 128, L, W)
    ref = _np(*sw_score_pallas(q, w, JSC, interpret=True))
    got = sw_cuda.sw_score_cuda(torch.from_numpy(q), torch.from_numpy(w), SC)
    _assert_all_equal(ref, [t.numpy() for t in got])


def test_score_wrapper_multi_tile():
    # 256 pairs: two of the TPU kernel's 128-pair tiles
    rng = np.random.default_rng(3)
    q = rng.integers(0, 5, (256, 24)).astype(np.int8)
    w = rng.integers(0, 5, (256, 32)).astype(np.int8)
    ref = _np(*sw_score_pallas(q, w, JSC, interpret=True))
    got = sw_cuda.sw_score_cuda(torch.from_numpy(q), torch.from_numpy(w), SC)
    _assert_all_equal(ref, [t.numpy() for t in got])


def test_score_wrapper_rows_truncation():
    # rows=24 over 32-padded queries whose reads are <= 20 long equals the
    # full DP, including the tie-break position of the end cell
    q, w = short_reads(4, 128, 32, 40, 20)
    ref = _np(*sw_score_pallas(q, w, JSC, interpret=True, rows=24))
    full = _np(*jsw.sw_score(q, w, JSC))
    got = sw_cuda.sw_score_cuda(torch.from_numpy(q), torch.from_numpy(w), SC,
                                rows=24)
    _assert_all_equal(ref, [t.numpy() for t in got])
    _assert_all_equal(full, [t.numpy() for t in got])


@pytest.mark.parametrize("seed,L,W,rows", [(6, 24, 24, 0), (7, 32, 40, 24)])
def test_align_traceback_wrapper_matches_pallas_interpret(seed, L, W, rows):
    if rows:
        q, w = short_reads(seed, 128, L, W, rows - 8)
    else:
        q, w = gapped_pairs(seed, 128, L, W)
    s1, ie1, je1, packed = sw_align_pallas(q, w, JSC, interpret=True,
                                           rows=rows)
    rc1 = sw_traceback_packed(packed, ie1, je1, L, W)
    got = sw_cuda.sw_align_traceback_cuda(
        torch.from_numpy(q), torch.from_numpy(w), SC, rows, L, W)
    _assert_all_equal(_np(s1, ie1, je1, rc1), [t.numpy() for t in got])
    # and the scan reference over the full L rows
    s0, ie0, je0, dirs0 = jsw.sw_align(q, w, JSC)
    rc0 = jsw.sw_traceback(dirs0, ie0, je0, L, W)
    _assert_all_equal(_np(s0, ie0, je0, rc0), [t.numpy() for t in got])


def _walk_steps(dirs, i, j):
    """Steps of one pair's traceback, walked cell by cell (dirs (D, Lk))."""
    st, n = (0 if i > 0 and j > 0 else 3), 0
    while st != 3:
        p = int(dirs[i + j - 2, i - 1])
        n += 1
        if st == 0:
            if p & 3 == tsw.CH_DIAG:
                i, j = i - 1, j - 1
            st = {tsw.CH_ZERO: 3, tsw.CH_DIAG: 0, tsw.CH_E: 1,
                  tsw.CH_F: 2}[p & 3]
        elif st == 1:
            j, st = j - 1, (0 if (p >> 2) & 1 else 1)
        else:
            i, st = i - 1, (0 if (p >> 3) & 1 else 2)
        if i <= 0 or j <= 0:
            st = 3
    return n


def test_traceback_steps():
    # the step count that chip_smoke.py's K3 bound reads: one per direction
    # byte the walk reads; the ref_col is the one without return_steps
    q, w = gapped_pairs(9, 48, 24, 32)
    q[-4:] = 4                                  # no positive cell: no walk
    s, ie, je, dirs = tsw.sw_align(torch.from_numpy(q), torch.from_numpy(w),
                                   SC)
    rc, steps = tsw.sw_traceback(dirs, ie, je, 24, 32, return_steps=True)
    torch.testing.assert_close(rc, tsw.sw_traceback(dirs, ie, je, 24, 32),
                               rtol=0, atol=0)
    want = [_walk_steps(dirs[:, b].numpy(), int(ie[b]), int(je[b]))
            for b in range(48)]
    assert steps.tolist() == want
    assert (steps[-4:] == 0).all()
    assert (steps >= (rc >= 0).sum(1)).all() and (steps[:-4] > 0).all()


def test_align_wrapper_dirs_layout():
    # the wrapper's batch-last dirs are the twin's dirs transposed
    q, w = gapped_pairs(8, 40, 16, 24)
    qt, wt = torch.from_numpy(q), torch.from_numpy(w)
    s, ie, je, dirs = sw_cuda.sw_align_cuda(qt, wt, SC)
    ref = _np(*jsw.sw_align(q, w, JSC))
    _assert_all_equal(ref[:3], [s.numpy(), ie.numpy(), je.numpy()])
    np.testing.assert_array_equal(ref[3], dirs.permute(0, 2, 1).numpy())
    assert dirs.shape == (16 + 24 - 1, 16, 40) and dirs.dtype == torch.uint8


def test_decode_best_negative_keys():
    # keys below zero decode with Python's floor rules and mask to (0, 0, 0),
    # as the Pallas wrapper's ceil / floor / % decode does
    W = 48
    keys = np.array([-(1 << 30), -32768 * 3 - 5, -32768, -1, 0,
                     1 * 32768 - (1 * 49 + 1), 7 * 32768 - (3 * 49 + 17),
                     104 * 32768 - (104 * 49 + 48)], np.int32)
    got = [t.numpy() for t in tsw.decode_best(torch.from_numpy(keys), W)]
    score = -(-keys // 32768)
    r = score * 32768 - keys
    ie, je = r // (W + 1), r % (W + 1)
    none = score <= 0
    ref = [np.where(none, 0, x).astype(np.int32) for x in (score, ie, je)]
    _assert_all_equal(ref, got)
    assert list(got[0][-3:]) == [1, 7, 104]
    assert list(got[1][-3:]) == [1, 3, 104]
    assert list(got[2][-3:]) == [1, 17, 48]


def test_best_cell_ties_go_to_lowest_cell():
    # one query base matching many window columns: every match cell scores 1,
    # and the winner must be the lowest (i, j) as in the reference
    q = np.full((4, 8), 4, np.int8)
    q[:, 0] = 2
    w = np.full((4, 16), 2, np.int8)
    w[1, :5] = 0
    w[2] = 4
    ref = _np(*jsw.sw_score(q, w, JSC))
    got = [t.numpy() for t in tsw.sw_score(torch.from_numpy(q),
                                           torch.from_numpy(w), SC)]
    _assert_all_equal(ref, got)
    assert list(got[2]) == [1, 6, 0, 1]


def test_wrapper_contract_errors():
    q = torch.zeros((2, 16), dtype=torch.int8)
    w = torch.zeros((2, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 8"):
        sw_cuda.sw_score_cuda(q, w, SC, rows=12)
    with pytest.raises(ValueError, match="best-key overflow"):
        sw_cuda.sw_score_cuda(torch.zeros((1, 256), dtype=torch.int8),
                              torch.zeros((1, 160), dtype=torch.int8), SC)
    with pytest.raises(ValueError, match="do not match"):
        sw_cuda.sw_align_traceback_cuda(q, w, SC, 0, 16, 32)


# ---- K1's 16-bit arithmetic (csrc/sw.cu) on the CPU -------------------------

def _packed16_case(name):
    """(q, w, rows) numpy int8 codes of one case; rows = 0 sweeps every
    query row."""
    B, L, W = 128, 32, 48
    if name == "planted":
        return (*planted_pairs(5, B, L, W), 0)
    if name == "planted-rows24":
        return (*short_reads(6, B, L, W, 20), 24)
    if name == "gapped":
        return (*gapped_pairs(7, B, L, W), 0)
    if name == "all-n-window":
        q, w = planted_pairs(8, B, L, W)
        w[:] = 4
        return q, w, 0
    k = ADVERSARIAL.index(name)
    q, w = adversarial_pairs(9, L, W, per_case=B)
    return q[k * B:(k + 1) * B], w[k * B:(k + 1) * B], 0


@pytest.mark.parametrize("case", [
    "planted", "planted-rows24", "gapped", "all-n-window", *ADVERSARIAL])
def test_packed16_matches_twin_scan_and_pallas(case):
    q, w, rows = _packed16_case(case)
    qr = q[:, :rows or q.shape[1]]
    got = [t.numpy() for t in tsw.sw_score_packed16(
        torch.from_numpy(qr.copy()), torch.from_numpy(w), SC)]
    assert all(g.dtype == np.int32 for g in got)
    twin = [t.numpy() for t in tsw.sw_score(torch.from_numpy(qr.copy()),
                                            torch.from_numpy(w), SC)]
    _assert_all_equal(twin, got)                      # tolerance 0: integers
    _assert_all_equal(_np(*jsw.sw_score(qr, w, JSC)), got)
    _assert_all_equal(_np(*sw_score_pallas(q, w, JSC, interpret=True,
                                           rows=rows)), got)
    if case in ("all-n-window", "all-mismatch"):
        assert not np.any(got)
    if case == "equal":
        assert (got[0] == 32).all() and (got[1] == 32).all()
    if case == "ties":
        # the first block's last cell, whatever the repeats
        assert (got[0] == 5).all() and (got[1] == 8).all()
        assert (got[2] == 7).all()


@pytest.mark.parametrize("rows", [0, 104])
def test_packed16_at_the_stream_shape(rows):
    # L = 128, W = 160 as the align step runs K1: a read equal to its window
    # (score 104 or 128: the top of the 16-bit key's range), reads of <= 100
    # bases with errors, all-N pairs, and a homopolymer against a cut window
    L, W = 128, 160
    n_rows = rows or L
    rng = np.random.default_rng(rows)
    q, w = short_reads(8 + rows, 8, L, W, 100, min_len=60)
    w[0] = rng.integers(0, 4, W)
    q[0] = w[0, 16:16 + L]                  # equal to its window at margin 16
    q[1], w[1] = 4, 4
    q[2], w[2] = 3, 3
    w[2, 70:77] = 0
    qr = np.ascontiguousarray(q[:, :n_rows])
    got = [t.numpy() for t in tsw.sw_score_packed16(
        torch.from_numpy(qr), torch.from_numpy(w), SC)]
    _assert_all_equal([t.numpy() for t in tsw.sw_score(
        torch.from_numpy(qr), torch.from_numpy(w), SC)], got)
    _assert_all_equal(_np(*jsw.sw_score(qr, w, JSC)), got)
    assert (got[0][0], got[1][0], got[2][0]) == (n_rows, n_rows, 16 + n_rows)
    assert (got[0][1], got[1][1], got[2][1]) == (0, 0, 0)
    assert got[0][2] == n_rows - 13       # 70 matches, a 7-gap, the rest


def test_packed16_border_never_wins():
    # the 16-bit border stands for neg_inf: E and F right after it equal
    # H - open exactly as with the int32 border, on the first row and column
    q = torch.tensor([[0, 1, 2, 3]], dtype=torch.int8)
    w = torch.tensor([[0, 1, 2, 3, 0, 1]], dtype=torch.int8)
    _assert_all_equal([t.numpy() for t in tsw.sw_score(q, w, SC)],
                      [t.numpy() for t in tsw.sw_score_packed16(q, w, SC)])
    assert tsw.BORDER16 - SC.gap_extend >= -(1 << 15)
    assert tsw.BORDER16 < -(SC.gap_open + SC.gap_extend)


def test_check_packed16_ranges():
    assert tsw.check_packed16(104, SC) == 7 == tsw.check_packed16(128, SC)
    assert tsw.check_packed16(32, SC) == 5
    with pytest.raises(ValueError, match="16-bit"):
        tsw.check_packed16(256, SC)          # (256 + 1) << 8 > 2^15
    with pytest.raises(ValueError, match="16-bit"):
        tsw.check_packed16(128, ScoringParams(match=2))
    with pytest.raises(ValueError, match="16-bit"):
        tsw.check_packed16(64, ScoringParams(gap_open=1 << 14))
