"""Banded/windowed affine-gap Smith-Waterman, NumPy specification: the port's
copy of `rambl_tpu/oracle/sw.py`, which the kernels are held against on the
card.

    H[i,j] = max(0, H[i-1,j-1] + s(q_i, w_j), E[i,j], F[i,j])
    E[i,j] = max(H[i,j-1] - go - ge, E[i,j-1] - ge)   # gap in query (deletion)
    F[i,j] = max(H[i-1,j] - go - ge, F[i-1,j] - ge)   # gap in ref  (insertion)

Deterministic rules locked here (every kernel must match exactly):

- substitution: s(a,b) = match iff a == b and both < 4, else mismatch
  (code 4 = N/pad never matches, even 4 vs 4);
- best cell: maximize H, ties broken by smallest i_end then smallest j_end;
- H-choice priority on ties: diag > E > F > zero;
- E/F "open" on ties: open (from H) preferred over extend;
- traceback emits, per query position i, the window column aligned to it
  (-1 when clipped or inserted).

Two implementations: `sw_scalar` (loops, obviously correct, tests only) and
`sw_batch` (an anti-diagonal wavefront vectorized over the pair batch).
"""

from __future__ import annotations

import numpy as np

from rambl_tpu_torch.config import ScoringParams

# H-choice codes (2 bits)
CH_ZERO, CH_DIAG, CH_E, CH_F = 0, 1, 2, 3


def _sub_score(a: np.ndarray, b: np.ndarray, sc: ScoringParams) -> np.ndarray:
    return np.where((a == b) & (a < 4) & (b < 4), sc.match, sc.mismatch)


def sw_scalar(q: np.ndarray, w: np.ndarray, sc: ScoringParams):
    """Reference scalar DP. Returns (score, i_end, j_end, Hch, Eopen, Fopen).

    q: (L,) int8 query codes; w: (W,) int8 window codes. DP arrays are 1-based
    with a zero border; i_end/j_end are 1-based cell coordinates (0 = no
    alignment). Hch/Eopen/Fopen have shape (L+1, W+1).
    """
    L, W = len(q), len(w)
    NEG = sc.neg_inf
    H = np.zeros((L + 1, W + 1), dtype=np.int32)
    E = np.full((L + 1, W + 1), NEG, dtype=np.int32)
    F = np.full((L + 1, W + 1), NEG, dtype=np.int32)
    Hch = np.zeros((L + 1, W + 1), dtype=np.int8)
    Eopen = np.zeros((L + 1, W + 1), dtype=np.int8)
    Fopen = np.zeros((L + 1, W + 1), dtype=np.int8)
    go, ge = sc.gap_open, sc.gap_extend
    for i in range(1, L + 1):
        for j in range(1, W + 1):
            e_open = H[i, j - 1] - go - ge
            e_ext = E[i, j - 1] - ge
            E[i, j] = max(e_open, e_ext)
            Eopen[i, j] = 1 if e_open >= e_ext else 0
            f_open = H[i - 1, j] - go - ge
            f_ext = F[i - 1, j] - ge
            F[i, j] = max(f_open, f_ext)
            Fopen[i, j] = 1 if f_open >= f_ext else 0
            diag = H[i - 1, j - 1] + int(_sub_score(q[i - 1], w[j - 1], sc))
            h = max(0, diag, E[i, j], F[i, j])
            H[i, j] = h
            if h == 0:
                Hch[i, j] = CH_ZERO
            elif h == diag:
                Hch[i, j] = CH_DIAG
            elif h == E[i, j]:
                Hch[i, j] = CH_E
            else:
                Hch[i, j] = CH_F
    # best cell: max H, tie -> smallest i then smallest j
    flat = np.argmax(H.ravel() * 32768 - (np.arange(H.size, dtype=np.int64)))
    i_end, j_end = divmod(int(flat), W + 1)
    score = int(H[i_end, j_end])
    if score <= 0:
        i_end = j_end = 0
    return score, i_end, j_end, Hch, Eopen, Fopen


def traceback_scalar(Hch, Eopen, Fopen, i_end, j_end, L) -> np.ndarray:
    """Scalar traceback -> ref_col (L,) int32: window col per query pos, -1 if
    clipped/inserted. Follows the locked preference rules."""
    ref_col = np.full((L,), -1, dtype=np.int32)
    i, j = int(i_end), int(j_end)
    state = "M"
    while i > 0 and j > 0:
        if state == "M":
            c = Hch[i, j]
            if c == CH_ZERO:
                break
            if c == CH_DIAG:
                ref_col[i - 1] = j - 1
                i -= 1
                j -= 1
            elif c == CH_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":  # deletion: window col j-1 consumed, no query base
            op = Eopen[i, j]
            j -= 1
            state = "M" if op else "E"
        else:  # F: insertion: query base i-1 unaligned
            op = Fopen[i, j]
            i -= 1
            state = "M" if op else "F"
    return ref_col


def sw_batch(q: np.ndarray, w: np.ndarray, sc: ScoringParams, want_dirs: bool = True):
    """Anti-diagonal wavefront DP vectorized over a batch of pairs.

    q: (B, L) int8, w: (B, W) int8. Returns (score, i_end, j_end, dir_pack)
    where dir_pack is (B, L+1, W+1) uint8 with bits [0:2]=Hch, bit2=Eopen,
    bit3=Fopen (same semantics as sw_scalar outputs). With want_dirs=False the
    direction matrix is skipped (score-only pass; dir_pack is None) - this is
    the shape of the two-pass kernel design: score all candidates, then rerun
    with directions only for each read's best candidate.

    State arrays are indexed by i and advanced over anti-diagonals d = i + j;
    the batch is the vector axis.
    """
    B, L = q.shape
    W = w.shape[1]
    NEG = sc.neg_inf
    go, ge = sc.gap_open, sc.gap_extend

    # state along i axis: value of row-state at diagonal d for each i
    ii = np.arange(1, L + 1)
    H1 = np.zeros((B, L + 1), np.int32)  # H at d-1, index by i
    H2 = np.zeros((B, L + 1), np.int32)  # H at d-2
    E1 = np.full((B, L + 1), NEG, np.int32)
    F1 = np.full((B, L + 1), NEG, np.int32)

    dir_pack = np.zeros((B, L + 1, W + 1), np.uint8) if want_dirs else None
    best = np.full((B,), -(1 << 60), np.int64)  # packed key: H*32768 - (i*(W+1)+j)

    qi = q.astype(np.int16)  # (B, L)
    for d in range(2, L + W + 1):
        # cells (i, j=d-i) for i in [max(1, d-W), min(L, d-1)]
        j = d - ii  # (L,) window col for each i (1-based)
        valid = (j >= 1) & (j <= W) & (ii >= 1) & (ii <= L)
        # gather w_j per batch: j index per i
        jc = np.clip(j - 1, 0, W - 1)
        wj = w[:, jc]  # (B, L)
        s = np.where(
            (qi == wj) & (qi < 4) & (wj < 4), sc.match, sc.mismatch
        ).astype(np.int32)  # (B, L)

        # predecessors (index by i over 1..L):
        Hdiag = H2[:, 0:L]       # H[i-1, j-1] at d-2, i-1 in 0..L-1
        Hup = H1[:, 0:L]         # H[i-1, j]   at d-1
        Fup = F1[:, 0:L]         # F[i-1, j]
        Hleft = H1[:, 1 : L + 1]  # H[i, j-1]  at d-1
        Eleft = E1[:, 1 : L + 1]

        e_open = Hleft - go - ge
        e_ext = Eleft - ge
        Enew = np.maximum(e_open, e_ext)
        eopen = (e_open >= e_ext).astype(np.uint8)
        f_open = Hup - go - ge
        f_ext = Fup - ge
        Fnew = np.maximum(f_open, f_ext)
        fopen = (f_open >= f_ext).astype(np.uint8)
        diag = Hdiag + s
        Hnew = np.maximum(0, np.maximum(diag, np.maximum(Enew, Fnew)))
        ch = np.where(
            Hnew == 0,
            CH_ZERO,
            np.where(Hnew == diag, CH_DIAG, np.where(Hnew == Enew, CH_E, CH_F)),
        ).astype(np.uint8)

        vm = valid[None, :]
        Hnew = np.where(vm, Hnew, 0)
        Enew = np.where(vm, Enew, NEG)
        Fnew = np.where(vm, Fnew, NEG)
        if want_dirs:
            pack = np.where(vm, (ch | (eopen << 2) | (fopen << 3)), 0)
            # scatter into dir_pack at (i, j=d-i)
            bidx = np.arange(B)[:, None]
            dir_pack[bidx, ii[None, :], np.clip(j, 0, W)[None, :]] = np.where(
                vm, pack, dir_pack[bidx, ii[None, :], np.clip(j, 0, W)[None, :]]
            )

        # best-cell update (tie: smallest i then j  ==  largest -(i*(W+1)+j))
        cell_key = Hnew.astype(np.int64) * 32768 - (ii * (W + 1) + j)[None, :]
        cell_key = np.where(vm & (Hnew > 0), cell_key, np.int64(-(1 << 60)))
        best = np.maximum(best, cell_key.max(axis=1))

        # rotate state: new arrays indexed by i (1..L); position 0 stays border
        H2 = H1
        H1 = np.concatenate([np.zeros((B, 1), np.int32), Hnew], axis=1)
        E1 = np.concatenate([np.full((B, 1), NEG, np.int32), Enew], axis=1)
        F1 = np.concatenate([np.full((B, 1), NEG, np.int32), Fnew], axis=1)

    # decode: best = H*32768 - r where 0 < r < 32768 -> H = ceil(best/32768)
    score = -(-best // 32768)
    r = score * 32768 - best
    i_end = r // (W + 1)
    j_end = r % (W + 1)
    none = best == -(1 << 60)
    score = np.where(none, 0, score).astype(np.int32)
    i_end = np.where(none, 0, i_end).astype(np.int32)
    j_end = np.where(none, 0, j_end).astype(np.int32)
    return score, i_end, j_end, dir_pack


def traceback_batch(dir_pack: np.ndarray, i_end: np.ndarray, j_end: np.ndarray,
                    L: int, max_steps: int | None = None) -> np.ndarray:
    """Vectorized traceback over a batch.

    dir_pack: (B, L+1, W+1) uint8 as produced by sw_batch. Returns ref_col
    (B, L) int32. Equivalent to traceback_scalar per row.
    """
    B = dir_pack.shape[0]
    W = dir_pack.shape[2] - 1
    if max_steps is None:
        max_steps = L + W + 2
    ref_col = np.full((B, L), -1, np.int32)
    i = i_end.astype(np.int32).copy()
    j = j_end.astype(np.int32).copy()
    # state: 0=M, 1=E, 2=F, 3=done
    st = np.where((i > 0) & (j > 0), 0, 3).astype(np.int8)
    bidx = np.arange(B)
    for _ in range(max_steps):
        if (st == 3).all():
            break
        p = dir_pack[bidx, np.clip(i, 0, L), np.clip(j, 0, W)]
        ch = p & 0x3
        eop = (p >> 2) & 1
        fop = (p >> 3) & 1

        act_m = st == 0
        act_e = st == 1
        act_f = st == 2

        # M-state transitions
        m_stop = act_m & (ch == CH_ZERO)
        m_diag = act_m & (ch == CH_DIAG)
        m_toE = act_m & (ch == CH_E)
        m_toF = act_m & (ch == CH_F)

        # emit diag
        if m_diag.any():
            ref_col[bidx[m_diag], i[m_diag] - 1] = j[m_diag] - 1

        ni = i - m_diag.astype(np.int32) - (act_f).astype(np.int32)
        nj = j - m_diag.astype(np.int32) - (act_e).astype(np.int32)

        nst = st.copy()
        nst[m_stop] = 3
        nst[m_toE] = 1
        nst[m_toF] = 2
        # E: consume col; open -> M
        nst[act_e & (eop == 1)] = 0
        nst[act_e & (eop == 0)] = 1
        nst[act_f & (fop == 1)] = 0
        nst[act_f & (fop == 0)] = 2

        i, j, st = ni, nj, nst
        st = np.where((i <= 0) | (j <= 0), 3, st).astype(np.int8)
    return ref_col
