"""Affine-gap local Smith-Waterman in plain PyTorch: the twin of the kernels.

Port of `rambl_tpu/ops/sw.py`, bit-identical to it and to the NumPy spec in
`rambl_tpu_torch.oracle.sw`. These functions are the CPU path of the port and the
reference that the CUDA kernels in `ops.sw_cuda` are held against on the card.

Rules (fixed by the reference):

- Gotoh local alignment over the full L x W rectangle; substitution is
  `match` iff q == w and both codes are < 4, else `mismatch`;
- H = max(0, diag, E, F), E horizontal (along the window), F vertical;
- direction bits: bits 0-1 the H choice with ties zero > diag > E > F,
  bit 2 E-open, bit 3 F-open, where open wins ties with extend (>=);
- the best cell maximises the key H * 32768 - (i * (W + 1) + j), so ties go
  to the lowest (i, j) whatever the sweep order; a pair with no positive
  cell gives (0, 0, 0).

The sweep runs over anti-diagonals d = i + j with the batch as the leading
axis, so each step is a handful of (B, L) tensor ops. Direction bits use the
reference layout: cell (i, j) of pair b sits at dirs[i + j - 2, b, i - 1].

`sw_score_packed16`, `sw_score_strips` and `sw_align_traceback_lanes` are
the CUDA kernels' schedules and arithmetic in plain PyTorch, step for step
(K1's, the strip kernel of S1 and S2, K2 + K3's): no path of the port calls
them; they pin the kernels' designs where there is no card.

`sw_raw_key` is the one function with other rules: the TPU score kernel's
raw output (`rambl_tpu/ops/sw_pallas.py::_score_kernel`, which the S2
ablation times on its own): match iff q == w on the codes as given, and the
key maximised over every cell, zero cells included.
"""

from __future__ import annotations

import torch

from rambl_tpu_torch.config import ScoringParams

CH_ZERO, CH_DIAG, CH_E, CH_F = 0, 1, 2, 3

TIE = 32768          # best-cell packing: key = H * TIE - (i * (W + 1) + j)
NONE_KEY = -(1 << 30)
BORDER16 = -16384    # neg_inf of the 16-bit arithmetic (`sw_score_packed16`)
NO_MATCH = 1 << 20   # `sw_align_traceback_lanes`: a q code >= 4
DEAD_ROW = -(1 << 30)  # and the key base of a row past `rows`


def decode_best(best: torch.Tensor, W: int):
    """Packed best keys (B,) int32 -> (score, i_end, j_end), each (B,) int32.

    Division follows Python's floor rules (the reference decodes negative
    keys the same way before masking them to 0)."""
    none = best <= 0
    score = -torch.div(-best, TIE, rounding_mode="floor")
    r = score * TIE - best
    i_end = torch.div(r, W + 1, rounding_mode="floor")
    j_end = torch.remainder(r, W + 1)
    zero = torch.zeros_like(best)
    return (torch.where(none, zero, score).to(torch.int32),
            torch.where(none, zero, i_end).to(torch.int32),
            torch.where(none, zero, j_end).to(torch.int32))


def _sw(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams, want_dirs: bool,
        raw_key: bool = False):
    """-> (best key (B,) int32, dirs or None); see the module docstring."""
    B, L = q.shape
    W = w.shape[1]
    dev = q.device
    NEG = sc.neg_inf
    go_ge = sc.gap_open + sc.gap_extend
    ge = sc.gap_extend
    i32 = torch.int32

    qi = q.to(i32)
    wi = w.to(i32)
    q_ok = qi < 4
    s_match = torch.tensor(sc.match, dtype=i32, device=dev)
    s_mismatch = torch.tensor(sc.mismatch, dtype=i32, device=dev)
    H1 = torch.zeros((B, L + 1), dtype=i32, device=dev)   # H at d - 1
    H2 = torch.zeros((B, L + 1), dtype=i32, device=dev)   # H at d - 2
    E1 = torch.full((B, L + 1), NEG, dtype=i32, device=dev)
    F1 = torch.full((B, L + 1), NEG, dtype=i32, device=dev)
    best = torch.full((B,), NONE_KEY, dtype=i32, device=dev)
    ii = torch.arange(1, L + 1, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    dirs = (torch.zeros((L + W - 1, B, L), dtype=torch.uint8, device=dev)
            if want_dirs else None)

    for d in range(2, L + W + 1):
        j = d - ii                                          # (L,) 1-based col
        valid = ((j >= 1) & (j <= W))[None, :]
        wj = wi.index_select(1, torch.clamp(j - 1, 0, W - 1))
        match = (qi == wj) if raw_key else q_ok & (qi == wj) & (wj < 4)
        s = torch.where(match, s_match, s_mismatch)

        Hdiag = H2[:, :L]
        Hup = H1[:, :L]
        Fup = F1[:, :L]
        Hleft = H1[:, 1:]
        Eleft = E1[:, 1:]

        e_open = Hleft - go_ge
        e_ext = Eleft - ge
        Enew = torch.maximum(e_open, e_ext)
        f_open = Hup - go_ge
        f_ext = Fup - ge
        Fnew = torch.maximum(f_open, f_ext)
        diag = Hdiag + s
        Hnew = torch.clamp(torch.maximum(diag, torch.maximum(Enew, Fnew)),
                           min=0)

        if want_dirs:
            ch = torch.where(
                Hnew == 0, CH_ZERO,
                torch.where(Hnew == diag, CH_DIAG,
                            torch.where(Hnew == Enew, CH_E, CH_F)))
            nib = (ch | ((e_open >= e_ext).to(i32) << 2)
                   | ((f_open >= f_ext).to(i32) << 3))
            dirs[d - 2] = torch.where(valid, nib, 0).to(torch.uint8)

        Hnew = torch.where(valid, Hnew, 0)
        Enew = torch.where(valid, Enew, NEG)
        Fnew = torch.where(valid, Fnew, NEG)

        key = Hnew * TIE - (ii * (W + 1) + j)[None, :]
        key = torch.where(valid if raw_key else valid & (Hnew > 0), key,
                          NONE_KEY)
        best = torch.maximum(best, key.amax(dim=1))

        H2 = H1
        H1 = torch.cat([zcol, Hnew], dim=1)
        E1 = torch.cat([ncol, Enew], dim=1)
        F1 = torch.cat([ncol, Fnew], dim=1)

    return best, dirs


def sw_score(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams):
    """Score-only pass. q (B, L) int8, w (B, W) int8 ->
    (score, i_end, j_end), each (B,) int32 with a 1-based end cell."""
    return decode_best(_sw(q, w, sc, want_dirs=False)[0], w.shape[1])


def check_packed16(rows: int, sc: ScoringParams) -> int:
    """The row bits of `sw_score_packed16`'s column key, after checking that
    every value of the 16-bit arithmetic fits a half: the key
    (H << rbits) + (2^rbits - i) stays below 2^15, and the border less one
    extension stays above -2^15."""
    rbits = max(rows - 1, 1).bit_length()
    open_ = sc.gap_open + sc.gap_extend
    if ((rows * max(sc.match, 0) + 1) << rbits > 1 << 15
            or not 0 < sc.gap_extend <= open_ < -BORDER16
            or not BORDER16 < sc.mismatch <= sc.match < -BORDER16):
        raise ValueError(
            f"rows={rows} with {sc} does not fit the score kernel's 16-bit "
            "arithmetic")
    return rbits


def sw_score_packed16(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams):
    """`sw_score` in the arithmetic of the CUDA score kernel
    (`csrc/sw.cu`), step for step, in torch.int16: a column sweep
    (rows inner) whose state is (H - open, E) a row, borders at BORDER16
    instead of neg_inf, and the best cell tracked as a 16-bit column key
    (H << rbits) + (2^rbits - i) that replaces the pair's best once a column
    only when strictly greater. Bit-identical to `sw_score`; the tests hold
    it to that. Nothing on the card's path calls it: it pins the kernel's
    arithmetic where there is no card."""
    B, L = q.shape
    W = w.shape[1]
    rbits = check_packed16(L, sc)
    i16 = torch.int16
    dev = q.device

    def const(x):
        return torch.full((B,), x, dtype=i16, device=dev)

    open_ = sc.gap_open + sc.gap_extend
    # codes that can never match are remapped as the kernel stages them
    qc = torch.where(q < 4, q, 4)
    wc = torch.where(w < 4, w, 5)
    hm = [const(-open_) for _ in range(L)]          # H(i, j - 1) - open
    e_col = [const(BORDER16) for _ in range(L)]     # E(i, j - 1)
    best = torch.zeros(B, dtype=i16, device=dev)
    best_j = torch.zeros(B, dtype=i16, device=dev)
    for j in range(1, W + 1):
        hm_diag, hm_up, f_up = const(-open_), const(-open_), const(BORDER16)
        colkey = torch.zeros(B, dtype=i16, device=dev)
        for i in range(1, L + 1):
            e = torch.maximum(e_col[i - 1] - sc.gap_extend, hm[i - 1])
            sub = torch.where(qc[:, i - 1] == wc[:, j - 1], sc.match + open_,
                              sc.mismatch + open_).to(i16)
            diag = hm_diag + sub
            f = torch.maximum(f_up - sc.gap_extend, hm_up)
            h = torch.clamp(torch.maximum(diag, torch.maximum(e, f)), min=0)
            hm_diag = hm[i - 1]
            hm[i - 1] = hm_up = h - open_
            e_col[i - 1] = e
            f_up = f
            colkey = torch.maximum(colkey, (h << rbits) + ((1 << rbits) - i))
        better = colkey > best
        best = torch.where(better, colkey, best)
        best_j = torch.where(better, j, best_j)
    if {t.dtype for t in (best, colkey, h, e, f)} != {i16}:
        raise AssertionError("the sweep left 16-bit arithmetic")
    score = (best >> rbits).to(torch.int32)
    i_end = ((1 << rbits) - (best & ((1 << rbits) - 1))).to(torch.int32)
    none = score == 0
    zero = torch.zeros_like(score)
    return (score, torch.where(none, zero, i_end),
            torch.where(none, zero, best_j.to(torch.int32)))


def sw_score_strips(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams,
                    strips: int, *, raw_key: bool = False):
    """`sw_score` (or, with `raw_key`, `sw_raw_key`) in the schedule and
    arithmetic of the strip kernel of S1 and S2 (`csrc/sw_variants.cu`),
    step for step, in torch.int16. Bit-identical to them; the tests hold it
    to that. Nothing on the card's path calls it.

    - The rows, L rounded up to whole q words of 4, are cut into `strips`
      strips of whole words, strip s taking words [s * r4 // strips,
      (s + 1) * r4 // strips). Strip s does column t + 1 - s at step t of
      W + strips - 1; at each step it takes (H - open, F) of the last row of
      strip s - 1 as that strip left it a step before, and the column's w
      code, and the H that came in a step earlier is its diagonal.
    - The column state is (H - open, E) a row, borders at BORDER16.
    - Match: S1 remaps q >= 4 to 4 and w >= 4 to 5 and compares; with
      `raw_key` the codes are compared as given (S2). A row past L (raw_key
      only) equals nothing.
    - The column key (H << rbits) + (2^rbits - i) of each strip's rows goes
      once a column, as (key << 16) | (0xFFFF - j), into the pair's running
      max. The raw key is rebuilt from the best cell, -(W + 2) where no cell
      is positive.
    """
    B, L = q.shape
    W = w.shape[1]
    r4 = -(-L // 4)
    rows = 4 * r4
    rbits = check_packed16(rows, sc)
    i16 = torch.int16
    dev = q.device

    def const(x):
        return torch.full((B,), x, dtype=i16, device=dev)

    open_ = sc.gap_open + sc.gap_extend
    if raw_key:
        qc, wc = q.to(torch.int64), w.to(torch.int64)
        live = torch.arange(rows, device=dev) < L
    else:
        qc = torch.where(q < 4, q, 4).to(torch.int64)
        wc = torch.where(w < 4, w, 5).to(torch.int64)
        live = torch.ones(rows, dtype=torch.bool, device=dev)
    qc = torch.cat([qc, qc.new_zeros((B, rows - L))], dim=1)
    lo = [4 * (s * r4 // strips) for s in range(strips + 1)]
    hm = [const(-open_) for _ in range(rows)]       # H(i, j - 1) - open
    e_col = [const(BORDER16) for _ in range(rows)]  # E(i, j - 1)
    # what each strip handed on at the end of the last step: its last row's
    # H - open and F, and the column's w code; the H that came in before
    out_hm = [const(-open_) for _ in range(strips)]
    out_f = [const(BORDER16) for _ in range(strips)]
    out_w = [wc[:, 0] for _ in range(strips)]
    diag_in = [const(-open_) for _ in range(strips)]
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(W + strips - 1):
        came = [(out_hm[s - 1], out_f[s - 1], out_w[s - 1]) if s else None
                for s in range(strips)]
        for s in range(strips):
            j = t + 1 - s
            if s:
                hm_up, f_up, wj = came[s]
                hm_diag, diag_in[s] = diag_in[s], hm_up
                out_w[s] = wj
            else:
                hm_up, f_up, hm_diag = const(-open_), const(BORDER16), \
                    const(-open_)
                if j <= W:
                    out_w[0] = wc[:, j - 1]
            if not 1 <= j <= W:
                continue
            wj = out_w[s]
            colkey = torch.zeros(B, dtype=i16, device=dev)
            for i in range(lo[s] + 1, lo[s + 1] + 1):
                e = torch.maximum(e_col[i - 1] - sc.gap_extend, hm[i - 1])
                hit = (qc[:, i - 1] == wj) & live[i - 1]
                sub = torch.where(hit, sc.match + open_,
                                  sc.mismatch + open_).to(i16)
                f = torch.maximum(f_up - sc.gap_extend, hm_up)
                h = torch.clamp(torch.maximum(hm_diag + sub,
                                              torch.maximum(e, f)), min=0)
                hm_diag = hm[i - 1]
                hm[i - 1] = hm_up = h - open_
                e_col[i - 1] = e
                f_up = f
                colkey = torch.maximum(colkey,
                                       (h << rbits) + ((1 << rbits) - i))
            out_hm[s], out_f[s] = hm_up, f_up
            if colkey.dtype != i16 or hm_up.dtype != i16:
                raise AssertionError("the sweep left 16-bit arithmetic")
            best = torch.maximum(best, (colkey.to(torch.int32) << 16)
                                 | (0xFFFF - j))
    key = best >> 16
    score = key >> rbits
    none = score == 0
    zero = torch.zeros_like(score)
    i_end = torch.where(none, zero, (1 << rbits) - (key & ((1 << rbits) - 1)))
    j_end = torch.where(none, zero, 0xFFFF - (best & 0xFFFF))
    if raw_key:
        return torch.where(none, -(W + 2),
                           score * TIE - (i_end * (W + 1) + j_end)
                           ).to(torch.int32)
    return score, i_end.to(torch.int32), j_end.to(torch.int32)


def sw_align(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams):
    """Full pass with direction bits: (score, i_end, j_end, dirs), dirs
    (L + W - 1, B, L) uint8 in the anti-diagonal layout of the module
    docstring."""
    best, dirs = _sw(q, w, sc, want_dirs=True)
    return (*decode_best(best, w.shape[1]), dirs)


def sw_raw_key(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams):
    """The TPU score kernel's raw best key (module docstring). q (B, L) and
    w (B, W) integer codes -> (B,) int32; `decode_best` turns it into
    (score, i_end, j_end)."""
    return _sw(q, w, sc, want_dirs=False, raw_key=True)[0]


def sw_traceback(dirs: torch.Tensor, i_end: torch.Tensor, j_end: torch.Tensor,
                 L: int, W: int, return_steps: bool = False):
    """Walk the M/E/F state machine back from each end cell.

    dirs: (D, B, Lk) uint8 from `sw_align` on Lk query rows (Lk <= L).
    Returns ref_col (B, L) int32: the window column of each query position
    on a diagonal (match) move, -1 elsewhere. The walk takes at most
    Lk + W + 2 steps and stops at i <= 0, j <= 0 or on a zero cell. With
    `return_steps`, returns (ref_col, steps): steps (B,) int32 counts the
    steps of each pair's walk, one direction byte read each.
    """
    dev = i_end.device
    D, B, Lk = dirs.shape
    bidx = torch.arange(B, device=dev)
    i = i_end.to(torch.int32)
    j = j_end.to(torch.int32)
    st = torch.where((i > 0) & (j > 0), 0, 3).to(torch.int32)
    ref_col = torch.full((B, L + 1), -1, dtype=torch.int32, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)

    for _ in range(Lk + W + 2):
        if not bool((st != 3).any()):
            break
        if return_steps:
            steps += (st != 3).to(torch.int32)
        d = i + j
        p = dirs[torch.clamp(d - 2, 0, D - 1).long(), bidx,
                 torch.clamp(i - 1, 0, Lk - 1).long()].to(torch.int32)
        p = torch.where((i > 0) & (j > 0), p, 0)
        ch = p & 0x3
        eop = (p >> 2) & 1
        fop = (p >> 3) & 1
        act_m = st == 0
        act_e = st == 1
        act_f = st == 2

        m_diag = act_m & (ch == CH_DIAG)
        # column L is the dump slot of rows that emit nothing this step
        emit_i = torch.where(m_diag, i - 1, L).long()
        ref_col[bidx, emit_i] = j - 1

        ni = i - m_diag.to(torch.int32) - act_f.to(torch.int32)
        nj = j - m_diag.to(torch.int32) - act_e.to(torch.int32)
        nst = torch.where(act_m & (ch == CH_ZERO), 3, st)
        nst = torch.where(act_m & (ch == CH_E), 1, nst)
        nst = torch.where(act_m & (ch == CH_F), 2, nst)
        nst = torch.where(act_e, torch.where(eop == 1, 0, 1), nst)
        nst = torch.where(act_f, torch.where(fop == 1, 0, 2), nst)
        st = torch.where((ni <= 0) | (nj <= 0), 3, nst).to(torch.int32)
        i, j = ni, nj
    return (ref_col[:, :L], steps) if return_steps else ref_col[:, :L]


def nib_stride(lanes: int, rows_per_lane: int) -> int:
    """Words in one column of the fused align kernel's direction buffer
    (`csrc/sw.cu::nib_stride`). A lane's codes of a column are one word (16
    bits at 4 rows a lane, 32 at 8), and at step t lane l writes word
    (t - l) * S + l; S is padded so that those 32 writes meet in no bank."""
    return lanes | 3 if rows_per_lane == 4 else (lanes + 1) & ~1


def _pack_hf(h: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(H, F) in one 32-bit word as the kernel's shuffle carries them: F in
    the high half, H in the low (int64 holding the word's bits)."""
    return ((f.long() & 0xFFFF) << 16) | (h.long() & 0xFFFF)


def _unpack_hf(v: torch.Tensor):
    f = ((v >> 16) + 0x8000 & 0xFFFF) - 0x8000    # sign-extend the high half
    return (v & 0xFFFF).to(torch.int32), f.to(torch.int32)


def sw_align_traceback_lanes(q: torch.Tensor, w: torch.Tensor,
                             sc: ScoringParams, rows_per_lane: int,
                             L: int = 0):
    """`sw_align` then `sw_traceback` in the schedule of the fused CUDA
    kernel (`csrc/sw.cu::sw_align_traceback_kernel`), step for step, batched
    over pairs. q (B, rows) int8 swept rows, w (B, W) int8 -> (score, i_end,
    j_end, ref_col (B, L or rows) int32). Bit-identical to the twins; the
    tests hold it to that. Nothing on the card's path calls it.

    - Lane l of a pair's warp owns rows R*l + 1 .. R*l + R (R =
      rows_per_lane, 4 or 8) and does column j at step t = j - 1 + l. It
      takes H and F of the row above its strip at column j from lane l - 1
      (which did that column at step t - 1) packed in one 32-bit word, and
      keeps that H as the next step's diagonal; row 0 and column 0 are the
      reference's borders.
    - Each cell's 4-bit code goes into the pair's buffer of words, [column]
      [lane] with the column stride `nib_stride`.
    - Each lane keeps the running max of H * TIE - (i * (W + 1) + j), a
      row past `rows` keyed below 0; the pair's best is their max.
    - The walk reads the buffer (sw_traceback's state machine).
    """
    B, rows = q.shape
    W = w.shape[1]
    R = rows_per_lane
    if R not in (4, 8) or not 0 < rows <= 32 * R:
        raise ValueError(f"rows={rows} at {R} rows a lane does not fit a warp")
    lanes = -(-rows // R)
    S = nib_stride(lanes, R)
    dev = q.device
    i32 = torch.int32
    go_ge, ge, NEG = sc.gap_open + sc.gap_extend, sc.gap_extend, sc.neg_inf

    qc = torch.full((B, lanes * R), NO_MATCH, dtype=i32, device=dev)
    qc[:, :rows] = torch.where(q < 4, q.to(i32), NO_MATCH)
    qc = qc.view(B, lanes, R)
    ii = torch.arange(1, lanes * R + 1, dtype=i32, device=dev).view(lanes, R)
    kb = torch.where(ii <= rows, -ii * (W + 1), DEAD_ROW)
    lane = torch.arange(lanes, device=dev)
    H = [torch.zeros((B, lanes), dtype=i32, device=dev) for _ in range(R)]
    E = [torch.full((B, lanes), NEG, dtype=i32, device=dev) for _ in range(R)]
    best = torch.full((B, lanes), NONE_KEY, dtype=i32, device=dev)
    out = torch.zeros((B, lanes), dtype=torch.int64, device=dev)
    diag_in = torch.zeros((B, lanes), dtype=i32, device=dev)
    # the buffer, and one slot past it where the lanes outside 1 <= j <= W
    # write nothing (the kernel's skip)
    nibs = torch.zeros((B, W * S + 1), dtype=torch.int64, device=dev)
    wi = w.to(i32)
    for t in range(W + lanes - 1):
        j = (t - lane + 1).to(i32)                       # (lanes,)
        act = (j >= 1) & (j <= W)
        # lane l - 1's word, shuffled up one lane; lane 0 takes the border
        hup, fup = _unpack_hf(torch.roll(out, 1, dims=1))
        hdiag = diag_in.clone()
        hup[:, 0], fup[:, 0], hdiag[:, 0] = 0, NEG, 0
        diag_in = torch.where(act & (lane > 0), hup, diag_in)
        wj = wi[:, torch.clamp(j - 1, 0, W - 1)]
        nib = torch.zeros((B, lanes), dtype=torch.int64, device=dev)
        colkey = torch.full((B, lanes), NONE_KEY, dtype=i32, device=dev)
        for u in range(R):
            e_open, e_ext = H[u] - go_ge, E[u] - ge
            f_open, f_ext = hup - go_ge, fup - ge
            e = torch.maximum(e_open, e_ext)
            f = torch.maximum(f_open, f_ext)
            diag = hdiag + torch.where(qc[:, :, u] == wj, sc.match,
                                       sc.mismatch)
            h = torch.clamp(torch.maximum(diag, torch.maximum(e, f)), min=0)
            ch = torch.where(h == 0, CH_ZERO, torch.where(
                h == diag, CH_DIAG, torch.where(h == e, CH_E, CH_F)))
            code = (ch | ((e_open >= e_ext).to(i32) << 2)
                    | ((f_open >= f_ext).to(i32) << 3))
            nib |= code.long() << (4 * u)
            colkey = torch.maximum(colkey, h * TIE + kb[:, u])
            hdiag = H[u]
            H[u] = torch.where(act, h, H[u])
            E[u] = torch.where(act, e, E[u])
            hup, fup = h, f
        out = torch.where(act, _pack_hf(hup, fup), out)
        best = torch.where(act, torch.maximum(best, colkey - j), best)
        at = torch.where(act, (j - 1) * S + lane, W * S).expand(B, lanes)
        nibs.scatter_(1, at, nib)
    best = best.amax(dim=1)                              # __reduce_max_sync
    score, i_end, j_end = decode_best(best, W)

    # the walk: sw_traceback's state machine over the buffer
    L = L or rows
    bidx = torch.arange(B, device=dev)
    i, j = i_end.clone(), j_end.clone()
    st = torch.where((i > 0) & (j > 0), 0, 3).to(i32)
    ref_col = torch.full((B, L + 1), -1, dtype=i32, device=dev)
    for _ in range(rows + W + 2):
        if not bool((st != 3).any()):
            break
        r = torch.clamp(i - 1, min=0)
        word = nibs[bidx, torch.clamp(j - 1, min=0).long() * S + r // R]
        p = ((word >> (4 * (r % R))) & 0xF).to(i32)
        ch = p & 0x3
        act_m, act_e, act_f = st == 0, st == 1, st == 2
        m_diag = act_m & (ch == CH_DIAG)
        ref_col[bidx, torch.where(m_diag, i - 1, L).long()] = j - 1
        ni = i - m_diag.to(i32) - act_f.to(i32)
        nj = j - m_diag.to(i32) - act_e.to(i32)
        nst = torch.where(act_m & (ch == CH_ZERO), 3, st)
        nst = torch.where(act_m & (ch == CH_E), 1, nst)
        nst = torch.where(act_m & (ch == CH_F), 2, nst)
        nst = torch.where(act_e, torch.where((p >> 2) & 1 == 1, 0, 1), nst)
        nst = torch.where(act_f, torch.where((p >> 3) & 1 == 1, 0, 2), nst)
        st = torch.where((ni <= 0) | (nj <= 0), 3, nst).to(i32)
        i, j = ni, nj
    return score, i_end, j_end, ref_col[:, :L]
