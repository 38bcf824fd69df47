"""Each reference's column map to its leaf's anchor (the lowest reference
index of its taxon): identity for the anchor and for a reference equal to
it, else the global alignment of the reference onto the anchor with linear
gap costs (match 2, mismatch -3, gap -4; traceback ties diag > up > left),
a reference column inserted relative to the anchor mapping to -1. A frozen
copy of the repository's host NW."""

from __future__ import annotations

import numpy as np

MATCH = 2
MISMATCH = -3
GAP = -4


def nw_map_batch(a_list, b_list, budget_bytes=400 << 20):
    """The column map of each b_i onto a_i: global alignment, linear gap
    costs, traceback ties diag > up (an insertion in b) > left; (len(b_i),)
    maps, -1 where b_i has a base a_i does not. The pairs of a chunk go in
    lockstep, the DP in int16 where its score range provably fits."""
    n = len(a_list)
    if n == 0:
        return []
    La = np.asarray([len(a) for a in a_list], np.int64)
    Lb = np.asarray([len(b) for b in b_list], np.int64)
    out: list = [None] * n
    order = np.argsort(La + Lb, kind="stable")  # like sizes share a chunk
    Lam_all = int(La.max())
    Lbm_all = int(Lb.max())
    # distinct pad codes: padded tails can never compare equal
    a_pad = np.full((n, Lam_all), 5, np.int8)
    b_pad = np.full((n, Lbm_all), 6, np.int8)
    for i in range(n):
        a_pad[i, : La[i]] = a_list[i]
        b_pad[i, : Lb[i]] = b_list[i]

    done = 0
    while done < n:
        # greedy chunk under the D-table byte budget
        g0 = done
        sel = [order[g0]]
        Lam = int(La[order[g0]])
        Lbm = int(Lb[order[g0]])
        while done + len(sel) < n:
            cand = order[g0 + len(sel)]
            lam = max(Lam, int(La[cand]))
            lbm = max(Lbm, int(Lb[cand]))
            if (len(sel) + 1) * (lbm + 1) * (lam + 1) * 4 > budget_bytes:
                break
            sel.append(cand)
            Lam, Lbm = lam, lbm
        done += len(sel)
        sel = np.asarray(sel)
        g = sel.size
        exact16 = -GAP * (Lam + Lbm) + (-GAP) * (Lam + 1) < 32000
        dt = np.int16 if exact16 else np.int32
        A = a_pad[sel, :Lam]
        Bq = b_pad[sel, :Lbm]
        D = np.zeros((g, Lbm + 1, Lam + 1), dt)
        jj = np.arange(Lam + 1, dtype=dt)
        D[:, 0, :] = (GAP * jj).astype(dt)
        D[:, :, 0] = (GAP * np.arange(Lbm + 1, dtype=dt))[None, :]
        mg = dt(-GAP)
        gp = dt(GAP)
        for i in range(1, Lbm + 1):
            sub_row = np.where(Bq[:, i - 1 : i] == A, dt(MATCH), dt(MISMATCH))
            diag = D[:, i - 1, :-1] + sub_row
            up = D[:, i - 1, 1:] + gp
            t = np.maximum(diag, up)
            t0 = np.concatenate([D[:, i, :1], t], axis=1)
            D[:, i] = np.maximum.accumulate(t0 + mg * jj, axis=1) + gp * jj
        # lockstep vectorized traceback
        res = np.full((g, Lbm), -1, np.int32)
        ii = Lb[sel].copy()
        jm = La[sel].copy()
        gi = np.arange(g)
        active = (ii > 0) & (jm > 0)
        while active.any():
            i1 = np.maximum(ii - 1, 0)
            j1 = np.maximum(jm - 1, 0)
            d = D[gi, ii, jm]
            sub = np.where(Bq[gi, i1] == A[gi, j1], dt(MATCH), dt(MISMATCH))
            diag_ok = active & (d == D[gi, i1, j1] + sub)
            up_ok = active & ~diag_ok & (d == D[gi, i1, jm] + gp)
            left = active & ~diag_ok & ~up_ok
            res[gi[diag_ok], ii[diag_ok] - 1] = jm[diag_ok] - 1
            ii = ii - (diag_ok | up_ok)
            jm = jm - (diag_ok | left)
            active = (ii > 0) & (jm > 0)
        for k, gsel in enumerate(sel.tolist()):
            out[gsel] = res[k, : Lb[gsel]].copy()
    return out


def col_map_rows(ref_seqs, ref_lens, ref_taxon, refs) -> dict:
    """{ref: (ref_len_max,) map} for the references asked for."""
    first = {}
    for r, t in enumerate(np.asarray(ref_taxon).tolist()):
        first.setdefault(t, r)
    out, nw = {}, []
    for r in np.unique(np.asarray(refs)).tolist():
        row = np.full(ref_seqs.shape[1], -1, np.int64)
        a = first[int(ref_taxon[r])]
        Lr, La = int(ref_lens[r]), int(ref_lens[a])
        if a == r or (Lr == La and np.array_equal(ref_seqs[r, :Lr],
                                                  ref_seqs[a, :La])):
            row[:Lr] = np.arange(Lr)
        else:
            nw.append((r, a))
        out[r] = row
    maps = nw_map_batch([ref_seqs[a, :ref_lens[a]] for _, a in nw],
                        [ref_seqs[r, :ref_lens[r]] for r, _ in nw])
    for (r, _), m in zip(nw, maps):
        out[r][:m.size] = m
    return out
