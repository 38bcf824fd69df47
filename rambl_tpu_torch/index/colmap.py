"""Reference-to-anchor column maps, one coordinate system per leaf bin: the
port's copy of `anchor_of_leaf`, `_nw_map` and `build_col_maps` from
`rambl_tpu/index/colmap.py` (the reference's batched native NW serves its
polish pass, not `build_col_maps`, and is not copied).

Pileups merge reads aligned to DIFFERENT references of the same leaf (strain
refs in round 0, variant panel genes later). Raw positions are only colinear
until the first indel difference between references - beyond it the merged
pileup smears by +-1 and the deletion rule starts dropping interior columns
(this was the dominant consensus-corruption mode; see git history).

Fix: per leaf, the lowest-index reference is the ANCHOR; every other
reference gets a column map to the anchor's coordinates via banded global
alignment (host NumPy, exact, deterministic), and every read's columns are
projected through its best reference's map right after alignment. Columns
inserted relative to the anchor map to -1 (their bases are dropped from
pileups, exactly like read insertions).

The row recurrence uses linear gap costs so each DP row is computable with a
prefix-max scan (no in-row dependency): with t[j] = max(diag, up) the row is
max_k<=j (t[k] - g*(j-k)) = accum-max(t[k] + g*k) - g*j.
"""

from __future__ import annotations

import numpy as np

MATCH = 2
MISMATCH = -3
GAP = -4  # linear


def anchor_of_leaf(ref_taxon: np.ndarray) -> np.ndarray:
    """(n_refs,) index of each ref's leaf anchor (lowest ref index per leaf)."""
    anchors = {}
    out = np.zeros_like(ref_taxon)
    for r, t in enumerate(ref_taxon.tolist()):
        if t not in anchors:
            anchors[t] = r
        out[r] = anchors[t]
    return out


def _nw_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Global alignment of b onto a; returns (len(b),) int32 map b-pos ->
    a-pos (-1 = inserted relative to a). Linear gap costs, deterministic
    tie-break: diag > up (gap in a / insertion) > left (gap in b)."""
    La, Lb = len(a), len(b)
    D = np.zeros((Lb + 1, La + 1), np.int32)
    D[0, :] = GAP * np.arange(La + 1)
    D[:, 0] = GAP * np.arange(Lb + 1)
    sub = np.where(b[:, None] == a[None, :], MATCH, MISMATCH)
    jj = np.arange(La + 1, dtype=np.int64)
    for i in range(1, Lb + 1):
        diag = D[i - 1, :-1] + sub[i - 1]
        up = D[i - 1, 1:] + GAP
        t = np.maximum(diag, up)
        t0 = np.concatenate(([D[i, 0]], t))
        row = np.maximum.accumulate(t0 + (-GAP) * jj) + GAP * jj
        D[i] = row
    # traceback
    out = np.full((Lb,), -1, np.int32)
    i, j = Lb, La
    while i > 0 and j > 0:
        if D[i, j] == D[i - 1, j - 1] + sub[i - 1, j - 1]:
            out[i - 1] = j - 1
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + GAP:
            i -= 1   # insertion in b relative to a -> -1 stays
        else:
            j -= 1   # deletion: a column skipped
    return out


def build_col_maps(ref_seqs: np.ndarray, ref_lens: np.ndarray,
                   ref_taxon: np.ndarray) -> np.ndarray:
    """(n_refs, ref_len_max) int32: per-ref column -> LEAF-ANCHOR column
    (-1 = unmapped). Identity for anchors and equal-sequence refs.

    Per-leaf anchors keep every taxon's own coordinates lossless (a global
    template would drop taxon-specific insertions and distort divergent
    variable regions). Cross-taxon consistency for tree-shared reads is
    provided by OFFSET-PRESERVING PANELS instead: every consensus gene
    records the anchor column of its first base (Gene.offset) and is placed
    at that offset in the next round's reference array, so all panel
    coordinates remain mutually aligned without any projection loss.
    """
    n_refs, Lmax = ref_seqs.shape
    anchors = anchor_of_leaf(np.asarray(ref_taxon))
    cmap = np.full((n_refs, Lmax), -1, np.int32)
    ident = np.arange(Lmax, dtype=np.int32)
    for r in range(n_refs):
        Lr = int(ref_lens[r])
        ar = int(anchors[r])
        if ar == r:
            cmap[r, :Lr] = ident[:Lr]
            continue
        La = int(ref_lens[ar])
        if Lr == La and np.array_equal(ref_seqs[r, :Lr], ref_seqs[ar, :La]):
            cmap[r, :Lr] = ident[:Lr]
            continue
        cmap[r, :Lr] = _nw_map(ref_seqs[ar, :La], ref_seqs[r, :Lr])
    return cmap
