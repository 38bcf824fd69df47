"""Pileup consensus calling (oracle).

Replaces `samtools mpileup` + per-column Python (SURVEY.md L7): per cluster,
scatter-add (column, base) counts plus span/deletion coverage, then call:

- a read covers columns [min_col, max_col] of its alignment; aligned positions
  contribute a base count, covered-but-unaligned columns contribute a deletion
  count (del = span_cover - base_cover);
- consensus spans [first, last] column with any base coverage;
- a column is emitted iff base_cover > 0 and del <= base_cover; the called
  base is argmax of counts (ties -> lowest base code A<C<G<T);
- columns with zero coverage inside the span are skipped (no information).

The port's copy of `rambl_tpu/oracle/consensus.py`, unchanged in behaviour.
"""

from __future__ import annotations

import numpy as np


def cluster_pileup(query: np.ndarray, ref_col: np.ndarray, ref_len: int):
    """Returns (counts (ref_len, 4) int32, span_cover (ref_len,) int32)."""
    counts = np.zeros((ref_len, 4), dtype=np.int32)
    span = np.zeros((ref_len + 1,), dtype=np.int32)  # +1 for diff trick
    ok = (ref_col >= 0) & (query < 4)
    np.add.at(counts, (ref_col[ok], query[ok].astype(np.int64)), 1)
    # span coverage via interval diff
    has = ok.any(axis=1)
    if has.any():
        masked = np.where(ok, ref_col, np.int32(1 << 30))
        lo = masked.min(axis=1)[has]
        masked = np.where(ok, ref_col, -1)
        hi = masked.max(axis=1)[has]
        np.add.at(span, lo, 1)
        np.add.at(span, hi + 1, -1)
    span_cover = np.cumsum(span[:-1]).astype(np.int32)
    return counts, span_cover


def call_consensus(counts: np.ndarray, span_cover: np.ndarray):
    """Emit consensus codes per the module rules.

    Returns (seq int8 (n,), offset int): offset is the column of the first
    emitted base (for offset-preserving panels). Empty -> ((0,), 0).
    """
    base_cover = counts.sum(axis=1)
    covered = np.nonzero(base_cover > 0)[0]
    if covered.size == 0:
        return np.zeros((0,), np.int8), 0
    lo, hi = int(covered[0]), int(covered[-1])
    dele = span_cover - base_cover
    emit = (base_cover > 0) & (dele <= base_cover)
    emit[:lo] = False
    emit[hi + 1 :] = False
    cols = np.nonzero(emit)[0]
    off = int(cols[0]) if cols.size else 0
    # argmax base, ties -> lowest code (np.argmax picks first max)
    return np.argmax(counts[cols], axis=1).astype(np.int8), off
