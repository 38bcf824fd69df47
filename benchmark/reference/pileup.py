"""Read counts and pileups over reads' bins, columns and bases.

A read adds one to its bin node's count, and each of its aligned bases
(column >= 0, code < 4) one to its node's (column, base) count; its span
from its first to its last aligned column adds +1 at the first and -1 one
past the last (an interval-difference row). Counts are made in `dtype`:
int64 for the reference, a narrower integer for its control."""

from __future__ import annotations

import numpy as np


def read_counts(bins: np.ndarray, n_nodes: int, dtype=np.int64):
    return np.bincount(bins[bins >= 0], minlength=n_nodes).astype(dtype)


def node_pileup(query, ref_col, bins, n_nodes: int, ref_len: int,
                dtype=np.int64, rows: int = 1 << 18):
    """(counts (n_nodes, ref_len * 4), span_diff (n_nodes, ref_len + 1))
    of every read with a bin."""
    counts = np.zeros(n_nodes * ref_len * 4, np.int64)
    span = np.zeros(n_nodes * (ref_len + 1), np.int64)
    for s in range(0, query.shape[0], rows):
        q = np.asarray(query[s:s + rows]).astype(np.int64)
        rc = np.asarray(ref_col[s:s + rows]).astype(np.int64)
        b = np.asarray(bins[s:s + rows]).astype(np.int64)
        ok = (rc >= 0) & (q < 4) & (b[:, None] >= 0)
        flat = ((b[:, None] * ref_len + rc) * 4 + q)[ok]
        counts += np.bincount(flat, minlength=counts.size)
        has = ok.any(1)
        lo = np.where(ok, rc, 1 << 30).min(1)[has]
        hi = np.where(ok, rc, -1).max(1)[has]
        node = b[has] * (ref_len + 1)
        span += np.bincount(node + lo, minlength=span.size)
        span -= np.bincount(node + np.minimum(hi + 1, ref_len),
                            minlength=span.size)
    return (counts.reshape(n_nodes, ref_len * 4).astype(dtype),
            span.reshape(n_nodes, ref_len + 1).astype(dtype))
