"""The comparisons that decide `correct`: the port's outputs, read only to
be judged, against the plain reference's. Every comparison is exact, so
every limit is 0."""

from __future__ import annotations

import numpy as np

ROW_FIELDS = ("query", "ref_col", "bins", "score", "ref", "strand")


def rows_differing(prog: dict, ref: dict) -> int:
    """Reads whose retained outputs differ in any field."""
    bad = np.zeros(prog["bins"].shape[0], bool)
    for f in ROW_FIELDS:
        a = np.asarray(prog[f]).astype(np.int64)
        b = np.asarray(ref[f]).astype(np.int64)
        d = a != b
        bad |= d.reshape(d.shape[0], -1).any(1)
    return int(bad.sum())


def nodes_differing(a, b) -> int:
    a = np.asarray(a).astype(np.int64).reshape(np.shape(a)[0], -1)
    b = np.asarray(b).astype(np.int64).reshape(np.shape(b)[0], -1)
    return int((a != b).any(1).sum())


def port_leaf(cons, kact, n_mem, mh, i: int, p) -> dict:
    """Leaf i of `cluster_stage`'s outputs in the reference's form
    {n_mem, kact, genes}, the genes read off as the port's round does: a
    cluster below `min_cluster_reads` or with nothing emitted gives none,
    and the minor-haplotype gene follows the clusters."""
    if int(n_mem[i]) < p.min_cluster_reads:
        return dict(n_mem=int(n_mem[i]), kact=None, genes=[])
    called, emit, nk = (np.asarray(x[i]) for x in cons)
    genes = []
    for k in range(int(kact[i])):
        if nk[k] < p.min_cluster_reads:
            continue
        seq = called[k][emit[k]].astype(np.int8)
        if seq.shape[0]:
            genes.append((k, int(nk[k]), int(np.argmax(emit[k])),
                          seq.tobytes()))
    m_called, m_emit, m_n, m_cols = (np.asarray(x[i]) for x in mh)
    if int(m_cols) >= max(1, p.minorhap_min_cols):
        seq = m_called[m_emit].astype(np.int8)
        if seq.shape[0] and int(m_n) >= p.min_cluster_reads:
            genes.append((p.max_clusters_per_bin, int(m_n),
                          int(np.argmax(m_emit)), seq.tobytes()))
    return dict(n_mem=int(n_mem[i]), kact=int(kact[i]), genes=genes)


def leaf_differs(prog: dict, ref: dict) -> bool:
    return (prog["n_mem"] != ref["n_mem"] or prog["kact"] != ref["kact"]
            or prog["genes"] != ref["genes"])
