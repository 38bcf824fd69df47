"""Data-parallel steps of the read stream over a `DataMesh`.

Port of the stream's steps of `rambl_tpu/parallel/steps.py`
(`make_align_bin_step`, `make_retain_step`, `make_pileup_merge_step`,
`make_read_count_step`). Each `shard_map` body becomes a loop over ranks,
rank r's work on its device and stream between `mesh.fork()` and
`mesh.join()`; `psum` and `psum_scatter` are `parallel.mesh.psum` /
`psum_scatter`. Reads shard over the ranks; the seed table is
replicated (a per-rank `SeedTable` list) or ring-sharded (`ring.RingShards`).
Counts are integers, so the merged accumulators are bitwise the
single-device stream's.

Streamed retention layout (the reference's RETAIN3 / RETAIN2): rank d holds
rows [d*bs/n, (d+1)*bs/n) of EVERY batch as (nb, bs/n, L) query and ref_col
buffers and an (nb, bs/n) bins buffer; stream-order read g is batch g // bs,
row g % bs.

`make_cluster_step`, `make_slot_pileup_step` and `make_align_pileup_step`
are not ported yet.
"""

from __future__ import annotations

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.parallel.mesh import DataMesh, psum, psum_scatter
from rambl_tpu_torch.pipeline.assemble import (
    _align_bin_batch,
    _bin_project,
    _read_count,
)
from rambl_tpu_torch.pipeline.pileup import node_pileup


def make_align_bin_step(mesh: DataMesh, cfg: PipelineConfig, n_bits: int,
                        ring: bool = False):
    """Per-batch align + bin step, no pileup and no collectives.

    step(reads, lens, table, st) with per-rank lists of (bs/n, L) int8 reads
    and (bs/n,) int32 lengths, `table` a per-rank `SeedTable` list (ring
    False) or the `RingShards` (ring True), and `st` per-rank
    `StreamTables` -> per-rank (query, proj_ref_col, bins, score, ref,
    strand), bitwise `assemble._align_bin_batch` on the same rows."""

    def step(reads, lens, table, st):
        mesh.fork()
        if ring:
            from rambl_tpu_torch.parallel.ring import ring_align_batch

            res = ring_align_batch(mesh, reads, lens, table,
                                   [s.ref_seqs for s in st], cfg, n_bits)
            out = []
            for r in range(mesh.size):
                with mesh.rank(r):
                    out.append(_bin_project(res[r], st[r], cfg))
        else:
            out = []
            for r in range(mesh.size):
                with mesh.rank(r):
                    out.append(_align_bin_batch(reads[r], lens[r], table[r],
                                                st[r], cfg))
        mesh.join()
        return out

    return step


def make_retain_step(mesh: DataMesh):
    """In-place write of batch i's per-rank align outputs into the
    retention buffers (ref_col narrows to the buffer's dtype: int16 when
    ref_len fits, exact).

    fill(qbuf, rbuf, bbuf, q, rc, bins, i), all per-rank lists."""

    def fill(qbuf, rbuf, bbuf, q, rc, bins, i: int) -> None:
        mesh.fork()
        for r in range(mesh.size):
            with mesh.rank(r):
                qbuf[r][i] = q[r]
                rbuf[r][i] = rc[r].to(rbuf[r].dtype)
                bbuf[r][i] = bins[r]
        mesh.join()

    return fill


def _flat_local(q_sh, rc_sh, bins_sh):
    """A rank's (nb, bs/n, ...) retention -> flat per-read arrays."""
    nb, bl, L = q_sh.shape
    return (q_sh.reshape(nb * bl, L), rc_sh.reshape(nb * bl, L),
            bins_sh.reshape(nb * bl))


def make_pileup_merge_step(mesh: DataMesh, n_nodes: int, ref_len: int,
                           shard_positions: bool = False):
    """One pileup over the whole streamed retention, merged across ranks.

    step(qbuf, rbuf, bbuf) -> (counts, span_diff, read_count), per-rank
    lists: every rank gets the summed (n_nodes, ref_len*4) counts,
    (n_nodes, ref_len+1) span_diff and (n_nodes,) read_count. With
    shard_positions the counts and span_diff are merged by psum_scatter
    over columns: rank r keeps the r-th of n column slices, and the span
    axis is zero-padded to ref_len + n so it divides the mesh.

    WIDTH CONTRACT (the reference's, `steps.py` `make_align_pileup_step`):
    with shard_positions the span_diff slices concatenate to (n_nodes,
    ref_len + n); callers slice back to [:, :ref_len + 1]; the pad columns
    are always zero, so the slice is exact."""
    n = mesh.size
    span_w = ref_len + 1
    if shard_positions:
        if ref_len % n:
            raise ValueError(f"ref_len {ref_len} must divide the {n}-rank "
                             "mesh for shard_positions")
        span_w = ref_len + n

    def step(q_sh, rc_sh, bins_sh):
        mesh.fork()
        counts, spans, rcs = [], [], []
        for r in range(n):
            with mesh.rank(r):
                query, proj, bins = _flat_local(q_sh[r], rc_sh[r], bins_sh[r])
                c, s = node_pileup(query, proj, bins, n_nodes, ref_len)
                if span_w != ref_len + 1:
                    s = torch.nn.functional.pad(s, (0, span_w - ref_len - 1))
                counts.append(c)
                spans.append(s)
                rcs.append(_read_count(bins, n_nodes))
        mesh.join()
        merge = psum_scatter if shard_positions else psum
        return merge(counts, mesh), merge(spans, mesh), psum(rcs, mesh)

    return step


def make_read_count_step(mesh: DataMesh, n_nodes: int):
    """Merged per-node read counts from the per-rank bins retention (slot
    mode needs the global counts before any pileup)."""

    def step(bins_sh):
        mesh.fork()
        rcs = []
        for r in range(mesh.size):
            with mesh.rank(r):
                rcs.append(_read_count(bins_sh[r].reshape(-1), n_nodes))
        mesh.join()
        return psum(rcs, mesh)

    return step
