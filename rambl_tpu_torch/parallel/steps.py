"""Data-parallel steps of the assembly round over a `DataMesh`.

Port of the seven steps of `rambl_tpu/parallel/steps.py`: the stream's
(`make_align_bin_step`, `make_retain_step`, `make_pileup_merge_step`,
`make_read_count_step`), the slot pileup (`make_slot_pileup_step`), the
leaf-sharded clustering (`make_cluster_step`) and the one-batch align +
pileup step (`make_align_pileup_step`). Each `shard_map` body becomes a loop
over ranks,
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

The reference's steps are cached per mesh and config only so that jit
reuses one executable; these return plain closures.
"""

from __future__ import annotations

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.parallel.mesh import DataMesh, psum, psum_scatter
from rambl_tpu_torch.pipeline.assemble import (
    _align_bin_batch,
    _bin_project,
    _read_count,
    cluster_round0_members,
)
from rambl_tpu_torch.pipeline.cluster import bin_sort, member_table_ranges
from rambl_tpu_torch.pipeline.pileup import node_pileup, node_slot_pileup
from rambl_tpu_torch.utils import trace


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
            with trace.span("align.bin"):
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


def make_slot_pileup_step(mesh: DataMesh, n_slots: int, ref_len: int):
    """Slot-compacted pileup over the streamed retention, merged across
    ranks (full-Greengenes-scale taxonomies, `pipeline.pileup` slot mode).

    step(qbuf, rbuf, bbuf, node2slot) -> (counts_s, span_s), per-rank lists
    of the summed (n_slots, ref_len*4) and (n_slots, ref_len+1) int32
    accumulators; node2slot per rank (replicated)."""

    def step(q_sh, rc_sh, bins_sh, node2slot):
        mesh.fork()
        counts, spans = [], []
        for r in range(mesh.size):
            with mesh.rank(r):
                query, proj, bins = _flat_local(q_sh[r], rc_sh[r], bins_sh[r])
                c, s = node_slot_pileup(query, proj, bins, node2slot[r],
                                        n_slots, ref_len)
                counts.append(c)
                spans.append(s)
        mesh.join()
        return psum(counts, mesh), psum(spans, mesh)

    return step


def make_align_pileup_step(mesh: DataMesh, cfg: PipelineConfig, n_bits: int,
                           n_nodes: int, ref_len: int, ring: bool = False,
                           shard_positions: bool = False):
    """Align + bin + pileup of one batch, the pileup merged across ranks.

    step(reads, lens, table, st), arguments as `make_align_bin_step`'s ->
    (query, proj_ref_col, bins, score: each rank's rows;
     counts, span_diff, read_count: merged), all per-rank lists. With
    shard_positions the counts and span_diff are merged by psum_scatter over
    columns under the reference's WIDTH CONTRACT (`make_pileup_merge_step`):
    rank r keeps the r-th column slice, the span axis padded to
    ref_len + n; callers slice the joined span_diff back to ref_len + 1."""
    align = make_align_bin_step(mesh, cfg, n_bits, ring=ring)
    merge = make_pileup_merge_step(mesh, n_nodes, ref_len,
                                   shard_positions=shard_positions)

    def step(reads, lens, table, st):
        outs = align(reads, lens, table, st)
        query, proj, bins, score = ([o[j] for o in outs] for j in range(4))
        counts, span_diff, read_count = merge(
            [q[None] for q in query], [p[None] for p in proj],
            [b[None] for b in bins])
        return query, proj, bins, score, counts, span_diff, read_count

    return step


def leaf_slices(n_leaves: int, n: int) -> list:
    """Rank r's contiguous (lo, hi) range of n_leaves leaves: sizes differ
    by at most one, and a rank may get none."""
    cuts = [r * n_leaves // n for r in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def gather_members(mesh: DataMesh, q_sh, rc_sh, midx: torch.Tensor,
                   r: int):
    """Rank r's member rows of a member table `midx` (NL, M) of stream rows,
    each row fetched from the rank that retains it -> (qm (NL, M, L) int8,
    rcm (NL, M, L) int32). Stream row g lives on rank (g % bs) // (bs/n) at
    (g // bs, (g % bs) % (bs/n)). The reference completes this all-to-all
    with a masked local gather on every device and a psum, the only way
    inside shard_map; one process drives every rank here, so each row comes
    from its owner alone: bitwise the same, since every row has exactly one
    owner. Called between mesh.fork() and mesh.join()."""
    n = mesh.size
    nb, bl, L = q_sh[r].shape
    bs = bl * n
    dev = mesh.devices[r]
    g = midx.long()
    bi, row = g // bs, g % bs
    owner, rl = row // bl, row % bl
    qm = torch.zeros(midx.shape + (L,), dtype=torch.int8, device=dev)
    rcm = torch.zeros(midx.shape + (L,), dtype=torch.int32, device=dev)
    for o in range(n):
        own = owner == o
        at = mesh.devices[o]
        bo = torch.where(own, bi, 0).to(at)
        ro = torch.where(own, rl, 0).to(at)
        own = own[..., None]
        qm = torch.where(own, q_sh[o][bo, ro].to(dev), qm)
        rcm = torch.where(own, rc_sh[o][bo, ro].to(dev, torch.int32), rcm)
    return qm, rcm


def make_cluster_step(mesh: DataMesh, cfg: PipelineConfig,
                      slots: bool = False, spawn: bool = True):
    """Leaf-sharded round-0 clustering over the streamed retention (the
    reference's EP step: per-taxon bins are the experts).

    step(qbuf, rbuf, bins, counts, span_diff, read_count, leaves, anc_path,
         depth[, node2slot]) with qbuf / rbuf each rank's (nb, bs/n, L)
    retention, `leaves` a host int array and every other argument a
    per-rank list of replicated tensors (`bins` the (B,) stream-order bin
    vector; node2slot only with slots=True, whose counts are
    slot-compacted). Rank r takes the leaves of `leaf_slices(NL, n)[r]`
    (the reference pads the leaves to a multiple of the mesh so that XLA
    gets equal slices; uneven slices need no pad), builds their member table
    from the replicated bins by `cluster_round0_core`'s rule (a leaf's
    member row does not depend on the other leaves), gathers its member rows
    (`gather_members`) and runs `cluster_round0_members` on them. Returns a
    per-rank list of (ConsensusOut, kact, n_mem, MinorHap) over the rank's
    leaf slice, None for a rank with no leaves: the slices in rank order
    are the leaves in the order given. The B-read bin sort runs on every
    rank, as in the reference."""

    def step(q_sh, rc_sh, bins, counts, span_diff, read_count, leaves,
             anc_path, depth, node2slot=None):
        if slots != (node2slot is not None):
            raise ValueError("node2slot is given exactly when slots=True")
        n = mesh.size
        leaves = np.asarray(leaves, np.int32)
        mesh.fork()
        out = []
        for r, (lo, hi) in enumerate(leaf_slices(leaves.size, n)):
            if lo == hi:
                out.append(None)
                continue
            with mesh.rank(r):
                dev = mesh.devices[r]
                lv = torch.from_numpy(leaves[lo:hi]).to(dev)
                order, nstart, nend = bin_sort(bins[r], anc_path[r].shape[0])
                midx, mvalid = member_table_ranges(
                    order, nstart, nend, lv, anc_path[r], depth[r],
                    min(cfg.max_bin_reads, bins[r].shape[0]),
                    cfg.bin_share_depth)
                qm, rcm = gather_members(mesh, q_sh, rc_sh, midx, r)
                out.append(cluster_round0_members(
                    qm, rcm, bins[r][midx.long()], mvalid, counts[r],
                    span_diff[r], read_count[r], lv, anc_path[r], depth[r],
                    cfg, node2slot=node2slot[r] if slots else None,
                    spawn=spawn))
        mesh.join()
        return out

    return step
