"""Assembly on the device: the read stream and round 0 of the assembly.

Port of `rambl_tpu/pipeline/assemble.py`, bit-identical to it: the stream
(`_align_bin_batch`, `_pileup_accum`, `_read_count_accum`, `_pad_batches`,
`_stream_align` and, over a mesh of ranks, `_stream_align_mesh`) and the
round (`assemble_round_jax` as `assemble_round`, with
`cluster_round0_members`, `cluster_round0_core`, `_genes_from_consensus` and
`_dedupe_cap`). Reads go through the align + bin step in fixed-size batches
(the last one padded with empty reads, which bin to -1); per-read outputs
are kept in preallocated device buffers and the node-space pileup
accumulators are summed on the device. Round 0 then discovers variants per
leaf bin (DP-means -> variant-aware consensus); panel management (gene
lists, dedupe) is host logic on tiny data.

The whole assembly (`assemble_jax` as `assemble`): round 0, the refinement
rounds (each a full discovery round against the last round's panel) until
the panel repeats or `max_assembly_iters`, per-round checkpoints and
resume, and the final polish (`polish_jax` as `polish`, its evidence from
`leaf_counts_dict`); `assemble_cohort` runs one `assemble` per sample
against a shared index, then cross-sample covariation phasing. The
reference pads each panel to a 32-gene bucket only so that XLA reuses one
compiled executable; pad references are all-N and inert, so the port
leaves the padding out (tests/test_torch_assemble.py shows it neutral).

Every entry point takes `mesh=` (a `parallel.mesh.DataMesh`; `device` is
then unused): the stream runs data-parallel (`_stream_align_mesh`), the slot
pileup and the clustering run as the reference's shard_map steps
(`parallel.steps.make_slot_pileup_step`, `make_cluster_step`: each rank
clusters a slice of the leaves), and the outputs are bitwise those of the
same call without a mesh. Round-0 evidence kept for polish is rank 0's
replica (whole rows), so checkpoints and sidecars do not depend on the mesh.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, NamedTuple

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import resolve, to_host
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.ops.seed import SeedTable
from rambl_tpu_torch.pipeline.align import align_batch
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.pipeline.binning import bin_batch
from rambl_tpu_torch.pipeline.cluster import (
    bin_sort,
    dp_means_leaves,
    feature_columns,
    leaf_features_dense,
    member_table_ranges,
)
from rambl_tpu_torch.pipeline.consensus import (
    ConsensusOut,
    MinorHap,
    _chain_read_count,
    cluster_consensus_leaves,
    minor_haplotype_leaves,
)
from rambl_tpu_torch.pipeline.pileup import (
    leaf_pileup,
    leaf_pileup_slots,
    node_pileup,
    node_slot_pileup,
    polymorphic_mask,
)
from rambl_tpu_torch.utils.errors import UserError

RETAINED = ("query", "ref_col", "bins", "score", "ref", "strand")


def _stage_timing() -> bool:
    return bool(int(os.environ.get("RAMBL_STAGE_TIMING", "0")))


class _StageClock:
    """Accumulates wall time per named stage when the environment sets
    RAMBL_STAGE_TIMING=1 (read as the clock is made), else does nothing.
    Diagnostic only: a mark synchronizes the card its tensors are on, which
    serializes the dispatch pipeline, so leave it off for benchmarks."""

    def __init__(self):
        self.on = _stage_timing()
        self.t = {}
        self._last = time.time()

    def mark(self, name, *sync):
        if not self.on:
            return
        for x in sync:
            for t in (x if isinstance(x, list) else [x]):   # mesh: per rank
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
        now = time.time()
        dt = now - self._last
        self.t[name] = round(self.t.get(name, 0.0) + dt, 2)
        self._last = now
        if dt > 5.0:
            # live progress for long runs: stage boundaries as they happen
            # (stderr; the stats dict still gets the per-round totals)
            print(f"[stage] {name} +{dt:.0f}s", file=sys.stderr, flush=True)

    def into(self, stats):
        if self.on:
            stats.update({f"t_{k}": v for k, v in self.t.items()})


class StreamTables(NamedTuple):
    """Device copies of the reference panel, taxonomy and column maps."""

    ref_seqs: torch.Tensor    # (R, ref_len) int8
    ref_taxon: torch.Tensor   # (R,) int32 leaf node per reference
    anc_path: torch.Tensor    # (n_nodes, MAX_DEPTH) int32
    depth: torch.Tensor       # (n_nodes,) int32
    col_map: torch.Tensor     # (R, ref_len) int32 column -> leaf-anchor column

    @staticmethod
    def from_host(ref_seqs, tables, col_map, device) -> "StreamTables":
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

        return StreamTables(
            ref_seqs=put(ref_seqs, torch.int8),
            ref_taxon=put(tables.ref_taxon, torch.int32),
            anc_path=put(tables.anc_path, torch.int32),
            depth=put(tables.depth, torch.int32),
            col_map=put(col_map, torch.int32),
        )


def _align_bin_batch(reads, lens, table: SeedTable, st: StreamTables,
                     cfg: PipelineConfig):
    """Align + bin one batch, with ref columns projected to leaf-anchor
    coordinates -> (query, proj, bins, score, ref, strand). The lengths are
    not checked against cfg.sw_rows here: the stream checks them on the host
    (the reference's jitted step leaves the check to it too)."""
    return _bin_project(align_batch(reads, lens, table, st.ref_seqs, cfg,
                                    check_rows=False), st, cfg)


def _bin_project(res, st: StreamTables, cfg: PipelineConfig):
    """Bin aligned records and project their ref columns to leaf-anchor
    coordinates -> (query, proj, bins, score, ref, strand)."""
    bins = bin_batch(res, st.ref_taxon, st.anc_path, st.depth, cfg)
    R, RL = st.ref_seqs.shape
    refc = torch.clamp(res.ref, 0, R - 1).long()
    rc = res.ref_col
    proj = torch.where(
        rc >= 0, st.col_map[refc[:, None], torch.clamp(rc, 0, RL - 1).long()],
        -1).to(torch.int32)
    return res.query, proj, bins, res.score, res.ref, res.strand


def _read_count(bins: torch.Tensor, n_nodes: int) -> torch.Tensor:
    rc = torch.zeros((n_nodes + 1,), dtype=torch.int32, device=bins.device)
    idx = torch.where(bins >= 0, bins, n_nodes).long()
    rc.index_add_(0, idx, torch.ones_like(bins, dtype=torch.int32))
    return rc[:-1]


def _pileup_accum(query, ref_col, bins, counts, span_diff, read_count,
                  n_nodes: int, ref_len: int) -> None:
    """Add one batch into the dense accumulators, in place."""
    c, s = node_pileup(query, ref_col, bins, n_nodes, ref_len)
    counts += c
    span_diff += s
    read_count += _read_count(bins, n_nodes)


def _read_count_accum(bins, read_count, n_nodes: int) -> None:
    """Add one batch's per-node read counts, in place."""
    read_count += _read_count(bins, n_nodes)


def _pad_batches(reads: np.ndarray, lens: np.ndarray, batch: int):
    B = reads.shape[0]
    nb = -(-B // batch)
    pad = nb * batch - B
    if pad:
        reads = np.concatenate(
            [reads, np.full((pad, reads.shape[1]), 4, np.int8)])
        lens = np.concatenate([lens, np.zeros((pad,), np.int32)])
    return reads, lens, nb, B


def stream_align(reads, lens, index, ref_seqs, ref_lens, tables,
                 cfg: PipelineConfig, mesh=None, col_maps=None, *,
                 device=None, ring_shards=None, stream_tables=None):
    """Stream host reads through the align + bin step on `device` (the
    first CUDA card when None; pass "cpu" for the plain PyTorch path).

    reads (N, L) int8 and lens (N,) int32 are host numpy arrays; index is the
    host `SeedIndex`, tables the host `TaxonomyTables`. Returns
    (merged, counts, span_diff, read_count) like the reference:

    - merged: dict of device tensors for the N real reads: query (N, L) int8,
      ref_col (N, L) projected columns (int16 when ref_len <= 32767, else
      int32), bins, score, ref (N,) int32, strand (N,) int8;
    - counts (n_nodes, ref_len*4) and span_diff (n_nodes, ref_len+1) int32,
      or both None when n_nodes > cfg.pileup_slot_nodes (slot mode: the
      caller builds slot accumulators after the stream);
    - read_count (n_nodes,) int32 reads binned at each node.

    Host batches are copied from pinned memory with non_blocking=True, one
    batch ahead of the batch being aligned.

    The lengths are checked against cfg.sw_rows here, on the host, once;
    the batches skip the device-side check, which would sync each one.

    With `mesh` (a `parallel.mesh.DataMesh`; `device` is then unused) the
    stream runs data-parallel, see `_stream_align_mesh`; `ring_shards` and
    `stream_tables` are only for that case.
    """
    if cfg.sw_rows and int(np.max(lens, initial=0)) > cfg.sw_rows:
        raise UserError(
            f"cfg.sw_rows={cfg.sw_rows} < longest read {int(np.max(lens))}: "
            "the truncated SW sweep is only exact when every real read fits")
    if mesh is not None:
        return _stream_align_mesh(reads, lens, index, ref_seqs, ref_lens,
                                  tables, cfg, mesh, col_maps, ring_shards,
                                  stream_tables)
    if ring_shards is not None or stream_tables is not None:
        raise ValueError("ring_shards and stream_tables need a mesh")
    device = resolve(device)
    table = SeedTable.from_index(index, device)
    if col_maps is None:
        col_maps = build_col_maps(np.asarray(ref_seqs), np.asarray(ref_lens),
                                  np.asarray(tables.ref_taxon))
    st = StreamTables.from_host(ref_seqs, tables, col_maps, device)
    n_nodes = tables.n_nodes
    ref_len = ref_seqs.shape[1]
    i32 = torch.int32

    padded, plens, nb, B = _pad_batches(np.asarray(reads, np.int8),
                                        np.asarray(lens, np.int32),
                                        cfg.batch_size)
    dense = n_nodes <= cfg.pileup_slot_nodes
    if dense:
        counts = torch.zeros((n_nodes, ref_len * 4), dtype=i32, device=device)
        span_diff = torch.zeros((n_nodes, ref_len + 1), dtype=i32,
                                device=device)
    else:
        counts = span_diff = None
    read_count = torch.zeros((n_nodes,), dtype=i32, device=device)

    host_reads = torch.from_numpy(padded)
    host_lens = torch.from_numpy(plens)
    if device.type == "cuda":
        host_reads = host_reads.pin_memory()
        host_lens = host_lens.pin_memory()

    def _put(i):
        sl = slice(i * cfg.batch_size, (i + 1) * cfg.batch_size)
        return (host_reads[sl].to(device, non_blocking=True),
                host_lens[sl].to(device, non_blocking=True))

    BT = nb * cfg.batch_size
    bufs = retention_buffers(BT, padded.shape[1], ref_len, device)
    stream_batches(_put, nb, table, st, cfg, bufs, read_count, counts,
                   span_diff)
    merged = {k: (v if BT == B else v[:B]) for k, v in bufs.items()}
    return merged, counts, span_diff, read_count


def retention_buffers(rows: int, L: int, ref_len: int, device) -> dict:
    """The stream's retention buffers of `rows` reads, filled in place;
    projected columns are < ref_len, so int16 holds them exactly when
    ref_len <= 32767."""
    i32 = torch.int32
    compact = ref_len <= 32767
    return {
        "query": torch.zeros((rows, L), dtype=torch.int8, device=device),
        "ref_col": torch.zeros((rows, L), dtype=torch.int16 if compact
                               else i32, device=device),
        "bins": torch.zeros((rows,), dtype=i32, device=device),
        "score": torch.zeros((rows,), dtype=i32, device=device),
        "ref": torch.zeros((rows,), dtype=i32, device=device),
        "strand": torch.zeros((rows,), dtype=torch.int8, device=device),
    }


def stream_batches(put, nb: int, table: SeedTable, st: StreamTables,
                   cfg: PipelineConfig, bufs: dict, read_count,
                   counts=None, span_diff=None) -> None:
    """The single-device stream's loop: batch i (`put(i)` copies it to the
    device, one batch ahead of the one being aligned) through the align +
    bin step, its outputs into rows [i * batch, (i + 1) * batch) of `bufs`,
    its bins into `read_count` and, with `counts`, its pileup into the
    dense accumulators, all in place."""
    n_nodes = read_count.shape[0]
    bs = cfg.batch_size
    nxt = put(0) if nb else None
    for i in range(nb):
        cur, nxt = nxt, (put(i + 1) if i + 1 < nb else None)
        outs = _align_bin_batch(cur[0], cur[1], table, st, cfg)
        q, rc, b = outs[0], outs[1], outs[2]
        if counts is not None:
            _pileup_accum(q, rc, b, counts, span_diff, read_count, n_nodes,
                          st.ref_seqs.shape[1])
        else:
            _read_count_accum(b, read_count, n_nodes)
        for k, v in zip(RETAINED, outs):
            bufs[k][i * bs:(i + 1) * bs] = v


def _stream_align_mesh(reads, lens, index, ref_seqs, ref_lens, tables,
                       cfg: PipelineConfig, mesh, col_maps=None,
                       ring_shards=None, stream_tables=None):
    """Data-parallel `stream_align` over the ranks of `mesh` (the
    reference's `_stream_align_mesh`, bitwise).

    Each batch's rows split evenly over the ranks. The seed table is
    replicated, or with cfg.shard_index split into bucket ranges that rotate
    around the ring (`parallel.ring`, transport cfg.ring_impl). Per-read
    query / ref_col / bins are retained where they were computed, rank d
    holding rows [d*bs/n, (d+1)*bs/n) of every batch (`parallel.steps`);
    the node-space pileup is merged once after the stream (psum, or
    psum_scatter over columns with cfg.shard_positions).

    `ring_shards` (with cfg.shard_index): a `parallel.ring.RingShards` of
    `index` on this mesh, built once with `build_ring_shards`, so that
    several samples stream against one sharded index without building and
    uploading it again; the ring leaves every shard where it found it.

    `stream_tables`: per-rank `StreamTables` of `ref_seqs`, `tables` and
    `col_maps`, each on its rank's card (virtual ranks of a card may share
    one), built once with `StreamTables.from_host`, so that the stream
    uploads none of them.

    Returns (merged, counts, span_diff, read_count), every tensor as a
    per-rank list: merged["bins", "score", "ref", "strand"] (B,) replicated;
    merged["query"], merged["ref_col"] (nb, bs/n, L) and merged["bins_sh"]
    (nb, bs/n) each rank's retention; counts and span_diff replicated, or
    with shard_positions counts as each rank's column slice and span_diff
    replicated and trimmed to ref_len + 1; both None in slot mode
    (n_nodes > cfg.pileup_slot_nodes), where only read_count is merged.
    """
    from rambl_tpu_torch.parallel.mesh import put_replicated, put_sharded
    from rambl_tpu_torch.parallel.ring import RingShards, build_ring_shards
    from rambl_tpu_torch.parallel.ring_dma import check_ring
    from rambl_tpu_torch.parallel.steps import (
        make_align_bin_step,
        make_pileup_merge_step,
        make_read_count_step,
        make_retain_step,
    )

    n = mesh.size
    bs = cfg.batch_size
    if bs % n:
        raise UserError(f"batch_size {bs} must divide the {n}-rank mesh")
    if ring_shards is not None:
        if not cfg.shard_index:
            raise ValueError("ring_shards needs cfg.shard_index")
        if (ring_shards.mesh is not mesh
                or ring_shards.n_local != -(-index.n_buckets // n)):
            raise ValueError("ring_shards are not this index's shards on "
                             "this mesh")
        table = ring_shards
    elif cfg.shard_index:
        table = RingShards(build_ring_shards(index, n), mesh)
    else:
        # one upload a card: virtual ranks of a card share its copy
        per_dev = {d: SeedTable.from_index(index, d)
                   for d in dict.fromkeys(mesh.devices)}
        table = [per_dev[d] for d in mesh.devices]
    if col_maps is None:
        col_maps = build_col_maps(np.asarray(ref_seqs), np.asarray(ref_lens),
                                  np.asarray(tables.ref_taxon))
    if stream_tables is not None:
        st = list(stream_tables)
        if len(st) != n or any(
                s.ref_seqs.device != d or tuple(s.ref_seqs.shape)
                != tuple(np.shape(ref_seqs))
                or s.anc_path.shape[0] != tables.n_nodes
                for s, d in zip(st, mesh.devices)):
            raise ValueError("stream_tables are not this panel's tables on "
                             "this mesh's cards, one a rank")
    else:
        per_dev = {d: StreamTables.from_host(ref_seqs, tables, col_maps, d)
                   for d in dict.fromkeys(mesh.devices)}
        st = [per_dev[d] for d in mesh.devices]
    n_nodes = tables.n_nodes
    ref_len = ref_seqs.shape[1]

    padded, plens, nb, B = _pad_batches(np.asarray(reads, np.int8),
                                        np.asarray(lens, np.int32), bs)
    L = padded.shape[1]
    host_reads = torch.from_numpy(padded)
    host_lens = torch.from_numpy(plens)
    if mesh.on_card:
        host_reads = host_reads.pin_memory()
        host_lens = host_lens.pin_memory()

    def _put(i):
        sl = slice(i * bs, (i + 1) * bs)
        return put_sharded(host_reads[sl], mesh), put_sharded(host_lens[sl],
                                                              mesh)

    compact = ref_len <= 32767
    bl = bs // n
    qbuf = [torch.zeros((nb, bl, L), dtype=torch.int8, device=d)
            for d in mesh.devices]
    rbuf = [torch.zeros((nb, bl, L),
                        dtype=torch.int16 if compact else torch.int32,
                        device=d) for d in mesh.devices]
    bbuf = [torch.zeros((nb, bl), dtype=torch.int32, device=d)
            for d in mesh.devices]
    step = make_align_bin_step(mesh, cfg, index.n_bits, ring=cfg.shard_index)
    fill = make_retain_step(mesh)
    small = {k: [] for k in RETAINED[2:]}       # bins, score, ref, strand
    nxt = _put(0) if nb else None
    for i in range(nb):
        cur, nxt = nxt, (_put(i + 1) if i + 1 < nb else None)
        outs = step(cur[0], cur[1], table, st)
        fill(qbuf, rbuf, bbuf, *([o[j] for o in outs] for j in range(3)), i)
        for j, k in enumerate(RETAINED[2:], start=2):
            small[k] += [o[j] for o in outs]

    if n_nodes <= cfg.pileup_slot_nodes:
        pstep = make_pileup_merge_step(mesh, n_nodes, ref_len,
                                       shard_positions=cfg.shard_positions)
        counts, span_diff, read_count = pstep(qbuf, rbuf, bbuf)
        if cfg.shard_positions:
            # width contract: replicate the padded span rows, keep ref_len+1
            full = torch.cat([s.to(mesh.devices[0]) for s in span_diff], 1)
            span_diff = put_replicated(full[:, :ref_len + 1].contiguous(),
                                       mesh)
    else:
        counts = span_diff = None
        read_count = make_read_count_step(mesh, n_nodes)(bbuf)
    if cfg.shard_index and cfg.ring_impl == "dma_barrier":
        check_ring(mesh)

    dev0 = mesh.devices[0]
    merged = {k: put_replicated(torch.cat([t.to(dev0) for t in v])[:B], mesh)
              for k, v in small.items()}
    merged["query"] = qbuf
    merged["ref_col"] = rbuf
    merged["bins_sh"] = bbuf
    return merged, counts, span_diff, read_count


# --------------------------------------------------------------------------
# round 0: clustering + consensus per leaf bin
# --------------------------------------------------------------------------

def cluster_round0_members(qm, rcm, bins_m, mvalid, counts, span_diff,
                           read_count, leaves, anc_path, depth,
                           cfg: PipelineConfig, node2slot=None,
                           spawn: bool = True):
    """Round-0 clustering + consensus from pre-gathered member tensors.

    The post-gather half of cluster_round0_core. qm/rcm: (NL, M, L) member
    query codes / projected columns (int32); bins_m: (NL, M) member bin
    nodes; mvalid: (NL, M). node2slot switches the pileup accumulators to
    slot-compacted active-node space (full-Greengenes-scale taxonomies; see
    pipeline.pileup) - bitwise identical where slots exist. Features come
    from the dense featurizer (cluster.leaf_features_dense).

    spawn=False is the LIGHT path for leaves with no leaf-exclusive reads:
    their can_seed mask is all-false, so DP-means provably degenerates to
    assign-all-to-cluster-0 / kact=1 - skip features + DP entirely. Bitwise
    identical to spawn=True on such leaves."""
    ref_len = counts.shape[1] // 4   # counts rows are FLAT (node_pileup)
    if node2slot is None:
        leaf_counts, leaf_span = leaf_pileup(
            counts, span_diff, leaves, anc_path, depth, cfg.bin_share_depth)
        excl_counts = counts[leaves.long()].reshape(-1, ref_len, 4)
    else:
        leaf_counts, leaf_span = leaf_pileup_slots(
            counts, span_diff, node2slot, leaves, anc_path, depth,
            cfg.bin_share_depth)
        ls = node2slot[leaves.long()]
        excl_counts = torch.where(
            (ls >= 0)[:, None, None],
            counts[torch.clamp(ls, 0, counts.shape[0] - 1).long()].reshape(
                -1, ref_len, 4), 0)
    # consensus mask is UNCAPPED (capping would crowd out late discriminating
    # columns); the feature columns below take the first max_poly_cols of it
    pm = polymorphic_mask(
        leaf_counts, cfg.min_coverage, cfg.poly_min_minor_count,
        cfg.poly_minor_frac_num, cfg.poly_minor_frac_den, ref_len,
    )
    if spawn:
        pol_cols, pol_valid = feature_columns(pm, cfg.max_poly_cols)
        feat = leaf_features_dense(qm, rcm, mvalid, pol_cols, pol_valid,
                                   ref_len)
        can_seed = (bins_m == leaves[:, None]) & mvalid  # leaf-exclusive only
        dp = dp_means_leaves(feat, can_seed, cfg)
        assign, kact = dp.assign, dp.kact
    else:
        assign = torch.zeros(mvalid.shape, dtype=torch.int32,
                             device=mvalid.device)
        kact = torch.ones((mvalid.shape[0],), dtype=torch.int32,
                          device=mvalid.device)

    cons = cluster_consensus_leaves(
        qm, rcm, mvalid, assign, pm, leaf_counts, leaf_span, cfg
    )
    # node-space counts at the leaf itself = leaf-EXCLUSIVE pileup
    mh = minor_haplotype_leaves(excl_counts, leaf_counts, leaf_span, cfg)
    n_mem = _chain_read_count(read_count, leaves, anc_path, depth,
                              cfg.bin_share_depth)
    return cons, kact, n_mem, mh


def cluster_round0_core(query, ref_col, bins, counts, span_diff,
                        read_count, leaves, anc_path, depth,
                        cfg: PipelineConfig, node2slot=None,
                        spawn: bool = True, bin_ranges=None):
    """Round-0 clustering + consensus over a set of leaves, on the device of
    the tensors given.

    bin_ranges: optional precomputed (order, node_start, node_end) from
    cluster.bin_sort - `cluster_stage` sorts the B reads once for all
    of its blocks. Membership is range-based (O(NL*D*M), not O(NL*B)),
    its width capped at B so small runs keep the dense table's shapes."""
    if bin_ranges is None:
        order, nstart, nend = bin_sort(bins, anc_path.shape[0])
    else:
        order, nstart, nend = bin_ranges
    midx, mvalid = member_table_ranges(
        order, nstart, nend, leaves, anc_path, depth,
        min(cfg.max_bin_reads, bins.shape[0]), cfg.bin_share_depth)
    # ref_col may arrive int16 (streaming retention): widen only AFTER the
    # member gather, so the full-read-range array never exists in int32
    mi = midx.long()
    qm = query[mi]                                       # (NL, M, L)
    rcm = ref_col[mi].to(torch.int32)
    return cluster_round0_members(
        qm, rcm, bins[mi], mvalid, counts, span_diff, read_count,
        leaves, anc_path, depth, cfg, node2slot=node2slot, spawn=spawn)


def _genes_from_consensus(called, emit, nk, kact, leaves, n_mem, cfg,
                          round_idx, orig_taxon_of_node=None, mh=None):
    """Host compaction of consensus tensors into Gene records (oracle order).

    mh: optional MinorHap arrays (host, leaf-sliced) - one extra
    frequency-phased gene per qualifying leaf, cluster id
    cfg.max_clusters_per_bin (after all real clusters, as in the oracle)."""
    genes: List[Gene] = []
    called = np.asarray(called)
    emit = np.asarray(emit)
    nk = np.asarray(nk)
    kact = np.asarray(kact)
    n_mem = np.asarray(n_mem)
    for li, leaf in enumerate(np.asarray(leaves).tolist()):
        if n_mem[li] < cfg.min_cluster_reads:
            continue
        taxon = (int(leaf) if orig_taxon_of_node is None
                 else int(orig_taxon_of_node[leaf]))
        for k in range(int(kact[li])):
            if nk[li, k] < cfg.min_cluster_reads:
                continue
            em = emit[li, k]
            seq = called[li, k][em].astype(np.int8)
            if seq.shape[0] == 0:
                continue
            off = int(np.argmax(em))  # first emitted column
            genes.append(Gene(seq=seq, n_reads=int(nk[li, k]), leaf=int(leaf),
                              cluster=k, round_born=round_idx, taxon=taxon,
                              offset=off))
        # max(1, ...) mirrors the oracle's guard: minorhap_min_cols == 0 with
        # zero qualifying columns must not emit a bogus backbone-duplicate gene
        if mh is not None and int(mh.n_cols[li]) >= max(1, cfg.minorhap_min_cols):
            em = np.asarray(mh.emit[li])
            seq = np.asarray(mh.called[li])[em].astype(np.int8)
            nk_mh = int(mh.n_reads[li])
            if seq.shape[0] and nk_mh >= cfg.min_cluster_reads:
                genes.append(Gene(
                    seq=seq, n_reads=nk_mh, leaf=int(leaf),
                    cluster=cfg.max_clusters_per_bin, round_born=round_idx,
                    taxon=taxon, offset=int(np.argmax(em))))
    return genes


def _dedupe_cap(genes: List[Gene], cfg) -> List[Gene]:
    bykey = {}
    for g in genes:
        kk = g.key()
        if kk not in bykey or g.n_reads > bykey[kk].n_reads:
            if kk in bykey:
                g = dataclasses.replace(g, n_reads=max(g.n_reads, bykey[kk].n_reads))
            bykey[kk] = g
    out = list(bykey.values())
    out.sort(key=lambda g: (-g.n_reads, g.leaf, g.cluster))
    return out[: cfg.max_genes]


def _active_leaves(rc_host: np.ndarray, tables, cfg: PipelineConfig):
    """Slot mode's leaves (host): those whose chain holds min_cluster_reads,
    with zero-exclusive duplicates collapsed; and their node2slot map and
    slot count.

    Inactive leaves produce no genes in the dense path either (n_mem <
    min_cluster_reads), so outputs match. A leaf with no reads binned AT it
    draws members and pileups solely from its ancestor-window nodes; leaves
    sharing that exact node set (and depth) are bitwise-identical clustering
    problems with can_seed all-false, so they emit byte-identical genes that
    _dedupe_cap collapses to the LOWEST leaf id anyway. Only that
    representative is kept: output-identical (dedupe keeps first-by-leaf on
    ties; np.unique gives ascending ids)."""
    anc = tables.anc_path
    leaves_all = np.unique(tables.ref_taxon)
    dd = np.arange(anc.shape[1])
    dl = tables.depth[leaves_all][:, None]
    usem = (dd[None, :] <= dl) & (dd[None, :] >= dl - cfg.bin_share_depth)
    n_mem_leaf = (rc_host[anc[leaves_all]] * usem).sum(axis=1)
    leaves = leaves_all[n_mem_leaf >= cfg.min_cluster_reads]
    excl0 = rc_host[leaves] == 0
    if excl0.any():
        dlv0 = tables.depth[leaves][:, None]
        win0 = (dd[None, :] <= dlv0) & (dd[None, :] >= dlv0
                                        - cfg.bin_share_depth)
        ch0 = anc[leaves]
        sig = np.where(win0 & (rc_host[ch0] > 0), ch0, -1)
        sig = np.concatenate([np.sort(sig, axis=1),
                              tables.depth[leaves][:, None]], axis=1)
        _, first_idx = np.unique(sig[excl0], axis=0, return_index=True)
        keep = ~excl0
        keep[np.nonzero(excl0)[0][first_idx]] = True
        leaves = leaves[keep]
    # slots for every chain node inside the share window with any reads
    dlv = tables.depth[leaves][:, None]
    win = (dd[None, :] <= dlv) & (dd[None, :] >= dlv - cfg.bin_share_depth)
    need = np.zeros(tables.n_nodes, bool)
    need[anc[leaves][win]] = True
    need &= rc_host > 0
    ids = np.nonzero(need)[0].astype(np.int32)
    node2slot = np.full(tables.n_nodes, -1, np.int32)
    node2slot[ids] = np.arange(ids.size, dtype=np.int32)
    n_slots = max(64, -(-max(ids.size, 1) // 64) * 64)
    return leaves, node2slot, n_slots


def _replica(x, mesh):
    """A mesh step's replicated per-rank output -> rank 0's copy; without a
    mesh, x itself."""
    return x if mesh is None else x[0]


def _whole_rows(counts, cfg: PipelineConfig, mesh):
    """The mesh stream's dense counts as whole (n_nodes, ref_len*4) rows on
    rank 0: its replica, or with cfg.shard_positions the ranks' column
    slices joined (the reference's consumers gather them on first use)."""
    if not cfg.shard_positions:
        return counts[0]
    return torch.cat([c.to(mesh.devices[0]) for c in counts], 1)


def cluster_stage(rec, counts, span_diff, read_count, leaves, tables,
                  cfg: PipelineConfig, node2slot=None, mesh=None):
    """Cluster + consensus for `leaves` (host int array) on the device of
    the stream's outputs `rec`; returns host arrays (cons ConsensusOut,
    kact, n_mem, mh MinorHap) in ascending leaf order.

    Leaves split by exclusivity: those with no reads binned AT them have an
    all-false can_seed mask, so DP-means provably assigns everything to
    cluster 0 - they run the LIGHT path (no features, no DP; spawn=False),
    bitwise identical. cfg.cluster_leaf_block bounds the leaves of one call:
    the per-leaf member tensors are (NL, max_bin_reads, ...); leaves are
    independent, so blocking is bitwise-neutral. The B-read bin sort is
    made once for every block.

    With `mesh`, `rec` and the accumulators are `_stream_align_mesh`'s
    per-rank outputs (counts as whole rows on every rank) and each block
    runs `parallel.steps.make_cluster_step`: every rank clusters a slice of
    the block's leaves over the sharded retention (the reference's
    `_cluster_block` mesh branch)."""
    rc_leaf = to_host(_replica(read_count, mesh))[leaves]
    sets = [(leaves[rc_leaf > 0], True), (leaves[rc_leaf == 0], False)]
    blk = cfg.cluster_leaf_block if cfg.cluster_leaf_block > 0 else leaves.size
    blk = max(1, blk)
    if mesh is None:
        dev = rec["bins"].device
        anc = torch.as_tensor(tables.anc_path, dtype=torch.int32).to(dev)
        dep = torch.as_tensor(tables.depth, dtype=torch.int32).to(dev)
        n2s = (None if node2slot is None else
               torch.as_tensor(node2slot, dtype=torch.int32).to(dev))
        bin_ranges = bin_sort(rec["bins"], tables.n_nodes)

        def block(lb, spawn):
            return [cluster_round0_core(
                rec["query"], rec["ref_col"], rec["bins"], counts, span_diff,
                read_count, torch.from_numpy(lb.astype(np.int32)).to(dev),
                anc, dep, cfg, n2s, spawn=spawn, bin_ranges=bin_ranges)]
    else:
        from rambl_tpu_torch.parallel.mesh import put_replicated
        from rambl_tpu_torch.parallel.steps import make_cluster_step

        anc, dep = (put_replicated(np.asarray(a, np.int32), mesh)
                    for a in (tables.anc_path, tables.depth))
        n2s = (None if node2slot is None else
               put_replicated(np.asarray(node2slot, np.int32), mesh))
        steps = {spawn: make_cluster_step(mesh, cfg, slots=n2s is not None,
                                          spawn=spawn)
                 for spawn in (True, False)}

        def block(lb, spawn):
            outs = steps[spawn](rec["query"], rec["ref_col"], rec["bins"],
                                counts, span_diff, read_count, lb, anc, dep,
                                n2s)
            return [o for o in outs if o is not None]   # rank order
    # per block (and rank): called, emit, n_reads, kact, n_mem and the
    # MinorHap's called, emit, n_reads, n_cols, fetched to the host
    parts, proc = [], []
    for lset, spawn in sets:
        for s in range(0, lset.size, blk):
            lb = lset[s: s + blk]
            proc.append(lb)
            for cons_b, kact_b, n_mem_b, mh_b in block(lb, spawn):
                parts.append([to_host(x) for x in (*cons_b, kact_b, n_mem_b,
                                                   *mh_b)])
    order = np.argsort(np.concatenate(proc), kind="stable")  # ascending ids
    cols = [np.concatenate([p[i] for p in parts])[order] for i in range(9)]
    return ConsensusOut(*cols[:3]), cols[3], cols[4], MinorHap(*cols[5:])


def assemble_round(reads, lens, ref_seqs, ref_lens, tables, cfg,
                   round_idx=0, orig_taxon_of_node=None, index=None,
                   n_bits=None, aux_out=None, mesh=None, col_maps=None, *,
                   device=None, ring_shards=None):
    """One align -> bin -> cluster -> consensus round on `device` (the first
    CUDA card when None; "cpu" for the plain PyTorch path): the device
    version of oracle.pipeline.assemble_round. Returns (genes, stats).

    `index` lets cohort runs share one prebuilt index across samples;
    `n_bits` pins the hash-table geometry. `aux_out`, if a dict, receives
    the node-space pileup accumulator ("node_counts"), or in slot mode the
    slot accumulators and their host node2slot map ("slot_counts"), for the
    final polish pass. `mesh` runs the round data-parallel over its ranks
    (the stream, the slot pileup, the leaf-sharded clustering), bitwise the
    same; `ring_shards` (with cfg.shard_index) are `index`'s prebuilt
    shards on that mesh (`stream_align`).
    """
    device = None if mesh is not None else resolve(device)
    clock = _StageClock()
    if index is None:
        index = build_seed_index(ref_seqs, ref_lens, k=cfg.k, n_bits=n_bits)
    clock.mark("index")
    rec, counts, span_diff, read_count = stream_align(
        reads, lens, index, ref_seqs, ref_lens, tables, cfg, mesh=mesh,
        col_maps=col_maps, device=device, ring_shards=ring_shards)
    clock.mark("align", rec["query"], counts, read_count)
    if mesh is not None and counts is not None and cfg.shard_positions:
        from rambl_tpu_torch.parallel.mesh import put_replicated

        # the cluster step and aux need whole rows: gather them once
        counts = put_replicated(_whole_rows(counts, cfg, mesh), mesh)
    aligned = int((_replica(rec["bins"], mesh) >= 0).sum())
    node2slot = None
    if counts is None:
        # slot-compacted active-node mode (n_nodes > cfg.pileup_slot_nodes):
        # active leaves chosen by chain read count, slots for nodes on their
        # ancestor chains that hold reads; one scatter pass builds the
        # compacted accumulators
        leaves, node2slot, n_slots = _active_leaves(
            to_host(_replica(read_count, mesh)), tables, cfg)
        if leaves.size == 0:
            return [], dict(round=round_idx, aligned=aligned, n_leaves=0,
                            genes=0)
        if mesh is None:
            counts, span_diff = node_slot_pileup(
                rec["query"], rec["ref_col"], rec["bins"],
                torch.from_numpy(node2slot).to(device), n_slots,
                ref_seqs.shape[1])
        else:
            from rambl_tpu_torch.parallel.mesh import put_replicated
            from rambl_tpu_torch.parallel.steps import make_slot_pileup_step

            counts, span_diff = make_slot_pileup_step(
                mesh, n_slots, ref_seqs.shape[1])(
                    rec["query"], rec["ref_col"], rec["bins_sh"],
                    put_replicated(node2slot, mesh))
        if aux_out is not None:
            aux_out["slot_counts"] = (_replica(counts, mesh), node2slot)
        clock.mark("slot_pileup", counts)
    else:
        leaves = np.unique(tables.ref_taxon)
        if aux_out is not None:
            aux_out["node_counts"] = _replica(counts, mesh)
    cons, kact, n_mem, mh = cluster_stage(
        rec, counts, span_diff, read_count, leaves, tables, cfg, node2slot,
        mesh=mesh)
    clock.mark("cluster")
    genes = _genes_from_consensus(
        cons.called, cons.emit, cons.n_reads, kact, leaves, n_mem, cfg,
        round_idx, orig_taxon_of_node, mh=mh,
    )
    stats = dict(round=round_idx, aligned=aligned,
                 n_leaves=int(leaves.size), genes=0)
    genes = _dedupe_cap(genes, cfg)
    stats["genes"] = len(genes)
    clock.mark("genes_host")
    clock.into(stats)
    return genes, stats


# --------------------------------------------------------------------------
# the whole assembly: refinement rounds, polish, cohort
# --------------------------------------------------------------------------

def _panel_bits(cfg):
    """The hash geometry of every panel round's index (the oracle pins the
    same value)."""
    return max(8, int(np.ceil(np.log2(2 * cfg.max_genes * cfg.ref_len_max + 1))))


def leaf_counts_dict(reads, lens, ref_seqs, ref_lens, tables,
                     cfg: PipelineConfig, taxa, node_counts=None,
                     slot_counts=None, shared_index=None, mesh=None,
                     col_maps=None, *, device=None, ring_shards=None):
    """{taxon: (ref_len, 4) np.int32} leaf-EXCLUSIVE round-0 pileups for the
    given taxa (oracle.polish.leaf_exclusive_counts semantics). The node-space
    accumulator built during the discovery round IS the per-leaf exclusive
    pileup (reads scatter at their exact bin node; ancestor chaining only
    happens later), so when the caller retained it (dense `node_counts` or
    slot-compacted `slot_counts`, tensors on any device or host arrays,
    each fetched to the host once) no extra device work is needed;
    otherwise one stream on `device` against the original index recomputes
    it bit-identically (in slot mode with `node_slot_pileup` over the
    requested taxa). With `mesh` the recompute runs on its ranks
    (`ring_shards`: the index's prebuilt shards, see `stream_align`).
    Shared by the polish pass and cohort phasing."""
    device = None if mesh is not None else resolve(device)
    ref_len = ref_seqs.shape[1]
    taxa = np.unique(np.asarray(taxa)).astype(np.int64)
    if node_counts is None and slot_counts is None:
        index = shared_index if shared_index is not None else build_seed_index(
            ref_seqs, ref_lens, k=cfg.k)
        rec, counts, _, read_count = stream_align(
            reads, lens, index, ref_seqs, ref_lens, tables, cfg, mesh=mesh,
            col_maps=col_maps, device=device, ring_shards=ring_shards)
        if counts is not None:
            node_counts = (counts if mesh is None
                           else _whole_rows(counts, cfg, mesh))
        else:
            # slot-mode recompute: only the requested taxa need counts
            rc_host = to_host(_replica(read_count, mesh))
            ids = taxa[rc_host[taxa] > 0].astype(np.int32)
            node2slot = np.full(tables.n_nodes, -1, np.int32)
            node2slot[ids] = np.arange(ids.size, dtype=np.int32)
            n_slots = max(64, -(-max(ids.size, 1) // 64) * 64)
            if mesh is None:
                counts_s, _ = node_slot_pileup(
                    rec["query"], rec["ref_col"], rec["bins"],
                    torch.from_numpy(node2slot).to(device), n_slots, ref_len)
            else:
                from rambl_tpu_torch.parallel.mesh import put_replicated
                from rambl_tpu_torch.parallel.steps import (
                    make_slot_pileup_step,
                )

                counts_s = make_slot_pileup_step(mesh, n_slots, ref_len)(
                    rec["query"], rec["ref_col"], rec["bins_sh"],
                    put_replicated(node2slot, mesh))[0][0]
            slot_counts = (counts_s, node2slot)
        del rec
    if node_counts is not None:
        node_counts = to_host(node_counts)
        if node_counts.ndim == 2:    # flat node_pileup rows -> host 3D view
            node_counts = node_counts.reshape(-1, ref_len, 4)
        return {int(l): node_counts[int(l)] for l in taxa}
    counts_s, node2slot = slot_counts
    counts_s = to_host(counts_s)
    node2slot = to_host(node2slot)
    if counts_s.ndim == 2:           # flat node_pileup rows -> host 3D view
        counts_s = counts_s.reshape(-1, ref_len, 4)
    zeros = np.zeros((ref_len, 4), np.int32)
    return {
        int(l): (counts_s[node2slot[int(l)]]
                 if node2slot[int(l)] >= 0 else zeros)
        for l in taxa
    }


def polish(reads, lens, genes, ref_seqs, ref_lens, tables,
           cfg: PipelineConfig, node_counts=None, slot_counts=None,
           shared_index=None, mesh=None, col_maps=None, *, device=None,
           ring_shards=None):
    """Polish pass (see oracle.polish): leaf-exclusive re-vote of the final
    panel from round-0 node pileups (evidence via leaf_counts_dict, which
    re-streams round 0 on `device`, or on `mesh`, only when none was
    retained). Returns (genes, n_changed)."""
    from rambl_tpu_torch.oracle.polish import anchor_seqs_of, apply_polish

    device = None if mesh is not None else resolve(device)
    if not genes:
        return genes, 0
    # retained dense accumulators cover every leaf; slot/recompute paths only
    # need the gene taxa (apply_polish looks up nothing else)
    taxa = (np.unique(tables.ref_taxon) if node_counts is not None
            else np.unique([g.taxon for g in genes]))
    counts_dict = leaf_counts_dict(
        reads, lens, ref_seqs, ref_lens, tables, cfg, taxa=taxa,
        node_counts=node_counts, slot_counts=slot_counts,
        shared_index=shared_index, mesh=mesh, col_maps=col_maps,
        device=device, ring_shards=ring_shards)
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    return apply_polish(genes, counts_dict, anchor, cfg)


def assemble(reads, lens, ref_seqs, ref_lens, tables, cfg: PipelineConfig,
             shared_index=None, initial_panel=None, mesh=None,
             checkpoint_path=None, aux_out=None, col_maps=None,
             initial_aux=None, *, device=None, ring_shards=None):
    """The whole assembly on `device` (the first CUDA card when None; "cpu"
    for the plain PyTorch path): the device version of
    oracle.pipeline.assemble, with its convergence loop (every round is a
    full discovery round; the panel maps genes back to their provenance
    taxa - oracle.pipeline.panel_tables). Returns an AssemblyResult.

    initial_panel resumes from a checkpointed panel (discovery skipped).
    checkpoint_path, if given, atomically saves the loop panel after EVERY
    round, and the round-0 evidence once to checkpoint_path + ".aux"; the
    rounds are deterministic, so a resumed continuation is bitwise.
    aux_out, if a dict, receives the retained round-0 pileup accumulators
    ("node_counts" dense or "slot_counts", tensors on `device`); empty on
    resumed runs unless initial_aux (utils.checkpoint.load_aux_evidence)
    restores them, which also spares polish the round-0 re-stream.
    `mesh` runs every round and polish's re-stream on its ranks, bitwise
    the same; `ring_shards` (with cfg.shard_index): `shared_index`'s
    prebuilt shards on that mesh, for round 0 and polish (each panel round
    shards its own index)."""
    from rambl_tpu_torch.index.colmap import nw_tier
    from rambl_tpu_torch.oracle.pipeline import (
        AssemblyResult,
        pad_panel,
        panel_tables,
    )
    from rambl_tpu_torch.utils.checkpoint import (
        save_aux_evidence,
        save_checkpoint,
    )

    device = None if mesh is not None else resolve(device)

    def _ckpt(genes, round_idx, stats):
        if checkpoint_path:
            save_checkpoint(checkpoint_path, cfg, genes, round_idx, stats)

    round_stats = []
    aux = {} if (cfg.polish or aux_out is not None) else None
    if initial_panel is None:
        genes, stats = assemble_round(
            reads, lens, ref_seqs, ref_lens, tables, cfg, round_idx=0,
            index=shared_index, aux_out=aux, mesh=mesh, col_maps=col_maps,
            device=device, ring_shards=ring_shards)
        round_stats.append(stats)
        _ckpt(genes, 0, round_stats)
        if checkpoint_path and aux:
            save_aux_evidence(checkpoint_path + ".aux", cfg, aux)
    else:
        genes = list(initial_panel)
        # resumed: reuse checkpointed round-0 evidence when provided, else
        # polish re-streams round 0 bit-identically
        aux = dict(initial_aux) if initial_aux else None
        round_stats.append(dict(round=0, resumed=True, genes=len(genes),
                                aux_restored=bool(initial_aux)))
    seen = {tuple(sorted(g.key() for g in genes))}
    converged = False
    for it in range(1, cfg.max_assembly_iters):
        if not genes:
            break
        # a fresh index of the panel (fixed hash geometry) and, with
        # col_maps=None, the panel's own NW anchor maps
        pseqs, plens = pad_panel(genes, ref_seqs.shape[1])
        genes, stats = assemble_round(
            reads, lens, pseqs, plens, panel_tables(genes, tables), cfg,
            round_idx=it, n_bits=_panel_bits(cfg), mesh=mesh, device=device)
        round_stats.append(stats)
        _ckpt(genes, it, round_stats)
        new_key = tuple(sorted(g.key() for g in genes))
        # fixpoint OR cycle (deterministic rounds): stop on any repeat
        if new_key in seen:
            converged = True
            break
        seen.add(new_key)
    n_rounds = len(round_stats)
    panel = list(genes)
    if aux_out is not None and aux:
        aux_out.update(aux)
    if cfg.polish and genes:
        t_pol = time.time()
        genes, n_changed = polish(
            reads, lens, genes, ref_seqs, ref_lens, tables, cfg,
            node_counts=(aux or {}).get("node_counts"),
            slot_counts=(aux or {}).get("slot_counts"),
            shared_index=shared_index, mesh=mesh, col_maps=col_maps,
            device=device, ring_shards=ring_shards)
        pstats = dict(round="polish", changed=n_changed, nw_tier=nw_tier())
        if _stage_timing():
            pstats["t_polish"] = round(time.time() - t_pol, 2)
        round_stats.append(pstats)
    return AssemblyResult(genes=genes, n_rounds=n_rounds,
                          converged=converged, round_stats=round_stats,
                          panel=panel)


def assemble_cohort(samples, ref_seqs, ref_lens, tables, cfg: PipelineConfig,
                    mesh=None, col_maps=None, *, device=None):
    """Multi-sample cohort assembly with a SHARED reference index (BASELINE
    config 4) on `device`.

    samples: list of (reads, lens). The round-0 index is built once and
    reused; each sample runs its own refinement loop (panel indexes are
    per-sample), and its retained round-0 evidence is fetched to the host
    before the next sample runs, so device buffers do not pile up; finally
    cross-sample abundance-covariation phasing (oracle/cohort.py) over the
    per-sample leaf-exclusive pileups. Returns one AssemblyResult per
    sample. With `mesh` every sample runs on its ranks; with cfg.shard_index
    the shared index is sharded over them once, and every sample's round 0,
    polish and phasing evidence rotate those shards."""
    from rambl_tpu_torch.oracle.cohort import cohort_phase
    from rambl_tpu_torch.oracle.polish import anchor_seqs_of

    device = None if mesh is not None else resolve(device)
    shared_index = build_seed_index(ref_seqs, ref_lens, k=cfg.k)
    shards = None
    if mesh is not None and cfg.shard_index:
        from rambl_tpu_torch.parallel.ring import RingShards, build_ring_shards

        shards = RingShards(build_ring_shards(shared_index, mesh.size), mesh)
    do_phase = cfg.cohort_phase and len(samples) >= 2
    results, retained = [], []
    for reads, lens in samples:
        aux = {} if do_phase else None
        results.append(assemble(
            reads, lens, ref_seqs, ref_lens, tables, cfg,
            shared_index=shared_index, aux_out=aux, mesh=mesh,
            col_maps=col_maps, device=device, ring_shards=shards))
        if do_phase:
            slot = aux.get("slot_counts")
            retained.append(dict(
                node_counts=(None if aux.get("node_counts") is None
                             else to_host(aux["node_counts"])),
                slot_counts=(None if slot is None
                             else (to_host(slot[0]), slot[1])),
            ))
    if not do_phase:
        return results
    taxa = np.unique(np.asarray(
        [g.taxon for r in results for g in r.genes], dtype=np.int64))
    if taxa.size == 0:
        return results
    counts_list = [
        leaf_counts_dict(reads, lens, ref_seqs, ref_lens, tables, cfg,
                         taxa=taxa, shared_index=shared_index, mesh=mesh,
                         col_maps=col_maps, device=device, ring_shards=shards,
                         **retained[j])
        for j, (reads, lens) in enumerate(samples)
    ]
    anchor = anchor_seqs_of(ref_seqs, ref_lens, tables.ref_taxon)
    geneses = cohort_phase([r.genes for r in results], counts_list, anchor, cfg)
    return [dataclasses.replace(r, genes=g)
            for r, g in zip(results, geneses)]
