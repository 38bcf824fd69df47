"""The read stream of the assembly driver: align, bin and pile up every read.

Port of the stream of `rambl_tpu/pipeline/assemble.py` (`_align_bin_batch`,
`_pileup_accum`, `_read_count_accum`, `_pad_batches`, `_stream_align` and,
over a mesh of ranks, `_stream_align_mesh`), bit-identical to it. Reads go
through the align + bin step in fixed-size batches (the last one padded
with empty reads, which bin to -1); per-read outputs are kept in
preallocated device buffers and the node-space pileup accumulators are
summed on the device.

Clustering, consensus, the refinement rounds and polish are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.ops.seed import SeedTable
from rambl_tpu_torch.pipeline.align import align_batch
from rambl_tpu_torch.pipeline.binning import bin_batch
from rambl_tpu_torch.pipeline.pileup import node_pileup
from rambl_tpu_torch.utils.errors import UserError

RETAINED = ("query", "ref_col", "bins", "score", "ref", "strand")


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

    # retention buffers, filled in place; projected columns are < ref_len,
    # so int16 holds them exactly when ref_len <= 32767
    BT = nb * cfg.batch_size
    L = padded.shape[1]
    compact = ref_len <= 32767
    bufs = {
        "query": torch.zeros((BT, L), dtype=torch.int8, device=device),
        "ref_col": torch.zeros((BT, L), dtype=torch.int16 if compact else i32,
                               device=device),
        "bins": torch.zeros((BT,), dtype=i32, device=device),
        "score": torch.zeros((BT,), dtype=i32, device=device),
        "ref": torch.zeros((BT,), dtype=i32, device=device),
        "strand": torch.zeros((BT,), dtype=torch.int8, device=device),
    }
    nxt = _put(0) if nb else None
    for i in range(nb):
        cur, nxt = nxt, (_put(i + 1) if i + 1 < nb else None)
        outs = _align_bin_batch(cur[0], cur[1], table, st, cfg)
        q, rc, b = outs[0], outs[1], outs[2]
        if dense:
            _pileup_accum(q, rc, b, counts, span_diff, read_count, n_nodes,
                          ref_len)
        else:
            _read_count_accum(b, read_count, n_nodes)
        s0 = i * cfg.batch_size
        for k, v in zip(RETAINED, outs):
            bufs[k][s0:s0 + cfg.batch_size] = v
    merged = {k: (v if BT == B else v[:B]) for k, v in bufs.items()}
    return merged, counts, span_diff, read_count


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
