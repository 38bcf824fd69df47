"""Ring-sharded seed index: each rank holds one bucket range of the table.

Port of `rambl_tpu/parallel/ring.py`. When the seed table is too large to
replicate, its hash buckets are range-sharded over the ranks. Reads stay on
their rank; the SHARDS rotate around the ring (`ring_dma.ring_rotate`), one
hop a step, so after n steps every rank has probed every bucket range and
the shards are back where they started. Each k-mer's bucket lives in
exactly one shard, so every probe slot fills at most once and the result is
bitwise the replicated lookup's.

Layout: the port's, not the TPU's 128-lane chunk rows. A shard is its
`bucket_start` slice (Pn + 1 absolute int32 offsets) and one (emax, 3) int32
entry array (key, ref, pos per row; pad rows carry key -1). Both rotate as
flat 32-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.ops.seed import (
    BIGK,
    SeedTable,
    hash_kmer,
    probe,
    query_kmers,
    revcomp,
    select_candidates,
)
from rambl_tpu_torch.parallel.mesh import DataMesh
from rambl_tpu_torch.parallel.ring_dma import ring_rotate
from rambl_tpu_torch.pipeline.align import align_from_candidates


def build_ring_shards(index, n_shards: int) -> dict:
    """Slice the CSR table into n_shards bucket ranges (host side).

    Returns numpy arrays with leading dim n_shards:
      bucket_start (n_shards, Pn + 1) ABSOLUTE offsets, Pn = ceil(P / n);
        trailing shards past the last bucket repeat the final offset;
      entries (n_shards, emax, 3) (key, ref, pos) rows, emax the largest
        shard's entry count (at least 1), pad rows all -1.
    """
    P = index.n_buckets
    Pn = -(-P // n_shards)
    slices = []
    emax = 1
    for s in range(n_shards):
        lo_b, hi_b = min(s * Pn, P), min((s + 1) * Pn, P)
        lo_e = int(index.bucket_start[lo_b])
        hi_e = int(index.bucket_start[hi_b])
        emax = max(emax, hi_e - lo_e)
        slices.append((lo_b, hi_b, lo_e, hi_e))
    bs = np.zeros((n_shards, Pn + 1), np.int32)
    ent = np.full((n_shards, emax, 3), -1, np.int32)
    for s, (lo_b, hi_b, lo_e, hi_e) in enumerate(slices):
        seg = index.bucket_start[lo_b:hi_b + 1]
        bs[s, :seg.shape[0]] = seg
        bs[s, seg.shape[0]:] = seg[-1]                 # empty pad buckets
        m = hi_e - lo_e
        ent[s, :m, 0] = index.entry_key[lo_e:hi_e]
        ent[s, :m, 1] = index.entry_ref[lo_e:hi_e]
        ent[s, :m, 2] = index.entry_pos[lo_e:hi_e]
    return dict(bucket_start=bs, entries=ent)


class RingShards:
    """Each rank's shard on its device, and a receive buffer of the same
    shape: a rotation writes rank r's shard into rank r + 1's receive
    buffer, and the two swap (ping-pong, `ring_dma` module docstring)."""

    def __init__(self, shards: dict, mesh: DataMesh):
        n = mesh.size
        bs, ent = shards["bucket_start"], shards["entries"]
        if bs.shape[0] != n or ent.shape[0] != n:
            raise ValueError(f"{bs.shape[0]} shards for a {n}-rank mesh")
        self.mesh = mesh
        self.state = []
        self.spare = []
        for r, d in enumerate(mesh.devices):
            own = (torch.from_numpy(np.ascontiguousarray(bs[r])).to(
                       d, copy=True),
                   torch.from_numpy(np.ascontiguousarray(ent[r])).to(
                       d, copy=True))
            self.state.append(own)
            self.spare.append(tuple(torch.empty_like(x) for x in own))

    @property
    def n_local(self) -> int:
        return self.state[0][0].shape[0] - 1

    def rotate(self, impl: str) -> None:
        out = ring_rotate(self.state, self.mesh, impl, out=self.spare)
        self.spare, self.state = self.state, out


def _ring_probe(mesh: DataMesh, keys, valid, shards: RingShards,
                cfg: PipelineConfig, n_bits: int) -> list:
    """Probe every shard by rotating them around the ring; per-rank ckey
    (B/n, Q, cap). Called between mesh.fork() and mesh.join()."""
    n = mesh.size
    Pn = shards.n_local
    bucket, ckey = [], []
    for r in range(n):
        with mesh.rank(r):
            bucket.append(hash_kmer(keys[r], n_bits))
            ckey.append(torch.full(keys[r].shape + (cfg.bucket_cap,), BIGK,
                                   dtype=torch.int32, device=keys[r].device))
    for step in range(n):
        for r in range(n):
            with mesh.rank(r):
                bs, ent = shards.state[r]
                table = SeedTable(bs, ent[:, 0], ent[:, 1], ent[:, 2], n_bits)
                shard_id = (r - step + n) % n
                ck = probe(keys[r], valid[r], bucket[r], table, cfg,
                           bucket_lo=shard_id * Pn)
                ckey[r] = torch.where(ck != BIGK, ck, ckey[r])
        # one ring hop (r -> r+1): the plain copy or K4 (cfg.ring_impl)
        shards.rotate(cfg.ring_impl)
    return ckey


def ring_align_batch(mesh: DataMesh, reads, read_lens, shards: RingShards,
                     ref_seqs, cfg: PipelineConfig, n_bits: int) -> list:
    """align_batch with ring-sharded seeding over per-rank reads (lists of
    (B/n, L) int8 and (B/n,) int32) and per-rank ref_seqs; returns per-rank
    AlignRecords, bitwise align_batch's with the replicated table. Called
    between mesh.fork() and mesh.join(). The lengths are not checked against
    cfg.sw_rows here (a sync a rank): the stream checks its host lengths, as
    the reference's traced version leaves the check to it."""
    n = mesh.size
    rc_reads, cands = [], {}
    for r in range(n):
        with mesh.rank(r):
            rc_reads.append(revcomp(reads[r], read_lens[r]))
    for strand, qs in (("f", reads), ("r", rc_reads)):
        keys, valid = [], []
        for r in range(n):
            with mesh.rank(r):
                k, v = query_kmers(qs[r], read_lens[r], cfg)
                keys.append(k)
                valid.append(v)
        ckey = _ring_probe(mesh, keys, valid, shards, cfg, n_bits)
        for r in range(n):
            with mesh.rank(r):
                cands[strand, r] = select_candidates(ckey[r], cfg)
    out = []
    for r in range(n):
        with mesh.rank(r):
            out.append(align_from_candidates(
                reads[r], rc_reads[r], cands["f", r], cands["r", r],
                ref_seqs[r], cfg))
    return out
