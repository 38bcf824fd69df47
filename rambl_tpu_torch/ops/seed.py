"""Seeding and candidate voting in PyTorch.

Port of `rambl_tpu/ops/seed.py`, bit-identical to it and to
`rambl_tpu_torch.oracle.seed`: query k-mers at fixed stride positions are hashed
into the CSR seed table of `rambl_tpu_torch.index.builder.SeedIndex`, the first
`bucket_cap` entries of each bucket are compared by key, every hit votes for
a (reference, diagonal bin) candidate, and the top C candidates per read are
taken by (votes desc, key asc).

The reference's TPU layouts are not ported: the CSR arrays are gathered
directly (no 128-lane chunk-row packing), windows come from one element
gather (no strided table or two-level gather, which agree with it on the
on-grid starts that `select_candidates` emits), and reversal is an index
gather (no barrel shifter).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rambl_tpu_torch.config import PipelineConfig

_HASH_MULT = 2654435769
BIGK = 2 ** 31 - 1   # probe miss


class SeedTable(NamedTuple):
    """Device copy of the CSR seed table (`rambl_tpu_torch.index.builder.SeedIndex`)."""

    bucket_start: torch.Tensor   # (P + 1,) int32 CSR offsets
    entry_key: torch.Tensor      # (n_entries,) int32
    entry_ref: torch.Tensor      # (n_entries,) int32
    entry_pos: torch.Tensor      # (n_entries,) int32
    n_bits: int

    @staticmethod
    def from_index(index, device) -> "SeedTable":
        def put(a):
            return torch.as_tensor(a, dtype=torch.int32).to(device)

        return SeedTable(put(index.bucket_start), put(index.entry_key),
                         put(index.entry_ref), put(index.entry_pos),
                         int(index.n_bits))


def seed_positions(cfg: PipelineConfig, device) -> torch.Tensor:
    return torch.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride,
                        dtype=torch.int32, device=device)


def hash_kmer(keys: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Multiplicative hash into [0, 2^n_bits): the reference multiplies in
    uint32 and wraps, so multiply in int64 and keep the low 32 bits."""
    h = (keys.to(torch.int64) * _HASH_MULT) & 0xFFFFFFFF
    return (h >> (32 - n_bits)).to(torch.int32)


def query_kmers(reads: torch.Tensor, read_lens: torch.Tensor,
                cfg: PipelineConfig):
    """(B, Lmax) int8 -> (keys (B, Q) int32, valid (B, Q) bool)."""
    pos = seed_positions(cfg, reads.device)
    keys = torch.zeros((reads.shape[0], pos.shape[0]), dtype=torch.int32,
                       device=reads.device)
    valid = torch.ones(keys.shape, dtype=torch.bool, device=reads.device)
    for j in range(cfg.k):
        c = reads.index_select(1, pos + j).to(torch.int32)
        valid &= c < 4
        keys = (keys << 2) | (c & 0x3)
    valid &= (pos[None, :] + cfg.k) <= read_lens[:, None]
    return keys, valid


def probe(keys: torch.Tensor, valid: torch.Tensor, bucket: torch.Tensor,
          table: SeedTable, cfg: PipelineConfig,
          bucket_lo: int = 0) -> torch.Tensor:
    """Scan the first `bucket_cap` entries of each query's bucket.

    `table` may be a bucket-range shard (`parallel.ring`): its bucket_start
    is the CSR slice of buckets [bucket_lo, bucket_lo + n_local] with
    ABSOLUTE offsets, its entry columns the matching slice (local entry
    index = offset - bucket_start[0]); buckets outside the range give no
    hits. The whole table is the shard with bucket_lo = 0.

    Returns ckey (B, Q, cap) int32 candidate vote keys
    ref * n_diag_bins + diagonal bin, BIGK where the slot is no hit."""
    pos = seed_positions(cfg, keys.device)
    cap = cfg.bucket_cap
    bs = table.bucket_start
    n_local = bs.shape[0] - 1
    local_b = bucket - bucket_lo                           # (B, Q)
    in_range = (local_b >= 0) & (local_b < n_local)
    lb = torch.clamp(local_b, 0, n_local - 1).long()
    base = bs[0]
    start = bs[lb] - base                                  # (B, Q)
    count = bs[lb + 1] - base - start
    slot = torch.arange(cap, dtype=torch.int32, device=keys.device)
    in_bucket = slot < count[..., None]                    # (B, Q, cap)
    n_entries = table.entry_key.shape[0]
    eidx = torch.clamp(start[..., None] + slot, 0, max(n_entries - 1, 0)).long()
    if n_entries == 0:
        return torch.full(eidx.shape, BIGK, dtype=torch.int32,
                          device=keys.device)
    ekey = table.entry_key[eidx]
    eref = table.entry_ref[eidx]
    epos = table.entry_pos[eidx]
    hit = (in_range[..., None] & in_bucket & (ekey == keys[..., None])
           & valid[..., None])
    diag = epos - pos[None, :, None]
    dbin = torch.div(diag + cfg.read_len_max, cfg.diag_bin,
                     rounding_mode="floor")
    ckey = eref * cfg.n_diag_bins + dbin
    return torch.where(hit, ckey, BIGK).to(torch.int32)


def select_candidates(ckey: torch.Tensor, cfg: PipelineConfig) -> dict:
    """Vote counting and deterministic top-C from probe keys (B, Q, cap).

    Votes are the run lengths of each row's sorted keys; the order
    (votes desc, key asc) is one int64 sort key (N - votes) << 32 | key,
    since keys are non-negative int32."""
    B = ckey.shape[0]
    flat = torch.sort(ckey.reshape(B, -1), dim=1).values
    N = flat.shape[1]
    dev = flat.device
    is_first = torch.ones(flat.shape, dtype=torch.bool, device=dev)
    is_first[:, 1:] = flat[:, 1:] != flat[:, :-1]
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    firsts = torch.where(is_first, idx, N)
    # next run start after each position: reverse cummin of run starts
    rev_min = torch.cummin(torch.flip(firsts, [1]), dim=1).values
    next_start = torch.full((B, N), N, dtype=torch.int32, device=dev)
    next_start[:, :-1] = torch.flip(rev_min, [1])[:, 1:]
    votes = torch.where(is_first & (flat != BIGK), next_start - idx, 0)

    order_key = ((N - votes).to(torch.int64) << 32) | flat.to(torch.int64)
    C = cfg.max_candidates
    top = torch.sort(order_key, dim=1).values[:, :C]
    cand_votes = (N - (top >> 32)).to(torch.int32)
    cand_key = (top & 0xFFFFFFFF).to(torch.int32)
    cand_valid = cand_votes > 0

    nd = cfg.n_diag_bins
    cand_ref = torch.where(cand_valid, torch.div(cand_key, nd,
                                                 rounding_mode="floor"), 0)
    cand_dbin = torch.where(cand_valid, torch.remainder(cand_key, nd), 0)
    cand_wstart = (cand_dbin * cfg.diag_bin - cfg.read_len_max
                   + cfg.diag_bin // 2 - cfg.window_margin)
    return dict(
        cand_ref=cand_ref.to(torch.int32),
        cand_wstart=cand_wstart.to(torch.int32),
        cand_votes=cand_votes,
        cand_valid=cand_valid,
    )


def seed_candidates(reads: torch.Tensor, read_lens: torch.Tensor,
                    table: SeedTable, cfg: PipelineConfig) -> dict:
    """Top-C candidate windows per read: dict of (B, C) tensors cand_ref,
    cand_wstart, cand_votes, cand_valid."""
    keys, valid = query_kmers(reads, read_lens, cfg)
    bucket = hash_kmer(keys, table.n_bits)
    return select_candidates(probe(keys, valid, bucket, table, cfg), cfg)


def gather_windows(ref_seqs: torch.Tensor, cand_ref: torch.Tensor,
                   cand_wstart: torch.Tensor, W: int) -> torch.Tensor:
    """(R, ref_len) int8 refs -> (..., W) int8 windows; columns outside the
    reference read as code 4."""
    RL = ref_seqs.shape[1]
    cols = cand_wstart[..., None] + torch.arange(W, dtype=torch.int32,
                                                 device=cand_wstart.device)
    in_range = (cols >= 0) & (cols < RL)
    g = ref_seqs[cand_ref[..., None].long(), torch.clamp(cols, 0, RL - 1).long()]
    return torch.where(in_range, g, 4)


def revcomp(reads: torch.Tensor, read_lens: torch.Tensor) -> torch.Tensor:
    """Batched reverse complement keeping right padding (io.pack semantics):
    out[b, p] = comp(reads[b, len - 1 - p]) for p < len, else 4."""
    B, L = reads.shape
    c = torch.where(reads < 4, 3 - reads, 4)
    p = torch.arange(L, dtype=torch.int64, device=reads.device)
    lens = read_lens.to(torch.int64)[:, None]
    src = torch.clamp(lens - 1 - p, 0, L - 1)
    out = torch.gather(c, 1, src)
    return torch.where(p < lens, out, 4)
