"""Seeding + candidate selection, NumPy specification: the port's copy of
`rambl_tpu/oracle/seed.py`. A deterministic rule set over the dense seed
table (`rambl_tpu_torch.index.builder`):

1. query k-mers are sampled at fixed stride positions p = 0, s, 2s, ...
   (static count Q per read; a position is valid iff p + k <= read_len and the
   window is N-free);
2. each k-mer probes its hash bucket and scans the first `bucket_cap` entries
   (dense (P, cap) layout); an entry hits iff its key matches exactly;
3. every hit votes for a candidate (ref_id, diagonal bin) where
   diag = ref_pos - p and bin = (diag + read_len_max) // diag_bin;
4. the top `max_candidates` candidates per read are chosen by
   (votes desc, candidate key asc) - fully deterministic;
5. a candidate's reference window starts at
   wstart = bin*diag_bin - read_len_max + diag_bin//2 - window_margin.

`rambl_tpu_torch.ops.seed` reproduces these rules bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.builder import SeedIndex, hash_kmer


def seed_positions(cfg: PipelineConfig) -> np.ndarray:
    """Static query k-mer sampling positions."""
    return np.arange(0, cfg.read_len_max - cfg.k + 1, cfg.seed_stride, dtype=np.int32)


def query_kmers(reads: np.ndarray, read_lens: np.ndarray, cfg: PipelineConfig):
    """Extract k-mer keys at the static positions.

    reads: (B, Lmax) int8. Returns (keys (B, Q) int64, valid (B, Q) bool).
    """
    pos = seed_positions(cfg)
    B = reads.shape[0]
    Q = pos.shape[0]
    keys = np.zeros((B, Q), dtype=np.int64)
    valid = np.ones((B, Q), dtype=bool)
    for j in range(cfg.k):
        c = reads[:, pos + j].astype(np.int64)  # (B, Q)
        valid &= c < 4
        keys = (keys << 2) | (c & 0x3)
    valid &= (pos[None, :] + cfg.k) <= read_lens[:, None]
    return keys, valid


def seed_candidates(
    reads: np.ndarray,
    read_lens: np.ndarray,
    index: SeedIndex,
    cfg: PipelineConfig,
    padded_entries=None,
):
    """Candidate windows per read.

    Returns dict with (B, C) arrays: cand_ref, cand_wstart, cand_votes,
    cand_valid. Deterministic per the module docstring.
    """
    if padded_entries is None:
        padded_entries = index.padded_entries(cfg.bucket_cap)
    ekeys, erefs, epos = padded_entries  # (P, cap) each
    pos = seed_positions(cfg)
    keys, valid = query_kmers(reads, read_lens, cfg)  # (B, Q)
    B, Q = keys.shape
    cap = ekeys.shape[1]

    bucket = hash_kmer(keys, index.n_bits)              # (B, Q)
    bk = ekeys[bucket]                                  # (B, Q, cap)
    hit = (bk == keys[..., None]) & valid[..., None]    # (B, Q, cap)
    href = erefs[bucket]                                # (B, Q, cap)
    hpos = epos[bucket]

    diag = hpos - pos[None, :, None]                    # (B, Q, cap)
    dbin = (diag + cfg.read_len_max) // cfg.diag_bin
    ckey = href.astype(np.int64) * cfg.n_diag_bins + dbin
    ckey = np.where(hit, ckey, np.int64(-1))            # -1 = no hit

    flat = ckey.reshape(B, Q * cap)
    flat = np.sort(flat, axis=1)                        # -1s first

    # run-length counts per row, then top-C by (count desc, key asc)
    C = cfg.max_candidates
    cand_key = np.full((B, C), -1, dtype=np.int64)
    cand_votes = np.zeros((B, C), dtype=np.int32)
    for b in range(B):
        row = flat[b]
        row = row[row >= 0]
        if row.size == 0:
            continue
        uniq, counts = np.unique(row, return_counts=True)
        # order: votes desc, key asc. np.lexsort: last key primary.
        order = np.lexsort((uniq, -counts))[:C]
        cand_key[b, : order.size] = uniq[order]
        cand_votes[b, : order.size] = counts[order]

    cand_valid = cand_key >= 0
    cand_ref = np.where(cand_valid, cand_key // cfg.n_diag_bins, 0).astype(np.int32)
    cand_dbin = np.where(cand_valid, cand_key % cfg.n_diag_bins, 0).astype(np.int32)
    cand_wstart = (
        cand_dbin * cfg.diag_bin
        - cfg.read_len_max
        + cfg.diag_bin // 2
        - cfg.window_margin
    ).astype(np.int32)
    return dict(
        cand_ref=cand_ref,
        cand_wstart=cand_wstart,
        cand_votes=cand_votes,
        cand_valid=cand_valid,
    )


def gather_windows(
    ref_seqs: np.ndarray, cand_ref: np.ndarray, cand_wstart: np.ndarray, W: int
) -> np.ndarray:
    """Extract (B, C, W) int8 windows; out-of-range positions -> code 4."""
    B, C = cand_ref.shape
    cols = cand_wstart[..., None] + np.arange(W, dtype=np.int32)  # (B, C, W)
    in_range = (cols >= 0) & (cols < ref_seqs.shape[1])
    g = ref_seqs[cand_ref[..., None], np.clip(cols, 0, ref_seqs.shape[1] - 1)]
    return np.where(in_range, g, np.int8(4))
