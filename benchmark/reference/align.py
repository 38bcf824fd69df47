"""The align step for a set of reads: seed, score every (read, strand,
candidate) pair, take the best pair (the largest score, ties to the lowest
pair index: forward candidates before reverse-complement ones), rerun it
with directions and trace it back to each query position's reference
column. Reads whose best score is under `min_score` are unaligned (ref -1,
score 0, strand 0, columns -1); the query is the best pair's orientation
whether or not the read aligned."""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.seed import (
    bucket_table,
    candidates,
    hash_keys,
    n_bits_of,
    query_kmers,
    revcomp,
    windows,
)
from benchmark.reference.sw import sw_batch, traceback_batch


@dataclasses.dataclass
class Aligned:
    score: np.ndarray        # (B,)
    ref: np.ndarray          # (B,) -1 when unaligned
    strand: np.ndarray       # (B,)
    ref_col: np.ndarray      # (B, L) reference column a query position, -1
    query: np.ndarray        # (B, L) int8 codes of the best pair's strand
    pair_score: np.ndarray   # (B, 2C)
    pair_ref: np.ndarray     # (B, 2C)
    pair_valid: np.ndarray   # (B, 2C) a candidate scoring >= min_score


def seed_table(reads, lens, ref_seqs, ref_lens, p, device):
    """The seed table's buckets that these reads (both strands) probe:
    (n_bits, (buckets, keys, refs, pos))."""
    n_bits = n_bits_of(ref_seqs, ref_lens, p.k, device)
    ks = [query_kmers(r, lens, p)[0] for r in (reads, revcomp(reads, lens))]
    buckets = np.unique(np.concatenate([hash_keys(k, n_bits).ravel()
                                        for k in ks]))
    return n_bits, (buckets, *bucket_table(ref_seqs, ref_lens, p.k, n_bits,
                                           buckets, p.bucket_cap, device))


def align_reads(reads, lens, ref_seqs, ref_lens, p, device="cpu",
                chunk: int = 512) -> Aligned:
    B, L = reads.shape
    W, C = p.window_len, p.max_candidates
    n_bits, table = seed_table(reads, lens, ref_seqs, ref_lens, p, device)
    rc_reads = revcomp(reads, lens)
    out = Aligned(score=np.zeros(B, np.int64), ref=np.full(B, -1, np.int64),
                  strand=np.zeros(B, np.int64),
                  ref_col=np.full((B, L), -1, np.int64), query=reads.copy(),
                  pair_score=np.zeros((B, 2 * C), np.int64),
                  pair_ref=np.zeros((B, 2 * C), np.int64),
                  pair_valid=np.zeros((B, 2 * C), bool))
    for s0 in range(0, B, chunk):
        s1 = min(s0 + chunk, B)
        n = s1 - s0
        fwd, rcq, ln = reads[s0:s1], rc_reads[s0:s1], lens[s0:s1]
        cf = candidates(fwd, ln, table, n_bits, p)
        cr = candidates(rcq, ln, table, n_bits, p)
        cref, cws, cval = (np.concatenate([a, b], 1) for a, b in zip(cf, cr))
        wins = windows(ref_seqs, cref, cws, W)
        q_pairs = np.concatenate([np.repeat(fwd[:, None], C, 1),
                                  np.repeat(rcq[:, None], C, 1)], 1)
        score = sw_batch(q_pairs.reshape(-1, L), wins.reshape(-1, W), p,
                         want_dirs=False)[0].reshape(n, 2 * C)
        score = np.where(cval, score, 0).astype(np.int64)
        key = score * (2 * C) + (2 * C - 1 - np.arange(2 * C))
        best = np.argmax(key, axis=1)
        bi = np.arange(n)
        bscore = score[bi, best]
        aligned = bscore >= p.min_score
        strand = (best >= C).astype(np.int64)
        qb = np.where(strand[:, None] == 1, rcq, fwd)
        _, ie, je, dirs = sw_batch(qb, wins[bi, best], p, want_dirs=True)
        local = traceback_batch(dirs, ie, je, L)
        gcol = np.where(local >= 0, local + cws[bi, best][:, None], -1)
        gcol = np.where((gcol >= 0) & (gcol < ref_seqs.shape[1]), gcol, -1)
        out.score[s0:s1] = np.where(aligned, bscore, 0)
        out.ref[s0:s1] = np.where(aligned, cref[bi, best], -1)
        out.strand[s0:s1] = np.where(aligned, strand, 0)
        out.ref_col[s0:s1] = np.where(aligned[:, None], gcol, -1)
        out.query[s0:s1] = qb
        out.pair_score[s0:s1] = score
        out.pair_ref[s0:s1] = cref
        out.pair_valid[s0:s1] = cval & (score >= p.min_score)
    return out
