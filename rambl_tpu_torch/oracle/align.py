"""Full align step (oracle): seed -> candidates -> score -> best hit -> traceback.

The port's copy of `rambl_tpu/oracle/align.py` (`align_reads`, a batched
two-pass computation, and `mapping_quality`):

  pass 1 (score): banded SW over all (read x strand x candidate) pairs;
  pass 2 (trace): rerun DP with direction bits only for each read's best pair,
                  then vectorized traceback -> per-query-position ref columns.

Deterministic best-hit rule: maximize score over the 2C pairs
(fwd candidates 0..C-1 then rc candidates C..2C-1); ties -> lowest pair index.
Reads whose best score < cfg.min_score are unaligned (ref -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.builder import SeedIndex
from rambl_tpu_torch.io.pack import revcomp_codes
from rambl_tpu_torch.oracle.seed import gather_windows, seed_candidates
from rambl_tpu_torch.oracle.sw import sw_batch, traceback_batch


@dataclasses.dataclass
class AlignmentResult:
    """Dense per-read alignment records."""

    score: np.ndarray        # (B,) int32 best local-alignment score (0 if none)
    ref: np.ndarray          # (B,) int32 best reference id, -1 if unaligned
    strand: np.ndarray       # (B,) int8 0=fwd, 1=rc
    ref_col: np.ndarray      # (B, L) int32 global ref position per query pos, -1
    query: np.ndarray        # (B, L) int8 codes of the aligned orientation
    # all-candidate info (for binning): scores and refs of every pair
    pair_score: np.ndarray   # (B, 2C) int32
    pair_ref: np.ndarray     # (B, 2C) int32
    pair_valid: np.ndarray   # (B, 2C) bool

    @property
    def aligned(self) -> np.ndarray:
        return self.ref >= 0


def mapping_quality(res: "AlignmentResult") -> np.ndarray:
    """MAPQ-equivalent margin, bit-identical to pipeline.align.mapping_quality
    (tests/test_ops_parity.py): best score minus best valid other-reference
    pair score; 0 for unaligned or cross-ref multi-mapped reads."""
    second = np.max(
        np.where(res.pair_valid & (res.pair_ref != res.ref[:, None]),
                 res.pair_score, 0),
        axis=1,
    )
    return np.where(res.aligned, res.score - second, 0).astype(np.int32)


def align_reads(
    reads: np.ndarray,
    read_lens: np.ndarray,
    ref_seqs: np.ndarray,
    index: SeedIndex,
    cfg: PipelineConfig,
    chunk: int = 512,
) -> AlignmentResult:
    B, L = reads.shape
    W = cfg.window_len
    C = cfg.max_candidates
    rc_reads = revcomp_codes(reads, read_lens)
    padded = index.padded_entries(cfg.bucket_cap)

    out_score = np.zeros((B,), np.int32)
    out_ref = np.full((B,), -1, np.int32)
    out_strand = np.zeros((B,), np.int8)
    out_refcol = np.full((B, L), -1, np.int32)
    out_query = reads.copy()
    out_pscore = np.zeros((B, 2 * C), np.int32)
    out_pref = np.zeros((B, 2 * C), np.int32)
    out_pvalid = np.zeros((B, 2 * C), bool)

    for s0 in range(0, B, chunk):
        s1 = min(s0 + chunk, B)
        n = s1 - s0
        fwd = reads[s0:s1]
        rcq = rc_reads[s0:s1]
        lens = read_lens[s0:s1]

        cands_f = seed_candidates(fwd, lens, index, cfg, padded)
        cands_r = seed_candidates(rcq, lens, index, cfg, padded)

        # stack pairs: (n, 2C)
        cref = np.concatenate([cands_f["cand_ref"], cands_r["cand_ref"]], axis=1)
        cws = np.concatenate([cands_f["cand_wstart"], cands_r["cand_wstart"]], axis=1)
        cval = np.concatenate([cands_f["cand_valid"], cands_r["cand_valid"]], axis=1)

        wins = gather_windows(ref_seqs, cref, cws, W)       # (n, 2C, W)
        # queries per pair: fwd for first C, rc for last C
        q_pairs = np.concatenate(
            [np.repeat(fwd[:, None, :], C, axis=1),
             np.repeat(rcq[:, None, :], C, axis=1)], axis=1
        )                                                    # (n, 2C, L)

        qs = q_pairs.reshape(n * 2 * C, L)
        ws = wins.reshape(n * 2 * C, W)
        score, _, _, _ = sw_batch(qs, ws, cfg.scoring, want_dirs=False)
        score = score.reshape(n, 2 * C)
        score = np.where(cval, score, 0)

        # best pair: max score, tie -> lowest pair index
        key = score.astype(np.int64) * (2 * C) + (2 * C - 1 - np.arange(2 * C))
        best_pair = np.argmax(key, axis=1)
        bidx = np.arange(n)
        best_score = score[bidx, best_pair]

        aligned = best_score >= cfg.min_score
        strand = (best_pair >= C).astype(np.int8)
        bref = cref[bidx, best_pair]
        bws = cws[bidx, best_pair]

        # pass 2: directions for best pair only
        qb = np.where(strand[:, None] == 1, rcq, fwd)
        wb = wins[bidx, best_pair]
        _, ie, je, dirp = sw_batch(qb, wb, cfg.scoring, want_dirs=True)
        rc_local = traceback_batch(dirp, ie, je, L)          # (n, L) window cols
        gcol = np.where(rc_local >= 0, rc_local + bws[:, None], -1)
        # clip to real reference extent
        gcol = np.where(
            (gcol >= 0) & (gcol < ref_seqs.shape[1]), gcol, -1
        )

        out_score[s0:s1] = np.where(aligned, best_score, 0)
        out_ref[s0:s1] = np.where(aligned, bref, -1)
        out_strand[s0:s1] = np.where(aligned, strand, 0)
        out_refcol[s0:s1] = np.where(aligned[:, None], gcol, -1)
        out_query[s0:s1] = qb
        out_pscore[s0:s1] = score
        out_pref[s0:s1] = cref
        out_pvalid[s0:s1] = cval & (score >= cfg.min_score)

    return AlignmentResult(
        score=out_score,
        ref=out_ref,
        strand=out_strand,
        ref_col=out_refcol,
        query=out_query,
        pair_score=out_pscore,
        pair_ref=out_pref,
        pair_valid=out_pvalid,
    )
