"""Align step: seed -> candidates -> score -> best pair -> ref columns.

Port of `rambl_tpu/pipeline/align.py`, bit-identical to it. A batch of padded
reads goes in, dense per-read alignment records come out.

Every (read, candidate window) pair is scored by K1 (`ops.sw_cuda`); the best
pair is the maximum score with ties to the lowest pair index (forward
candidates before reverse-complement ones). Most best pairs are gapless, and
their columns come from the end cell alone: walk the diagonal back until the
suffix substitution sum reaches the best score. Only the rest carry gaps;
they are compacted with `nonzero` (the one host sync of the step) and go
through K2 + K3. The reference's
traceback cap and full-batch fallback are a static-shape device; this eager
port has no cap and gives what both of its branches give.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.ops.seed import (
    SeedTable,
    gather_windows,
    revcomp,
    seed_candidates,
)
from rambl_tpu_torch.ops.sw_cuda import sw_align_traceback_cuda, sw_score_cuda
from rambl_tpu_torch.utils.errors import UserError


class AlignRecords(NamedTuple):
    """Dense per-read alignment records (fields and order of the reference)."""

    score: torch.Tensor       # (B,) int32
    ref: torch.Tensor         # (B,) int32, -1 if unaligned
    strand: torch.Tensor      # (B,) int8
    ref_col: torch.Tensor     # (B, L) int32 global ref column per query pos, -1
    query: torch.Tensor       # (B, L) int8 aligned-orientation codes
    pair_score: torch.Tensor  # (B, 2C) int32
    pair_ref: torch.Tensor    # (B, 2C) int32
    pair_valid: torch.Tensor  # (B, 2C) bool

    @property
    def aligned(self) -> torch.Tensor:
        return self.ref >= 0


def mapping_quality(res: AlignRecords) -> torch.Tensor:
    """Best pair score minus the best valid pair score on a different
    reference; 0 for unaligned reads (the reference's MAPQ margin)."""
    second = torch.where(res.pair_valid & (res.pair_ref != res.ref[:, None]),
                         res.pair_score, 0).amax(dim=1)
    return torch.where(res.aligned, res.score - second, 0).to(torch.int32)


def check_sw_rows(read_lens: torch.Tensor, cfg: PipelineConfig) -> None:
    """cfg.sw_rows is exact only when every real read fits in it. Reads the
    longest length back to the host: one sync. The stream checks its host
    lengths once instead and skips this (`align_batch(check_rows=False)`),
    as the reference skips it under trace."""
    if not cfg.sw_rows or read_lens.numel() == 0:
        return
    ml = int(read_lens.max())
    if ml > cfg.sw_rows:
        raise UserError(
            f"cfg.sw_rows={cfg.sw_rows} < longest read {ml}: the truncated "
            "SW sweep is only exact when every real read fits")


def align_batch(reads: torch.Tensor, read_lens: torch.Tensor,
                table: SeedTable, ref_seqs: torch.Tensor,
                cfg: PipelineConfig, *, check_rows: bool = True
                ) -> AlignRecords:
    """`check_rows=False` is for callers that have checked the lengths
    against cfg.sw_rows on the host (`check_sw_rows`)."""
    if check_rows:
        check_sw_rows(read_lens, cfg)
    rc_reads = revcomp(reads, read_lens)
    cands_f = seed_candidates(reads, read_lens, table, cfg)
    cands_r = seed_candidates(rc_reads, read_lens, table, cfg)
    return align_from_candidates(reads, rc_reads, cands_f, cands_r, ref_seqs,
                                 cfg)


def align_from_candidates(reads: torch.Tensor, rc_reads: torch.Tensor,
                          cands_f: dict, cands_r: dict,
                          ref_seqs: torch.Tensor,
                          cfg: PipelineConfig) -> AlignRecords:
    B, L = reads.shape
    W = cfg.window_len
    C = cfg.max_candidates
    sc = cfg.scoring
    dev = reads.device
    i32 = torch.int32

    cref = torch.cat([cands_f["cand_ref"], cands_r["cand_ref"]], dim=1)
    cws = torch.cat([cands_f["cand_wstart"], cands_r["cand_wstart"]], dim=1)
    cval = torch.cat([cands_f["cand_valid"], cands_r["cand_valid"]], dim=1)

    wins = gather_windows(ref_seqs, cref, cws, W)             # (B, 2C, W)
    q_pairs = torch.cat([reads[:, None, :].expand(B, C, L),
                         rc_reads[:, None, :].expand(B, C, L)], dim=1)

    # pass 1: score every pair (K1)
    score, p_ie, p_je = sw_score_cuda(
        q_pairs.reshape(B * 2 * C, L).contiguous(),
        wins.reshape(B * 2 * C, W).contiguous(), sc, rows=cfg.sw_rows)
    score = torch.where(cval, score.reshape(B, 2 * C), 0)
    p_ie = p_ie.reshape(B, 2 * C)
    p_je = p_je.reshape(B, 2 * C)

    # best pair: max score, tie -> lowest pair index
    key = score * (2 * C) + (2 * C - 1 - torch.arange(2 * C, dtype=i32,
                                                      device=dev))
    best_pair = torch.argmax(key, dim=1)
    bidx = torch.arange(B, device=dev)
    best_score = score[bidx, best_pair]

    aligned = best_score >= cfg.min_score
    strand = (best_pair >= C).to(torch.int8)
    bref = cref[bidx, best_pair]
    bws = cws[bidx, best_pair]

    # pass 2: window column per query position for the best pair
    qb = torch.where(strand[:, None] == 1, rc_reads, reads)
    wb = wins[bidx, best_pair]
    ie = p_ie[bidx, best_pair]
    je = p_je[bidx, best_pair]

    # gapless reads: qi[k] = qb[ie-1-k], wj[k] = wb[je-1-k] for k < min(ie, je)
    kk = torch.arange(L, dtype=i32, device=dev)
    kmax = torch.minimum(ie, je)
    live = kk[None, :] < kmax[:, None]
    qi = torch.gather(qb, 1, torch.clamp(ie[:, None] - 1 - kk, 0, L - 1).long())
    wj = torch.gather(wb, 1, torch.clamp(je[:, None] - 1 - kk, 0, W - 1).long())
    # int32 filled on the device: a device tensor made from a Python scalar
    # is a host copy, and where() of two Python scalars gives int64
    sub = torch.full(qi.shape, sc.mismatch, dtype=i32, device=dev)
    sub.masked_fill_((qi == wj) & (qi < 4) & (wj < 4), sc.match)
    sub.masked_fill_(~live, sc.neg_inf)
    S = torch.cumsum(sub, dim=1, dtype=i32)                   # suffix sums
    hit = (S == best_score[:, None]) & live
    gapless = hit.any(dim=1) & (best_score > 0)
    # first hit (argmax returns the first of equal maxima)
    n = torch.argmax(hit.to(i32), dim=1).to(i32) + 1
    in_span = ((kk[None, :] >= (ie - n)[:, None])
               & (kk[None, :] <= (ie - 1)[:, None]))
    rc_local = torch.where(in_span & gapless[:, None],
                           (je - ie)[:, None] + kk[None, :], -1).to(i32)

    # gapped reads: K2 + K3 on the compacted sub-batch
    needs_tb = (best_score > 0) & ~gapless
    sel = torch.nonzero(needs_tb).squeeze(1)
    if sel.numel():
        _, _, _, rc_s = sw_align_traceback_cuda(
            qb[sel].contiguous(), wb[sel].contiguous(), sc, cfg.sw_rows, L, W)
        rc_local[sel] = rc_s

    gcol = torch.where(rc_local >= 0, rc_local + bws[:, None], -1)
    gcol = torch.where((gcol >= 0) & (gcol < ref_seqs.shape[1]), gcol, -1)

    return AlignRecords(
        score=torch.where(aligned, best_score, 0).to(i32),
        ref=torch.where(aligned, bref, -1).to(i32),
        strand=torch.where(aligned, strand, 0).to(torch.int8),
        ref_col=torch.where(aligned[:, None], gcol, -1).to(i32),
        query=qb,
        pair_score=score.to(i32),
        pair_ref=cref,
        pair_valid=cval & (score >= cfg.min_score),
    )
