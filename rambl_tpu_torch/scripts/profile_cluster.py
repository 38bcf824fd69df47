"""Split round 0's cluster stage into its pieces on the card: the port of
scripts/profile_cluster.py.

Builds config-3-shaped synthetic inputs (the shapes are what matter: the
DP-means loop runs a fixed dp_max_iters for every leaf and the member
tensors are (leaves, max_bin_reads, ...) whatever a leaf holds, so the
content changes nothing structural) and times each piece of the stage
(`pipeline.assemble.cluster_round0_core`) apart, in its order:

  bin_sort        argsort of the B bins + range search (`cluster.bin_sort`)
  member_gather   `cluster.member_table_ranges` + the query and ref_col
                  row gathers
  pileup_feat     `pileup.leaf_pileup_slots` + `polymorphic_mask` + the
                  first max_poly_cols polymorphic columns +
                  `cluster.leaf_features_dense`
  dp_means        `cluster.dp_means_leaves`
  consensus       `consensus.cluster_consensus_leaves` +
                  `minor_haplotype_leaves`

The reference's `sort_cols` (`sorted_col_base`) has no counterpart: the
port's dense featurizer reads a base + 1 plane and needs no sorted columns,
so the script prints it as absent.

For each piece: ms (CUDA events, `utils.timing.trial_times`), the device's
busy time over one profiled call (torch.profiler) as a share of those ms,
its five longest device operations, and the host syncs of one call by
source line (`torch.cuda.set_sync_debug_mode("warn")`). The sum of the
pieces is printed beside the card's name and power limit.

    python -m rambl_tpu_torch.scripts.profile_cluster [n_reads] [n_leaves]
        [--device D]

Inputs (`make_inputs`, numpy from `default_rng(seed)`, the big arrays drawn
in int8 and int16 directly): reads spread over 17 x n_leaves leaves in the
upper half of the node ids, a straight-chain `anc_path` (every node at the
deepest rank, its ancestors the nodes 0..MAX_DEPTH-2), int16 ref_col of
gapless reads, and 4,864 slot accumulators in the pipeline's flat
(n_slots, ref_len * 4) layout (the reference's script draws them as
(n_slots, ref_len, 4), which `leaf_pileup_slots` does not take).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.taxonomy import MAX_DEPTH
from rambl_tpu_torch.pipeline.cluster import (
    bin_sort,
    dp_means_leaves,
    feature_columns,
    leaf_features_dense,
    member_table_ranges,
)
from rambl_tpu_torch.pipeline.consensus import (
    cluster_consensus_leaves,
    minor_haplotype_leaves,
)
from rambl_tpu_torch.pipeline.pileup import leaf_pileup_slots, polymorphic_mask
from rambl_tpu_torch.scripts import run_config3

N_READS, N_LEAVES = 10_000_000, 512
PIECES = ("bin_sort", "member_gather", "pileup_feat", "dp_means",
          "consensus")
ABSENT = {"sort_cols": "no counterpart: the dense featurizer needs no "
                       "sorted columns"}


def config() -> PipelineConfig:
    """Config 3's settings (scripts/run_config3.py), as the reference
    script takes them."""
    return run_config3.config(N_READS, max_genes=1024)


@dataclasses.dataclass
class ClusterInputs:
    """Host arrays of one cluster block: the retention (query, ref_col,
    bins), the block's leaves, the taxonomy and the slot accumulators."""

    query: np.ndarray       # (B, L) int8
    ref_col: np.ndarray     # (B, L) int16
    bins: np.ndarray        # (B,) int32
    leaves: np.ndarray      # (n_leaves,) int32
    anc_path: np.ndarray    # (n_nodes, MAX_DEPTH) int32
    depth: np.ndarray       # (n_nodes,) int32
    counts: np.ndarray      # (n_slots, ref_len * 4) int32
    span: np.ndarray        # (n_slots, ref_len + 1) int32
    node2slot: np.ndarray   # (n_nodes,) int32

    @property
    def ref_len(self) -> int:
        return int(self.span.shape[1] - 1)


def make_inputs(n_reads: int, n_leaves: int, *, n_nodes: int = 187_667,
                ref_len: int = 2048, L: int = 128, n_slots: int = 4864,
                seed: int = 0) -> ClusterInputs:
    """The reference script's synthetic config-3 shapes, from
    `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    query = rng.integers(0, 4, (n_reads, L), dtype=np.int8)
    start = rng.integers(0, ref_len - L, n_reads, dtype=np.int16)
    ref_col = start[:, None] + np.arange(L, dtype=np.int16)[None, :]
    pool = np.sort(rng.choice(n_nodes // 2, n_leaves * 17, replace=False)
                   .astype(np.int32)) + n_nodes // 2
    bins = pool[rng.integers(0, pool.size, n_reads)].astype(np.int32)
    # a simple deep tree: anc_path rows are straight chains
    D = MAX_DEPTH
    anc = np.tile(np.arange(D, dtype=np.int32)[None, :], (n_nodes, 1))
    anc[:, -1] = np.arange(n_nodes, dtype=np.int32)
    for d in range(D - 1):
        anc[:, d] = np.minimum(anc[:, d], anc[:, -1])
    depth = np.full(n_nodes, D - 1, np.int32)
    counts = rng.integers(0, 50, (n_slots, ref_len * 4), dtype=np.int32)
    span = rng.integers(0, 5, (n_slots, ref_len + 1), dtype=np.int32)
    node2slot = np.full(n_nodes, -1, np.int32)
    slot_nodes = np.unique(np.concatenate([pool[: n_slots // 2],
                                           np.arange(n_slots // 2)]))
    node2slot[slot_nodes] = np.arange(slot_nodes.size, dtype=np.int32)
    return ClusterInputs(query, ref_col, bins, pool[:n_leaves], anc, depth,
                         counts, span, node2slot)


class Piece(NamedTuple):
    name: str
    fn: Callable
    args: tuple
    out: tuple


def pieces(inputs: ClusterInputs, cfg: PipelineConfig, device) -> list:
    """Upload `inputs` to `device` and run each piece of the cluster stage
    once, in order, each on its predecessors' outputs -> [Piece(name, fn,
    args, out)]: fn(*args) reruns the piece."""
    dev = torch.device(device)
    x = {f.name: torch.from_numpy(getattr(inputs, f.name)).to(dev)
         for f in dataclasses.fields(inputs)}
    n_nodes, ref_len = x["anc_path"].shape[0], inputs.ref_len
    leaves, anc, dep = x["leaves"], x["anc_path"], x["depth"]
    share = cfg.bin_share_depth

    def member_gather(order, ns, ne):
        midx, mvalid = member_table_ranges(order, ns, ne, leaves, anc, dep,
                                           cfg.max_bin_reads, share)
        mi = midx.long()
        return (x["query"][mi], x["ref_col"][mi].to(torch.int32), midx,
                mvalid)

    def pileup_feat(qm, rcm, mvalid):
        lc, lsp = leaf_pileup_slots(x["counts"], x["span"], x["node2slot"],
                                    leaves, anc, dep, share)
        pm = polymorphic_mask(lc, cfg.min_coverage, cfg.poly_min_minor_count,
                              cfg.poly_minor_frac_num,
                              cfg.poly_minor_frac_den, ref_len)
        pol_cols, pol_valid = feature_columns(pm, cfg.max_poly_cols)
        feat = leaf_features_dense(qm, rcm, mvalid, pol_cols, pol_valid,
                                   ref_len)
        return lc, lsp, pm, feat

    def dp_means(feat, midx, mvalid):
        can_seed = (x["bins"][midx.long()] == leaves[:, None]) & mvalid
        return dp_means_leaves(feat, can_seed, cfg)

    def consensus(qm, rcm, mvalid, assign, pm, lc, lsp):
        cons = cluster_consensus_leaves(qm, rcm, mvalid, assign, pm, lc, lsp,
                                        cfg)
        counts = x["counts"]
        ls = x["node2slot"][leaves.long()]
        excl = torch.where(
            (ls >= 0)[:, None, None],
            counts[torch.clamp(ls, 0, counts.shape[0] - 1).long()].reshape(
                -1, ref_len, 4), 0)
        return cons, minor_haplotype_leaves(excl, lc, lsp, cfg)

    out = []

    def step(name, fn, *args):
        res = fn(*args)
        out.append(Piece(name, fn, args, res))
        return res

    order, ns, ne = step("bin_sort", bin_sort, x["bins"], n_nodes)
    qm, rcm, midx, mvalid = step("member_gather", member_gather, order, ns,
                                 ne)
    lc, lsp, pm, feat = step("pileup_feat", pileup_feat, qm, rcm, mvalid)
    dp = step("dp_means", dp_means, feat, midx, mvalid)
    step("consensus", consensus, qm, rcm, mvalid, dp.assign, pm, lc, lsp)
    return out


def run(n_reads: int = N_READS, n_leaves: int = N_LEAVES, *, device=None,
        trials: int = 3, out=print) -> dict:
    """Time every piece on `device` (the first card when None) at
    config 3's block shapes -> {"pieces": {name: {"ms", "busy_share",
    "syncs", "sync_lines", "top"}}, "sum_ms", "card", "shapes",
    "absent"}. On the card: CUDA events, torch.profiler and the sync
    counter; on "cpu" the host clock alone (busy share and syncs None)."""
    from rambl_tpu_torch.utils.timing import median_spread, trial_times

    dev = resolve(device)
    card = card_line(dev)
    cfg = config()
    t0 = time.perf_counter()
    inputs = make_inputs(n_reads, n_leaves)
    gen_s = time.perf_counter() - t0
    shapes = dict(B=n_reads, NL=n_leaves, M=cfg.max_bin_reads,
                  L=inputs.query.shape[1], ref_len=inputs.ref_len,
                  n_nodes=inputs.anc_path.shape[0],
                  n_slots=inputs.counts.shape[0])
    out(f"shapes: {' '.join(f'{k}={v}' for k, v in shapes.items())} "
        f"(inputs made on the host in {gen_s:.1f} s)")
    ps = pieces(inputs, cfg, dev)
    del inputs
    on_card = dev.type == "cuda"
    res = {}
    for p in ps:
        ms = median_spread(trial_times(p.fn, *p.args, device=dev,
                                       trials=trials, iters=1))[0]
        row = dict(ms=ms, busy_share=None, syncs=None, sync_lines=None,
                   top=[])
        if on_card:
            row.update(_profiled(p, ms))
        res[p.name] = row
        busy = ("" if row["busy_share"] is None else
                f", device busy {100 * row['busy_share']:.1f}%, host syncs "
                f"{row['syncs']} {row['sync_lines']}")
        out(f"  {p.name:14s}: {ms:10.3f} ms{busy}")
        for ms_, calls, key in row["top"]:
            out(f"      {ms_:10.3f} ms {calls:6d} calls  {key[:90]}")
    for name, why in ABSENT.items():
        out(f"  {name:14s}: absent ({why})")
    total = sum(r["ms"] for r in res.values())
    out(f"sum of the pieces: {total:.3f} ms a block of {n_leaves} leaves "
        f"[{card}]")
    return dict(pieces=res, sum_ms=total, card=card, shapes=shapes,
                absent=dict(ABSENT))


def _profiled(p: Piece, ms: float) -> dict:
    """A piece's device busy time over one profiled call, as a share of its
    time `ms`, its five longest device operations, and the host syncs of
    one more call."""
    from rambl_tpu_torch.utils.timing import profiled, syncs_of

    busy_ms, ops = profiled(lambda: p.fn(*p.args))
    top = [(e.self_device_time_total / 1e3, e.count, e.key) for e in ops[:5]]
    _, lines = syncs_of(lambda: p.fn(*p.args))
    return dict(busy_share=busy_ms / ms, syncs=sum(lines.values()),
                sync_lines=dict(lines), top=top)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=N_READS)
    ap.add_argument("n_leaves", nargs="?", type=int, default=N_LEAVES,
                    help="leaves of the block (default 512)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(args.n_reads, args.n_leaves, device=args.device)


if __name__ == "__main__":
    main()
