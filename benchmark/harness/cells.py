"""The `Context` a traffic kind's runner takes, and the runners of the
first two kinds. A traffic file names its kind, and `kinds/<kind>.py`
exports the kind's runner as `Cell` (`spec.runner`); everything that
differs between cells (the deployment's sizes and settings, how much is
checked) is data in the configuration and traffic files.

A runner is made from a `Context` and has `setup()`, `window(seconds,
span) -> work` (whole units of work for at least `seconds`, inside one
`span()`), `check(control) -> {name: (value, limit)}` and `release()`. It
works on the context's cards, `ctx.devices` (the cell's `chips` cards;
`ctx.device` is the first), and `sync(ctx)` waits for all of them.

- `stream` (`StreamCell`): whole passes of `stream_align` over the
  sample's reads against the deployment's prebuilt index and column maps,
  back to back, on `ctx.device`. The work is the reads streamed.
- `cluster` (`ClusterCell`): round 0's prelude as `assemble_round` runs it
  (the stream, the active leaves, the slot pileups), then `cluster_stage`
  on round 0's blocks of leaves with reads of their own (DP-means' path)
  one at a time, in an order drawn from the seed, wrapping. The work is
  the leaves clustered.

Each runner's check compares the timed path's own outputs with the plain
reference (`benchmark.reference`) once the window has closed. `control`
puts the reference in the program's place, its counters and retained
columns in the next narrower integers, and compares the same numbers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.panel import load_database
from benchmark.harness.reads import make_reads
from benchmark.reference import align as ralign
from benchmark.reference import leaf as rleaf
from benchmark.reference import pileup as rpileup
from benchmark.reference import taxonomy as rtax
from benchmark.reference.colmap import col_map_rows
from benchmark.reference.params import Params


@dataclasses.dataclass
class Context:
    cell: str
    config_name: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    log: object = print
    #: every card of the cell, `device` first; (device,) when not given
    devices: tuple = ()

    def __post_init__(self):
        self.devices = tuple(self.devices) or (self.device,)

    @property
    def settings(self) -> dict:
        return self.config["settings"]

    def program_config(self):
        from rambl_tpu_torch.config import PipelineConfig

        return PipelineConfig(**self.settings)

    def params(self) -> Params:
        return Params.of(self.settings)

    def rng(self, salt: int) -> np.random.Generator:
        """A generator of the seed for the harness's own choices (which
        reads and leaves are checked, the order of blocks)."""
        return np.random.default_rng([self.seed, salt])


def sync(ctx: Context) -> None:
    """Wait until every card of the context has finished its work."""
    for dev in ctx.devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StreamCell:
    """Whole `stream_align` passes over the sample."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg = ctx.program_config()
        self.p = ctx.params()

    def _load(self) -> None:
        """The deployment's database and the seed's sample, then one whole
        pass of the stream."""
        ctx = self.ctx
        self.db = load_database(ctx.config_name, ctx.config["panel"],
                                self.cfg.k, ctx.log)
        self.reads, self.lens = make_reads(
            self.db.ref_seqs, self.db.ref_lens, ctx.config["sample"],
            ctx.seed, ctx.device)
        self.out = self._pass(self.reads, self.lens)
        sync(ctx)

    def setup(self) -> None:
        # the first pass at full size allocates the retention buffers and
        # the pinned host copy, which later passes find in the allocators'
        # caches
        self._load()
        self.out = None

    def _pass(self, reads, lens):
        from rambl_tpu_torch.pipeline.assemble import stream_align

        db = self.db
        return stream_align(reads, lens, db.index, db.ref_seqs, db.ref_lens,
                            db.tables, self.cfg, col_maps=db.col_map,
                            device=self.ctx.device)

    def window(self, seconds: float, span) -> int:
        from torch.profiler import record_function

        passes = 0
        with span():
            t0 = time.perf_counter()
            while True:
                self.out = None          # free the last pass's retention
                t1 = time.perf_counter()
                with record_function("bench.stream_align"):
                    self.out = self._pass(self.reads, self.lens)
                    sync(self.ctx)
                passes += 1
                t2 = time.perf_counter()
                self.ctx.log(f"pass {passes}: {t2 - t1:.3f} s")
                if t2 - t0 >= seconds:
                    break
        return passes * self.reads.shape[0]

    # ---- the check --------------------------------------------------------
    def _sample(self, n: int) -> np.ndarray:
        N = self.reads.shape[0]
        return np.sort(self.ctx.rng(1).choice(N, size=min(n, N),
                                              replace=False))

    def reference_rows(self, idx) -> dict:
        db, p = self.db, self.p
        al = ralign.align_reads(self.reads[idx], self.lens[idx], db.ref_seqs,
                                db.ref_lens, p, device=self.ctx.device)
        anc = rtax.anc_paths(db.tax_parent, db.tax_depth)
        bins = rtax.bin_reads(al, anc, db.tax_depth, db.ref_taxon, p)
        maps = col_map_rows(db.ref_seqs, db.ref_lens, db.ref_taxon,
                            np.clip(al.ref, 0, db.n_refs - 1))
        proj = np.full(al.ref_col.shape, -1, np.int64)
        for i in range(idx.size):
            if al.ref[i] >= 0:
                c = al.ref_col[i]
                m = maps[int(al.ref[i])]
                proj[i] = np.where(c >= 0, m[np.clip(c, 0, m.size - 1)], -1)
        return dict(query=al.query, ref_col=proj, bins=bins, score=al.score,
                    ref=al.ref, strand=al.strand)

    def program_rows(self, idx) -> dict:
        merged = self.out[0]
        t = torch.as_tensor(idx, device=merged["bins"].device)
        return {k: merged[k][t].cpu().numpy() for k in compare.ROW_FIELDS}

    def _stream_checks(self, control: bool, bins: np.ndarray) -> dict:
        """The stream's per-read outputs on the seed's sample of reads, and
        its read counts against the retained bins of every read."""
        read_count = self.out[3]
        n_nodes = self.db.tables.n_nodes
        idx = self._sample(self.ctx.traffic["check_reads"])
        ref = self.reference_rows(idx)
        self.ctx.log(f"reference rows of {idx.size} reads")
        want_rc = rpileup.read_counts(bins, n_nodes)
        if control:
            prog = dict(ref, ref_col=ref["ref_col"].astype(np.int8))
            got_rc = rpileup.read_counts(bins, n_nodes, np.int16)
        else:
            prog = self.program_rows(idx)
            got_rc = read_count.cpu().numpy()
        return {"rows_differing": (compare.rows_differing(prog, ref), 0),
                "read_count_nodes_differing":
                    (compare.nodes_differing(got_rc, want_rc), 0)}

    def check(self, control: bool = False) -> dict:
        """{name: (value, limit)} of the numbers compared."""
        merged, counts, span_diff, _ = self.out
        n_nodes = self.db.tables.n_nodes
        bins = merged["bins"].cpu().numpy()
        out = self._stream_checks(control, bins)
        if counts is not None:
            ref_len = self.db.ref_seqs.shape[1]
            q = merged["query"].cpu().numpy()
            rc = merged["ref_col"].cpu().numpy()
            want = rpileup.node_pileup(q, rc, bins, n_nodes, ref_len)
            got = (rpileup.node_pileup(q, rc, bins, n_nodes, ref_len,
                                       np.int16) if control
                   else (counts.cpu().numpy(), span_diff.cpu().numpy()))
            out["pileup_nodes_differing"] = (
                compare.nodes_differing(np.concatenate(got, 1),
                                        np.concatenate(want, 1)), 0)
        return out

    def release(self) -> None:
        self.out = None


class ClusterCell(StreamCell):
    """Round 0's cluster stage, a leaf block a call."""

    def setup(self) -> None:
        from rambl_tpu_torch.pipeline.assemble import _active_leaves
        from rambl_tpu_torch.pipeline.pileup import node_slot_pileup

        ctx, cfg = self.ctx, self.cfg
        self._load()
        rec, counts, span_diff, read_count = self.out
        if counts is not None:
            raise ValueError("the cluster traffic is round 0 in slot mode: "
                             "the deployment's taxonomy must exceed "
                             "pileup_slot_nodes")
        rc_host = read_count.cpu().numpy()
        leaves, node2slot, n_slots = _active_leaves(rc_host, self.db.tables,
                                                    cfg)
        self.node2slot = node2slot
        self.slot_counts = node_slot_pileup(
            rec["query"], rec["ref_col"], rec["bins"],
            torch.from_numpy(node2slot).to(ctx.device), n_slots,
            self.db.ref_seqs.shape[1])
        heavy = rc_host[leaves] > 0
        self.blocks = self._blocks(leaves, heavy)
        ctx.log(f"round 0: {leaves.size} active leaves, {int(heavy.sum())} "
                f"with reads of their own in {len(self.blocks)} blocks; "
                f"{n_slots} slots")
        if not self.blocks:
            raise ValueError("round 0 has no leaf with reads of its own")
        self.done, self.cursor = [], 0
        self._block(self.blocks[0])          # warm the block's shapes
        sync(ctx)

    def _blocks(self, leaves, heavy):
        """The blocks of leaves with reads of their own, as `cluster_stage`
        forms them (`cluster_leaf_block` at a time, in leaf order), in an
        order drawn from the seed. These run DP-means. The blocks of leaves
        without reads of their own take the light path (no features, no
        DP-means): about an eighth of round 0's leaves in a small share of
        its time. They are not timed, since a window of a few blocks that
        sometimes takes one of them in swings the rate by a fifth."""
        blk = max(1, self.cfg.cluster_leaf_block or leaves.size)
        ls = leaves[heavy]
        bl = [ls[s:s + blk] for s in range(0, ls.size, blk)]
        return [bl[i] for i in self.ctx.rng(2).permutation(len(bl))]

    def _block(self, lb):
        from rambl_tpu_torch.pipeline.assemble import cluster_stage

        rec, _, _, read_count = self.out
        counts, span = self.slot_counts
        return cluster_stage(rec, counts, span, read_count, lb,
                             self.db.tables, self.cfg, self.node2slot)

    def window(self, seconds: float, span) -> int:
        from torch.profiler import record_function

        leaves = 0
        with span():
            t0 = time.perf_counter()
            while True:
                lb = self.blocks[self.cursor % len(self.blocks)]
                t1 = time.perf_counter()
                with record_function("bench.cluster_stage"):
                    res = self._block(lb)
                self.done.append((lb, res))
                leaves += lb.size
                self.cursor += 1
                self.ctx.log(f"block of {lb.size} leaves: "
                             f"{time.perf_counter() - t1:.3f} s")
                if time.perf_counter() - t0 >= seconds:
                    break
        return leaves

    def check(self, control: bool = False) -> dict:
        rec = self.out[0]
        p = self.p
        db = self.db
        anc = rtax.anc_paths(db.tax_parent, db.tax_depth)
        bins = rec["bins"].cpu().numpy()
        # the leaves checked: the one with the most members, and others
        # drawn from the seed, among those the window clustered
        seen = {}
        for lb, res in self.done:
            for i, leaf in enumerate(lb.tolist()):
                seen[leaf] = (res, i)
        leaves = np.array(sorted(seen))
        n_mem = np.array([seen[l][0][2][seen[l][1]] for l in leaves])
        pick = [int(leaves[np.argmax(n_mem)])]
        rest = leaves[leaves != pick[0]]
        k = min(self.ctx.traffic["check_leaves"] - 1, rest.size)
        pick += [int(x) for x in self.ctx.rng(3).choice(rest, k,
                                                          replace=False)]
        dev = rec["bins"].device

        def rows(ix):
            t = torch.as_tensor(ix, device=dev)
            return (rec["query"][t].cpu().numpy(),
                    rec["ref_col"][t].cpu().numpy())

        ref_len = db.ref_seqs.shape[1]
        differ = 0
        for leaf in pick:
            want = rleaf.discover(leaf, bins, rows, anc, db.tax_depth,
                                  ref_len, p)
            if control:
                got = rleaf.discover(leaf, bins, rows, anc, db.tax_depth,
                                     ref_len, p, dtype=np.int16)
            else:
                res, i = seen[leaf]
                cons, kact, nm, mh = res
                got = compare.port_leaf(cons, kact, nm, mh, i, p)
            differ += compare.leaf_differs(got, want)
            self.ctx.log(f"leaf {leaf}: {want['n_mem']} members, "
                         f"{want['kact']} clusters, {len(want['genes'])} "
                         f"genes")
        return {"leaves_differing": (differ, 0),
                **self._stream_checks(control, bins)}

    def release(self) -> None:
        self.slot_counts = None
        super().release()

