"""The `mesh_stream` traffic kind: whole `stream_align` passes over the
sample on a data-parallel mesh of the context's cards, the seed index
ring-sharded over them.

Set-up loads the deployment's database and the seed's sample as the
`stream` kind does, makes the mesh (`data_mesh(devices=ctx.devices)`), the
ring shards of the index (`RingShards(build_ring_shards(index, n), mesh)`)
and each card's `StreamTables` once, as a lab that streams many samples
against one sharded index does, then runs one warm pass. The window runs
whole passes back to back, waiting for every card after each; the work is
the reads streamed.

The check holds what the window's last pass produced to the plain
reference (sharding changes no bit) and to the deployment's guarantees:

- `rows_differing`: of `check_reads` reads drawn from the seed, those
  whose query or projected columns in the owning rank's retention (read g:
  batch g // bs, rank (g % bs) // (bs / n)), or bin, score, ref or strand
  in that rank's replica, differ from the reference's alignment;
- `read_count_nodes_differing`: summed over the ranks' replicas, the nodes
  whose read count differs from a count of every rank's retained bins;
- `shards_differing`: the ranks whose shard after the window differs from
  its slice of the index, so that every pass left each shard home.

The stream must be in slot mode (taxonomy nodes above `pileup_slot_nodes`),
where only read counts merge: the position-sharded pileup merge is not
checked here, and a deployment that would run it is refused in set-up.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.cells import StreamCell, sync
from benchmark.harness.panel import load_database
from benchmark.harness.reads import make_reads
from benchmark.reference import pileup as rpileup


class Cell(StreamCell):
    def setup(self) -> None:
        from rambl_tpu_torch.parallel.mesh import data_mesh
        from rambl_tpu_torch.parallel.ring import (
            RingShards,
            build_ring_shards,
        )
        from rambl_tpu_torch.pipeline.assemble import StreamTables

        ctx = self.ctx
        self.db = db = load_database(ctx.config_name, ctx.config["panel"],
                                     self.cfg.k, ctx.log)
        if db.tables.n_nodes <= self.cfg.pileup_slot_nodes:
            raise ValueError(
                "the mesh_stream kind checks slot mode only: the "
                "deployment's taxonomy must exceed pileup_slot_nodes")
        if not self.cfg.shard_index:
            raise ValueError("the mesh_stream kind streams against a "
                             "ring-sharded index: set shard_index")
        self.reads, self.lens = make_reads(
            db.ref_seqs, db.ref_lens, ctx.config["sample"], ctx.seed,
            ctx.device)
        self.mesh = data_mesh(devices=ctx.devices)
        self.host_shards = build_ring_shards(db.index, self.mesh.size)
        self.shards = RingShards(self.host_shards, self.mesh)
        per_card = {d: StreamTables.from_host(db.ref_seqs, db.tables,
                                              db.col_map, d)
                    for d in dict.fromkeys(self.mesh.devices)}
        self.tables = [per_card[d] for d in self.mesh.devices]
        words = sum(a.size for a in self.host_shards.values())
        ctx.log(f"mesh of {self.mesh.size} ranks; shards of "
                f"{words // self.mesh.size} words a rank")
        self.out = self._pass(self.reads, self.lens)
        sync(ctx)
        self.out = None

    def _pass(self, reads, lens):
        from rambl_tpu_torch.pipeline.assemble import stream_align

        db = self.db
        return stream_align(reads, lens, db.index, db.ref_seqs, db.ref_lens,
                            db.tables, self.cfg, mesh=self.mesh,
                            col_maps=db.col_map, ring_shards=self.shards,
                            stream_tables=self.tables)

    # ---- the check --------------------------------------------------------
    def _owner(self, g: np.ndarray):
        """(batch, rank, row in the rank's block) of stream rows g."""
        bs = self.cfg.batch_size
        bl = bs // self.mesh.size
        return g // bs, (g % bs) // bl, (g % bs) % bl

    def program_rows(self, idx) -> dict:
        merged = self.out[0]
        b, r, row = self._owner(np.asarray(idx, np.int64))
        out = {}
        for rank in range(self.mesh.size):
            sel = np.flatnonzero(r == rank)
            dev = merged["bins"][rank].device
            bt, rt, gt = (torch.as_tensor(x[sel], device=dev)
                          for x in (b, row, idx))
            for k in compare.ROW_FIELDS:
                got = (merged[k][rank][bt, rt] if k in ("query", "ref_col")
                       else merged[k][rank][gt]).cpu().numpy()
                if k not in out:
                    out[k] = np.empty((idx.size,) + got.shape[1:], got.dtype)
                out[k][sel] = got
        return out

    def retained_bins(self) -> np.ndarray:
        """Every rank's retained bins in stream order, the reads only."""
        bins_sh = self.out[0]["bins_sh"]
        flat = torch.cat([b.cpu() for b in bins_sh], 1).reshape(-1)
        return flat[:self.reads.shape[0]].numpy()

    def shards_differing(self) -> int:
        bad = 0
        for r, (bst, ent) in enumerate(self.shards.state):
            want_bs = torch.from_numpy(self.host_shards["bucket_start"][r])
            want_ent = torch.from_numpy(self.host_shards["entries"][r])
            bad += not (torch.equal(bst, want_bs.to(bst.device))
                        and torch.equal(ent, want_ent.to(ent.device)))
        return bad

    def check(self, control: bool = False) -> dict:
        n_nodes = self.db.tables.n_nodes
        idx = self._sample(self.ctx.traffic["check_reads"])
        ref = self.reference_rows(idx)
        self.ctx.log(f"reference rows of {idx.size} reads")
        want_rc = rpileup.read_counts(self.retained_bins(), n_nodes)
        if control:
            prog = dict(ref, ref_col=ref["ref_col"].astype(np.int8))
            got_rc = [rpileup.read_counts(self.retained_bins(), n_nodes,
                                          np.int16)] * self.mesh.size
        else:
            prog = self.program_rows(idx)
            got_rc = [rc.cpu().numpy() for rc in self.out[3]]
        return {"rows_differing": (compare.rows_differing(prog, ref), 0),
                "read_count_nodes_differing":
                    (sum(compare.nodes_differing(rc, want_rc)
                         for rc in got_rc), 0),
                "shards_differing": (self.shards_differing(), 0)}

    def release(self) -> None:
        self.out = None
        self.shards = self.tables = None
