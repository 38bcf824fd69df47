"""Entry hooks of the port: the counterpart of the repository's
`__graft_entry__.py`.

`entry()` returns the hot step of the main path, `pipeline.align.
align_batch` (seeding, K1 on every pair, K2 + K3 on the gapped best pairs),
on a toy problem, with example arguments on the device.

`dryrun_multichip(n)` builds an n-rank 'data' mesh and runs the align +
bin + pileup step (`parallel.steps.make_align_pileup_step`) in both of the
framework's distribution modes, then the whole assembly on the mesh in both:

  - DP: reads sharded, seed index replicated, the pileups summed;
  - SP/TP analogue: reads sharded AND the seed index bucket-range sharded,
    its shards rotated round the ring (`cfg.ring_impl`: the plain copy, or
    K4 with "dma" / "dma_barrier").

The two modes must agree bit for bit; any difference raises. The ranks are
virtual ranks of the card by default (`data_mesh(devices=[card] * n)`), or
n CPU ranks with `device="cpu"`.

The reference passes the first reference's base codes where
`build_col_maps` takes each reference's leaf (`build_col_maps(...,
ds.ref_seqs[0, :ds.ref_lens[0]])`), so its toy column maps map references
that share a code onto each other; the port passes the leaves
(`tax.ref_taxon`), as every other caller does.
"""

from __future__ import annotations

import dataclasses

import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.ops.seed import SeedTable
from rambl_tpu_torch.parallel.mesh import data_mesh, put_sharded
from rambl_tpu_torch.parallel.ring import RingShards, build_ring_shards
from rambl_tpu_torch.parallel.steps import make_align_pileup_step
from rambl_tpu_torch.pipeline.align import align_batch
from rambl_tpu_torch.pipeline.assemble import StreamTables, assemble

#: the step outputs the two modes must agree on (the reference's out[2:])
AGREE = ("bins", "score", "counts", "span_diff", "read_count")


def _toy_problem(n_reads=256, batch=128):
    cfg = PipelineConfig(batch_size=batch, max_bin_reads=512)
    ds = simulate_dataset(
        n_species=3, refs_per_species=1, n_reads=n_reads, seed=0,
        skewed_abundance=False,
    )
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    return cfg, ds, index, tax


def entry(device=None):
    """(fn, example_args): the forward align step on one device (the first
    card when None; "cpu" for the plain PyTorch path)."""
    dev = resolve(device)
    cfg, ds, index, _ = _toy_problem()
    table = SeedTable.from_index(index, dev)
    ref_seqs = torch.from_numpy(ds.ref_seqs).to(dev)

    def fn(reads, lens):
        return align_batch(reads, lens, table, ref_seqs, cfg)

    example_args = (
        torch.from_numpy(ds.reads[: cfg.batch_size]).to(dev),
        torch.from_numpy(ds.read_lens[: cfg.batch_size]).to(dev),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None,
                     ring_impl: str | None = None) -> None:
    """Run the distributed step and the whole assembly on an n-rank mesh
    at tiny shapes, index replicated and ring-sharded; raise if the two
    modes differ. `ring_impl` (default: the config's) moves the shards."""
    dev = resolve(device)
    mesh = data_mesh(devices=[dev] * n_devices)
    cfg, ds, index, tax = _toy_problem(n_reads=16 * n_devices)
    if ring_impl is not None:
        cfg = dataclasses.replace(cfg, ring_impl=ring_impl)
    B = 16 * n_devices
    reads = put_sharded(ds.reads[:B], mesh)
    lens = put_sharded(ds.read_lens[:B], mesh)
    cmap = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    tables = {d: StreamTables.from_host(ds.ref_seqs, tax, cmap, d)
              for d in set(mesh.devices)}
    st = [tables[d] for d in mesh.devices]
    ref_len = ds.ref_seqs.shape[1]

    # mode 1: DP, replicated index
    step = make_align_pileup_step(mesh, cfg, index.n_bits, tax.n_nodes,
                                  ref_len)
    table = {d: SeedTable.from_index(index, d) for d in set(mesh.devices)}
    out = step(reads, lens, [table[d] for d in mesh.devices], st)

    # mode 2: ring-sharded index (SP/TP analogue), rotated by cfg.ring_impl
    shards = RingShards(build_ring_shards(index, n_devices), mesh)
    ring_step = make_align_pileup_step(mesh, cfg, index.n_bits, tax.n_nodes,
                                       ref_len, ring=True)
    out2 = ring_step(reads, lens, shards, st)

    # the two modes must agree bitwise, on every rank
    for name, a, b in zip(AGREE, out[2:], out2[2:]):
        for r, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x, y):
                raise AssertionError(f"distributed step: {name} on rank {r} "
                                     "differs between the ring-sharded and "
                                     "the replicated index")

    # the COMPLETE assembly on the mesh (discovery, refinement, polish), in
    # both index modes, which must agree bitwise
    cfg2 = dataclasses.replace(cfg, max_assembly_iters=2)
    args = (ds.reads[:B], ds.read_lens[:B], ds.ref_seqs, ds.ref_lens, tax)
    res_dp = assemble(*args, cfg2, mesh=mesh)
    res_ring = assemble(*args, dataclasses.replace(cfg2, shard_index=True),
                        mesh=mesh)
    k_dp = [(g.key(), g.n_reads, g.taxon) for g in res_dp.genes]
    k_ring = [(g.key(), g.n_reads, g.taxon) for g in res_ring.genes]
    if k_dp != k_ring:
        raise AssertionError("mesh assembly: ring vs replicated index "
                             f"mismatch ({len(k_ring)} vs {len(k_dp)} genes)")
    if res_dp.n_rounds < 1:
        raise AssertionError("mesh assembly ran no round")


if __name__ == "__main__":
    fn, args = entry()
    print(int(fn(*args).score.sum()))
    dryrun_multichip(4)
    print("dryrun_multichip(4) OK")
