"""The round-0 align step at config 3's index scale, split by prefix: the
port of scripts/bench_align_scale.py.

Config 3's round 0 aligns a batch in more time than a panel round does for
the same work, and its index (153.6 M entries of 100,000 references) is the
difference. This times the production step `pipeline.assemble.
_align_bin_batch` as the stream runs it (tables on the card, two batches
alternating, no sync between calls beyond the step's own) and walks the
prefix ablation until the cost appears:

  FULL  the whole step: seeding, K1, K2 + K3, binning, column projection
  A     `ops.seed.revcomp` + `seed_candidates` on both strands
  B     A + `gather_windows`
  C     `pipeline.align.align_batch` (score and traceback: K1, K2 + K3)
  D     the single-device stream's loop (`assemble.stream_batches`) over nb
        batches with fresh pinned host-to-device copies, into retention
        buffers of `rows` reads (10 M at full size: the production size)

FULL, A, B and C in ms a batch (CUDA events around alternating calls), the
device's busy ms a batch (torch.profiler, over one more such run) with its
share of them, and their three longest device operations; D in ms a batch
on the host clock (to the last batch's synchronize) and the device's idle
share: 1 - its busy ms over one more, profiled, loop / those ms. Every
ms is the median of three runs, printed with their spread ((max - min) /
median).

    python -m rambl_tpu_torch.scripts.bench_align_scale [B] [rows] [nb]
        [--device D]

The dataset and index are config 3's `.npz` cache of its 10 M reads
(`scripts.build_scale_caches.config3`, built and written there when
missing: minutes of host work), loaded with `allow_pickle=False`; `run`
also takes a dataset and index (`ds=`, `index=`). The reference's padded
128-lane entry rows (`_pad_entry_rows`, `pack_entries_np`) are a TPU layout
the port leaves out.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.ops.seed import (
    SeedTable,
    gather_windows,
    revcomp,
    seed_candidates,
)
from rambl_tpu_torch.pipeline.align import align_batch
from rambl_tpu_torch.pipeline.assemble import (
    StreamTables,
    _align_bin_batch,
    retention_buffers,
    stream_batches,
)
from rambl_tpu_torch.scripts import run_config3
from rambl_tpu_torch.utils.timing import median_spread, profiled, trial_times

BATCH, NB = 16384, 16
N_READS = 10_000_000
#: runs of each timing, their median taken
TRIALS = 3
PREFIXES = ("FULL", "A", "B", "C")


def config(batch: int) -> PipelineConfig:
    """Config 3's settings (scripts/run_config3.py) at batch `batch`."""
    return run_config3.config(N_READS, max_genes=2048, batch_size=batch)


def tables_of(ds, index, cfg: PipelineConfig, device):
    """(SeedTable, StreamTables, TaxonomyTables) of a dataset on `device`."""
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    col_map = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    return (SeedTable.from_index(index, device),
            StreamTables.from_host(ds.ref_seqs, tax, col_map, device), tax)


def prefixes(table: SeedTable, st: StreamTables, cfg: PipelineConfig):
    """{name: fn(reads, lens) -> tuple of tensors}: the step and its
    prefixes A, B, C on device tensors."""

    def full(r, ln):
        return _align_bin_batch(r, ln, table, st, cfg)

    def seed2(r, ln):
        rc = revcomp(r, ln)
        cf = seed_candidates(r, ln, table, cfg)
        cr = seed_candidates(rc, ln, table, cfg)
        return cf, cr

    def a(r, ln):
        cf, cr = seed2(r, ln)
        return cf["cand_ref"], cr["cand_ref"]

    def b(r, ln):
        cf, cr = seed2(r, ln)
        cref = torch.cat([cf["cand_ref"], cr["cand_ref"]], dim=1)
        cws = torch.cat([cf["cand_wstart"], cr["cand_wstart"]], dim=1)
        return (gather_windows(st.ref_seqs, cref, cws, cfg.window_len),)

    def c(r, ln):
        res = align_batch(r, ln, table, st.ref_seqs, cfg, check_rows=False)
        return res.score, res.ref, res.ref_col

    return dict(zip(PREFIXES, (full, a, b, c)))


def stream_loop(reads, lens, table: SeedTable, st: StreamTables,
                cfg: PipelineConfig, n_nodes: int, rows: int, nb: int,
                device):
    """D: nb batches of the host arrays through the stream's loop into
    retention buffers of `rows` reads -> (bufs, read_count)."""
    B = cfg.batch_size
    if rows < nb * B:
        raise ValueError(f"{rows} retention rows hold fewer than {nb} "
                         f"batches of {B}")
    host_reads = torch.from_numpy(np.ascontiguousarray(reads[:nb * B]))
    host_lens = torch.from_numpy(np.ascontiguousarray(lens[:nb * B]))
    if device.type == "cuda":
        host_reads, host_lens = host_reads.pin_memory(), host_lens.pin_memory()

    def put(i):
        sl = slice(i * B, (i + 1) * B)
        return (host_reads[sl].to(device, non_blocking=True),
                host_lens[sl].to(device, non_blocking=True))

    bufs = retention_buffers(rows, reads.shape[1], st.ref_seqs.shape[1],
                             device)
    read_count = torch.zeros((n_nodes,), dtype=torch.int32, device=device)
    stream_batches(put, nb, table, st, cfg, bufs, read_count)
    return bufs, read_count


def _timed(fn, a0, a1, reps: int, on_card: bool) -> dict:
    """ms a batch of `reps` calls alternating a0 and a1 (the median of
    TRIALS runs in CUDA events on the card, else one on the host clock)
    with the runs' spread in percent and, on the card, the device's busy
    ms a batch over one more such run (torch.profiler), its share of the
    ms, and the three longest device operations (ms a batch, name)."""

    def work():
        for i in range(reps):
            fn(*(a0 if i % 2 == 0 else a1))

    fn(*a0)
    fn(*a1)
    if not on_card:
        t0 = time.perf_counter()
        work()
        return dict(ms=(time.perf_counter() - t0) * 1e3 / reps, spread=0.0,
                    device_ms=None, busy_share=None, top=[])
    ms, spread = median_spread(trial_times(work, device=torch.device("cuda"),
                                           trials=TRIALS, iters=1, warmup=0))
    ms /= reps
    busy, ops = profiled(work)
    top = [(e.self_device_time_total / 1e3 / reps, e.key) for e in ops[:3]]
    return dict(ms=ms, spread=spread, device_ms=busy / reps,
                busy_share=busy / reps / ms, top=top)


def run(batch: int = BATCH, rows: int | None = None, nb: int = NB, *,
        ds=None, index=None, device=None, reps: int = 16,
        out=print) -> dict:
    """Time FULL, A, B, C and D on `device` (the first card when None) ->
    {name: {"ms", "spread", "device_ms", "busy_share", "top"}, "D": {"ms",
    "spread", "device_ms", "idle_share"}, "card", "batch", "entries",
    "rows", "nb"}. `ds` and `index` default to config 3's cache of its
    N_READS reads; `rows` to the dataset's read count. On "cpu" the host
    clock alone (device ms and shares None)."""
    from rambl_tpu_torch.scripts import build_scale_caches as caches

    dev = resolve(device)
    card = card_line(dev)
    on_card = dev.type == "cuda"
    if ds is None:
        ds = caches.config3(N_READS, out=out)
        index = ds.index
    cfg = config(batch)
    rows = ds.reads.shape[0] if rows is None else rows
    t0 = time.perf_counter()
    table, st, tax = tables_of(ds, index, cfg, dev)
    up_s = time.perf_counter() - t0
    out(f"B={batch} entries={index.n_entries} col_map "
        f"{st.col_map.numel() * 4 / 1e9:.2f} GB (tables built and uploaded "
        f"in {up_s:.1f} s)")
    a0, a1 = ([torch.from_numpy(np.ascontiguousarray(x[i * batch:(i + 1)
                                                       * batch])).to(dev)
               for x in (ds.reads, ds.read_lens)] for i in (0, 1))
    res = {}
    for name, fn in prefixes(table, st, cfg).items():
        res[name] = _timed(fn, a0, a1, reps, on_card)
        r = res[name]
        out(f"{name:4s}: {r['ms']:9.3f} ms/batch (spread {r['spread']:.1f}%)"
            + ("" if r["device_ms"] is None else
               f", device busy {r['device_ms']:.3f} ms "
               f"({100 * r['busy_share']:.1f}%)"))
        for ms_, key in r["top"]:
            out(f"      {ms_:8.3f} ms  {key[:90]}")

    def stream_once():
        return stream_loop(ds.reads, ds.read_lens, table, st, cfg,
                           tax.n_nodes, rows, nb, dev)

    # one warm loop (allocator, pinned pages), then TRIALS loops on the
    # host clock, each to its last batch's synchronize
    d_ms, d_spread = median_spread(trial_times(
        stream_once, device=dev, trials=TRIALS if on_card else 1, iters=1,
        warmup=1, host_clock=True))
    d_ms /= nb
    busy = profiled(stream_once)[0] / nb if on_card else None
    res["D"] = dict(ms=d_ms, spread=d_spread, device_ms=busy,
                    idle_share=None if busy is None else 1.0 - busy / d_ms)
    out(f"D   : {d_ms:9.3f} ms/batch (spread {d_spread:.1f}%) over {nb} "
        f"batches into {rows} retention rows"
        + ("" if busy is None else f", device busy {busy:.3f} ms a batch, "
           f"idle {100 * res['D']['idle_share']:.1f}%")
        + f" [{card}]")
    res.update(card=card, batch=batch, entries=int(index.n_entries),
               rows=rows, nb=nb)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=BATCH)
    ap.add_argument("rows", nargs="?", type=int, default=None,
                    help="D's retention rows (default: every read)")
    ap.add_argument("nb", nargs="?", type=int, default=NB,
                    help="D's batches (default 16)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    run(args.batch, args.rows, args.nb, device=args.device)


if __name__ == "__main__":
    main()
