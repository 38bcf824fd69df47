"""Driver config 3: a human-gut-shaped metagenome, ~10 M reads against a
full-Greengenes-sized index (~100k refs), one card (BASELINE.json:9). The
port of scripts/run_config3.py.

    python -m rambl_tpu_torch.scripts.run_config3 [n_reads] [n_refs] [--device D]

Shape choices match a real Greengenes DB through the CLI: every reference
is its own OTU leaf (identity column maps, as `cli._load_taxonomy` makes
them), the sample holds a few hundred present taxa with lognormal
abundance, and the index holds all the references. Exercises slot-compacted
node pileups (187,667 taxonomy nodes), int16 streaming retention and
DP-means in blocks of 512 leaves.

The dataset and index come from `scripts.build_scale_caches` (loaded from
its cache, or built and cached: 1-2 min of simulation and 1.5-2 min of
index build on the host at 10 M reads). `RAMBL_MAX_GENES` sets the panel cap (default
1024; 2048 is the cap of the recorded runs). Recovery counts the
detectable present references (>= 3x true depth) with a gene at > 95%
25-mer containment, scored after the wall (`quality_bench.
present_recovery`). Beside the reference's lines it prints each round's
stages (RAMBL_STAGE_TIMING=1), col maps' build, launches and device memory
(`scripts.ladder`) with the card's name and power limit.

Every run writes the panel dump that `scripts.diagnose_config3` classifies
the misses from (the reference pickles it to /tmp/config3_genes.pkl): a
directory, by default `config3_torch_panel_<n_reads>_<n_refs>_k<k>` in
`build_scale_caches.cache_dir()` (or in `--cache-dir`), holding `panel.npz`
(the final genes as plain arrays, the recovered and detectable references,
the round stats as JSON, the slot map `node2slot` and the dataset's key)
and `slot_counts.npy`, round 0's slot-compacted leaf-exclusive pileups as
flat (n_slots, ref_len * 4) int32 rows, fetched from the card once. At
config 3's full size the counts are about 1 GB; `load_dump` maps them from
the disk rather than reading them. Both files load with
`allow_pickle=False`.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import shutil
import signal
import time

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import card_line, resolve, to_host
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts.ladder import RoundRecorder
from rambl_tpu_torch.scripts.quality_bench import (
    present_recovery,
    true_depth,
)

N_READS = 10_000_000
_GENE_META = ("n_reads", "leaf", "cluster", "round_born", "taxon", "offset")


def config(n_reads: int, max_genes: int | None = None,
           **overrides) -> PipelineConfig:
    # the batch divides n_reads when it can (no padded tail)
    batch = 16000 if n_reads % 16000 == 0 else 16384
    # max_genes > n_present: 500 present refs saturate 256 and 1024 slots
    if max_genes is None:
        max_genes = int(os.environ.get("RAMBL_MAX_GENES", "1024"))
    cfg = PipelineConfig(batch_size=batch, max_genes=max_genes,
                         max_clusters_per_bin=16, max_assembly_iters=4,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    return dataclasses.replace(cfg, **overrides)


def describe(data, tax, t0, out):
    out(f"dataset: {data.n_reads} reads vs {data.n_refs} refs "
        f"({int((data.abundance > 0).sum())} present, {tax.n_nodes} "
        f"taxonomy nodes) in {time.time() - t0:.0f}s")
    idx = data.index
    out(f"index: {idx.n_entries} entries, 2^{idx.n_bits} buckets")


def gene_arrays(genes) -> dict:
    """Genes as plain arrays: `gene_seq` the sequences end to end (int8),
    `gene_bounds` (n + 1) int64 offsets into it, `gene_meta` (n, 6) int64
    rows of n_reads, leaf, cluster, round_born, taxon, offset."""
    lens = [int(g.seq.shape[0]) for g in genes]
    return {
        "gene_seq": (np.concatenate([np.asarray(g.seq, np.int8)
                                     for g in genes])
                     if genes else np.zeros(0, np.int8)),
        "gene_bounds": np.concatenate([[0], np.cumsum(lens)]).astype(
            np.int64),
        "gene_meta": np.array([[int(getattr(g, f)) for f in _GENE_META]
                               for g in genes],
                              np.int64).reshape(-1, len(_GENE_META)),
    }


def genes_of(arrays, lo: int = 0, hi=None) -> list:
    """`gene_arrays`' genes lo..hi back as `Gene`s (all of them by default)."""
    seq, bounds = arrays["gene_seq"], arrays["gene_bounds"]
    meta = arrays["gene_meta"]
    hi = meta.shape[0] if hi is None else hi
    return [Gene(seq=seq[bounds[i]: bounds[i + 1]].copy(),
                 **{f: int(v) for f, v in zip(_GENE_META, meta[i])})
            for i in range(lo, hi)]


def dump_path(n_reads: int, n_refs: int, k: int | None = None,
              directory: str | None = None) -> str:
    """The default panel dump of config 3 at n_reads x n_refs."""
    k = PipelineConfig().k if k is None else k
    return os.path.join(caches.cache_dir() if directory is None
                        else directory,
                        f"config3_torch_panel_{n_reads}_{n_refs}_k{k}")


def _plain(o):
    return o.item() if isinstance(o, np.generic) else str(o)


_DUMP_FILES = frozenset({"panel.npz", "slot_counts.npy"})


def _tmp(path: str) -> str:
    return path.rstrip("/") + ".tmp"


def check_dump_target(path: str) -> None:
    """Raise FileExistsError unless `path` and its `.tmp` sibling are each
    absent or a directory holding nothing but a panel dump's files: a dump
    replaces no other directory's contents."""
    for p in (path, _tmp(path)):
        if not os.path.lexists(p):
            continue
        if os.path.islink(p) or not os.path.isdir(p):
            raise FileExistsError(f"{p} is not a panel dump directory")
        other = sorted(set(os.listdir(p)) - _DUMP_FILES)
        if other:
            raise FileExistsError(f"{p} holds files that are not a panel "
                                  f"dump's ({', '.join(other[:5])}); not "
                                  f"replacing it")


def write_dump(path: str, genes, recovered, detectable, stats, slot_counts,
               n_reads: int, n_refs: int, k: int) -> int:
    """Write the panel dump to the directory `path` (replaced whole; written
    beside it first): `panel.npz` and, when `slot_counts` = (counts on any
    device, node2slot) is given, `slot_counts.npy`. `n_reads`, `n_refs`
    and `k` key the dataset cache the diagnosis loads. Writes nothing
    where `check_dump_target` raises. -> bytes written."""
    check_dump_target(path)
    tmp = _tmp(path)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = gene_arrays(genes)
    arrays.update(
        recovered=np.asarray(sorted(int(r) for r in recovered), np.int64),
        detectable=np.asarray(detectable, np.int64),
        stats=np.array(json.dumps(stats, default=_plain)),
        key=np.array([n_reads, n_refs, k], np.int64))
    if slot_counts is not None:
        counts, node2slot = slot_counts
        arrays["node2slot"] = to_host(node2slot)
        np.save(os.path.join(tmp, "slot_counts.npy"), to_host(counts))
    np.savez(os.path.join(tmp, "panel.npz"), **arrays)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def load_dump(path: str) -> dict:
    """Read `write_dump`'s directory (nothing is unpickled) -> {"genes",
    "recovered" (a set), "detectable", "stats", "slot_counts" ((counts
    memory-mapped, node2slot), or None), "n_reads", "n_refs", "k"}."""
    with np.load(os.path.join(path, "panel.npz"), allow_pickle=False) as z:
        n_reads, n_refs, k = (int(v) for v in z["key"])
        out = dict(genes=genes_of(z),
                   recovered=set(z["recovered"].tolist()),
                   detectable=z["detectable"],
                   stats=json.loads(str(z["stats"])), slot_counts=None,
                   n_reads=n_reads, n_refs=n_refs, k=k)
        if "node2slot" in z.files:
            counts = np.load(os.path.join(path, "slot_counts.npy"),
                             mmap_mode="r", allow_pickle=False)
            out["slot_counts"] = (counts, z["node2slot"])
    return out


def run(n_reads: int = N_READS, n_refs: int = caches.N_REFS, *,
        n_present: int = caches.N_PRESENT, device=None, max_genes=None,
        data=None, cache_dir="", overrides=None, dump=None,
        out=print) -> dict:
    """Config 3 through the whole assembly on `device` (the first CUDA card
    when None). `data` is the `build_scale_caches.ScaleData` when already
    built, else it comes from `build_scale_caches.config3` (`cache_dir`:
    "" its default directory, None no cache). `overrides` replace config
    fields (tests). `dump`, a directory, receives the panel dump
    (`write_dump`; checked before the assembly starts). Returns {"result", "cfg", "aux", "genes",
    "full_length", "recovered", "recovered_refs", "detectable",
    "detectable_refs", "present", "wall_s", "score_s", "dump_s",
    "dump_bytes", "rounds", "recorder", "card"}."""
    dev = resolve(device)
    card = card_line(dev)
    if dump is not None:
        check_dump_target(dump)
    t0 = time.time()
    if data is None:
        data = caches.config3(n_reads, n_refs, n_present,
                              directory=cache_dir, out=out)
    tax = build_taxonomy_tables(data.tax_parent, data.tax_depth,
                                data.ref_taxon)
    describe(data, tax, t0, out)
    cfg = config(data.n_reads, max_genes, **(overrides or {}))
    aux = {}
    with RoundRecorder(dev) as rec:
        t1 = time.time()
        res = tassemble.assemble(data.reads, data.read_lens, data.ref_seqs,
                                 data.ref_lens, tax, cfg,
                                 shared_index=data.index, aux_out=aux,
                                 device=dev)
        rec.sync()
        wall = time.time() - t1
    for s in res.round_stats:
        out(s)
    t2 = time.time()
    rec_refs, det_refs, present = present_recovery(data, res.genes,
                                                   true_depth(data))
    rec_n = int(np.isin(rec_refs, det_refs).sum())
    det, present = int(det_refs.size), int(present.size)
    score_s = time.time() - t2
    n_full = len(res.full_length(cfg))
    aligns = sum(s.get("aligned", 0) for s in res.round_stats)
    out(f"wall {wall:.0f}s | rounds {res.n_rounds} converged {res.converged}"
        f" [{card}]")
    out(f"genes {len(res.genes)} full-length {n_full} | recovered>95% "
        f"{rec_n}/{det} detectable ({present} present) (scored in "
        f"{score_s:.0f}s after the wall)")
    out(f"effective throughput {aligns / wall:.0f} reads/s (all stages, "
        f"{aligns} alignments) [{card}]")
    out(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f} [{card}]")
    rec.report(card, out)
    dump_s = dump_bytes = None
    if dump is not None:
        t3 = time.time()
        dump_bytes = write_dump(dump, res.genes, rec_refs, det_refs,
                                res.round_stats, aux.get("slot_counts"),
                                data.n_reads, data.n_refs, cfg.k)
        dump_s = time.time() - t3
        out(f"panel dump -> {dump} ({dump_bytes / 1e9:.3f} GB) in "
            f"{dump_s:.1f}s, after the wall")
    return dict(result=res, cfg=cfg, aux=aux, genes=len(res.genes),
                full_length=n_full, recovered=rec_n, recovered_refs=rec_refs,
                detectable=det, detectable_refs=det_refs, present=present,
                wall_s=wall, score_s=score_s, dump_s=dump_s,
                dump_bytes=dump_bytes, rounds=rec.summary(), recorder=rec,
                card=card)


def main(argv=None) -> None:
    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=N_READS)
    ap.add_argument("n_refs", nargs="?", type=int, default=caches.N_REFS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--cache-dir", default="",
                    help="dataset + index cache directory (default: "
                    "$RAMBL_SCALE_CACHE or _scale_cache/)")
    ap.add_argument("--no-cache", action="store_true",
                    help="build the dataset and index, and write no cache")
    args = ap.parse_args(argv)
    dump = dump_path(args.n_reads, args.n_refs,
                     directory=args.cache_dir or None)
    run(args.n_reads, args.n_refs, device=args.device,
        cache_dir=None if args.no_cache else args.cache_dir, dump=dump,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
