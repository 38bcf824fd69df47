"""Config-5-shaped run on one card (BASELINE.json:11): 20 M reads against
the 100k-ref index, with a real resume from disk. The port of
scripts/run_config5.py.

    python -m rambl_tpu_torch.scripts.run_config5 [n_reads] [n_refs] [--device D]

The full config 5 is >= 100 M reads on several hosts with a sharded index;
this run shows the memory and throughput model holding past config 3 on
one card: a 20 M-read gut-shaped job (config 3's panel, reads drawn in 5 M
chunks by `build_scale_caches.config5_reads`), streaming retention, slot
pileups, per-round checkpoints and a REAL mid-run resume. Phase A runs the
discovery round (max_assembly_iters 1) with a checkpoint and stops; phase
B loads the panel (`utils.checkpoint.load_checkpoint`) and the `.aux`
round-0 evidence (`load_aux_evidence`) from disk and finishes
(`initial_panel`, `initial_aux`), so its polish does not re-stream round 0.
The continuation is bitwise that of an uninterrupted run.

Memory (one card): the retention is 3 B a read column (int8 query + int16
ref_col) plus 13 B a read, ~0.40 GB a million 128-column reads, beside the
index (~2.4 GB for 100k refs) and the slot accumulators; PERF.md holds the
measured model.

The dataset and index come from `scripts.build_scale_caches`;
`RAMBL_MAX_GENES` sets the panel cap (default 2048). Recovery counts the
detectable present references by abundance-expected depth (>= 3x; the
chunked reads keep no truth), scored after the wall
(`quality_bench.recovered_expected`). Beside the reference's lines it
prints each round's stages (RAMBL_STAGE_TIMING=1), col maps' build,
launches and device memory (`scripts.ladder`) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import os
import signal
import tempfile
import time

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.device import card_line, resolve
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts.ladder import RoundRecorder
from rambl_tpu_torch.scripts.quality_bench import recovered_expected
from rambl_tpu_torch.scripts.run_config3 import describe
from rambl_tpu_torch.utils.checkpoint import load_aux_evidence, load_checkpoint

N_READS = 20_000_000


def config(n_reads: int, max_genes: int | None = None,
           **overrides) -> PipelineConfig:
    batch = 16000 if n_reads % 16000 == 0 else 16384
    # 2048, the clean config-3 cap (512 saturated in the reference's r4 run)
    if max_genes is None:
        max_genes = int(os.environ.get("RAMBL_MAX_GENES", "2048"))
    cfg = PipelineConfig(batch_size=batch, max_genes=max_genes,
                         max_clusters_per_bin=16, max_assembly_iters=3,
                         bin_share_depth=3, cluster_leaf_block=512,
                         sw_rows=104)
    return dataclasses.replace(cfg, **overrides)


def run(n_reads: int = N_READS, n_refs: int = caches.N_REFS, *,
        n_present: int = caches.N_PRESENT, device=None, max_genes=None,
        data=None, cache_dir="", ckpt_dir=None, overrides=None,
        out=print) -> dict:
    """Phase A (discovery + checkpoint) then phase B (resumed from disk)
    on `device` (the first CUDA card when None). `data` is the
    `build_scale_caches.ScaleData` when already built, else it comes from
    `build_scale_caches.config5` (`cache_dir` as there); the checkpoint
    goes to `ckpt_dir` (a new temporary directory when None). Returns
    {"result" (phase B's AssemblyResult), "result_a", "cfg", "header",
    "aux_restored", "genes", "full_length", "recovered", "detectable",
    "present", "wall_s", "phase_a_s", "phase_b_s", "score_s", "rounds_a",
    "rounds_b", "recorder_a", "recorder_b", "card"}."""
    dev = resolve(device)
    card = card_line(dev)
    t0 = time.time()
    if data is None:
        data = caches.config5(n_reads, n_refs, n_present,
                              directory=cache_dir, out=out)
    tax = build_taxonomy_tables(data.tax_parent, data.tax_depth,
                                data.ref_taxon)
    describe(data, tax, t0, out)
    cfg = config(data.n_reads, max_genes, **(overrides or {}))
    args = (data.reads, data.read_lens, data.ref_seqs, data.ref_lens, tax)
    ckpt = os.path.join(ckpt_dir or tempfile.mkdtemp(prefix="rambl_config5_"),
                        "config5.ckpt")

    # phase A: the discovery round only, checkpointed ("crash" after round 0)
    cfg_a = dataclasses.replace(cfg, max_assembly_iters=1)
    with RoundRecorder(dev) as rec_a:
        t2 = time.time()
        res_a = tassemble.assemble(*args, cfg_a, shared_index=data.index,
                                   checkpoint_path=ckpt, device=dev)
        rec_a.sync()
        t_a = time.time() - t2
    out(f"phase A (discovery + checkpoint): {t_a:.0f}s, {len(res_a.panel)} "
        f"panel genes [{card}]")
    rec_a.report(card, out)

    # phase B: resume from disk; the .aux sidecar restores the round-0
    # polish evidence, so polish skips the round-0 re-stream
    header, panel = load_checkpoint(ckpt)
    aux = load_aux_evidence(ckpt + ".aux", cfg_a)
    out(f"resume: {len(panel)} panel genes, aux evidence "
        f"{'RESTORED' if aux else 'absent (will re-stream)'}")
    with RoundRecorder(dev) as rec_b:
        t3 = time.time()
        res = tassemble.assemble(*args, cfg, shared_index=data.index,
                                 initial_panel=panel, initial_aux=aux,
                                 device=dev)
        rec_b.sync()
        t_b = time.time() - t3
    wall = t_a + t_b
    for s in res.round_stats:
        out(s)
    aligns = (sum(s.get("aligned", 0) for s in res.round_stats)
              + sum(s.get("aligned", 0) for s in res_a.round_stats))
    n_full = len(res.full_length(cfg))
    out(f"phase B (resumed): {t_b:.0f}s | total wall {wall:.0f}s [{card}]")
    out(f"genes {len(res.genes)} full-length {n_full} | rounds "
        f"{res.n_rounds} (resumed from round {header['round']})")
    rec_b.report(card, out)
    t4 = time.time()
    rec_n, det, present = recovered_expected(data, res.genes, data.n_reads)
    score_s = time.time() - t4
    out(f"recovered>95% {rec_n}/{det} detectable ({present} present) "
        f"(scored in {score_s:.0f}s after the wall)")
    out(f"effective throughput {aligns / wall:.0f} reads/s "
        f"(all stages, {aligns} alignments) [{card}]")
    out(f"genes assembled/hour {len(res.genes) / (wall / 3600):.0f} [{card}]")
    return dict(result=res, result_a=res_a, cfg=cfg, header=header,
                aux_restored=bool(aux), genes=len(res.genes),
                full_length=n_full, recovered=rec_n, detectable=det,
                present=present, wall_s=wall, phase_a_s=t_a, phase_b_s=t_b,
                score_s=score_s, rounds_a=rec_a.summary(),
                rounds_b=rec_b.summary(), recorder_a=rec_a,
                recorder_b=rec_b, card=card)


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
    run(args.n_reads, args.n_refs, device=args.device,
        cache_dir=None if args.no_cache else args.cache_dir,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
