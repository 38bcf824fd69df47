"""rambl_tpu_torch command line: the port's counterpart of `rambl_tpu/cli.py`,
with the same flags and the same output files.

    python -m rambl_tpu_torch.cli simulate --out DIR [--species N ...]
    python -m rambl_tpu_torch.cli assemble --reads R.fastq [R2.fastq ...]
        --reference refs.fasta [--taxonomy T.tsv] --out genes.fasta
        [--device D] [--oracle] [--checkpoint P] [--resume-from P] ...
    python -m rambl_tpu_torch.cli bench [--device D]

Subcommands:
  simulate  - generate a mock community (FASTA refs + FASTQ reads + truth)
  assemble  - run the whole assembly on one card (the first CUDA card
              unless --device names another device; `--device cpu` runs
              the plain PyTorch path, `--oracle` the NumPy oracle), or
              with `--mesh N` data-parallel on the first N cards (-1: all;
              with `--device cpu`, N CPU ranks)
  bench     - `rambl_tpu_torch.bench` on one card

`assemble` consumes a reference FASTA with a Greengenes-style taxonomy TSV
(name<TAB>k__...;p__...;...) or falls back to one leaf per reference.
Several --reads files are a cohort: one shared index, per-sample outputs
(`OUT.sampleN.fasta`) and cross-sample phasing. `--profile DIR` writes a
torch.profiler trace of the assembly, in which the port's spans
(`utils/trace.py`: round, stream, align, cluster and polish) name the
host's work. Under `--mesh` the process joins
the process group its environment describes (`init_distributed`), adopts
process 0's config and checks that every process read the same reference;
a mesh across processes is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from rambl_tpu_torch.config import PRESETS, PipelineConfig
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.io.fasta import read_fasta, write_fasta, write_fastq
from rambl_tpu_torch.io.pack import decode_seq, encode_batch
from rambl_tpu_torch.utils.errors import UserError


def _load_taxonomy(path: Optional[str], ref_names: List[str]):
    """Greengenes-style taxonomy file -> tree tensors; None -> flat leaves.

    Real-Greengenes semantics live in index.greengenes.load_gg_taxonomy
    (empty-rank placeholders like ``g__; s__`` truncate the lineage); plain
    TSVs without placeholders parse identically."""
    if path is None:
        n = len(ref_names)
        parent = np.zeros((n + 1,), np.int32)
        depth = np.concatenate([[0], np.ones(n)]).astype(np.int32)
        ref_taxon = np.arange(1, n + 1, dtype=np.int32)
        return build_taxonomy_tables(parent, depth, ref_taxon)
    from rambl_tpu_torch.index.greengenes import load_gg_taxonomy

    return load_gg_taxonomy(path, ref_names)


def _write_taxonomy(path: str, ds, ref_ids) -> None:
    with open(path, "w") as f:
        for i in ref_ids:
            node = int(ds.ref_taxon[i])
            chain = []
            while node != 0:
                chain.append(ds.tax_name[node])
                node = int(ds.tax_parent[node])
            f.write(ds.ref_names[i] + "\t" + ";".join(reversed(chain)) + "\n")


def cmd_simulate(args) -> int:
    from rambl_tpu_torch.data.simulate import simulate_cohort, simulate_dataset

    os.makedirs(args.out, exist_ok=True)
    if args.samples > 1:
        # cohort mode (BASELINE config 4): one community, per-sample strain
        # abundances, one FASTQ per sample
        co = simulate_cohort(
            n_species=args.species, refs_per_species=args.strains,
            n_samples=args.samples, reads_per_sample=args.reads,
            seed=args.seed)
        ds = co.ds
        for j, (reads, lens) in enumerate(co.samples):
            write_fastq(
                os.path.join(args.out, f"reads.sample{j}.fastq"),
                [(f"s{j}r{i}", decode_seq(reads[i, : lens[i]]),
                  "I" * int(lens[i])) for i in range(reads.shape[0])])
        truth = {"true_ref": [t.tolist() for t in co.true_ref],
                 "abundance": co.abundance.tolist()}
        n_reads = sum(r.shape[0] for r, _ in co.samples)
    else:
        ds = simulate_dataset(
            n_species=args.species, refs_per_species=args.strains,
            n_reads=args.reads, seed=args.seed,
        )
        write_fastq(
            os.path.join(args.out, "reads.fastq"),
            [(n, decode_seq(ds.reads[i, : ds.read_lens[i]]), ds.read_quals[i])
             for i, n in enumerate(ds.read_names)],
        )
        truth = {"true_ref": ds.true_ref.tolist(),
                 "true_pos": ds.true_pos.tolist(),
                 "true_strand": ds.true_strand.tolist()}
        n_reads = ds.n_reads
    # --db-refs anchors: the reference DB holds only each species' first
    # strain (the real Greengenes shape: sample strains are NOT in the DB
    # and co-bin to their species OTU). The full strain truth always goes
    # to strains.fasta for quality evaluation.
    all_refs = ds.ref_fasta()
    if args.db_refs == "anchors":
        keep = [i for i in range(ds.n_refs)
                if ds.ref_names[i].endswith("_strain0")]
    else:
        keep = list(range(ds.n_refs))
    write_fasta(os.path.join(args.out, "refs.fasta"),
                [all_refs[i] for i in keep])
    write_fasta(os.path.join(args.out, "strains.fasta"), all_refs)
    _write_taxonomy(os.path.join(args.out, "taxonomy.tsv"), ds, keep)
    with open(os.path.join(args.out, "truth.json"), "w") as f:
        json.dump(truth, f)
    print(f"wrote {len(keep)} refs / {n_reads} reads "
          f"({max(args.samples, 1)} sample(s)) to {args.out}")
    return 0


def gene_records(genes):
    """(name, sequence) FASTA records of a gene list, as `assemble` writes
    them: `gene{i}|reads=…|taxon=…|len=…`."""
    return [
        (f"gene{i}|reads={g.n_reads}|taxon={g.taxon}|len={g.seq.shape[0]}",
         decode_seq(g.seq))
        for i, g in enumerate(genes)
    ]


def _mesh_of(args):
    """The --mesh N ranks: the first N visible cards (-1: all of them;
    more than are visible is a UserError), or with --device cpu N CPU
    ranks."""
    import torch

    from rambl_tpu_torch.parallel.mesh import data_mesh

    n = args.mesh
    if args.device is not None and torch.device(args.device).type == "cpu":
        if n < 1:
            raise UserError(f"--mesh {n} with --device cpu: give the number "
                            "of CPU ranks")
        return data_mesh(devices=["cpu"] * n)
    return data_mesh(n if n > 0 else None)


def _run(args, samples, ref_seqs, ref_lens, tables, cfg, col_maps,
         initial_panel, mesh=None):
    """The assembly the flags ask for -> one AssemblyResult per sample."""
    if args.oracle and len(samples) > 1:
        from rambl_tpu_torch.oracle.cohort import assemble_cohort

        return assemble_cohort(samples, ref_seqs, ref_lens, tables, cfg,
                               col_maps=col_maps)
    if args.oracle:
        from rambl_tpu_torch.oracle.pipeline import assemble

        return [assemble(samples[0][0], samples[0][1], ref_seqs, ref_lens,
                         tables, cfg, initial_panel=initial_panel,
                         col_maps=col_maps)]
    from rambl_tpu_torch.pipeline import assemble as device_asm

    if len(samples) > 1:
        return device_asm.assemble_cohort(samples, ref_seqs, ref_lens, tables,
                                          cfg, mesh=mesh, col_maps=col_maps,
                                          device=args.device)
    # per-round checkpoints: a crash/kill anywhere leaves the last round
    # boundary resumable (--resume-from); the final save below overwrites
    return [device_asm.assemble(samples[0][0], samples[0][1], ref_seqs,
                                ref_lens, tables, cfg,
                                initial_panel=initial_panel, mesh=mesh,
                                checkpoint_path=args.checkpoint,
                                col_maps=col_maps, device=args.device)]


def cmd_assemble(args) -> int:
    from rambl_tpu_torch.io.loader import load_fastq_codes, native_available
    from rambl_tpu_torch.utils.checkpoint import (
        config_fingerprint,
        load_checkpoint,
        save_checkpoint,
    )
    from rambl_tpu_torch.utils.metrics import MetricsLogger

    cfg = PRESETS[args.preset] if args.preset else PipelineConfig()
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())

    refs = read_fasta(args.reference)  # names needed for taxonomy mapping
    ref_names = [n for n, _ in refs]
    ref_seqs, ref_lens = encode_batch([s for _, s in refs], cfg.ref_len_max)
    samples = [load_fastq_codes(p, cfg.read_len_max) for p in args.reads]
    tables = _load_taxonomy(args.taxonomy, ref_names)

    col_maps = None
    if args.msa:
        # the database's own pre-aligned (PyNAST) columns replace pairwise-NW
        # anchor maps for every round against the original references
        from rambl_tpu_torch.index.greengenes import (
            col_maps_from_msa,
            load_gg_msa,
        )

        msa_cols = load_gg_msa(args.msa, ref_names, cfg.ref_len_max)
        col_maps = col_maps_from_msa(msa_cols, ref_lens, tables.ref_taxon)

    metrics = MetricsLogger(args.metrics)
    metrics.log("load", refs=len(refs), samples=len(samples),
                reads=sum(int(r.shape[0]) for r, _ in samples),
                native_loader=native_available(),
                preset=args.preset or "default")

    initial_panel = None
    if args.resume_from:
        header, initial_panel = load_checkpoint(args.resume_from)
        if header["fingerprint"] != config_fingerprint(cfg):
            print("warning: checkpoint config fingerprint differs from the "
                  "active config; resuming anyway", file=sys.stderr)
        metrics.log("resume", round=header["round"], genes=len(initial_panel))

    mesh = None
    if args.mesh:
        import hashlib

        from rambl_tpu_torch.parallel.mesh import (
            assert_hosts_agree,
            init_distributed,
            sync_host_config,
        )

        init_distributed()
        mesh = _mesh_of(args)
        # process 0's config wins everywhere, and every process must hold
        # the same reference DB (the seed index is derived from it)
        cfg = sync_host_config(cfg)
        assert_hosts_agree("reference FASTA", hashlib.sha256(
            ref_seqs.tobytes() + ref_lens.tobytes()).digest())
        metrics.log("mesh", devices=mesh.size)

    if len(samples) > 1 and (args.resume_from or args.checkpoint):
        # the cohort paths (oracle and device) run the multi-sample loop with
        # cross-sample phasing and do not thread initial_panel/checkpoint
        # through; silently ignoring --resume-from would break the bitwise
        # resume contract, so refuse loudly
        print("error: --checkpoint/--resume-from are not supported with "
              "multi-sample (cohort) input; run per-sample or drop the flag",
              file=sys.stderr)
        return 2
    run = (samples, ref_seqs, ref_lens, tables, cfg, col_maps, initial_panel,
           mesh)
    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=acts) as prof:
            results = _run(args, *run)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        results = _run(args, *run)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    for si, result in enumerate(results):
        for s in result.round_stats:
            metrics.log("round", sample=si, **s)
        genes = result.genes
        full = result.full_length(cfg)
        metrics.log("done", sample=si, genes=len(genes),
                    full_length=len(full), rounds=result.n_rounds,
                    converged=result.converged)
        out = args.out if len(results) == 1 else (
            args.out + f".sample{si}.fasta")
        write_fasta(out, gene_records(genes))
        if args.checkpoint:
            ck = args.checkpoint if len(results) == 1 else (
                args.checkpoint + f".sample{si}")
            # checkpoint the PRE-polish loop panel: resume continues the loop,
            # and the loop must never see polished genes (bitwise continuation)
            save_checkpoint(ck, cfg, result.panel, result.n_rounds,
                            result.round_stats)
        print(f"sample {si}: {len(genes)} genes ({len(full)} full-length) -> {out}")
    metrics.close()
    return 0


def cmd_bench(args) -> int:
    from rambl_tpu_torch import bench

    bench.main([] if args.device is None else ["--device", args.device])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rambl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="generate a mock community")
    s.add_argument("--out", required=True)
    s.add_argument("--species", type=int, default=20)
    s.add_argument("--strains", type=int, default=5)
    s.add_argument("--reads", type=int, default=10_000,
                   help="reads (per sample in cohort mode)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--samples", type=int, default=1,
                   help=">1 = cohort: per-sample abundances + FASTQs")
    s.add_argument("--db-refs", choices=("all", "anchors"), default="all",
                   help="'anchors' writes only each species' first strain to "
                        "refs.fasta (real-DB shape: sample strains co-bin to "
                        "their species OTU); full truth -> strains.fasta")
    s.set_defaults(fn=cmd_simulate)

    a = sub.add_parser("assemble", help="assemble full-length 16S genes")
    a.add_argument("--reads", required=True, nargs="+",
                   help="FASTQ[.gz]; several = cohort with shared index")
    a.add_argument("--reference", required=True, help="reference FASTA[.gz]")
    a.add_argument("--taxonomy", help="taxonomy TSV (name<TAB>lineage;...); "
                   "Greengenes empty ranks (g__; s__) truncate the lineage")
    a.add_argument("--msa", help="pre-aligned reference FASTA[.gz] (PyNAST/"
                   "Greengenes): its columns replace pairwise-NW anchor maps")
    a.add_argument("--out", required=True, help="output FASTA")
    a.add_argument("--preset", choices=sorted(PRESETS))
    a.add_argument("--config", help="PipelineConfig JSON file")
    a.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; 'cpu' "
                        "runs the plain PyTorch path)")
    a.add_argument("--oracle", action="store_true",
                   help="run the NumPy oracle instead of the device path")
    a.add_argument("--metrics", help="JSONL metrics output path")
    a.add_argument("--checkpoint", help="write per-round and final panel "
                   "checkpoints here (+ the round-0 evidence at PATH.aux)")
    a.add_argument("--resume-from", help="panel checkpoint to resume from: "
                   "skips discovery, continues assembly rounds on its panel")
    a.add_argument("--profile", help="write a torch.profiler trace "
                   "(trace.json) of the assembly to this dir")
    a.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run data-parallel on the first N cards (-1: all; "
                   "with --device cpu, N CPU ranks)")
    a.set_defaults(fn=cmd_assemble)

    b = sub.add_parser("bench", help="run rambl_tpu_torch.bench")
    b.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, UserError) as e:
        # bad input paths / malformed inputs / config-guard violations are
        # user errors, not crashes: clean message, nonzero exit; any OTHER
        # exception propagates with its traceback. Set RAMBL_DEBUG=1 to get
        # the full traceback here too.
        if os.environ.get("RAMBL_DEBUG"):
            raise
        if isinstance(e, FileNotFoundError):
            # open() raises with (errno, strerror) + filename; the native
            # loader raises with the path as the sole arg
            what = e.filename if e.filename else (
                e.args[0] if len(e.args) == 1 else str(e))
            print(f"rambl_tpu_torch: file not found: {what}", file=sys.stderr)
        else:
            print(f"rambl_tpu_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
