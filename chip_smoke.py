#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU: the read
stream, the K1 bench path (bench, S1 variant sweep, S2 prep ablation), the
data-parallel read stream with a ring-sharded index on a mesh of four
virtual ranks of the card (K4, the ring rotation), round 0 of the assembly,
the whole assembly (reads -> final genes: refinement rounds, polish,
checkpoint and resume, cohort phasing, the command line), on one card and
on a mesh, the scale ladder's runners (configs 2-5) at cut depth, and the
entry hooks and the card tools (`graft_entry`, `check_ring_dma`,
`profile_cluster`, `bench_align_scale`).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one progress line; any failure raises, so the exit
code is non-zero and no result line is printed:

1. device: a CUDA card must be visible (no CPU fallback);
2. build: nvcc compiles `rambl_tpu_torch/csrc/*.cu` for sm_90a;
3. kernels: K1 (score) and the fused K2 + K3 (direction codes and
   traceback in one launch) against their plain PyTorch twins on the card,
   bit for bit, at the align step's shapes, and 256 pairs each against the
   NumPy oracle; K1 also at ragged batch sizes (1 pair, odd counts, not a
   multiple of a block's pairs, none) and on adversarial pairs, against the
   twin, its 16-bit plain version and the oracle; K2 + K3 (score, end cell,
   ref_col and its optional direction bytes) also at 8 and 128 rows, at 200
   rows (8 rows a lane) and at ragged batch sizes;
4. slice: `stream_align` over BASELINE config 2 (the "small" preset: 20
   species x 5 strains, 1,000,000 reads of 100 bp, batch 8192, sw_rows 104),
   with random data from a seed, every tensor on cuda:0;
5. checks: every kernel launched in that run, K2 + K3 once per batch with
   gapped reads; the first 512 reads equal the
   NumPy oracle aligner; the first batch rerun on CPU tensors (the twins)
   equals the card's; the pileup accumulators count what was retained;
6. timings: stream wall time and reads/s, one batch's time, the device's
   busy share and time by kernel (torch.profiler), and each kernel's time
   beside its twin's at the path's shapes (K2 + K3, at a batch's gapped
   count and at 4,224 pairs, by CUDA events around a CUDA graph of its
   launches, and by its device time in torch.profiler); the host syncs a
   stream batch (`stream_syncs`: set_sync_debug_mode("warn"));
7. bench kernels: every S1 variant (instances of the strip kernel) at
   131,072 x 128 x 161 and S2 at 65,536 x 128 x 160 against their plain
   PyTorch versions on the card, bit for bit (S2's raw key included, also
   on codes outside 0..126), and 256 pairs each against the NumPy oracle;
   each variant's resident blocks per SM; S2's byte and 32-bit compare
   paths timed at full size;
8. bench path: `rambl_tpu_torch.bench`, `scripts.bench_sw_variants` and
   `scripts.ablate_prep` once each at their documented sizes, the launch
   counts set to 0 before each and read after it; each kernel of the path
   must have launched; S1's best variant beside prod-K1 and S2 beside full
   K1 on the same shapes;
9. ring kernel: K4 (`dma` and `dma_barrier`) against the plain rotation
   (`ppermute`) bit for bit at 2 and 4 virtual ranks on an odd word count,
   on tuples of 1 to 4 arrays with odd counts and views that are not
   16-byte aligned (one launch a rank), and 64 consecutive rotations on
   persistent buffers, each rank's shard checked against np.roll of the
   host copy after every rotation;
10. mesh stream: `stream_align(mesh=...)` over BASELINE config 4 (the
   "cohort" preset with ring_impl="dma": batch 16,384, ring-sharded index,
   sw_rows 104) on 4 virtual ranks of cuda:0, 1,000,000 reads against the
   full-Greengenes-scale panel of config 3 (100,000 refs, seed 13, leaf per
   ref, 500 present); K4 (one launch a rank a rotation: batches x 8 x 4)
   and K1 and K2 + K3 must launch (K2 + K3 once a rank a batch with gapped
   reads); every output equals the
   single-device stream bit for bit and the first 512 reads the NumPy
   oracle; then 4 batches of config 2 through the same mesh with
   shard_positions, against the single-device dense pileup;
11. mesh timings: stream wall and reads/s, one batch in CUDA events, the
   device's busy share and host-to-device copies (torch.profiler, the
   shards and ref tables uploaded before it), and K4 per rotation at the path's
   shard sizes (first held bit for bit against the plain rotation on them)
   beside the plain rotation and the bare `copy_` calls. On
   one card the four ranks share its memory, so K4 copies within HBM: its
   times are not NVLink times;
12. round: `assemble_round` (round 0: stream, slot selection, DP-means
   clustering, consensus, genes) on cuda:0. (a) The dataset of
   tests/test_assembly_parity.py, dense and with pileup_slot_nodes=1: the
   genes equal the port's NumPy oracle field for field. (b) Config 2 at full
   width: K1 and K2 + K3 must launch (counts set to 0 just before the round,
   read just after); wall time, the round's stage spans
   (RAMBL_STAGE_TIMING=1) and gene count; the same round with
   pileup_slot_nodes=1 gives the same genes; the cluster stage (`assemble.cluster_stage`) on phase 4's stream
   outputs, profiled (device busy share, five longest device operations)
   and its host syncs counted, equals its rerun on CPU tensors for at least
   16 leaves bit for bit (spawn and light leaves where present; the light
   path also on 4 leaves directly);
13. assembly: `assemble` (round 0, the refinement rounds, polish) on
   cuda:0; its NumPy-oracle references run in worker processes started
   after phase 2, on half the host's cores. (a) The dataset of
   tests/test_assembly_parity.py, dense and with pileup_slot_nodes=1:
   n_rounds, converged, the pre-polish panel, polish's `changed` and the
   genes equal the port's oracle `oracle.pipeline.assemble`. (b) Config 2
   at full width (max_assembly_iters 5, polish on): rounds, genes,
   full-length genes, wall and genes/hour; per round its stage spans,
   the col maps' build, K1 and K2 + K3 launches (> 0 in every
   round, 0 in polish), peak device memory and what is allocated at its
   start (which must not climb). (c) The same run killed after round 1
   (a wrapped `assemble_round` raises) resumes from its checkpoint and
   `.aux` sidecar to (b)'s genes bit for bit; a sidecar under another
   config raises. (d) scripts/quality_bench.py's four scenarios: recovered
   references (27 of 27 in all), each scenario's genes equal to the
   oracle's. (e) A 2-sample cohort through `assemble_cohort` equals the
   oracle's `assemble_cohort`; `python -m rambl_tpu_torch.cli simulate`
   then `assemble` in a subprocess writes the FASTA the in-process genes
   give;
14. mesh assembly: the same entry points with `mesh=` on 4 virtual ranks
   of cuda:0 (`data_mesh(devices=[dev] * 4)`: the stream, the slot pileup
   and the leaf-sharded cluster step on the ranks), each held to phase
   13's one-card result. (a) The parity dataset, dense and slot, also
   equal to the oracle; a run killed after round 1 on the mesh resumes on
   one card to the same genes, and the reverse. (b) Config 2 at full width
   on the first 250,000 of its 1 M reads (cut; max_assembly_iters 5,
   polish on) with a replicated index, with
   shard_index and ring_impl="dma" (the cohort preset's mode), and with
   shard_positions added (the deep preset's mode, its rotation K4 too):
   rounds, their stats (timings aside), panel and genes equal one card's
   run of the same reads; K1,
   K2 + K3 and, in the ring modes, K4 launch in every round, none in
   polish; wall, genes/hour, each round's stages, launches and
   peak memory; the cluster stage on round 0's mesh stream, alone, with
   its member gathers timed apart, and on one card, outputs equal. (c) 13 (e)'s cohort, its shared index sharded once.
   (d) `make_align_pileup_step` on config 2's first four batches equals the
   one-card batch and its pileup; K4 timed on config 2's index shards. (e) `cli assemble --mesh 1` in a
   subprocess writes 13 (e)'s FASTA. The ranks share one card's SMs and
   memory: these are not multi-card times;
15. the scale ladder: the runners `rambl_tpu_torch.scripts.run_config2` ..
   `run_config5` on cuda:0 through their `run` functions (stage timing on;
   every runner's own lines go to standard error), each cut printed. (a)
   Config 2 at full size (phase 4's dataset: 1 M reads, max_genes 256, 4
   iterations). (b) Config 3 at 1,000,000 of its 10 M
   reads (phase 10's dataset and index; max_genes 2048): slot mode engages
   and round 0 clusters more than one block of 512 leaves; K1 and K2 + K3
   launch in every round and not in polish; what is allocated at each
   panel round's start does not climb; round 0's cluster stage equals its
   rerun on CPU tensors for 16 of its leaves (spawn and light ones, and
   the leaves with the most members, at max_bin_reads); recovery, genes,
   stages and peak memory are printed, with no bar at this depth; the run
   writes its panel dump (phase 17). (c)
   Config 5 at 250,000 of its 20 M reads (its chunked generator on phase
   10's panel): phase A (discovery + checkpoint in a temporary directory),
   then phase B from disk with the `.aux` sidecar, equal to an
   uninterrupted run of the same config (rounds, stats but timings, panel,
   genes); phase B's polish launches no K1. (d) Config 4 at full size (8
   species x 5 strains, 5 samples of 5,120 reads): with phasing 36/40
   recovered, without 22/40 (SCALE_r5.json's counts);
16. the entry hooks and the card tools, on cuda:0. (a)
   `rambl_tpu_torch.graft_entry.entry()`'s align step on the card equals
   its rerun on CPU tensors and, for the first 64 reads, the NumPy oracle;
   K1 must launch; `dryrun_multichip(4)` on 4 virtual ranks (both index
   modes of the align + pileup step and of the whole assembly agree) under
   the default ring_impl and with ring_impl="dma", where K4 must launch.
   (b) `scripts.check_ring_dma.run(n)` at n = 1, 2 and 4: every impl
   bitwise np.roll (virtual ranks: cross-card ordering is not certified).
   (c) `scripts.profile_cluster.run` at config 3's block (10 M reads, 512
   leaves x 4,096 members, 187,667 nodes, ref_len 2,048), in a process of
   its own: each piece's time, device busy share, longest device
   operations and host syncs.
   (d) `scripts.bench_align_scale.run` on phase 10's dataset and index
   (handed to a process of its own as a plain-array cache) at batch
   16,384: FULL, A, B and C in ms a batch, and D (the stream loop into 10
   M retention rows, 16 batches; the median of 3 loops and their spread)
   in ms a batch with the device's idle share;
17. the diagnostics, on what phase 15 built. (a) `scripts.run_config3`'s
   panel dump of 15 (b)'s run (written there, after its wall), read back
   with its slot counts memory-mapped: its genes equal the run's, and
   `scripts.diagnose_config3.run` classes every miss. (b) 15 (d)'s cohort
   with phasing: `scripts.cache_config4_state` takes `leaf_counts_dict`
   of every leaf on cuda:0, writes the state and reads it back equal;
   `scripts.census_config4.run`, `scripts.diagnose_impure.run` and
   `scripts.demonstrate_c4_ambiguity.run` on it: no residual wrong base
   is fixable, and there are C4_RESIDUAL of them.

The second-to-last lines are the kernel table as JSON (time, launches on the
main path (for K1 and K2 + K3 the whole assembly of phase 13 (b)), error
against the plain version, and the bound: the larger of the
bytes over 3.35 TB/s and the integer operations over 132 SMs x 64 INT32
lanes x the card's max SM clock) and the card's name and power limit from
nvidia-smi; the last line is the result as JSON.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from rambl_tpu_torch.device import card_line, require_cuda
from rambl_tpu_torch.scripts import quality_bench
from rambl_tpu_torch.utils.timing import (
    busy_ms_of,
    device_ops,
    sync_lines,
    syncs_of,
)

N_READS = 1_000_000
SEED = 7
#: the panel of BASELINE config 3 (scripts/build_scale_caches.py): 100,000
#: refs, 153.6 M index entries in 2^27 buckets
COHORT_REFS = 100_000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64
# Integer operations per DP cell of K1's function (K1, S1, S2). On this card
# one packed 16-bit (DPX) instruction serves two cells: the shipped inner
# loop (csrc/sw.cu::score_cell) spends 9 on two cells (E, the match mask,
# the substitution, the diagonal, F, H, H - open, and two for the column
# key) plus 6 every four rows on the byte-equality masks: 10.5 / 2. Each is
# rated at INT32_LANES_PER_SM results a clock, the rate of 32-bit integer
# add, compare, min and max at compute capability 9.0 in the throughput
# table of NVIDIA's CUDA C++ programming documentation (section "Arithmetic
# Instructions"); the table gives the DPX forms no rate of their own, so
# they are taken at that of the min/max they extend.
# In scalar 32-bit arithmetic it was 12 (E, F, diagonal and H take 3 each:
# the Pallas cost estimate's count).
# K2 + K3's sweep runs the same recurrence (its values fit 16 bits too, as
# the kernel's packed (H, F) shuffle shows), so K1's 5.25 is its floor, plus
# the direction code: five comparisons a cell (the H choice's three, E-open,
# F-open) at two cells an instruction, 2.5, and 1.5 to fold their results
# into the cell's 4 bits: 9.25 a cell. Earlier it was rated at 18 (12 plus ~6
# for the code). Its walk spends ~10 a step.
OPS_PER_CELL, OPS_PER_CELL_32 = 5.25, 12
OPS_PER_CELL_DIRS, OPS_PER_CELL_DIRS_32 = 9.25, 18
OPS_PER_TRACE_STEP = 10


def say(*parts):
    print(*parts, flush=True)


def template_args(mangled: str) -> list:
    """The template arguments of a mangled `I...E` list: integers, and the
    names of the policy structs of the kernels' namespace (`NS_<len><name>`),
    e.g. ['4', '1', '2', 'S2Load', 'RawKeyOut']."""
    args, k = [], 1
    while k < len(mangled) and mangled[k] != "E":
        m = re.match(r"L[ib](\d+)E", mangled[k:])
        if m:
            args.append(m.group(1))
            k += m.end()
            continue
        m = re.match(r"NS_(\d+)", mangled[k:])
        if not m:
            break
        k += m.end()
        args.append(mangled[k:k + int(m.group(1))])
        k += int(m.group(1)) + 1
    return args


def ptxas_report(lines):
    """(kernel, registers, spills) per kernel of a `-Xptxas -v` log, the
    kernel named with its template arguments."""
    name = spill = None
    for ln in lines:
        m = re.search(r"Compiling entry function '\S*?\d+"
                      r"((?:sw|ring)_[a-z_]+_kernel)(\S*)'", ln)
        if m:
            rest = m.group(2)
            args = ",".join(template_args(rest) if rest[:1] == "I" else [])
            name, spill = m.group(1) + (f"<{args}>" if args else ""), None
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            yield name, ln.split(":", 1)[-1].strip(), spill
            name = None


def int32_ops_per_s(dev) -> float:
    """Peak INT32 rate outside the tensor cores: SMs x 64 lanes x the max
    SM clock that nvidia-smi reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(mhz.strip().splitlines()[0]) * 1e6


def bound(ops: float, nbytes: float, peak_ops: float):
    """(least ms the card could take, what bounds it)."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def blocks_per_sm(variant, L: int, regs: int, props) -> int:
    """Resident blocks per SM of a strip-kernel variant: the fewest that its
    shared memory (plus the 1 KB the runtime reserves a block), its threads,
    its registers (from the ptxas log, allocated per warp in units of 256)
    and the 32 blocks an SM holds leave room for."""
    by_smem = props.shared_memory_per_multiprocessor // (
        variant.smem_bytes(L) + 1024)
    by_threads = props.max_threads_per_multi_processor // (32 * variant.warps)
    regs_per_warp = -(-regs * 32 // 256) * 256
    by_regs = props.regs_per_multiprocessor // (regs_per_warp * variant.warps)
    return min(by_smem, by_threads, by_regs, 32)


def max_abs_err(got, ref) -> int:
    """Largest |kernel - twin| over a set of integer outputs."""
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(r.shape)} {r.dtype}")
        if g.numel():
            err = max(err, int((g.long() - r.long()).abs().max()))
    return err


def stream_syncs(run_stream, n_batches: int):
    """(syncs a batch, {source line: syncs a batch}) of run_stream(), which
    streams n_batches batches through `assemble._align_bin_batch`, as
    torch.cuda.set_sync_debug_mode("warn") reports them. The window opens
    as the second batch's step starts and closes as the last one's starts:
    n_batches - 2 whole turns of the stream's loop, none of its set-up or
    its end."""
    import warnings

    from rambl_tpu_torch.pipeline import assemble

    real, seen = assemble._align_bin_batch, [0]

    def windowed(*args, **kwargs):
        seen[0] += 1
        if seen[0] == 2:
            torch.cuda.set_sync_debug_mode("warn")
        elif seen[0] == n_batches:
            torch.cuda.set_sync_debug_mode("default")
        return real(*args, **kwargs)

    torch.cuda.synchronize()
    assemble._align_bin_batch = windowed
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_stream()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        assemble._align_bin_batch = real
    if seen[0] != n_batches:
        raise AssertionError(f"{seen[0]} batches streamed, not {n_batches}")
    at = sync_lines(caught)
    turns = n_batches - 2
    return (sum(at.values()) / turns,
            {k: v / turns for k, v in at.items()})


def gene_fields(genes) -> list:
    """Each gene as (sequence bytes, n_reads, leaf, cluster, taxon, offset)."""
    return [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon, g.offset)
            for g in genes]


def phase_round(dev, ds, index, tables, col_maps, cfg, stream_out, card):
    """Phase 12: round 0 of the assembly (`pipeline.assemble.assemble_round`)
    on the card. (a) the dataset of tests/test_assembly_parity.py, dense and
    in forced slot mode, against the port's NumPy oracle; (b) config 2 at
    full width: the round's launches, wall time and stages, forced slot mode
    against dense, and the cluster stage on the stream outputs of phase 4
    (profiled, its host syncs counted) against its rerun on CPU tensors for
    at least 16 leaves. Returns the round's kernel launches."""
    import dataclasses
    import os

    from torch.profiler import ProfilerActivity, profile

    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.oracle.pipeline import assemble_round as oracle_round
    from rambl_tpu_torch.pipeline import assemble as tassemble

    # (a) the small dataset against the oracle, dense and forced slot
    sm = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    sm_tax = build_taxonomy_tables(sm.tax_parent, sm.tax_depth, sm.ref_taxon)
    sm_cfg = PipelineConfig(max_assembly_iters=2, batch_size=128)
    sm_args = (sm.reads, sm.read_lens, sm.ref_seqs, sm.ref_lens, sm_tax)
    want = gene_fields(oracle_round(*sm_args, sm_cfg, 0)[0])
    for mode, c in (("dense", sm_cfg),
                    ("slot", dataclasses.replace(sm_cfg,
                                                 pileup_slot_nodes=1))):
        got = gene_fields(tassemble.assemble_round(*sm_args, c, 0,
                                                   device=dev)[0])
        if got != want or not got:
            raise AssertionError(f"round 0 ({mode}) differs from the NumPy "
                                 f"oracle: {len(got)} vs {len(want)} genes")
    say(f"[12 round] (a) {sm.reads.shape[0]} reads, {sm.ref_seqs.shape[0]} "
        f"refs: the round's {len(want)} genes on the card, dense and with "
        "pileup_slot_nodes=1, equal the NumPy oracle's (sequence, n_reads, "
        "leaf, cluster, taxon, offset)")

    # (b) config 2 at full width
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tables)
    os.environ["RAMBL_STAGE_TIMING"] = "1"
    try:
        sw_cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        genes, stats = tassemble.assemble_round(
            *args, cfg, 0, index=index, col_maps=col_maps, device=dev)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        launches = dict(sw_cuda.LAUNCHES)
    finally:
        del os.environ["RAMBL_STAGE_TIMING"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches["score"] <= 0 or launches["align"] <= 0:
        raise AssertionError(f"the round launched {launches}: K1 and K2+K3 "
                             "must launch")
    merged, counts, span_diff, read_count = stream_out
    if (not genes or stats["genes"] != len(genes)
            or stats["aligned"] != int((merged["bins"] >= 0).sum())):
        raise AssertionError(f"round stats {stats} for {len(genes)} genes")
    t0 = time.perf_counter()
    genes_s, stats_s = tassemble.assemble_round(
        *args, dataclasses.replace(cfg, pileup_slot_nodes=1), 0, index=index,
        col_maps=col_maps, device=dev)
    slot_s = time.perf_counter() - t0
    if gene_fields(genes_s) != gene_fields(genes):
        raise AssertionError("config 2: forced slot mode's genes differ from "
                             "the dense round's")

    # the cluster stage alone, on phase 4's stream outputs
    leaves = np.unique(tables.ref_taxon)

    def stage():
        return tassemble.cluster_stage(merged, counts, span_diff, read_count,
                                       leaves, tables, cfg)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card_out = stage()
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
    busy_ms = busy_ms_of(prof)
    top = device_ops(prof)[:5]
    _, stage_syncs = syncs_of(stage)

    # the stage rerun on CPU tensors for >= 16 leaves, spawn and light
    rc_leaf = read_count.cpu().numpy()[leaves]
    spawn_l, light_l = leaves[rc_leaf > 0], leaves[rc_leaf == 0]
    n_light = min(8, light_l.size)
    pick = np.sort(np.concatenate([
        spawn_l[np.linspace(0, spawn_l.size - 1, 16 - n_light).astype(int)],
        light_l[:n_light]]))
    pick = np.unique(pick)
    if pick.size < 16:
        raise AssertionError(f"only {pick.size} leaves to rerun on CPU")
    cpu = {k: merged[k].cpu() for k in ("query", "ref_col", "bins")}
    t0 = time.perf_counter()
    cpu_out = tassemble.cluster_stage(cpu, counts.cpu(), span_diff.cpu(),
                                      read_count.cpu(), pick, tables, cfg)
    cpu_s = time.perf_counter() - t0
    at = np.searchsorted(leaves, pick)
    names = ("called", "emit", "n_reads", "kact", "n_mem", "mh.called",
             "mh.emit", "mh.n_reads", "mh.n_cols")

    def arrays(out):
        cons, kact, n_mem, mh = out
        return [*cons, kact, n_mem, *mh]

    for name, g, c in zip(names, arrays(card_out), arrays(cpu_out)):
        if g.dtype != c.dtype or not np.array_equal(g[at], c):
            raise AssertionError(f"cluster stage {name}: the card differs "
                                 f"from the CPU rerun on leaves {pick}")
    # the light path on the card and on CPU, whether or not config 2 has
    # leaves without exclusive reads
    lt = torch.from_numpy(pick[:4].astype(np.int32))
    anc = torch.from_numpy(tables.anc_path)
    dep = torch.from_numpy(tables.depth)
    light_card = tassemble.cluster_round0_core(
        merged["query"], merged["ref_col"], merged["bins"], counts, span_diff,
        read_count, lt.to(dev), anc.to(dev), dep.to(dev), cfg, spawn=False)
    light_cpu = tassemble.cluster_round0_core(
        cpu["query"], cpu["ref_col"], cpu["bins"], counts.cpu(),
        span_diff.cpu(), read_count.cpu(), lt, anc, dep, cfg, spawn=False)
    for g, c in zip(arrays(light_card), arrays(light_cpu)):
        if not torch.equal(g.cpu(), c):
            raise AssertionError("light cluster path: the card differs from "
                                 "CPU")
    kact = card_out[1]
    say(f"[12 round] (b) config 2 round 0 ({ds.reads.shape[0]} reads, "
        f"{leaves.size} leaves, {int((rc_leaf > 0).sum())} with exclusive "
        f"reads): {len(genes)} genes; {round_s:.3f} s wall; stages "
        + ", ".join(f"{k[2:]} {v:.2f} s" for k, v in stats.items()
                    if k.startswith("t_"))
        + f"; launches {launches}; peak device memory {peak_gb:.2f} GB; "
        f"clusters a leaf {int(kact.min())}..{int(kact.max())} (sum "
        f"{int(kact.sum())}) [{card}]")
    say(f"    forced slot mode (pileup_slot_nodes=1): {stats_s['n_leaves']} "
        f"leaves, the same {len(genes_s)} genes, {slot_s:.3f} s wall [{card}]")
    say(f"    cluster stage on the card ({leaves.size} leaves, "
        f"max_bin_reads {cfg.max_bin_reads}, max_poly_cols "
        f"{cfg.max_poly_cols}, max_clusters_per_bin "
        f"{cfg.max_clusters_per_bin}, profiled): {stage_s * 1e3:.1f} ms wall, "
        f"device busy {busy_ms:.1f} ms = {100 * busy_ms / (stage_s * 1e3):.1f}"
        f"% [{card}]; host syncs {sum(stage_syncs.values())} ("
        + ", ".join(f"{k} x{v}" for k, v in sorted(stage_syncs.items()))
        + "); five longest device operations:")
    for e in top:
        say(f"      {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")
    say(f"    cluster stage rerun on CPU tensors for {pick.size} leaves "
        f"({int((rc_leaf[at] > 0).sum())} spawn, {int((rc_leaf[at] == 0).sum())}"
        f" light) in {cpu_s:.1f} s: ConsensusOut, kact, n_mem and MinorHap "
        f"equal the card's bit for bit; the light path (spawn=False) on "
        f"{lt.numel()} leaves too")
    return launches


#: the small dataset of tests/test_assembly_parity.py and its config
PARITY_DS = dict(n_species=3, refs_per_species=2, n_reads=400, seed=2,
                 skewed_abundance=False)
PARITY_CFG = dict(max_assembly_iters=2, batch_size=128)
PARITY_MODES = {"dense": {}, "slot": dict(pileup_slot_nodes=1)}
#: quality_bench's scenarios and config
QUALITY, QUALITY_CFG = quality_bench.SCENARIOS, quality_bench.CONFIG
QUALITY_BAR = 27           # the reference's record, SURVEY.md:523
#: phase 13's cohort: 3 species x 2 strains, 2 samples of 2,000 reads
COHORT_DS = dict(n_species=3, refs_per_species=2, n_samples=2,
                 reads_per_sample=2000, seed=5)
COHORT_CFG = dict(max_assembly_iters=2, batch_size=512, max_genes=32)
#: phase 13's command-line run: `simulate` with these flags, then
#: `assemble` with the default config
CLI_SIM = ["--species", "3", "--strains", "2", "--reads", "2000",
           "--seed", "11"]
_POOL = None


def oracle_job(job):
    """One NumPy-oracle reference of phase 13 (a worker process's task):
    (name, kind, dataset kwargs, config fields) -> (name, results, s)."""
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_cohort, simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.oracle.cohort import assemble_cohort
    from rambl_tpu_torch.oracle.pipeline import assemble

    name, kind, kw, fields = job
    t0 = time.perf_counter()
    cfg = PipelineConfig(**fields)
    if kind == "cohort":
        co = simulate_cohort(**kw)
        ds = co.ds
        tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
        out = assemble_cohort(co.samples, ds.ref_seqs, ds.ref_lens, tax, cfg)
    else:
        ds = simulate_dataset(**kw)
        tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
        out = [assemble(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
                        cfg)]
    return name, out, time.perf_counter() - t0


def start_oracles():
    """Start phase 13's NumPy-oracle references in worker processes now, so
    that they run on half the host's cores while phases 3-12 use the card.
    Returns ({name: AsyncResult}, the number of workers)."""
    import multiprocessing
    import os

    global _POOL
    jobs = [("parity", "assemble", PARITY_DS, PARITY_CFG),
            ("cohort", "cohort", COHORT_DS, COHORT_CFG)]
    jobs += [(name, "assemble", kw, QUALITY_CFG) for name, kw in QUALITY]
    # half the host's cores: the phases before 13 keep the other half
    n = max(1, min(len(jobs), (os.cpu_count() or 2) // 2))
    # spawn, not fork: this process holds a CUDA context
    _POOL = multiprocessing.get_context("spawn").Pool(n)
    # longest first
    order = sorted(jobs, key=lambda j: -j[2].get(
        "n_reads", j[2].get("reads_per_sample", 0) * 2))
    return {j[0]: _POOL.apply_async(oracle_job, (j,)) for j in order}, n


def stop_oracles():
    if _POOL is not None:
        _POOL.terminate()
        _POOL.join()


def same_result(what, got, want, genes=True):
    """The card's AssemblyResult equals the oracle's: n_rounds, converged,
    the pre-polish panel, polish's `changed` and (genes) every final
    gene's fields."""
    if (got.n_rounds, got.converged) != (want.n_rounds, want.converged):
        raise AssertionError(f"{what}: rounds {got.n_rounds} converged "
                             f"{got.converged}, the oracle's "
                             f"{want.n_rounds} {want.converged}")
    if gene_fields(got.panel) != gene_fields(want.panel):
        raise AssertionError(f"{what}: the pre-polish panel differs from "
                             "the oracle's")
    pol = [(s["round"], s.get("changed")) for s in got.round_stats[-1:]]
    if pol != [(s["round"], s.get("changed"))
               for s in want.round_stats[-1:]]:
        raise AssertionError(f"{what}: polish {pol} differs from the "
                             f"oracle's {want.round_stats[-1:]}")
    if genes and gene_fields(got.genes) != gene_fields(want.genes):
        raise AssertionError(f"{what}: final genes differ from the oracle's")


def phase_assembly(dev, ds, tables, cfg, card, oracles):
    """Phase 13: the whole assembly (`pipeline.assemble.assemble`) on the
    card. (a) the parity dataset against the port's NumPy oracle, dense and
    slot; (b) config 2 at full width, round by round; (c) a crash after
    round 1 and its resume; (d) quality_bench's scenarios; (e) a cohort
    and the command line. Returns what phase 14 holds the mesh to: the K1
    and K2 + K3 launches of (b) ("launches"), the results of (a) and the
    oracle's, (b)'s result and rounds, (e)'s cohort and its inputs, and
    (e)'s command line with the FASTA it wrote."""
    import dataclasses
    import os
    import tempfile

    from rambl_tpu_torch import cli
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_cohort, simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.io.fasta import read_fasta, write_fasta
    from rambl_tpu_torch.io.loader import load_fastq_codes
    from rambl_tpu_torch.io.pack import encode_batch
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.pipeline import assemble as tassemble
    from rambl_tpu_torch.scripts.ladder import RoundRecorder
    from rambl_tpu_torch.utils.checkpoint import (
        load_aux_evidence,
        load_checkpoint,
    )

    def oracle(name):
        t0 = time.perf_counter()
        _, out, s = oracles[name].get(timeout=900)
        return out, s, time.perf_counter() - t0

    # (a) the parity dataset, dense and slot, against the oracle
    sm = simulate_dataset(**PARITY_DS)
    sm_tax = build_taxonomy_tables(sm.tax_parent, sm.tax_depth, sm.ref_taxon)
    sm_args = (sm.reads, sm.read_lens, sm.ref_seqs, sm.ref_lens, sm_tax)
    (want,), want_s, waited = oracle("parity")
    parity = {}
    for mode, extra in PARITY_MODES.items():
        got = tassemble.assemble(*sm_args,
                                 PipelineConfig(**PARITY_CFG, **extra),
                                 device=dev)
        same_result(f"parity ({mode})", got, want)
        parity[mode] = got
    parity_oracle = want
    say(f"[13 assembly] (a) {sm.reads.shape[0]} reads: assemble on the card "
        f"(dense and pileup_slot_nodes=1) equals the NumPy oracle: "
        f"{want.n_rounds} rounds, converged {want.converged}, the "
        f"{len(want.panel)}-gene pre-polish panel, polish changed "
        f"{want.round_stats[-1]['changed']}, {len(want.genes)} genes "
        f"(sequence, n_reads, leaf, cluster, taxon, offset) (oracle "
        f"{want_s:.1f} s in a worker, waited {waited:.1f} s) [{card}]")

    # (b) config 2 at full width, round by round
    tmp = tempfile.mkdtemp(prefix="rambl_smoke_")
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tables)
    os.environ["RAMBL_STAGE_TIMING"] = "1"
    try:
        sw_cuda.reset_launches()
        with RoundRecorder(dev) as recorder:
            t0 = time.perf_counter()
            res = tassemble.assemble(
                *args, cfg, checkpoint_path=os.path.join(tmp, "b.ckpt"),
                device=dev)
            recorder.sync()
            e2e_s = time.perf_counter() - t0
    finally:
        del os.environ["RAMBL_STAGE_TIMING"]
    total = recorder.total
    if len(recorder.rounds) != res.n_rounds:
        raise AssertionError(f"{len(recorder.rounds)} rounds recorded, "
                             f"{res.n_rounds} reported")
    # K1 and K2+K3 in every round, none in polish (the retained counts
    # spare it the round-0 re-stream); nothing of a round stays allocated
    # into the next (round 0's retained counts aside)
    recorder.check("config 2")
    full = res.full_length(cfg)
    pol = res.round_stats[-1]
    genes_per_hour = len(full) / (e2e_s / 3600.0)
    say(f"[13 assembly] (b) config 2 ({ds.reads.shape[0]} reads, "
        f"max_assembly_iters {cfg.max_assembly_iters}, polish on): "
        f"{res.n_rounds} rounds, converged {res.converged}; {len(res.genes)} "
        f"genes, {len(full)} full-length (>= {cfg.full_len_min}); wall "
        f"{e2e_s:.3f} s (host clock, index and col maps built inside) = "
        f"{genes_per_hour:.0f} genes/hour [{card}]")
    recorder.report(card, say)
    say(f"    polish: changed {pol['changed']}, t_polish {pol['t_polish']:.2f}"
        f" s, nw_tier {pol['nw_tier']} [{card}]")

    # (c) killed after round 1, resumed from its checkpoint and sidecar
    real_round = tassemble.assemble_round
    ck = os.path.join(tmp, "c.ckpt")
    calls = {"n": 0}

    class Killed(RuntimeError):
        pass

    def dying_round(*a, **kw):
        out = real_round(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:          # round 0 + round 1 done -> crash
            raise Killed()
        return out

    tassemble.assemble_round = dying_round
    try:
        tassemble.assemble(*args, cfg, checkpoint_path=ck, device=dev)
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    finally:
        tassemble.assemble_round = real_round
    header, panel = load_checkpoint(ck)
    aux = load_aux_evidence(ck + ".aux", cfg)
    if header["round"] != 0 or not panel or list(aux) != ["node_counts"]:
        raise AssertionError(f"checkpoint after the kill: {header}")
    sw_cuda.reset_launches()
    t0 = time.perf_counter()
    resumed = tassemble.assemble(*args, cfg, initial_panel=panel,
                                 initial_aux=aux, device=dev)
    resume_s = time.perf_counter() - t0
    if (gene_fields(resumed.genes) != gene_fields(res.genes)
            or any(g.round_born != h.round_born
                   for g, h in zip(resumed.genes, res.genes))
            or (resumed.n_rounds, resumed.converged)
            != (res.n_rounds, res.converged)):
        raise AssertionError("the resumed run's genes differ from (b)'s")
    try:
        load_aux_evidence(ck + ".aux", dataclasses.replace(
            cfg, min_score=cfg.min_score + 1))
        raise AssertionError("a sidecar under another config was accepted")
    except ValueError as e:
        if "different config" not in str(e):
            raise
    say(f"[13 assembly] (c) killed after round 1 (checkpoint at round "
        f"{header['round']}, {len(panel)} genes, sidecar {aux['node_counts'].shape}"
        f"); resumed with the sidecar in {resume_s:.3f} s to (b)'s "
        f"{len(res.genes)} final genes bit for bit (launches "
        f"{dict(sw_cuda.LAUNCHES)}); a sidecar under another config raises "
        f"[{card}]")

    # (d) quality_bench's scenarios
    qcfg = PipelineConfig(**QUALITY_CFG)
    total_rec = total_det = 0
    for name, kw in QUALITY:
        q = simulate_dataset(**kw)
        qtax = build_taxonomy_tables(q.tax_parent, q.tax_depth, q.ref_taxon)
        t0 = time.perf_counter()
        got = tassemble.assemble(q.reads, q.read_lens, q.ref_seqs, q.ref_lens,
                                 qtax, qcfg, device=dev)
        q_s = time.perf_counter() - t0
        (want,), want_s, waited = oracle(name)
        same_result(f"quality {name}", got, want)
        rec, det, _ = quality_bench.recovered(q, got.genes)
        total_rec += rec
        total_det += det
        say(f"[13 assembly] (d) {name}: recovered {rec}/{det}, "
            f"{len(got.genes)} genes, {got.n_rounds} rounds, converged "
            f"{got.converged}; {q_s:.3f} s on the card; equal to the NumPy "
            f"oracle ({want_s:.1f} s in a worker, waited {waited:.1f} s) "
            f"[{card}]")
    if total_rec != QUALITY_BAR or total_det != QUALITY_BAR:
        raise AssertionError(f"quality bar: recovered {total_rec}/"
                             f"{total_det}, the bar is {QUALITY_BAR}/"
                             f"{QUALITY_BAR}")
    say(f"    TOTAL recovered {total_rec}/{total_det}")

    # (e) a 2-sample cohort against the oracle; the command line
    co = simulate_cohort(**COHORT_DS)
    co_tax = build_taxonomy_tables(co.ds.tax_parent, co.ds.tax_depth,
                                   co.ds.ref_taxon)
    t0 = time.perf_counter()
    got = tassemble.assemble_cohort(co.samples, co.ds.ref_seqs,
                                    co.ds.ref_lens, co_tax,
                                    PipelineConfig(**COHORT_CFG), device=dev)
    co_s = time.perf_counter() - t0
    want, want_s, waited = oracle("cohort")
    for j, (g, w) in enumerate(zip(got, want)):
        same_result(f"cohort sample {j}", g, w)
    phased = [sum(g.round_born == -1 for g in r.genes) for r in got]
    if len(got) != 2 or not all(phased):
        raise AssertionError(f"cohort: phased genes {phased}")
    say(f"[13 assembly] (e) cohort of {len(got)} samples x "
        f"{COHORT_DS['reads_per_sample']} reads: {[len(r.genes) for r in got]}"
        f" genes ({phased} phased) in {co_s:.3f} s on the card, equal to the "
        f"NumPy oracle's ({want_s:.1f} s in a worker, waited {waited:.1f} s) "
        f"[{card}]")
    d = os.path.join(tmp, "cli")
    gene_fa = os.path.join(d, "genes.fasta")
    files = [os.path.join(d, n) for n in ("reads.fastq", "refs.fasta",
                                          "taxonomy.tsv")]
    t0 = time.perf_counter()
    cli_argv = ["assemble", "--reads", files[0], "--reference", files[1],
                "--taxonomy", files[2], "--device", str(dev)]
    for argv in (["simulate", "--out", d, *CLI_SIM],
                 [*cli_argv, "--out", gene_fa, "--metrics",
                  os.path.join(d, "m.jsonl")]):
        run_cli(argv)
    cli_s = time.perf_counter() - t0
    ccfg = PipelineConfig()
    refs = read_fasta(files[1])
    r_seqs, r_lens = encode_batch([s for _, s in refs], ccfg.ref_len_max)
    reads, lens = load_fastq_codes(files[0], ccfg.read_len_max)
    ctax = cli._load_taxonomy(files[2], [n for n, _ in refs])
    mine = tassemble.assemble(reads, lens, r_seqs, r_lens, ctax, ccfg,
                              device=dev)
    write_fasta(gene_fa + ".in_process", cli.gene_records(mine.genes))
    with open(gene_fa) as a, open(gene_fa + ".in_process") as b:
        if a.read() != b.read() or not mine.genes:
            raise AssertionError("the CLI's FASTA differs from the "
                                 "in-process genes'")
    say(f"[13 assembly] (e) python -m rambl_tpu_torch.cli simulate && "
        f"assemble (default config, on the card, in a subprocess, "
        f"{cli_s:.1f} s together): its FASTA of {len(mine.genes)} genes "
        f"equals the one written from the in-process genes [{card}]")
    with open(gene_fa) as f:
        cli_fasta = f.read()
    return dict(launches={"score": total["score"], "align": total["align"]},
                parity=parity, parity_oracle=parity_oracle,
                rounds=recorder.rounds, cohort=got, cohort_in=(co, co_tax),
                cli_argv=cli_argv, cli_fasta=cli_fasta, tmp=tmp)


def run_cli(argv):
    """`python -m rambl_tpu_torch.cli *argv` in a subprocess from the
    repository root; raises when it exits with another code than 0."""
    import os

    r = subprocess.run(
        [sys.executable, "-m", "rambl_tpu_torch.cli", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise AssertionError(f"rambl_tpu_torch.cli {argv[0]} exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    return r


#: phase 14's mesh: virtual ranks of cuda:0, and config 2's three modes
MESH_RANKS = 4
#: phase 14 (b)'s reads of config 2 (cut from 1 M when phase 16 came: the
#: run must stay inside its time; phase 13 (b) runs all of them on one card)
MESH_C2_READS = 250_000
MESH_MODES = {
    "replicated": {},
    "ring dma": dict(shard_index=True, ring_impl="dma"),
    "ring dma, positions": dict(shard_index=True, ring_impl="dma",
                                shard_positions=True),
}


def stats_of(result):
    """An AssemblyResult's round stats without the stage timings."""
    return [{k: v for k, v in st.items() if not k.startswith("t_")}
            for st in result.round_stats]


def same_run(what, got, want, stats=True):
    """`got` equals `want` (two AssemblyResults of the port): n_rounds,
    converged, the round stats (timings aside), the pre-polish panel and
    every final gene's fields, round_born included."""
    if (got.n_rounds, got.converged) != (want.n_rounds, want.converged):
        raise AssertionError(f"{what}: rounds {got.n_rounds} converged "
                             f"{got.converged}, one card's {want.n_rounds} "
                             f"{want.converged}")
    if stats and stats_of(got) != stats_of(want):
        raise AssertionError(f"{what}: round stats {stats_of(got)} differ "
                             f"from one card's {stats_of(want)}")
    for part in ("panel", "genes"):
        a, b = getattr(got, part), getattr(want, part)
        if (gene_fields(a) != gene_fields(b)
                or [g.round_born for g in a] != [g.round_born for g in b]):
            raise AssertionError(f"{what}: {part} differs from one card's")


def phase_mesh(dev, ds, index, tables, col_maps, cfg, card, ref):
    """Phase 14: the assembly on a mesh of MESH_RANKS virtual ranks of the
    card, each of (a)-(e) held to a single-device result: phase 13's `ref`
    (a dict from `phase_assembly`), and for (b) one card's run of the same
    MESH_C2_READS reads."""
    import dataclasses
    import os

    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.ops.seed import SeedTable
    from rambl_tpu_torch.parallel import ring_dma
    from rambl_tpu_torch.parallel.mesh import data_mesh, put_sharded
    from rambl_tpu_torch.parallel.ring import RingShards, build_ring_shards
    from rambl_tpu_torch.parallel import steps as tsteps
    from rambl_tpu_torch.parallel.steps import make_align_pileup_step
    from rambl_tpu_torch.pipeline import assemble as tassemble
    from rambl_tpu_torch.pipeline.pileup import node_pileup
    from rambl_tpu_torch.utils.checkpoint import (
        load_aux_evidence,
        load_checkpoint,
    )
    from rambl_tpu_torch.utils.timing import cuda_time

    mesh = data_mesh(devices=[dev] * MESH_RANKS)
    real_round = tassemble.assemble_round

    def reset():
        sw_cuda.reset_launches()
        ring_dma.reset_launches()

    def launches():
        return {**sw_cuda.LAUNCHES, **ring_dma.LAUNCHES}

    # (a) the parity dataset, dense and slot; killed and resumed across
    sm = simulate_dataset(**PARITY_DS)
    sm_tax = build_taxonomy_tables(sm.tax_parent, sm.tax_depth, sm.ref_taxon)
    sm_args = (sm.reads, sm.read_lens, sm.ref_seqs, sm.ref_lens, sm_tax)
    for mode, extra in PARITY_MODES.items():
        got = tassemble.assemble(*sm_args,
                                 PipelineConfig(**PARITY_CFG, **extra),
                                 mesh=mesh)
        same_result(f"mesh parity ({mode})", got, ref["parity_oracle"])
        same_run(f"mesh parity ({mode})", got, ref["parity"][mode])

    class Killed(RuntimeError):
        pass

    def dying_round(*a, **kw):
        out = real_round(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:          # round 0 + round 1 done -> crash
            raise Killed()
        return out

    pcfg = PipelineConfig(**PARITY_CFG)
    sides = {"mesh": dict(mesh=mesh), "one card": dict(device=dev)}
    for first, then in (("mesh", "one card"), ("one card", "mesh")):
        ck = os.path.join(ref["tmp"], f"mesh_{first.replace(' ', '_')}.ckpt")
        calls = {"n": 0}
        tassemble.assemble_round = dying_round
        try:
            tassemble.assemble(*sm_args, pcfg, checkpoint_path=ck,
                               **sides[first])
            raise AssertionError("the run was not killed")
        except Killed:
            pass
        finally:
            tassemble.assemble_round = real_round
        header, panel = load_checkpoint(ck)
        aux = load_aux_evidence(ck + ".aux", pcfg)
        resumed = tassemble.assemble(*sm_args, pcfg, initial_panel=panel,
                                     initial_aux=aux, **sides[then])
        if header["round"] != 0 or not resumed.round_stats[0]["aux_restored"]:
            raise AssertionError(f"checkpoint after the kill: {header}")
        same_run(f"killed on {first}, resumed on {then}", resumed,
                 ref["parity"]["dense"], stats=False)
    say(f"[14 mesh assembly] (a) {sm.reads.shape[0]} reads on {mesh} "
        f"({MESH_RANKS} virtual ranks of cuda:0): dense and "
        f"pileup_slot_nodes=1 equal phase 13 (a)'s one-card runs (rounds, "
        f"stats, panel, genes) and the NumPy oracle; killed after round 1 "
        f"on the mesh and resumed on one card, and the reverse, from the "
        f"checkpoint and its sidecar: the one-card genes bit for bit")

    # (b) config 2 at full width on its first MESH_C2_READS reads, three
    # modes, round by round, each held to one card's run of those reads
    n_b = MESH_C2_READS
    args = (ds.reads[:n_b], ds.read_lens[:n_b], ds.ref_seqs, ds.ref_lens,
            tables)
    t0 = time.perf_counter()
    want = tassemble.assemble(*args, cfg, device=dev)
    one_s = time.perf_counter() - t0
    for mode, extra in MESH_MODES.items():
        mcfg = dataclasses.replace(cfg, **extra)
        rounds = []

        def recorded_round(*a, **kw):
            torch.cuda.synchronize(dev)
            before = launches()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = real_round(*a, **kw)
            torch.cuda.synchronize(dev)
            rounds.append(dict(
                wall=time.perf_counter() - t0, stats=out[1],
                peak=torch.cuda.max_memory_allocated(dev),
                launches={k: v - before[k] for k, v in launches().items()}))
            return out

        os.environ["RAMBL_STAGE_TIMING"] = "1"
        tassemble.assemble_round = recorded_round
        try:
            reset()
            t0 = time.perf_counter()
            res = tassemble.assemble(*args, mcfg, mesh=mesh)
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            total = launches()
        finally:
            del os.environ["RAMBL_STAGE_TIMING"]
            tassemble.assemble_round = real_round
        same_run(f"config 2 on the mesh ({mode})", res, want)
        after_rounds = {k: sum(r["launches"][k] for r in rounds)
                        for k in total}
        if any(total[k] != after_rounds[k] for k in total):
            raise AssertionError(f"{mode}: polish launched "
                                 f"{total} - {after_rounds}")
        ring = mcfg.shard_index and mcfg.ring_impl == "dma"
        for i, r in enumerate(rounds):
            n = r["launches"]
            if n["score"] <= 0 or n["align"] <= 0 or (ring and n["ring"] <= 0):
                raise AssertionError(f"{mode}: round {i} launched {n}")
        full = res.full_length(mcfg)
        say(f"[14 mesh assembly] (b) config 2 on the mesh, {mode} (the "
            f"first {n_b} of its {ds.reads.shape[0]} reads (cut), "
            f"max_assembly_iters {mcfg.max_assembly_iters}, polish on): "
            f"{res.n_rounds} rounds, {len(res.genes)} genes, {len(full)} "
            f"full-length, equal to one card's run of those reads "
            f"({one_s:.3f} s) (rounds, stats, panel, genes); wall {e2e_s:.3f} s"
            f" (host clock, index and col maps built inside) = "
            f"{len(full) / (e2e_s / 3600.0):.0f} genes/hour; polish "
            f"launched nothing [{card}]")
        for i, r in enumerate(rounds):
            st = r["stats"]
            say(f"    round {i}: wall {r['wall']:.3f} s: "
                + ", ".join(f"{k[2:]} {v:.2f} s" for k, v in st.items()
                            if k.startswith("t_"))
                + f"; launches K1 {r['launches']['score']}, K2+K3 "
                f"{r['launches']['align']}, K4 {r['launches']['ring']}; "
                f"peak device memory {r['peak'] / 1e9:.3f} GB [{card}]")

    # the cluster stage on the mesh, alone and with its member gathers
    # timed apart (a sync around each), beside one card's on the same reads
    cl = {}
    leaves = np.unique(tables.ref_taxon)
    for where in ("mesh", "one card", "mesh, gathers timed"):
        kw = dict(device=dev) if where == "one card" else dict(mesh=mesh)
        out = tassemble.stream_align(*args[:2], index, *args[2:], cfg,
                                     col_maps=col_maps, **kw)
        gather_s, real_gather = [0.0], tsteps.gather_members

        def timed_gather(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got = real_gather(*a, **kw)
            torch.cuda.synchronize(dev)
            gather_s[0] += time.perf_counter() - t0
            return got

        if where.endswith("timed"):
            tsteps.gather_members = timed_gather
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            cons = tassemble.cluster_stage(*out, leaves, tables, cfg,
                                           mesh=kw.get("mesh"))
            cl[where] = (time.perf_counter() - t0, gather_s[0], cons)
        finally:
            tsteps.gather_members = real_gather
        del out
    for where in ("mesh", "mesh, gathers timed"):
        if not all(np.array_equal(a, b) for a, b in zip(
                (*cl[where][2][0], *cl[where][2][1:3], *cl[where][2][3]),
                (*cl["one card"][2][0], *cl["one card"][2][1:3],
                 *cl["one card"][2][3]))):
            raise AssertionError(f"cluster stage ({where}) differs from one "
                                 "card's")
    say(f"    cluster stage on config 2's round-0 stream, {leaves.size} "
        f"leaves: mesh {cl['mesh'][0]:.3f} s; with a sync around each "
        f"member gather {cl['mesh, gathers timed'][0]:.3f} s, of which the "
        f"gathers {cl['mesh, gathers timed'][1]:.3f} s; one card "
        f"{cl['one card'][0]:.3f} s; outputs equal (host clock) [{card}]")

    # (c) the cohort of phase 13 (e), its shared index sharded once
    co, co_tax = ref["cohort_in"]
    ccfg = PipelineConfig(**COHORT_CFG, shard_index=True, ring_impl="dma")
    reset()
    t0 = time.perf_counter()
    got = tassemble.assemble_cohort(co.samples, co.ds.ref_seqs,
                                    co.ds.ref_lens, co_tax, ccfg, mesh=mesh)
    co_s = time.perf_counter() - t0
    if len(got) != len(ref["cohort"]):
        raise AssertionError("mesh cohort: samples differ")
    for j, (g, w) in enumerate(zip(got, ref["cohort"])):
        same_run(f"mesh cohort sample {j}", g, w)
    say(f"[14 mesh assembly] (c) the cohort of phase 13 (e) on the mesh "
        f"(shard_index, ring_impl=dma: one set of shards for every sample): "
        f"equal to the one-card cohort in {co_s:.3f} s; launches "
        f"{launches()} [{card}]")

    # (d) make_align_pileup_step on config 2's first four batches
    B = cfg.batch_size
    table = SeedTable.from_index(index, dev)
    st = tassemble.StreamTables.from_host(ds.ref_seqs, tables, col_maps, dev)
    n_nodes, ref_len = tables.n_nodes, ds.ref_seqs.shape[1]
    shards = RingShards(build_ring_shards(index, MESH_RANKS), mesh)
    for mode, ring, positions in (("replicated", False, False),
                                  ("ring dma, positions", True, True)):
        dcfg = dataclasses.replace(cfg, shard_index=ring, ring_impl="dma",
                                   shard_positions=positions)
        step = make_align_pileup_step(mesh, dcfg, index.n_bits, n_nodes,
                                      ref_len, ring=ring,
                                      shard_positions=positions)
        for b in range(4):
            rd = ds.reads[b * B:(b + 1) * B]
            ln = ds.read_lens[b * B:(b + 1) * B]
            one = tassemble._align_bin_batch(
                torch.from_numpy(rd.copy()).to(dev),
                torch.from_numpy(ln.copy()).to(dev), table, st, dcfg)
            c1, s1 = node_pileup(one[0], one[1], one[2], n_nodes, ref_len)
            r1 = tassemble._read_count(one[2], n_nodes)
            q, proj, bins, score, counts, span, rcount = step(
                put_sharded(rd, mesh), put_sharded(ln, mesh),
                shards if ring else [table] * MESH_RANKS, [st] * MESH_RANKS)
            if positions:
                counts = [torch.cat(counts, 1)]
                span = [torch.cat(span, 1)[:, :ref_len + 1]]
            ok = all(torch.equal(torch.cat(x), y) for x, y in
                     zip((q, proj, bins, score), one[:4]))
            ok &= all(torch.equal(x, c1) for x in counts)
            ok &= all(torch.equal(x, s1) for x in span)
            ok &= all(torch.equal(x, r1) for x in rcount)
            if not ok:
                raise AssertionError(f"make_align_pileup_step ({mode}) "
                                     f"batch {b} differs from one card's")
    torch.cuda.synchronize()
    say(f"[14 mesh assembly] (d) make_align_pileup_step ({MESH_RANKS} "
        f"ranks; replicated, and ring dma with shard_positions) on config "
        f"2's first 4 batches of {B}: rows, counts, span_diff and read_count "
        f"equal the one-card batch and its pileup bit for bit")

    # K4 at config 2's shards, the size (b)'s ring modes rotate
    def rot(impl):
        mesh.fork()
        shards.rotate(impl)
        mesh.join()

    k4 = {}
    for impl in ("ppermute", "dma", "dma", "ppermute"):     # in turns
        k4.setdefault(impl, []).append(cuda_time(rot, impl, iters=50))
    shard_bytes = sum(x.numel() * x.element_size()
                      for st_ in shards.state for x in st_)
    say(f"    K4 one rotation of config 2's index shards ({MESH_RANKS} "
        f"launches, {shard_bytes} B in all; CUDA events over 50 rotations, "
        f"host gaps included, in turns plain, K4, K4, plain): dma "
        + ", ".join(f"{t:.4f}" for t in k4["dma"]) + " ms; plain rotation "
        "(ppermute) " + ", ".join(f"{t:.4f}" for t in k4["ppermute"])
        + f" ms; bound "
        f"{2 * shard_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) [{card}]")
    del table, st, shards

    # (e) the command line on a one-rank mesh
    gene_fa = os.path.join(ref["tmp"], "cli", "genes.mesh1.fasta")
    t0 = time.perf_counter()
    run_cli([*ref["cli_argv"], "--out", gene_fa, "--mesh", "1"])
    with open(gene_fa) as f:
        if f.read() != ref["cli_fasta"]:
            raise AssertionError("--mesh 1 wrote another FASTA than "
                                 "phase 13 (e)'s")
    say(f"[14 mesh assembly] (e) python -m rambl_tpu_torch.cli assemble "
        f"--mesh 1 (a subprocess, {time.perf_counter() - t0:.1f} s) writes "
        f"phase 13 (e)'s FASTA [{card}]")


#: phase 15's cuts of the ladder: config 3 at 1 M of its 10 M reads (phase
#: 10's dataset and index), config 5 at 250,000 of its 20 M reads on the
#: same panel (500,000 before phase 16 came: the run must stay inside its
#: time); config 2 and config 4 at full size
LADDER_C3_READS = 1_000_000
LADDER_C5_READS = 250_000
#: the config-4 bars (SCALE_r5.json): recovered/detectable with phasing on
#: and off
LADDER_C4_BARS = {"on": (36, 40), "off": (22, 40)}
#: leaves of round 0's cluster stage rerun on CPU tensors in (b)
LADDER_RERUN_LEAVES = 16


def cluster_arrays(out):
    """cluster_stage's outputs as 9 host arrays in a fixed order."""
    cons, kact, n_mem, mh = out
    return [*cons, kact, n_mem, *mh]


def capture_cluster_stage(tassemble, cfg, n_pick):
    """Wrap `assemble.cluster_stage` so that its first call (round 0) keeps
    CPU copies of its inputs for `n_pick` leaves (spawn and light where
    present, and the leaves with the most members) and its outputs for
    them. Returns (the wrapper, the record dict)."""
    real = tassemble.cluster_stage
    record = {}

    def wrapper(rec, counts, span_diff, read_count, leaves, tables, cfg_,
                node2slot=None, mesh=None):
        out = real(rec, counts, span_diff, read_count, leaves, tables, cfg_,
                   node2slot, mesh=mesh)
        if record:
            return out
        t0 = time.perf_counter()
        rc_leaf = read_count.cpu().numpy()[leaves]
        n_mem = out[2]
        spawn_at = np.nonzero(rc_leaf > 0)[0]
        light_at = np.nonzero(rc_leaf == 0)[0]
        deep = spawn_at[np.argsort(-n_mem[spawn_at], kind="stable")[:4]]
        n_light = min(n_pick // 2 - 2, light_at.size)
        chosen = list(dict.fromkeys([
            *deep, *light_at[np.linspace(0, light_at.size - 1,
                                         n_light).astype(int)],
            *spawn_at[np.linspace(0, spawn_at.size - 1,
                                  n_pick).astype(int)]]))
        at = np.sort(np.asarray(chosen[:n_pick], np.int64))
        record.update(
            leaves=leaves[at], tables=tables, cfg=cfg_, n_leaves=leaves.size,
            node2slot=node2slot, spawn=int((rc_leaf[at] > 0).sum()),
            light=int((rc_leaf[at] == 0).sum()),
            full=int((n_mem[at] >= cfg.max_bin_reads).sum()),
            max_mem=int(n_mem.max()),
            want=[a[at] for a in cluster_arrays(out)],
            inputs=({k: rec[k].cpu() for k in ("query", "ref_col", "bins")},
                    counts.cpu(), span_diff.cpu(), read_count.cpu()))
        record["copy_s"] = time.perf_counter() - t0
        return out

    return wrapper, record


def rerun_cluster_stage(tassemble, record):
    """Round 0's cluster stage on the CPU copies for the recorded leaves;
    raises unless every output equals the card's. -> seconds taken."""
    t0 = time.perf_counter()
    got = tassemble.cluster_stage(*record["inputs"], record["leaves"],
                                  record["tables"], record["cfg"],
                                  record["node2slot"])
    names = ("called", "emit", "n_reads", "kact", "n_mem", "mh.called",
             "mh.emit", "mh.n_reads", "mh.n_cols")
    for name, w, g in zip(names, record["want"], cluster_arrays(got)):
        if w.dtype != g.dtype or not np.array_equal(w, g):
            raise AssertionError(f"round 0's cluster stage {name}: the card "
                                 f"differs from the CPU rerun on leaves "
                                 f"{record['leaves']}")
    return time.perf_counter() - t0


def phase_ladder(dev, ds, ds4, index4, card):
    """Phase 15: the scale ladder's runners (`rambl_tpu_torch.scripts.
    run_config2` .. `run_config5`) on the card at cut depth. (a) config 2 at
    full size on phase 4's dataset; (b) config 3 at LADDER_C3_READS (phase
    10's dataset and index): slot mode, several leaf blocks, launches every
    round and none in polish, flat allocation, round 0's cluster stage
    equal to its CPU rerun; (c) config 5 at LADDER_C5_READS: phase A, then
    phase B from disk, equal to an uninterrupted run; (d) config 4 at full
    size, held to its bars. Returns what phase 17 reads: (b)'s panel dump
    and genes, (d)'s cohort and its results with phasing."""
    import os
    import tempfile

    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.pipeline import assemble as tassemble
    from rambl_tpu_torch.scripts import build_scale_caches as caches
    from rambl_tpu_torch.scripts import (
        run_config2,
        run_config3,
        run_config4,
        run_config5,
    )
    from rambl_tpu_torch.scripts.ladder import RoundRecorder

    def runner_out(*parts):
        print(*parts, file=sys.stderr, flush=True)

    keep = {}
    os.environ["RAMBL_STAGE_TIMING"] = "1"
    try:
        # (a) config 2 at full size
        t0 = time.perf_counter()
        c2 = run_config2.run(ds=ds, device=dev, out=runner_out)
        c2["recorder"].check("config 2")
        say(f"[15 ladder] (a) run_config2 ({ds.reads.shape[0]} reads, "
            f"max_genes {c2['cfg'].max_genes}): {c2['result'].n_rounds} "
            f"rounds, {c2['genes']} genes, {c2['full_length']} full-length, "
            f"recovered>95% {c2['recovered']}/{c2['n_refs']}; wall "
            f"{c2['wall_s']:.3f} s ({time.perf_counter() - t0:.1f} s with "
            f"scoring); K1 and K2+K3 launch every round, none in polish; "
            f"allocation flat [{card}]")
        c2["recorder"].report(card, say)

        # (b) config 3 at LADDER_C3_READS, with max_genes 2048
        data3 = caches.ScaleData.of(ds4, index4)
        if data3.n_reads != LADDER_C3_READS:
            raise AssertionError(f"phase 10's dataset has {data3.n_reads} "
                                 f"reads, not {LADDER_C3_READS}")
        wrapper, record = capture_cluster_stage(
            tassemble, run_config3.config(LADDER_C3_READS, 2048),
            LADDER_RERUN_LEAVES)
        real_stage = tassemble.cluster_stage
        tassemble.cluster_stage = wrapper
        dump_dir = tempfile.mkdtemp(prefix="rambl_smoke_c3_")
        try:
            c3 = run_config3.run(data=data3, max_genes=2048, device=dev,
                                 dump=os.path.join(dump_dir, "panel"),
                                 out=runner_out)
        finally:
            tassemble.cluster_stage = real_stage
        cfg3, res3 = c3["cfg"], c3["result"]
        c3["recorder"].check("config 3")
        n0 = res3.round_stats[0]["n_leaves"]
        if list(c3["aux"]) != ["slot_counts"]:
            raise AssertionError("config 3: slot mode did not engage")
        if n0 <= cfg3.cluster_leaf_block:
            raise AssertionError(f"config 3: round 0 has {n0} leaves, one "
                                 "leaf block")
        if (record["spawn"] == 0 or record["light"] == 0
                or record["full"] == 0 or record["leaves"].size
                < LADDER_RERUN_LEAVES):
            raise AssertionError(f"config 3: the rerun's leaves miss a kind: "
                                 f"{record['spawn']} spawn, {record['light']}"
                                 f" light, {record['full']} at max_bin_reads")
        del c3["aux"]
        cpu_s = rerun_cluster_stage(tassemble, record)
        say(f"[15 ladder] (b) run_config3 at {LADDER_C3_READS} of its "
            f"10,000,000 reads (cut; phase 10's dataset and index), max_genes "
            f"2048: slot mode, round 0 {n0} leaves in "
            f"{-(-n0 // cfg3.cluster_leaf_block)} blocks of "
            f"{cfg3.cluster_leaf_block}; {res3.n_rounds} rounds, converged "
            f"{res3.converged}; {c3['genes']} genes, {c3['full_length']} "
            f"full-length; recovered>95% {c3['recovered']}/{c3['detectable']}"
            f" detectable ({c3['present']} present; no bar at this depth); "
            f"wall {c3['wall_s']:.3f} s (scored in {c3['score_s']:.1f} s "
            f"after it); K1 and K2+K3 launch every round, none in polish; "
            f"allocation flat [{card}]")
        c3["recorder"].report(card, say)
        say(f"    panel dump: {c3['dump_bytes'] / 1e9:.3f} GB written in "
            f"{c3['dump_s']:.2f} s after the wall (phase 17 reads it) [{card}]")
        keep.update(c3_dump=os.path.join(dump_dir, "panel"), c3_dir=dump_dir,
                    c3_genes=res3.genes,
                    c3_missed=np.setdiff1d(c3["detectable_refs"],
                                           c3["recovered_refs"]).tolist())
        say(f"    round 0's cluster stage rerun on CPU tensors for "
            f"{record['leaves'].size} of its {record['n_leaves']} leaves "
            f"({record['spawn']} spawn, {record['light']} light, "
            f"{record['full']} with members at max_bin_reads "
            f"{cfg3.max_bin_reads}; most members {record['max_mem']}) in "
            f"{cpu_s:.1f} s (copies {record['copy_s']:.2f} s, inside the "
            f"stage): ConsensusOut, kact, n_mem and MinorHap equal the "
            f"card's bit for bit")
        del record, c3, res3

        # (c) config 5 at LADDER_C5_READS: A + B from disk == uninterrupted
        t0 = time.perf_counter()
        reads5, lens5 = caches.config5_reads(ds4, LADDER_C5_READS)
        gen_s = time.perf_counter() - t0
        data5 = caches.ScaleData.of(ds4, index4, reads5, lens5)
        ckdir = tempfile.mkdtemp(prefix="rambl_smoke_c5_")
        c5 = run_config5.run(data=data5, device=dev, ckpt_dir=ckdir,
                             out=runner_out)
        res5, cfg5 = c5["result"], c5["cfg"]
        for rec_ in (c5["recorder_a"], c5["recorder_b"]):
            rec_.check("config 5")
        if not c5["aux_restored"] or c5["recorder_b"].polish_launches[
                "score"]:
            raise AssertionError("config 5: phase B did not restore the aux "
                                 "evidence, or its polish launched K1")
        tax5 = build_taxonomy_tables(ds4.tax_parent, ds4.tax_depth,
                                     ds4.ref_taxon)
        with RoundRecorder(dev) as whole_rec:
            t0 = time.perf_counter()
            whole = tassemble.assemble(reads5, lens5, ds4.ref_seqs,
                                       ds4.ref_lens, tax5, cfg5,
                                       shared_index=index4, device=dev)
            whole_rec.sync()
            whole_s = time.perf_counter() - t0
        same_run("config 5 resumed", res5, whole, stats=False)
        if stats_of(res5)[1:] != stats_of(whole)[1:]:
            raise AssertionError("config 5: the resumed rounds' stats differ "
                                 "from the uninterrupted run's")
        say(f"[15 ladder] (c) run_config5 at {LADDER_C5_READS} of its "
            f"20,000,000 reads (cut; its chunked generator on phase 10's "
            f"panel, {gen_s:.1f} s): phase A {c5['phase_a_s']:.3f} s "
            f"(discovery + checkpoint), phase B {c5['phase_b_s']:.3f} s "
            f"(resumed from round {c5['header']['round']} on disk, aux "
            f"RESTORED, polish launched K1 "
            f"{c5['recorder_b'].polish_launches['score']} times); "
            f"{res5.n_rounds} rounds, {c5['genes']} genes, "
            f"{c5['full_length']} full-length, recovered>95% "
            f"{c5['recovered']}/{c5['detectable']} detectable (no bar at "
            f"this depth); equal to the uninterrupted run ({whole_s:.3f} s): "
            f"rounds, stats (timings aside), panel and genes [{card}]")
        for rec_ in (c5["recorder_a"], c5["recorder_b"]):
            rec_.report(card, say)
        del c5, res5, whole, data5, reads5, lens5

        # (d) config 4 at full size, held to its bars
        co4 = run_config4.cohort()
        c4 = run_config4.run(device=dev, co=co4, out=runner_out)
        for mode, (bar_rec, bar_det) in LADDER_C4_BARS.items():
            got = (c4[mode]["recovered"], c4[mode]["detectable"])
            if got != (bar_rec, bar_det):
                raise AssertionError(f"config 4 phasing {mode}: recovered "
                                     f"{got}, the bar is {bar_rec}/{bar_det}")
            c4[mode]["recorder"].check(f"config 4 ({mode})")
        say(f"[15 ladder] (d) run_config4 (8 species x 5 strains, 5 samples "
            f"of 5,120 reads): with phasing {c4['on']['recovered']}/"
            f"{c4['on']['detectable']} (mean cont "
            f"{c4['on']['mean_cont']:.3f}) in {c4['on']['wall_s']:.3f} s, "
            f"without {c4['off']['recovered']}/{c4['off']['detectable']} "
            f"(mean cont {c4['off']['mean_cont']:.3f}) in "
            f"{c4['off']['wall_s']:.3f} s: the bars 36/40 and 22/40 held; "
            f"K1 and K2+K3 launch every round, none in polish [{card}]")
        keep.update(c4_co=co4, c4_on=c4["on"]["results"])
    finally:
        del os.environ["RAMBL_STAGE_TIMING"]
    return keep


#: phase 16 (c): config 3's cluster block, at the reference script's reads
TOOLS_CLUSTER = dict(n_reads=10_000_000, n_leaves=512)
#: phase 16 (d): the align batch of config 3 and the production retention
TOOLS_ALIGN = dict(batch=16384, rows=10_000_000, nb=16)


def phase_tools(dev, ds4, index4, card):
    """Phase 16: the entry hooks and the card tools. (a) `graft_entry.
    entry()`'s align step on the card equals its CPU rerun and, for the
    first 64 reads, the NumPy oracle, with K1 launching;
    `dryrun_multichip(4)` on 4 virtual ranks under the default ring_impl
    and with "dma" (K4 must launch). (b) `scripts.check_ring_dma.run(n)` at
    n = 1, 2, 4 with every impl. (c) `scripts.profile_cluster.run` at
    config 3's block and (d) `scripts.bench_align_scale.run` on phase 10's
    dataset and index, each in a process of its own."""
    import os

    from rambl_tpu_torch import graft_entry
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.oracle.align import align_reads
    from rambl_tpu_torch.parallel import ring_dma
    from rambl_tpu_torch.scripts import bench_align_scale, check_ring_dma

    t_phase = time.perf_counter()
    # the earlier phases' cached blocks go back to the card: (c)'s process
    # and (d) need ~25 GB of their own
    torch.cuda.empty_cache()
    # (a) the entry hooks
    fn, args = graft_entry.entry()
    if args[0].device != dev:
        raise AssertionError(f"entry() put its example on {args[0].device}")
    torch.cuda.synchronize()
    sw_cuda.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = dict(sw_cuda.LAUNCHES)
    if launches["score"] <= 0:
        raise AssertionError(f"entry()'s step launched {launches}: K1 must "
                             "launch")
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    for name in got._fields:
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
            raise AssertionError(f"entry(): {name} on the card differs from "
                                 "its CPU rerun")
    cfg, ds, index, _ = graft_entry._toy_problem()
    n_or = 64
    orc = align_reads(ds.reads[:n_or], ds.read_lens[:n_or], ds.ref_seqs,
                      index, cfg)
    for name in got._fields:
        g = getattr(got, name)[:n_or].cpu().numpy().astype(np.int64)
        if not np.array_equal(getattr(orc, name).astype(np.int64), g):
            raise AssertionError(f"entry(): {name} of the first {n_or} reads "
                                 "differs from the NumPy oracle")
    say(f"[16 tools] (a) entry(): {args[0].shape[0]} reads on the card, "
        f"launches {launches}; AlignRecords equal the CPU rerun, the first "
        f"{n_or} reads the NumPy oracle")
    for impl in ("ppermute", "dma"):
        sw_cuda.reset_launches()
        ring_dma.reset_launches()
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(4, ring_impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = {**sw_cuda.LAUNCHES, **ring_dma.LAUNCHES}
        if k["score"] <= 0 or (impl == "dma" and k["ring"] <= 0):
            raise AssertionError(f"dryrun_multichip(4, ring_impl={impl!r}) "
                                 f"launched {k}")
        say(f"    dryrun_multichip(4) on 4 virtual ranks, ring_impl={impl}: "
            f"both index modes agree (step and assembly) in {wall:.2f} s; "
            f"launches {k}")

    # (b) the ring rotation under every impl
    for n in (1, 2, 4):
        ring_dma.reset_launches()
        done = check_ring_dma.run(n, out=lambda *a: None)
        if list(done) != list(ring_dma.IMPLS):
            raise AssertionError(f"check_ring_dma.run({n}) ran {list(done)}")
        ranks = (f"{n} cards" if 1 < n <= torch.cuda.device_count() else
                 f"{n} virtual rank(s) of {dev}: cross-card ordering is not "
                 "certified")
        say(f"[16 tools] (b) check_ring_dma.run({n}): {', '.join(done)} "
            f"bitwise np.roll; K4 launches {ring_dma.LAUNCHES['ring']} "
            f"({ranks})")

    # (c) and (d) run in processes of their own: run here, late in this
    # script, torch.profiler lost device records (consensus 1.4% busy
    # against 99.9% alone; 69 of (d)'s 6,800 kernels), and
    # `utils.timing.profiled` raises on a session that lost them
    prof = run_apart(
        "from rambl_tpu_torch.scripts import profile_cluster; "
        f"r = profile_cluster.run(**{TOOLS_CLUSTER!r}, trials=1, "
        "out=lambda *a: None)")
    say(f"[16 tools] (c) profile_cluster: "
        + " ".join(f"{k}={v}" for k, v in prof["shapes"].items())
        + f"; sum of the pieces {prof['sum_ms']:.3f} ms a block [{card}]")
    for name, r in prof["pieces"].items():
        say(f"    {name:14s} {r['ms']:10.3f} ms, device busy "
            f"{100 * r['busy_share']:.1f}%, host syncs {r['syncs']} "
            f"{r['sync_lines']}; longest: "
            + "; ".join(f"{ms:.3f} ms x{calls} {key[:60]}"
                        for ms, calls, key in r["top"][:3]))
    for name, why in prof["absent"].items():
        say(f"    {name:14s} absent: {why}")

    # (d) the round-0 align batch at config 3's index, on phase 10's data
    # (handed over as a plain-array cache, removed after)
    from rambl_tpu_torch.scripts import build_scale_caches as caches

    os.makedirs(caches.cache_dir(), exist_ok=True)
    path = os.path.join(caches.cache_dir(), "phase16_config3.npz")
    caches.save_cache(path, caches.ScaleData.of(ds4, index4))
    try:
        res = run_apart(
            "from rambl_tpu_torch.scripts import bench_align_scale, "
            "build_scale_caches; "
            f"d = build_scale_caches.load_cache({path!r}); "
            f"r = bench_align_scale.run(**{TOOLS_ALIGN!r}, ds=d, "
            "index=d.index, out=lambda *a: None)")
    finally:
        os.remove(path)
    say(f"[16 tools] (d) bench_align_scale on phase 10's "
        f"{ds4.reads.shape[0]} reads, {res['entries']} entries, batch "
        f"{res['batch']}: "
        + ", ".join(f"{k} {res[k]['ms']:.3f} ms (device busy "
                    f"{res[k]['device_ms']:.3f} ms)"
                    for k in bench_align_scale.PREFIXES)
        + f"; D {res['D']['ms']:.3f} ms a batch (spread "
        f"{res['D']['spread']:.1f}% over {bench_align_scale.TRIALS} loops) "
        f"over {res['nb']} batches into {res['rows']} rows, device busy "
        f"{res['D']['device_ms']:.3f} ms, idle "
        f"{100 * res['D']['idle_share']:.1f}% [{card}]")
    say(f"    phase 16 took {time.perf_counter() - t_phase:.1f} s")


#: config 4's residual wrong bases with phasing: the reference package's own
#: `scripts/cache_config4_state.py` and `scripts/demonstrate_c4_ambiguity.py`
#: give 40 on the CPU, on a state equal to the port's (PERF.md §6);
#: SCALE_r5.json records 51, on a state the repository does not hold, for a
#: reason not established. None of them may be fixable
C4_RESIDUAL = 40


def phase_diagnostics(dev, ds4, keep, card):
    """Phase 17: (a) `diagnose_config3.run` on phase 15 (b)'s panel dump,
    read back memory-mapped, on phase 10's panel; (b) phase 15 (d)'s cohort
    with phasing through `cache_config4_state` (leaf counts on the card, a
    write and a read), then `census_config4.run`, `diagnose_impure.run`
    and `demonstrate_c4_ambiguity.run` on the state read back."""
    import os
    import shutil
    import tempfile

    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.scripts import (
        cache_config4_state,
        census_config4,
        demonstrate_c4_ambiguity,
        diagnose_config3,
        diagnose_impure,
        run_config3,
    )

    def runner_out(*parts):
        print(*parts, file=sys.stderr, flush=True)

    t_phase = time.perf_counter()
    # (a) config 3's misses, from the dump
    t0 = time.perf_counter()
    dump = run_config3.load_dump(keep["c3_dump"])
    load_s = time.perf_counter() - t0
    counts = dump["slot_counts"][0]
    if not isinstance(counts, np.memmap):
        raise AssertionError("the dump's slot counts are not memory-mapped")
    if gene_fields(dump["genes"]) != gene_fields(keep["c3_genes"]):
        raise AssertionError("config 3: the dump's genes differ from the "
                             "run's")
    t0 = time.perf_counter()
    classes, base_classes, rows = diagnose_config3.run(
        dump, ds4.ref_seqs, ds4.ref_lens, ds4.ref_taxon, out=runner_out)
    diag_s = time.perf_counter() - t0
    if [row["ref"] for row in rows] != keep["c3_missed"]:
        raise AssertionError(f"config 3: the run missed {keep['c3_missed']}"
                             f", the dump's diagnosis classed "
                             f"{[row['ref'] for row in rows]}")
    unknown = ((set(classes) - set(diagnose_config3.CLASSES))
               | (set(base_classes) - set(diagnose_config3.BASE_CLASSES)))
    if unknown:
        raise AssertionError(f"config 3: unknown classes {sorted(unknown)}")
    say(f"[17 diagnostics] (a) diagnose_config3 on 15 (b)'s panel dump "
        f"({len(dump['genes'])} genes equal to the run's; slot counts "
        f"{counts.shape[0]} x {counts.shape[1]} int32, memory-mapped; read "
        f"in {load_s:.2f} s): {len(rows)} misses classed in {diag_s:.2f} s: "
        f"{dict(classes)}; wrong bases {dict(base_classes)} [{card}]")
    del dump, counts
    shutil.rmtree(keep["c3_dir"], ignore_errors=True)

    # (b) config 4's state, census, impure diagnosis and ambiguity proof
    state_dir = tempfile.mkdtemp(prefix="rambl_smoke_c4_")
    try:
        path = os.path.join(state_dir, "state.npz")
        sw_cuda.reset_launches()
        t0 = time.perf_counter()
        st = cache_config4_state.run(co=keep["c4_co"], results=keep["c4_on"],
                                     device=dev, path=path, out=runner_out)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launched = dict(sw_cuda.LAUNCHES)
        if not launched["score"]:
            raise AssertionError("config 4's leaf counts launched no K1")
        back = cache_config4_state.load_state(path)
        if ([gene_fields(g) for g in back.geneses]
                != [gene_fields(g) for g in st.geneses]
                or any(set(a) != set(b) or any(
                    not np.array_equal(a[t], b[t]) for t in b)
                    for a, b in zip(back.counts_list, st.counts_list))):
            raise AssertionError("config 4: the state read back differs")
        t0 = time.perf_counter()
        buckets = census_config4.run(back, out=runner_out)
        impure, _ = diagnose_impure.run(back, out=runner_out)
        total, _, n_fix, n_all = demonstrate_c4_ambiguity.run(
            back, out=runner_out)
        host_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
    if n_fix or n_all != C4_RESIDUAL:
        raise AssertionError(f"config 4: {n_all - n_fix}/{n_all} residual "
                             f"wrong bases invisible or ambiguous, {n_fix} "
                             f"fixable; the bar is {C4_RESIDUAL}/"
                             f"{C4_RESIDUAL}, 0 fixable")
    say(f"[17 diagnostics] (b) config 4 with phasing (15 (d)'s cohort and "
        f"genes): leaf counts of {len(st.counts_list[0])} leaves x "
        f"{len(st.counts_list)} samples on the card in {build_s:.2f} s (K1 "
        f"{launched['score']}, K2+K3 {launched['align']} launches), the "
        f"state written and read back equal; census {dict(buckets)}; "
        f"impure {dict(impure.most_common())}; demonstration "
        f"{dict(total)}: {n_all - n_fix}/{n_all} invisible or ambiguous, "
        f"{n_fix} fixable (the bar: {C4_RESIDUAL}, 0); host tools "
        f"{host_s:.2f} s [{card}]")
    say(f"    phase 17 took {time.perf_counter() - t_phase:.1f} s")


def run_apart(code: str) -> dict:
    """`code`, which sets `r` to a dict, in a Python process of its own
    from the repository root -> that dict (through JSON); raises when the
    process exits with another code than 0."""
    import os

    proc = subprocess.run(
        [sys.executable, "-c",
         f"import json; {code}; print(json.dumps(r))"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"`{code[:80]}...` exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def require_equal(what: str, got, ref) -> int:
    err = max_abs_err(got, ref)
    if err:
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"(max abs err {err})")
    return err


def main() -> None:
    # ---- 1. device ---------------------------------------------------------
    dev = require_cuda(0)
    card = card_line(dev)
    say(f"[1 device] {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} "
        f"| torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.device_count()} device(s)")

    from rambl_tpu_torch.config import PRESETS
    from rambl_tpu_torch.oracle.sw import sw_batch, traceback_batch
    from rambl_tpu_torch.ops import sw as tsw
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.utils.sw_cases import (
        adversarial_pairs,
        gapped_pairs,
        planted_pairs,
        short_reads,
    )
    from rambl_tpu_torch.utils.timing import (
        cuda_time,
        graph_ms,
        kernel_ms,
        median_spread,
        trial_times,
    )

    cfg = PRESETS["small"]
    sc = cfg.scoring
    L, W, ROWS = cfg.read_len_max, cfg.window_len, cfg.sw_rows
    PAIRS = cfg.batch_size * 2 * cfg.max_candidates

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = sw_cuda.load_library()._name
    build_s = time.perf_counter() - t0
    say(f"[2 build] {lib_path} in {build_s:.2f} s "
        f"(nvcc {' '.join(sw_cuda.NVCC_FLAGS)})")
    oracles, n_workers = start_oracles()
    say(f"    phase 13's NumPy-oracle references started in {n_workers} "
        f"worker processes ({len(oracles)} jobs)")
    kernel_regs = {}
    with open(sw_cuda.BUILD_LOG) as f:
        for name, regs, spill in ptxas_report(f):
            say(f"    ptxas: {name}: {regs}; {spill}")
            kernel_regs[name] = int(re.search(r"(\d+) registers",
                                              regs).group(1))
            if (name.startswith(("sw_score_kernel", "ring_copy_kernel",
                                 "sw_align_traceback_kernel"))
                    and "0 bytes spill stores, 0 bytes spill loads"
                    not in (spill or "")):
                raise AssertionError(f"{name} spills: {spill}")
    from rambl_tpu_torch.ops import sw_variants as sv

    for name in ("sw_score_kernel", "ring_copy_kernel",
                 "sw_align_traceback_kernel<4>",
                 "sw_align_traceback_kernel<8>",
                 sv.S2_VARIANT.kernel("S2Load", "RawKeyOut"),
                 *(v.kernel() for v in sv.VARIANTS)):
        if name not in kernel_regs:
            raise AssertionError(f"no ptxas report for {name}")

    # ---- 3. kernels vs twin, bit for bit -----------------------------------
    def on_card(*arrays):
        return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]

    err = {"score": 0, "align": 0}
    q_full, w_full = on_card(*planted_pairs(11, PAIRS, L, W))
    q_path, w_path = on_card(*short_reads(12, PAIRS, L, W, ROWS, min_len=60))
    for rows, q, w in ((0, q_full, w_full), (ROWS, q_full, w_full),
                       (ROWS, q_path, w_path)):
        got = sw_cuda.sw_score_cuda(q, w, sc, rows=rows)
        ref = tsw.sw_score(q[:, :rows or L], w, sc)
        torch.cuda.synchronize()
        err["score"] = max(err["score"],
                           require_equal(f"K1 rows={rows}", got, ref))
    qn, wn = q_full[:256].cpu().numpy(), w_full[:256].cpu().numpy()
    got = [t[:256].cpu().numpy() for t in sw_cuda.sw_score_cuda(
        q_full[:256].contiguous(), w_full[:256].contiguous(), sc)]
    for g, r in zip(got, sw_batch(qn, wn, sc, want_dirs=False)[:3]):
        np.testing.assert_array_equal(r, g)
    # ragged batches: one pair, odd counts (the last thread's second half
    # has no pair), not a multiple of a block's pairs
    ragged = (1, 2, 31, 33, 65, 1037)
    for n_r in ragged:
        qr, wr = q_path[:n_r].contiguous(), w_path[:n_r].contiguous()
        for rows in (0, ROWS):
            got = sw_cuda.sw_score_cuda(qr, wr, sc, rows=rows)
            err["score"] = max(err["score"], require_equal(
                f"K1 n={n_r} rows={rows}", got,
                tsw.sw_score(qr[:, :rows or L], wr, sc)))
        for g, r in zip(got, sw_batch(qr[:64, :ROWS].cpu().numpy(),
                                      wr[:64].cpu().numpy(), sc,
                                      want_dirs=False)[:3]):
            np.testing.assert_array_equal(r, g[:64].cpu().numpy())
    before = sw_cuda.LAUNCHES["score"]
    empty = sw_cuda.sw_score_cuda(q_path[:0], w_path[:0], sc, rows=ROWS)
    if sw_cuda.LAUNCHES["score"] != before or any(t.numel() for t in empty):
        raise AssertionError("K1 on no pairs must launch nothing")
    # adversarial pairs (utils.sw_cases.ADVERSARIAL), also against the
    # 16-bit arithmetic in plain PyTorch
    qa, wa = adversarial_pairs(3, L, W)
    qa_t, wa_t = on_card(qa, wa)
    for rows in (0, ROWS):
        got = sw_cuda.sw_score_cuda(qa_t, wa_t, sc, rows=rows)
        err["score"] = max(err["score"], require_equal(
            f"K1 adversarial rows={rows}", got,
            tsw.sw_score(qa_t[:, :rows or L], wa_t, sc)))
        require_equal(f"K1 against its 16-bit plain version rows={rows}",
                      [g.cpu() for g in got], tsw.sw_score_packed16(
                          torch.from_numpy(qa[:, :rows or L].copy()),
                          torch.from_numpy(wa), sc))
        if not ((got[0][:32] == (rows or L)).all()
                and (got[0][128:] == 0).all()):
            raise AssertionError("K1: a read equal to its window must score "
                                 "its length, all mismatches 0")

    def check_align(what, q, w, rows, Ls=L):
        """K2 + K3 (main path: no dirs; tests': dirs) against the twins."""
        nrows = rows or Ls
        s_, ie_, je_, dirs_ = tsw.sw_align(q[:, :nrows], w, sc)
        rc_ = tsw.sw_traceback(dirs_, ie_, je_, Ls, W)
        got = sw_cuda.sw_align_traceback_cuda(q, w, sc, rows, Ls, W)
        gd = sw_cuda.sw_align_cuda(q, w, sc, rows)
        torch.cuda.synchronize()
        return max(require_equal(f"K2+K3 {what}", got, (s_, ie_, je_, rc_)),
                   require_equal(f"K2+K3 dirs {what}",
                                 (*gd[:3], gd[3].permute(0, 2, 1)),
                                 (s_, ie_, je_, dirs_))), got

    qg, wg = gapped_pairs(13, 4096, ROWS, W)
    qg = np.concatenate([qg, np.full((4096, L - ROWS), 4, np.int8)], axis=1)
    qg = np.concatenate([qg, np.full((128, L), 4, np.int8)])   # all-N block
    wg = np.concatenate([wg, np.full((128, W), 4, np.int8)])
    qg, wg = on_card(qg, wg)
    # 26 lanes of 4 rows (the path), 2 lanes, 32 lanes
    for rows in (ROWS, 8, 0):
        e_, got = check_align(f"rows={rows}", qg, wg, rows)
        err["align"] = max(err["align"], e_)
        if rows == ROWS and not ((got[0][-128:] == 0).all()
                                 and (got[3][-128:] == -1).all()):
            raise AssertionError("all-N pairs must score 0 and trace nothing")
    L8 = 200                    # 8 rows a lane: 25 lanes, 200 x 161 + 160 <
    q8, w8 = gapped_pairs(18, 1024, L8, W)             # 32,768
    q8[-16:], w8[-16:] = 4, 4
    err["align"] = max(err["align"], check_align(
        f"L={L8}", *on_card(q8, w8), 0, L8)[0])
    ragged_tb = (1, 31, 33, 171)
    for n_r in ragged_tb:
        err["align"] = max(err["align"], check_align(
            f"n={n_r}", qg[:n_r].contiguous(), wg[:n_r].contiguous(),
            ROWS)[0])
    qo, wo = gapped_pairs(14, 256, L, W)
    _, _, _, rco = sw_cuda.sw_align_traceback_cuda(*on_card(qo, wo), sc, 0,
                                                   L, W)
    _, oie, oje, odirs = sw_batch(qo, wo, sc, want_dirs=True)
    np.testing.assert_array_equal(traceback_batch(odirs, oie, oje, L),
                                  rco.cpu().numpy())
    torch.cuda.synchronize()
    say(f"[3 kernels] K1 on {PAIRS} planted pairs at rows 0 and {ROWS} and "
        f"on {PAIRS} reads of <= {ROWS} bases at rows {ROWS}, on batches of "
        f"{ragged} and 0 pairs and on 160 adversarial pairs (also against its "
        f"16-bit plain version); K2+K3 on 4224 gapped/all-N pairs at rows "
        f"{ROWS}, 8 and {L}, on 1024 at L={L8} and on batches of {ragged_tb} "
        f"pairs (score, end cell, ref_col and the optional dirs): equal to "
        f"the twins bit for bit; 256 pairs each equal to the NumPy oracle")

    # ---- 4. the slice: stream_align over config 2 --------------------------
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.builder import build_seed_index
    from rambl_tpu_torch.index.colmap import build_col_maps
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.ops.seed import SeedTable
    from rambl_tpu_torch.pipeline import align as talign
    from rambl_tpu_torch.pipeline.assemble import (
        RETAINED,
        StreamTables,
        _align_bin_batch,
        stream_align,
    )

    t0 = time.perf_counter()
    ds = simulate_dataset(n_species=20, refs_per_species=5, n_reads=N_READS,
                          seed=SEED)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    tables = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    col_maps = build_col_maps(ds.ref_seqs, ds.ref_lens, ds.ref_taxon)
    host_s = time.perf_counter() - t0
    B = cfg.batch_size

    def run_stream(n):
        return stream_align(ds.reads[:n], ds.read_lens[:n], index,
                            ds.ref_seqs, ds.ref_lens, tables, cfg,
                            col_maps=col_maps, device=dev)

    run_stream(2 * B)                              # warm-up: 2 batches
    torch.cuda.synchronize()

    gapped = []
    real_tb = talign.sw_align_traceback_cuda

    def counting_tb(q, *a):
        gapped.append(q.shape[0])
        return real_tb(q, *a)

    talign.sw_align_traceback_cuda = counting_tb
    sw_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    merged, counts, span_diff, read_count = run_stream(N_READS)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = dict(sw_cuda.LAUNCHES)
    talign.sw_align_traceback_cuda = real_tb
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_batches = -(-N_READS // B)
    say(f"[4 slice] config 2: {N_READS} reads, {ds.ref_seqs.shape[0]} refs x "
        f"{ds.ref_seqs.shape[1]} cols, {tables.n_nodes} taxonomy nodes, "
        f"{n_batches} batches of {B}; host prep {host_s:.1f} s; stream "
        f"{stream_s:.2f} s; launches {launches}; gapped reads to K2+K3 "
        f"{sum(gapped)} ({100 * sum(gapped) / N_READS:.2f}%); peak device "
        f"memory {peak_gb:.2f} GB")

    # ---- 5. checks on the slice --------------------------------------------
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched in the stream")
    if launches["align"] != len(gapped):
        raise AssertionError(f"K2+K3 launched {launches['align']} times, not "
                             f"once for each of the {len(gapped)} batches "
                             "with gapped reads")
    for k in RETAINED:
        if merged[k].shape[0] != N_READS:
            raise AssertionError(f"{k}: {tuple(merged[k].shape)} rows")
    if counts is None or span_diff is None:
        raise AssertionError("config 2 must use the dense accumulators")
    bins = merged["bins"]
    if int(read_count.sum()) != int((bins >= 0).sum()):
        raise AssertionError("read_count does not count the binned reads")
    ref_col = merged["ref_col"]
    kept = ((ref_col >= 0) & (merged["query"] < 4) & (bins >= 0)[:, None])
    if int(counts.sum()) != int(kept.sum()) or int(span_diff.sum()) != 0:
        raise AssertionError("pileup counts differ from the retained cells")
    aligned = float((merged["ref"] >= 0).float().mean())
    binned = float((bins >= 0).float().mean())

    from rambl_tpu_torch.oracle.align import align_reads

    n_or = 512
    orc = align_reads(ds.reads[:n_or], ds.read_lens[:n_or], ds.ref_seqs,
                      index, cfg)
    R, RL = ds.ref_seqs.shape
    proj = np.where(orc.ref_col >= 0,
                    col_maps[np.clip(orc.ref, 0, R - 1)[:, None],
                             np.clip(orc.ref_col, 0, RL - 1)], -1)
    for k, want in (("score", orc.score), ("ref", orc.ref),
                    ("strand", orc.strand), ("ref_col", proj)):
        got = merged[k][:n_or].cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(want.astype(np.int64), got,
                                      err_msg=f"oracle {k}")

    cpu_table = SeedTable.from_index(index, "cpu")
    cpu_st = StreamTables.from_host(ds.ref_seqs, tables, col_maps, "cpu")
    t0 = time.perf_counter()
    cpu_out = _align_bin_batch(torch.from_numpy(ds.reads[:B].copy()),
                               torch.from_numpy(ds.read_lens[:B].copy()),
                               cpu_table, cpu_st, cfg)
    cpu_s = time.perf_counter() - t0
    for k, v in zip(RETAINED, cpu_out):
        if not torch.equal(merged[k][:B].cpu().long(), v.long()):
            raise AssertionError(f"first batch {k}: card differs from CPU")
    say(f"[5 checks] launches > 0; {aligned * 100:.2f}% aligned, "
        f"{binned * 100:.2f}% binned; pileup sums match retention; first "
        f"{n_or} reads equal the NumPy oracle; first batch equals the CPU "
        f"twins ({cpu_s:.1f} s on CPU)")

    # ---- 6. timings on the card --------------------------------------------
    table = SeedTable.from_index(index, dev)
    st = StreamTables.from_host(ds.ref_seqs, tables, col_maps, dev)
    r0 = torch.from_numpy(ds.reads[:B].copy()).to(dev)
    l0 = torch.from_numpy(ds.read_lens[:B].copy()).to(dev)
    batch_ms = cuda_time(lambda: _align_bin_batch(r0, l0, table, st, cfg),
                         iters=10)
    k1 = {}
    for rows, q, w in ((ROWS, q_path, w_path), (0, q_full, w_full)):
        nrows = rows or L
        ms = cuda_time(sw_cuda.sw_score_cuda, q, w, sc, rows, iters=10)
        tw = cuda_time(tsw.sw_score, q[:, :nrows], w, sc, iters=3)
        k1[nrows] = (ms, tw, PAIRS * nrows * W / (ms * 1e-3) / 1e9)
    n_tb = max(128, int(round(sum(gapped) / max(len(gapped), 1))))

    def twin_tb(q, w):
        s_, ie_, je_, dirs_ = tsw.sw_align(q[:, :ROWS], w, sc)
        return tsw.sw_traceback(dirs_, ie_, je_, L, W)

    # pairs: (CUDA events over a graph of 50 launches, median of 3; device
    # time from torch.profiler; CUDA events around 20 calls, host gaps
    # included, as K2 and K3 were timed before they were one launch; twins)
    k23 = {}
    for n_k in (n_tb, qg.shape[0]):
        qt, wt = qg[:n_k].contiguous(), wg[:n_k].contiguous()
        args = (qt, wt, sc, ROWS, L, W)
        k23[n_k] = (
            median_spread(graph_ms(sw_cuda.sw_align_traceback_cuda, *args))[0],
            kernel_ms(sw_cuda.sw_align_traceback_cuda, *args,
                      kernel="sw_align_traceback_kernel", iters=20),
            cuda_time(sw_cuda.sw_align_traceback_cuda, *args, iters=20),
            cuda_time(twin_tb, qt, wt, iters=3))
    qt, wt = qg[:n_tb].contiguous(), wg[:n_tb].contiguous()
    # device busy share and kernel time by name over a 16-batch stream;
    # kernels and copies are the events with no host time of their own
    from torch.profiler import ProfilerActivity, profile

    n_prof = 16 * B
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_stream(n_prof)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    on_dev = device_ops(prof)
    busy_ms = busy_ms_of(prof)
    syncs, sync_at = stream_syncs(lambda: run_stream(6 * B), 6)
    card = card_line(dev)
    say(f"[6 timings] card: {card}")
    say(f"    profiled stream of {n_prof} reads: {prof_s * 1e3:.1f} ms wall, "
        f"device busy {busy_ms:.1f} ms (union of device intervals) = "
        f"{busy_ms / 16:.3f} ms per batch, idle "
        f"{100 * (1 - busy_ms / (prof_s * 1e3)):.1f}% [{card}]")
    for e in on_dev[:8]:
        say(f"      {e.self_device_time_total / 1e3 / 16:8.3f} ms/batch "
            f"{e.count / 16:6.1f} calls/batch  {e.key[:90]}")
    say(f"    stream: {stream_s:.3f} s wall for {N_READS} reads = "
        f"{N_READS / stream_s:.0f} reads/s (host clock, H2D and upload "
        f"included) [{card}]")
    say(f"    one batch of {B} (align + bin; CUDA events over 10 calls, "
        f"host gaps included): {batch_ms:.3f} ms [{card}]")
    say(f"    host syncs a stream batch (set_sync_debug_mode('warn') over "
        f"batches 2 to 5 of a 6-batch stream): {syncs:g} ("
        + ", ".join(f"{k} x{v:g}" for k, v in sorted(sync_at.items()))
        + ")")
    for nrows, (ms, tw, gcups) in k1.items():
        say(f"    K1 sw_score, {PAIRS} pairs x {nrows} rows x {W} cols: "
            f"{ms:.3f} ms = {gcups:.1f} GCUPS; twin {tw:.3f} ms [{card}]")
    for n_k, (ms, dev_ms, ev, tw) in k23.items():
        say(f"    K2+K3 sw_align_traceback, {n_k} gapped pairs x {ROWS} rows "
            f"x {W} cols: {ms:.4f} ms a launch (CUDA events over a CUDA "
            f"graph of 50 launches); device time {dev_ms:.4f} ms "
            f"(torch.profiler over 20); {ev:.4f} ms a call in CUDA events "
            f"around 20 calls (host gaps included); twins sw_align + "
            f"sw_traceback {tw:.3f} ms [{card}]")

    # ---- 7. S1 and S2 against their plain versions, bit for bit -----------
    from rambl_tpu_torch import bench as tbench
    from rambl_tpu_torch.scripts import ablate_prep, bench_sw_variants

    P1, L1, W1 = bench_sw_variants.PAIRS, bench_sw_variants.L, \
        bench_sw_variants.W
    q1n, w1n = planted_pairs(15, P1, L1, W1)
    q1, w1 = on_card(q1n, w1n)
    plain1 = tsw.sw_score(q1, w1, sc)
    s1_plain_ms = cuda_time(tsw.sw_score, q1, w1, sc, iters=3)
    orc1 = sw_batch(q1n[:256], w1n[:256], sc, want_dirs=False)[:3]
    props = torch.cuda.get_device_properties(dev)
    err["variant"], occ = 0, {}
    for v in sv.VARIANTS:
        fn = sv.make_score_fn(sc, L1, W1, strips=v.strips, warps=v.warps,
                              arith=v.arith)
        got = fn(q1, w1)
        torch.cuda.synchronize()
        err["variant"] = max(err["variant"],
                             require_equal(f"S1 {v.name}", got, plain1))
        for g, r in zip(got, orc1):
            np.testing.assert_array_equal(r, g[:256].cpu().numpy(),
                                          err_msg=f"S1 {v.name} vs oracle")
        regs = kernel_regs[v.kernel()]
        occ[v.name] = (blocks_per_sm(v, L1, regs, props), regs)
    del q1, w1, plain1

    P2, L2, W2 = ablate_prep.PAIRS, ablate_prep.L, ablate_prep.W
    rng = np.random.default_rng(16)
    q2n = rng.integers(0, 5, (P2, L2)).astype(np.int8)
    w2n = rng.integers(0, 4, (P2, W2)).astype(np.int8)
    n_homo = P2 // 3
    w2n[:n_homo, 2:L2 - 6] = q2n[:n_homo, 1:L2 - 7] % 4     # planted homology
    q2n[-128:] = 4              # code 4 never equals w's 0..3: no positive cell
    qT, wT = sv.prep(*on_card(q2n, w2n))
    key2 = sv.score_pretransposed(qT, wT, sc, W2)
    q2, w2 = qT.t().contiguous(), wT[:W2].t().contiguous()
    plain2 = tsw.sw_raw_key(q2, w2, sc)
    s2_plain_ms = cuda_time(tsw.sw_raw_key, q2, w2, sc, iters=3)
    torch.cuda.synchronize()
    err["pretransposed"] = require_equal("S2 raw key", [key2], [plain2])
    none_key = int(key2[-1])
    if not (none_key == -(W2 + 2) and bool((key2[-128:] == none_key).all())):
        raise AssertionError("S2: pairs with no positive cell must key "
                             "-(W + 2), cell (1, 1)")
    for g, r in zip(sv.decode_raw_key(key2[:256], W2),
                    sw_batch(q2n[:256], w2n[:256], sc, want_dirs=False)[:3]):
        np.testing.assert_array_equal(r, g.cpu().numpy(), err_msg="S2 oracle")
    # codes that only the 32-bit compare path can tell apart, in some blocks
    trap = qT[:, :4096].clone(), wT[:, :4096].clone()
    trap[0][:, 40:48], trap[1][:, 40:48] = 4, 4
    trap[0][:, 48:56], trap[1][:, 48:56] = -1, -1
    trap[0][:, 100:108], trap[1][:, 100:108] = 256, 0
    trap[0][::2, 200:208], trap[1][::3, 200:208] = 1000, 1000
    trap[1][:, 300:304], trap[1][:, 304:308] = 256, -1     # w only
    trap = tuple(t.contiguous() for t in trap)
    err["pretransposed"] = max(err["pretransposed"], require_equal(
        "S2 raw key on codes outside 0..126",
        [sv.score_pretransposed(*trap, sc, W2)],
        [tsw.sw_raw_key(trap[0].t().contiguous(),
                        trap[1][:W2].t().contiguous(), sc)]))
    # the 32-bit compare path at full size: one q code a pair outside
    # 0..126 sends every block there; timed beside the byte path
    qT_wide = qT.clone()
    qT_wide[0] = 1000
    err["pretransposed"] = max(err["pretransposed"], require_equal(
        "S2 raw key, every block on the 32-bit path",
        [sv.score_pretransposed(qT_wide, wT, sc, W2)],
        [tsw.sw_raw_key(qT_wide.t().contiguous(), w2, sc)]))
    s2_path_ms = {}
    for path, qx in (("byte", qT), ("32-bit", qT_wide), ("byte", qT),
                     ("32-bit", qT_wide)):
        s2_path_ms.setdefault(path, []).append(median_spread(trial_times(
            sv.score_pretransposed, qx, wT, sc, W2, device=dev, trials=3,
            iters=10))[0])
    del qT, wT, q2, w2, key2, plain2, trap, qT_wide
    say(f"[7 bench kernels] S1: {len(sv.VARIANTS)} variants on {P1} planted "
        f"pairs x {L1} x {W1} equal the plain version bit for bit (plain "
        f"{s1_plain_ms:.1f} ms); S2 raw key on {P2} pairs x {L2} x {W2} equals "
        f"the plain version bit for bit (plain {s2_plain_ms:.1f} ms; a pair "
        f"with no positive cell keys {none_key}), also on 4096 pairs with "
        f"codes 4 == 4, -1, 256 against 0 and 1000 (and 256 and -1 in w "
        f"only), and on all {P2} pairs with one code a pair outside 0..126; "
        f"256 pairs each equal the NumPy oracle")
    say(f"    S2 kernel only on {P2} x {L2} x {W2}, median of 3 trials of 10 "
        f"calls, twice each: byte compare path "
        + ", ".join(f"{t:.3f}" for t in s2_path_ms["byte"])
        + " ms; 32-bit compare path (every block) "
        + ", ".join(f"{t:.3f}" for t in s2_path_ms["32-bit"])
        + f" ms [{card}]")
    say(f"    strip-kernel resident blocks per SM at L={L1} (shared memory a "
        f"block, registers a thread; {props.shared_memory_per_multiprocessor}"
        f" B shared memory an SM): " + ", ".join(
            f"{v.name} {occ[v.name][0]} x {v.warps} warps ({v.smem_bytes(L1)}"
            f" B, {occ[v.name][1]} regs)" for v in sv.VARIANTS)
        + f"; S2 {sv.S2_VARIANT.name} "
        f"{kernel_regs[sv.S2_VARIANT.kernel('S2Load', 'RawKeyOut')]} regs")

    # ---- 8. the bench path: each entry point once, launches counted --------
    def counted(run):
        sw_cuda.reset_launches()
        sv.reset_launches()
        res = run(device=dev, out=lambda *a: say("    " + " ".join(a)))
        torch.cuda.synchronize()
        return res, {**sw_cuda.LAUNCHES, **sv.LAUNCHES}

    say("[8 bench path] python -m rambl_tpu_torch.bench")
    bench_line, bench_n = counted(tbench.run)
    say("    " + json.dumps(bench_line))
    if not (bench_line["e2e_wall_s"] > 0 and bench_line["genes_per_hour"] > 0):
        raise AssertionError(f"bench's end-to-end assembly: {bench_line}")
    say("[8 bench path] python -m rambl_tpu_torch.scripts.bench_sw_variants")
    sweep, sweep_n = counted(bench_sw_variants.run)
    say("[8 bench path] python -m rambl_tpu_torch.scripts.ablate_prep")
    abl, abl_n = counted(ablate_prep.run)
    for what, n_run, keys in (("bench", bench_n, ("score", "align")),
                              ("bench_sw_variants", sweep_n,
                               ("score", "variant")),
                              ("ablate_prep", abl_n,
                               ("score", "pretransposed"))):
        for k in keys:
            if n_run[k] <= 0:
                raise AssertionError(f"{what}: kernel {k} never launched")
        say(f"    launches in {what}: {n_run}")
    res1 = sweep["results"]
    best_v = min((k for k in res1 if k != "prod-K1"),
                 key=lambda k: res1[k]["ms"])
    say(f"    S1's best variant {best_v} {res1[best_v]['ms']:.3f} ms against "
        f"prod-K1 {res1['prod-K1']['ms']:.3f} ms on the same "
        f"{P1} x {L1} x {W1}; S2 kernel only {abl['kernel_only']['ms']:.3f} "
        f"ms against full K1 {abl['full']['ms']:.3f} ms on {P2} x {L2} x "
        f"{W2} [{card}]")

    # ---- 9. K4 against the plain rotation, bit for bit ----------------------
    import dataclasses

    from rambl_tpu_torch.parallel import ring as tring
    from rambl_tpu_torch.parallel import ring_dma
    from rambl_tpu_torch.parallel.mesh import data_mesh, put_sharded
    from rambl_tpu_torch.parallel.steps import make_align_bin_step
    from rambl_tpu_torch.utils.ring_cases import TUPLE_CASES, ring_tuples

    def ring_arrays(seed, n, words=1_000_003, rows=77_777):
        """Per-rank (flat int32 of an odd word count, (rows, 3) int32)."""
        g = np.random.default_rng(seed)
        a = g.integers(-2**31, 2**31 - 1, (n, words),
                       dtype=np.int64).astype(np.int32)
        b = g.integers(-1, 1 << 20, (n, rows, 3)).astype(np.int32)
        return a, b, [tuple(on_card(a[r], b[r])) for r in range(n)]

    def rotate(mesh, state, impl):
        mesh.fork()
        got = ring_dma.ring_rotate(state, mesh, impl)
        mesh.join()
        return got

    err["ring"] = 0
    for n in (2, 4):
        mesh = data_mesh(devices=[dev] * n)
        a, b, state = ring_arrays(17 + n, n)
        want = rotate(mesh, state, "ppermute")
        for r in range(n):
            np.testing.assert_array_equal(np.roll(a, 1, 0)[r],
                                          want[r][0].cpu().numpy())
            np.testing.assert_array_equal(np.roll(b, 1, 0)[r],
                                          want[r][1].cpu().numpy())
        for impl in ("dma", "dma_barrier"):
            got = rotate(mesh, state, impl)
            torch.cuda.synchronize()
            ring_dma.check_ring(mesh)
            for g, w in zip(got, want):
                err["ring"] = max(err["ring"], require_equal(
                    f"K4 {impl} at {n} ranks", g, w))
    # tuples of 1 to 4 arrays in one launch a rank (utils.ring_cases)
    mesh = data_mesh(devices=[dev] * 3)
    for words, misalign in TUPLE_CASES:
        for impl in ("dma", "dma_barrier"):
            host, state, out = ring_tuples(dev, 3, len(words), words,
                                           misalign)
            before = ring_dma.LAUNCHES["ring"]
            mesh.fork()
            got = ring_dma.ring_rotate(state, mesh, impl, out=out)
            mesh.join()
            torch.cuda.synchronize()
            ring_dma.check_ring(mesh)
            if ring_dma.LAUNCHES["ring"] != before + 3:
                raise AssertionError("K4 is one launch a rank a rotation")
            for r in range(3):
                for a_, x in enumerate(got[r]):
                    np.testing.assert_array_equal(
                        host[(r - 1) % 3][a_], x.cpu().numpy(),
                        err_msg=f"K4 {impl} words={words} rank {r}")
    n_rep, T = 4, 64
    mesh = data_mesh(devices=[dev] * n_rep)
    a, b, _ = ring_arrays(23, n_rep)
    w_a = torch.arange(1, a.shape[1] + 1, dtype=torch.int64, device=dev)
    w_b = torch.arange(1, b[0].size + 1, dtype=torch.int64, device=dev)
    want_sums = np.stack([(a.astype(np.int64) * np.arange(1, a.shape[1] + 1))
                          .sum(1),
                          (b.reshape(n_rep, -1).astype(np.int64)
                           * np.arange(1, b[0].size + 1)).sum(1)], 1)
    for impl in ("dma", "dma_barrier"):
        state = [tuple(on_card(a[r], b[r])) for r in range(n_rep)]
        spare = [tuple(torch.empty_like(x) for x in st_) for st_ in state]
        sums = []
        mesh.fork()
        for _ in range(T):
            out = ring_dma.ring_rotate(state, mesh, impl, out=spare)
            spare, state = state, out
            for r in range(n_rep):
                with mesh.rank(r):        # a reader of the shard, as a probe
                    sums.append(torch.stack([
                        (state[r][0].long() * w_a).sum(),
                        (state[r][1].reshape(-1).long() * w_b).sum()]))
        mesh.join()
        torch.cuda.synchronize()
        ring_dma.check_ring(mesh)
        got = torch.stack(sums).cpu().numpy().reshape(T, n_rep, 2)
        for t in range(T):
            np.testing.assert_array_equal(np.roll(want_sums, t + 1, 0), got[t],
                                          err_msg=f"K4 {impl} rotation {t}")
        for r in range(n_rep):
            np.testing.assert_array_equal(np.roll(a, T, 0)[r],
                                          state[r][0].cpu().numpy())
    del state, spare, want, got, out
    say(f"[9 ring kernel] K4 dma and dma_barrier at 2 and 4 virtual ranks on "
        f"{a.shape[1]} + {b[0].size} words a rank equal the plain rotation "
        f"bit for bit; {len(TUPLE_CASES)} tuples of 1 to 4 arrays (odd counts, "
        f"unaligned views) arrive bit for bit in one launch a rank; {T} "
        f"consecutive rotations on persistent buffers at "
        f"{n_rep} ranks: every rank's shard equals np.roll of the host copy "
        f"after every rotation")

    # ---- 10. the mesh stream: config 4 on 4 virtual ranks ------------------
    n_ranks = 4
    cfg4 = dataclasses.replace(PRESETS["cohort"], ring_impl="dma")
    B4 = cfg4.batch_size
    t0 = time.perf_counter()
    ds4 = simulate_dataset(n_species=COHORT_REFS // 5, refs_per_species=5,
                           n_reads=N_READS, seed=13, leaf_per_ref=True,
                           n_present=500)
    ds4_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index4 = build_seed_index(ds4.ref_seqs, ds4.ref_lens, k=cfg4.k)
    index4_s = time.perf_counter() - t0
    tables4 = build_taxonomy_tables(ds4.tax_parent, ds4.tax_depth,
                                    ds4.ref_taxon)
    col4 = build_col_maps(ds4.ref_seqs, ds4.ref_lens, ds4.ref_taxon)
    mesh4 = data_mesh(devices=[dev] * n_ranks)
    # the shards are set-up, built once and passed in (a cohort's samples
    # share them): the stream's wall below holds none of this
    t0 = time.perf_counter()
    host_shards = tring.build_ring_shards(index4, n_ranks)
    shard_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards4 = tring.RingShards(host_shards, mesh4)
    torch.cuda.synchronize()
    shard_up_s = time.perf_counter() - t0
    del host_shards
    shard_bytes = sum(x.numel() * x.element_size()
                      for st_ in shards4.state for x in st_)
    say(f"[10 mesh] config 4 ('cohort', ring_impl=dma, batch {B4}): "
        f"{ds4.ref_seqs.shape[0]} refs x {ds4.ref_seqs.shape[1]} cols, "
        f"{tables4.n_nodes} taxonomy nodes, index {index4.n_entries} entries "
        f"in 2^{index4.n_bits} buckets (dataset {ds4_s:.1f} s, index "
        f"{index4_s:.1f} s on the host); mesh {mesh4} = {n_ranks} virtual "
        f"ranks on cuda:0; {shard_bytes} B of shards built on the host in "
        f"{shard_build_s:.2f} s and uploaded in {shard_up_s:.2f} s")

    def run_mesh(n_reads, cfg_=cfg4, d=ds4, idx=index4, tab=tables4,
                 cm=col4, **kw):
        return stream_align(d.reads[:n_reads], d.read_lens[:n_reads], idx,
                            d.ref_seqs, d.ref_lens, tab, cfg_, col_maps=cm,
                            **kw)

    run_mesh(2 * B4, mesh=mesh4, ring_shards=shards4)    # warm-up: 2 batches
    torch.cuda.synchronize()
    gapped.clear()
    talign.sw_align_traceback_cuda = counting_tb
    sw_cuda.reset_launches()
    ring_dma.reset_launches()
    t0 = time.perf_counter()
    mm, mcounts, mspan, mrc = run_mesh(N_READS, mesh=mesh4,
                                       ring_shards=shards4)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_launches = {**sw_cuda.LAUNCHES, **ring_dma.LAUNCHES}
    talign.sw_align_traceback_cuda = real_tb
    if mesh_launches["align"] != len(gapped):
        raise AssertionError(f"K2+K3 launched {mesh_launches['align']} times "
                             f"in the mesh stream, not once for each of the "
                             f"{len(gapped)} rank batches with gapped reads")
    for k, v in mesh_launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in the mesh "
                                 "stream")
    # one K4 launch a rank a rotation, 2 strands x n_ranks rotations a batch
    want_k4 = -(-N_READS // B4) * 2 * n_ranks * n_ranks
    if mesh_launches["ring"] != want_k4:
        raise AssertionError(f"K4 launched {mesh_launches['ring']} times in "
                             f"the mesh stream, not {want_k4}")
    t0 = time.perf_counter()
    one, ocounts, ospan, orc = run_mesh(N_READS, device=dev)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    for k in ("bins", "score", "ref", "strand"):
        for r in range(n_ranks):
            if not torch.equal(one[k], mm[k][r]):
                raise AssertionError(f"mesh {k} (rank {r}) differs from the "
                                     "single-device stream")
    nb4, bl4, L4 = mm["query"][0].shape
    for k in ("query", "ref_col"):
        flat = torch.cat(mm[k], dim=1).reshape(nb4 * B4, L4)[:N_READS]
        if not torch.equal(one[k], flat):
            raise AssertionError(f"mesh retention {k} differs from the "
                                 "single-device stream")
    bins_sh = torch.cat(mm["bins_sh"], dim=1).reshape(-1)[:N_READS]
    if not torch.equal(bins_sh, one["bins"]):
        raise AssertionError("mesh bins retention differs")
    for r in range(n_ranks):
        if not torch.equal(orc, mrc[r]):
            raise AssertionError("mesh read_count differs")
    slot_mode = tables4.n_nodes > cfg4.pileup_slot_nodes
    if slot_mode and not (mcounts is mspan is ocounts is ospan is None):
        raise AssertionError("slot mode returns no dense accumulators")
    orc4 = align_reads(ds4.reads[:n_or], ds4.read_lens[:n_or], ds4.ref_seqs,
                       index4, cfg4)
    R4, RL4 = ds4.ref_seqs.shape
    proj4 = np.where(orc4.ref_col >= 0,
                     col4[np.clip(orc4.ref, 0, R4 - 1)[:, None],
                          np.clip(orc4.ref_col, 0, RL4 - 1)], -1)
    for k, want in (("score", orc4.score), ("ref", orc4.ref),
                    ("strand", orc4.strand)):
        np.testing.assert_array_equal(
            want.astype(np.int64),
            mm[k][0][:n_or].cpu().numpy().astype(np.int64),
            err_msg=f"mesh oracle {k}")
    np.testing.assert_array_equal(
        proj4, torch.cat(mm["ref_col"], dim=1).reshape(-1, L4)[:n_or]
        .cpu().numpy().astype(np.int64), err_msg="mesh oracle ref_col")
    aligned4 = float((one["ref"] >= 0).float().mean())
    binned4 = float((one["bins"] >= 0).float().mean())
    del one, ocounts, ospan, orc
    say(f"[10 mesh] {N_READS} reads in {nb4} batches of {B4} ({bl4} a rank): "
        f"launches {mesh_launches} (K4: {nb4} batches x {2 * n_ranks} "
        f"rotations x {n_ranks} ranks, one launch each); {aligned4 * 100:.2f}% aligned, "
        f"{binned4 * 100:.2f}% binned; "
        f"{'slot mode (read_count merged only)' if slot_mode else 'dense'}; "
        f"retention in stream order, small vectors and read_count "
        f"equal the single-device stream bit for bit; first {n_or} reads "
        f"equal the NumPy oracle")

    # config 2's dense pileup through the same mesh, positions sharded; this
    # stream builds its own shards
    n_d = 4 * B
    cfg_d = dataclasses.replace(cfg, shard_index=True, ring_impl="dma",
                                shard_positions=True)
    dm, dcounts, dspan, drc = run_mesh(n_d, cfg_d, ds, index, tables,
                                       col_maps, mesh=mesh4)
    d1, d1counts, d1span, d1rc = run_mesh(n_d, cfg, ds, index, tables,
                                          col_maps, device=dev)
    torch.cuda.synchronize()
    if not (torch.equal(d1counts, torch.cat(dcounts, dim=1))
            and all(torch.equal(d1span, x) for x in dspan)
            and all(torch.equal(d1rc, x) for x in drc)):
        raise AssertionError("config 2 mesh pileup differs from the "
                             "single-device stream")
    nbd, _, Ld = dm["query"][0].shape
    for k in ("query", "ref_col"):
        if not torch.equal(d1[k], torch.cat(dm[k], dim=1).reshape(
                nbd * B, Ld)[:n_d]):
            raise AssertionError(f"config 2 mesh retention {k} differs")
    ring_dma.check_ring(mesh4)
    del dm, dcounts, dspan, drc, d1, d1counts, d1span, d1rc
    say(f"[10 mesh] config 2, {n_d} reads, shard_positions on the same mesh: "
        f"counts (column slices), span_diff, read_count and retention equal "
        f"the single-device dense stream bit for bit")

    # ---- 11. mesh timings ----------------------------------------------------
    card = card_line(dev)
    # what each stream uploads before its first batch, timed apart
    t0 = time.perf_counter()
    st4 = StreamTables.from_host(ds4.ref_seqs, tables4, col4, dev)
    torch.cuda.synchronize()
    tables_up_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table4 = SeedTable.from_index(index4, dev)
    torch.cuda.synchronize()
    table_up_s = time.perf_counter() - t0
    del table4
    # the device's busy share of the stream alone (shards and ref tables
    # uploaded before it and passed in), and where its device time goes
    n_prof4 = 8 * B4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof4:
        t0 = time.perf_counter()
        run_mesh(n_prof4, mesh=mesh4, ring_shards=shards4,
                 stream_tables=[st4] * n_ranks)
        torch.cuda.synchronize()
        prof4_s = time.perf_counter() - t0
    busy4_ms = busy_ms_of(prof4)
    on_dev4 = device_ops(prof4)
    step4 = make_align_bin_step(mesh4, cfg4, index4.n_bits, ring=True)
    rb4 = put_sharded(ds4.reads[:B4], mesh4)
    lb4 = put_sharded(ds4.read_lens[:B4], mesh4)
    batch_trials = trial_times(step4, rb4, lb4, shards4, [st4] * n_ranks,
                               device=dev, trials=3, iters=5)
    mesh_batch_ms, batch_spread = median_spread(batch_trials)

    def rot(impl):
        mesh4.fork()
        shards4.rotate(impl)
        mesh4.join()

    def copies():
        for r in range(n_ranks):
            for x, o in zip(shards4.state[r], shards4.spare[(r + 1) % n_ranks]):
                o.copy_(x)

    for impl in ("dma", "dma_barrier"):       # at the path's shapes
        before = [tuple(x.clone() for x in st_) for st_ in shards4.state]
        rot(impl)
        want4 = rotate(mesh4, before, "ppermute")
        torch.cuda.synchronize()
        ring_dma.check_ring(mesh4)
        for g, w in zip(shards4.state, want4):
            err["ring"] = max(err["ring"], require_equal(
                f"K4 {impl} on the path's shards", g, w))
        del before, want4
    k4 = {}
    for impl in ("ppermute", "dma", "dma_barrier", "copy_"):
        fn, args = (copies, ()) if impl == "copy_" else (rot, (impl,))
        k4[impl] = cuda_time(fn, *args, iters=20)
    torch.cuda.synchronize()
    ring_dma.check_ring(mesh4)
    nb_prof4 = n_prof4 // B4
    say(f"[11 mesh timings] card: {card}")
    say(f"    mesh stream: {mesh_s:.3f} s wall for {N_READS} reads = "
        f"{N_READS / mesh_s:.0f} reads/s on {n_ranks} virtual ranks of one "
        f"card (host clock; shards passed in, built and uploaded apart; H2D "
        f"of the reads and the ref tables included, the tables' upload "
        f"{tables_up_s:.3f} s alone); the single-device stream of the same "
        f"reads and index {single_s:.3f} s = {N_READS / single_s:.0f} "
        f"reads/s (its seed table's upload, {table_up_s:.3f} s alone, "
        f"included) [{card}]")
    say(f"    one batch of {B4} (4 ranks: ring seeding, align, bin; CUDA "
        f"events over 5 calls, host gaps included): {mesh_batch_ms:.3f} ms, "
        f"median of 3 trials ("
        + ", ".join(f"{t:.3f}" for t in batch_trials)
        + f" ms, spread {batch_spread:.1f}%) [{card}]")
    say(f"    profiled mesh stream of {n_prof4} reads (shards and ref tables "
        f"passed in): "
        f"{prof4_s * 1e3:.1f} ms wall, device busy {busy4_ms:.1f} ms (union "
        f"of device intervals) = busy {100 * busy4_ms / (prof4_s * 1e3):.1f}%"
        f", {busy4_ms / nb_prof4:.3f} ms a batch; host-to-device copies "
        + ", ".join(f"{e.key} {e.self_device_time_total / 1e3 / nb_prof4:.3f}"
                    f" ms over {e.count / nb_prof4:.1f} a batch"
                    for e in on_dev4 if "HtoD" in e.key)
        + f" [{card}]")
    say("      device time by kernel, summed over the rank streams (which "
        "overlap, so the sum may exceed the wall):")
    for e in on_dev4[:10]:
        say(f"      {e.self_device_time_total / 1e3 / nb_prof4:8.3f} ms/batch "
            f"{e.count / nb_prof4:7.1f} calls/batch  {e.key[:90]}")
    say(f"    K4 one rotation of the path's shards ({n_ranks} launches, one "
        f"a rank of 2 arrays, {shard_bytes} B in all; copies within one "
        f"card's HBM, not "
        f"NVLink; dma and dma_barrier equal the plain rotation bit for bit "
        f"on them): dma {k4['dma']:.3f} ms, dma_barrier "
        f"{k4['dma_barrier']:.3f} ms; plain rotation (ppermute) "
        f"{k4['ppermute']:.3f} ms; the {2 * n_ranks} bare copy_ calls "
        f"{k4['copy_']:.3f} ms; bound "
        f"{2 * shard_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes) [{card}]")
    del shards4, rb4, lb4, st4

    # ---- 12. round 0 of the assembly ---------------------------------------
    phase_round(dev, ds, index, tables, col_maps, cfg,
                (merged, counts, span_diff, read_count), card)
    del merged, counts, span_diff, read_count

    # ---- 13. the whole assembly ---------------------------------------------
    asm = phase_assembly(dev, ds, tables, cfg, card, oracles)
    asm_launches = asm["launches"]

    # ---- 14. the assembly on a mesh -----------------------------------------
    phase_mesh(dev, ds, index, tables, col_maps, cfg, card, asm)
    del asm

    # ---- 15. the scale ladder at cut depth ---------------------------------
    keep = phase_ladder(dev, ds, ds4, index4, card)

    # ---- 16. the entry hooks and the card tools ---------------------------
    phase_tools(dev, ds4, index4, card)

    # ---- 17. the diagnostics ------------------------------------------------
    phase_diagnostics(dev, ds4, keep, card)
    del keep

    peak = int32_ops_per_s(dev)
    n_path = PAIRS
    # the walk reads one direction code a step, and no others
    _, tie, tje, tdirs = tsw.sw_align(qt[:, :ROWS], wt, sc)
    k3_steps = int(tsw.sw_traceback(tdirs, tie, tje, L, W,
                                    return_steps=True)[1].sum())
    _, tie, tje, tdirs = tsw.sw_align(qg[:, :ROWS], wg, sc)
    full_steps = int(tsw.sw_traceback(tdirs, tie, tje, L, W,
                                      return_steps=True)[1].sum())
    del tdirs

    def k23_bound(n, steps, per_cell=OPS_PER_CELL_DIRS):
        # q and w in, 12 B and the ref_col row out a pair; the direction
        # codes stay on chip
        return bound(per_cell * n * ROWS * W + OPS_PER_TRACE_STEP * steps,
                     n * (L + W) + 12 * n + 4 * n * L, peak)

    bounds = {
        "K1": bound(OPS_PER_CELL * n_path * ROWS * W,
                    n_path * (L + W) + 12 * n_path, peak),
        "K2+K3": k23_bound(n_tb, k3_steps),
        "S1": bound(OPS_PER_CELL * P1 * L1 * W1, P1 * (L1 + W1) + 12 * P1,
                    peak),
        # S2's byte path, plus the range test of its staging: two a code
        "S2": bound(OPS_PER_CELL * P2 * L2 * W2 + 2 * P2 * (L2 + W2),
                    4 * P2 * (L2 + W2 + 1), peak),
        # every shard word read once and written once; no arithmetic
        "K4": bound(0, 2 * shard_bytes, peak),
    }
    say(f"[8 bench path] bounds at {peak / 1e12:.2f} T INT32 op/s and "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {OPS_PER_CELL} operations a cell "
        f"of K1's function (packed 16-bit: an instruction serves two cells; "
        f"at the {OPS_PER_CELL_32} of scalar 32-bit arithmetic K1's bound "
        f"would be "
        f"{bound(OPS_PER_CELL_32 * n_path * ROWS * W, 0, peak)[0]:.4f} ms) "
        f"(K2+K3: {n_tb} pairs, {k3_steps} walk steps, {OPS_PER_CELL_DIRS} "
        f"operations a cell; at {OPS_PER_CELL_DIRS_32} "
        f"{k23_bound(n_tb, k3_steps, OPS_PER_CELL_DIRS_32)[0]:.4f} ms): "
        + ", ".join(f"{k} {ms:.4f} ms ({by})"
                    for k, (ms, by) in bounds.items())
        + f"; K2+K3 at {qg.shape[0]} pairs ({full_steps} walk steps) "
        f"{k23_bound(qg.shape[0], full_steps)[0]:.4f} ms (at "
        f"{OPS_PER_CELL_DIRS_32}: "
        f"{k23_bound(qg.shape[0], full_steps, OPS_PER_CELL_DIRS_32)[0]:.4f}),"
        f" timed {k23[qg.shape[0]][0]:.4f} ms [{card}]")

    src = "rambl_tpu_torch/csrc/sw.cu"
    src_v = "rambl_tpu_torch/csrc/sw_variants.cu"

    def row(name, source, replaces, launched, error, ms, plain_ms, which):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": error, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
                "library_ms": None}

    kernels = [
        row("sw_score (K1)", src, "rambl_tpu/ops/sw_pallas.py:75",
            asm_launches["score"], err["score"], k1[ROWS][0], k1[ROWS][1],
            "K1"),
        {**row("sw_align_traceback (K2+K3)", src,
               "rambl_tpu/ops/sw_pallas.py:150 and "
               "rambl_tpu/ops/sw_pallas.py:317",
               asm_launches["align"], err["align"], k23[n_tb][0],
               k23[n_tb][3], "K2+K3"),
         "device_ms": k23[n_tb][1]},
        row(f"sw_strip_score (S1, {best_v})", src_v,
            "scripts/bench_sw_variants.py:48", sweep_n["variant"],
            err["variant"], sweep["results"][best_v]["ms"], s1_plain_ms, "S1"),
        row("sw_pretransposed (S2)", src_v, "scripts/ablate_prep.py:47",
            abl_n["pretransposed"], err["pretransposed"],
            abl["kernel_only"]["ms"], s2_plain_ms, "S2"),
        {**row("ring_copy (K4, one rotation of 4 virtual ranks' shards)",
               "rambl_tpu_torch/csrc/ring.cu",
               "rambl_tpu/parallel/ring_dma.py:63", mesh_launches["ring"],
               err["ring"], k4["dma"], k4["ppermute"], "K4"),
         "library_ms": k4["copy_"]},
    ]
    for k in kernels:
        if k["ms"] < k["bound_ms"]:
            raise AssertionError(f"{k['name']}: {k['ms']:.4f} ms is below "
                                 f"its bound of {k['bound_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_oracles()
    sys.exit(0)
