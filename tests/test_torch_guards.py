"""Guards around the port: it stands alone, and never falls back quietly.

(a) `rambl_tpu_torch` streams reads, runs round 0, the whole assembly and
    the ladder's config-2 runner, and runs its bench with both jax and the
    JAX package `rambl_tpu` made
    unimportable, using only its own copies of the host layers; no file of
    the port and no line of `chip_smoke.py` imports `rambl_tpu`;
(b) `chip_smoke.py` fails in its first phase where there is no CUDA device,
    and also when it stands alone without the repository; the port's entry
    points raise where there is no card unless the caller asks for the CPU;
(c) the kernel tests that need the card skip here, with a reason.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_JAX = "import sys; sys.modules['jax'] = None; "
BLOCK_BOTH = BLOCK_JAX + "sys.modules['rambl_tpu'] = None; "


def _run(args, cwd=REPO, timeout=300, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one intra-op thread: the suite's other workers hold the cores, and an
    # oversubscribed torch runs these small CPU paths many times slower
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_streams_without_jax():
    code = BLOCK_BOTH + """
import numpy as np
import rambl_tpu_torch
from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.builder import build_seed_index
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.pipeline.assemble import stream_align
from rambl_tpu_torch.ops import sw_variants
from rambl_tpu_torch.scripts import ablate_prep, bench_sw_variants
from rambl_tpu_torch.ops import sw_cuda
from rambl_tpu_torch.utils import timing, sw_cases
from rambl_tpu_torch import graft_entry, io, oracle, utils
from rambl_tpu_torch.scripts import (bench_align_scale, check_ring_dma,
    profile_cluster)
assert rambl_tpu_torch.PipelineConfig is PipelineConfig and io.read_fasta
check_ring_dma.run(2, ("ppermute",), device="cpu", out=lambda *a: None)
ds = simulate_dataset(n_species=2, refs_per_species=2, n_reads=40, seed=3)
cfg = PipelineConfig(batch_size=32, sw_rows=104)
idx = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
merged, counts, span, rc = stream_align(ds.reads, ds.read_lens, idx,
    ds.ref_seqs, ds.ref_lens, tax, cfg, device="cpu")
assert merged["bins"].shape == (40,) and int(rc.sum()) > 0
import dataclasses, torch
from rambl_tpu_torch.parallel import mesh, ring, ring_dma, steps
m2 = stream_align(ds.reads, ds.read_lens, idx, ds.ref_seqs, ds.ref_lens, tax,
    dataclasses.replace(cfg, shard_index=True),
    mesh=mesh.data_mesh(devices=["cpu"] * 2))
assert torch.equal(m2[0]["bins"][1], merged["bins"])
from rambl_tpu_torch.oracle.pipeline import assemble_round as oracle_round
from rambl_tpu_torch.pipeline.assemble import assemble_round
genes, stats = assemble_round(ds.reads, ds.read_lens, ds.ref_seqs,
    ds.ref_lens, tax, cfg, device="cpu")
want, _ = oracle_round(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
    cfg, 0)
assert genes and [(g.key(), g.n_reads, g.leaf) for g in genes] == [
    (g.key(), g.n_reads, g.leaf) for g in want], (genes, want)
assert stats["genes"] == len(genes) and stats["aligned"] > 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "rambl_tpu")
            and sys.modules[m] is not None]
print("OK", int((merged["ref"] >= 0).sum()), len(genes))
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_port_assembles_without_jax():
    """The whole assembly (rounds, polish, a checkpoint) with jax and
    rambl_tpu unimportable, held to the port's NumPy oracle."""
    code = BLOCK_BOTH + """
import os, tempfile
from rambl_tpu_torch import cli
from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index import greengenes
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.io import loader
from rambl_tpu_torch.oracle import cohort
from rambl_tpu_torch.oracle.pipeline import assemble as oracle_assemble
from rambl_tpu_torch.pipeline.assemble import assemble
from rambl_tpu_torch.utils.checkpoint import load_checkpoint
ds = simulate_dataset(n_species=2, refs_per_species=2, n_reads=120, seed=3)
tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
cfg = PipelineConfig(batch_size=64, max_assembly_iters=2)
args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax, cfg)
ck = os.path.join(tempfile.mkdtemp(), "panel.ckpt")
got = assemble(*args, checkpoint_path=ck, device="cpu")
want = oracle_assemble(*args)
fields = lambda gs: [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon,
                      g.offset) for g in gs]
assert got.genes and fields(got.genes) == fields(want.genes)
assert (got.n_rounds, got.converged) == (want.n_rounds, want.converged)
assert fields(load_checkpoint(ck)[1]) == fields(got.panel)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "rambl_tpu")
            and sys.modules[m] is not None]
print("OK", len(got.genes), got.n_rounds)
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_ladder_runs_without_jax():
    """`run_config2.run(device="cpu")` at a tiny size (200 reads, batch
    128, two rounds) with jax and rambl_tpu unimportable."""
    code = BLOCK_BOTH + """
from rambl_tpu_torch.scripts import run_config2
out = run_config2.run(200, device="cpu", overrides=dict(
    batch_size=128, max_assembly_iters=2), out=lambda *a: None)
assert out["genes"] > 0 and out["result"].n_rounds == 2
assert [r["round"] for r in out["rounds"]] == [0, 1]
assert out["card"] == "cpu, host clock"
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "rambl_tpu")
            and sys.modules[m] is not None]
print("OK", out["genes"], out["recovered"])
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = _run(["-c", BLOCK_JAX + "import runpy; runpy.run_path("
              "'chip_smoke.py', run_name='__main__')"], timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert '"ok"' not in r.stdout and "[1 device]" not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, timeout=120)
    assert r.returncode != 0
    assert "ModuleNotFoundError" in r.stderr or "CUDA" in r.stderr
    assert '"ok"' not in r.stdout


def test_card_tests_skip_here_with_reason():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests run instead")
    r = _run(["-m", "pytest", "--noconftest", "-q", "-rs", "-p",
              "no:cacheprovider", "tests/test_torch_kernels_cuda.py"],
             env_extra={"PYTHONPATH": REPO})
    assert r.returncode == 0, r.stdout[-3000:]
    assert "174 skipped" in r.stdout and "passed" not in r.stdout
    assert "needs an NVIDIA GPU with CUDA" in r.stdout


def test_port_bench_runs_without_jax_or_rambl_tpu():
    code = BLOCK_BOTH + """
import json
from rambl_tpu_torch import bench
line = bench.run(device="cpu", n_reads=256, batch=128, pairs=128, trials=1,
                 batches=2, e2e_reads=120, e2e_batch=64,
                 out=lambda *a: print(*a, file=sys.stderr))
print(json.dumps(line))
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["metric"] == "reads_aligned_per_s_per_chip"
    assert line["device"]["platform"] == "cpu" and line["value"] > 0
    assert line["e2e_wall_s"] > 0 and line["genes_per_hour"] >= 0
    assert "parity: OK" in r.stderr and "e2e assembly:" in r.stderr


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_rambl_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rambl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("rambl_tpu", "jax")]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["bench", "bench_sw_variants",
                                   "ablate_prep", "stream_align", "data_mesh",
                                   "assemble_round", "assemble", "polish",
                                   "assemble_cohort", "cli_assemble",
                                   "build_scale_caches", "quality_bench",
                                   "run_config2", "run_config3",
                                   "run_config4", "run_config5",
                                   "graft_entry", "dryrun_multichip",
                                   "profile_cluster", "bench_align_scale",
                                   "check_ring_dma", "cache_config4_state",
                                   "census_config4"])
def test_entry_points_need_the_card_by_default(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run")
    from rambl_tpu_torch import bench, cli, graft_entry
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.oracle.pipeline import Gene
    from rambl_tpu_torch.parallel.mesh import data_mesh
    from rambl_tpu_torch.pipeline import assemble as asm
    from rambl_tpu_torch.scripts import (
        ablate_prep,
        bench_align_scale,
        bench_sw_variants,
        build_scale_caches,
        cache_config4_state,
        census_config4,
        check_ring_dma,
        profile_cluster,
        quality_bench,
        run_config2,
        run_config3,
        run_config4,
        run_config5,
    )

    reads, lens = np.zeros((0, 128), np.int8), np.zeros(0, np.int32)
    refs, ref_lens = np.zeros((1, 8), np.int8), np.ones(1, np.int32)
    cfg = PipelineConfig()
    gene = Gene(seq=np.zeros(8, np.int8), n_reads=3, leaf=1, cluster=0,
                round_born=0, taxon=1)
    if entry == "cli_assemble":
        assert cli.main(["simulate", "--out", str(tmp_path), "--species",
                         "1", "--strains", "1", "--reads", "5"]) == 0
    run = {
        "bench": bench.run, "bench_sw_variants": bench_sw_variants.run,
        "ablate_prep": ablate_prep.run, "data_mesh": data_mesh,
        "stream_align": lambda: asm.stream_align(reads, lens, None, refs,
                                                 ref_lens, None, cfg),
        "assemble_round": lambda: asm.assemble_round(reads, lens, refs,
                                                     ref_lens, None, cfg),
        "assemble": lambda: asm.assemble(reads, lens, refs, ref_lens, None,
                                         cfg),
        "polish": lambda: asm.polish(reads, lens, [gene], refs, ref_lens,
                                     None, cfg),
        "assemble_cohort": lambda: asm.assemble_cohort(
            [(reads, lens)] * 2, refs, ref_lens, None, cfg),
        "cli_assemble": lambda: cli.main([
            "assemble", "--reads", str(tmp_path / "reads.fastq"),
            "--reference", str(tmp_path / "refs.fasta"),
            "--out", str(tmp_path / "genes.fasta")]),
        # the ladder: each raises before it simulates or loads anything
        "build_scale_caches": lambda: build_scale_caches.main(
            ["--cache-dir", str(tmp_path)]),
        "quality_bench": quality_bench.run, "run_config2": run_config2.run,
        "run_config3": run_config3.run, "run_config4": run_config4.run,
        "run_config5": run_config5.run,
        # the entry hooks and the card tools: each raises before it builds
        # a toy problem, inputs or scale data
        "graft_entry": graft_entry.entry,
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(2),
        "profile_cluster": profile_cluster.run,
        "bench_align_scale": bench_align_scale.run,
        "check_ring_dma": check_ring_dma.run,
        # the config-4 state and census: each raises before it simulates
        # its cohort
        "cache_config4_state": cache_config4_state.run,
        "census_config4": lambda: census_config4.main([]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
