"""The port's command line, `rambl_tpu_torch.cli.main`, against the JAX
package's.

- `simulate` writes the same files, byte for byte, as the reference CLI's
  `cmd_simulate` (one sample, and a 2-sample cohort);
- `assemble --device cpu` on those files writes the FASTA that
  `assemble_jax`'s genes give on the same files and config, with the
  reference CLI's headers (`gene{i}|reads=…|taxon=…|len=…`); its metrics
  JSONL and its final checkpoint (the pre-polish panel) follow;
- `--mesh` with more cards than are visible, `--mesh` in a process group
  of more than one process, several `--reads` with `--checkpoint`, and a
  missing input are refused with exit code 2 (`--mesh` itself:
  tests/test_torch_mesh_cohort.py).
"""

import argparse
import filecmp
import json
import os

import pytest
import torch
from test_torch_assemble import gene_fields, one_thread

from rambl_tpu import cli as jcli
from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.io.fasta import read_fasta
from rambl_tpu.io.loader import load_fastq_codes
from rambl_tpu.io.pack import decode_seq, encode_batch
from rambl_tpu.pipeline.assemble import assemble_jax
from rambl_tpu_torch import cli as tcli
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.utils.checkpoint import load_checkpoint

__all__ = ["one_thread"]      # the fixture shared with that module

CFG = dict(max_assembly_iters=2, batch_size=128)
SIM = ["--species", "2", "--strains", "2", "--reads", "200", "--seed", "4"]


def _simulate_both(tmp_path, extra=()):
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert tcli.main(["simulate", "--out", mine, *SIM, *extra]) == 0
    ns = argparse.Namespace(out=ref, species=2, strains=2, reads=200, seed=4,
                            samples=1, db_refs="all")
    for flag, value in zip(extra[::2], extra[1::2]):
        setattr(ns, flag.lstrip("-").replace("-", "_"),
                int(value) if value.isdigit() else value)
    assert jcli.cmd_simulate(ns) == 0
    return mine, ref


@pytest.mark.parametrize("extra", [(), ("--samples", "2"),
                                   ("--db-refs", "anchors")],
                         ids=["one", "cohort", "anchors"])
def test_simulate_matches_the_reference_cli(tmp_path, extra):
    mine, ref = _simulate_both(tmp_path, extra)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names and len(names) >= 5
    match, mismatch, errors = filecmp.cmpfiles(ref, mine, names,
                                               shallow=False)
    assert mismatch == errors == [] and match == names


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = str(d / "mock")
    assert tcli.main(["simulate", "--out", out, *SIM]) == 0
    with open(d / "cfg.json", "w") as f:
        f.write(JConfig(**CFG).to_json())
    return d, out


def test_assemble_matches_assemble_jax(sim):
    d, out = sim
    files = dict(reads=os.path.join(out, "reads.fastq"),
                 reference=os.path.join(out, "refs.fasta"),
                 taxonomy=os.path.join(out, "taxonomy.tsv"))
    genes_fa, metrics, ck = (str(d / "genes.fasta"), str(d / "m.jsonl"),
                             str(d / "panel.ckpt"))
    rc = tcli.main(["assemble", "--reads", files["reads"], "--reference",
                    files["reference"], "--taxonomy", files["taxonomy"],
                    "--config", str(d / "cfg.json"), "--device", "cpu",
                    "--out", genes_fa, "--metrics", metrics,
                    "--checkpoint", ck])
    assert rc == 0

    # the reference on the same files: its loaders, assemble_jax, its headers
    cfg = JConfig(**CFG)
    refs = read_fasta(files["reference"])
    ref_seqs, ref_lens = encode_batch([s for _, s in refs], cfg.ref_len_max)
    reads, lens = load_fastq_codes(files["reads"], cfg.read_len_max)
    tables = jcli._load_taxonomy(files["taxonomy"], [n for n, _ in refs])
    res = assemble_jax(reads, lens, ref_seqs, ref_lens, tables, cfg)
    want = "".join(
        f">gene{i}|reads={g.n_reads}|taxon={g.taxon}|len={g.seq.shape[0]}\n"
        + "".join(decode_seq(g.seq)[k:k + 70] + "\n"
                  for k in range(0, g.seq.shape[0], 70))
        for i, g in enumerate(res.genes))
    assert res.genes and open(genes_fa).read() == want

    recs = [json.loads(x) for x in open(metrics)]
    done = [r for r in recs if r["stage"] == "done"]
    assert len(done) == 1 and done[0]["genes"] == len(res.genes)
    assert done[0]["rounds"] == res.n_rounds
    rounds = [r for r in recs if r["stage"] == "round"]
    assert [r["round"] for r in rounds] == [s["round"]
                                            for s in res.round_stats]
    header, panel = load_checkpoint(ck)
    assert header["round"] == res.n_rounds
    assert gene_fields(panel) == gene_fields(res.panel)
    assert os.path.exists(ck + ".aux")


def test_assemble_refusals(sim, capsys, monkeypatch):
    d, out = sim
    base = ["assemble", "--reference", os.path.join(out, "refs.fasta"),
            "--out", str(d / "no.fasta"), "--device", "cpu"]
    reads = os.path.join(out, "reads.fastq")
    # --mesh 2 on the cards of a machine with one visible card (the
    # reference's devices[:n] quietly takes fewer)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        assert tcli.main([*base[:-2], "--reads", reads, "--mesh", "2"]) == 2
    assert "a mesh of 2 cards asked for, 1 visible" in capsys.readouterr().err
    # a process group of two processes: a mesh across them is not ported
    with monkeypatch.context() as m:
        m.setattr(tmesh, "process_count", lambda: 2)
        assert tcli.main([*base, "--reads", reads, "--mesh", "2"]) == 2
    err = capsys.readouterr().err
    assert "a mesh across 2 processes is not ported" in err
    assert "ROADMAP item 15" in err
    assert tcli.main([*base, "--reads", reads, reads, "--checkpoint",
                      str(d / "c.ckpt")]) == 2
    assert "not supported with multi-sample" in capsys.readouterr().err
    assert tcli.main([*base, "--reads", str(d / "absent.fastq")]) == 2
    err = capsys.readouterr().err
    assert "file not found" in err and "absent" in err
    assert not os.path.exists(d / "no.fasta")
