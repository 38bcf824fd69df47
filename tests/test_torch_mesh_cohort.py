"""The cohort, polish's evidence and the command line on a mesh: the port ==
the JAX reference, bit for bit.

- `assemble_cohort(mesh=...)` on tests/test_torch_cohort.py's 2-sample
  cohort, with the shared index ring-sharded once over 3 CPU ranks
  (`shard_index`), equals the JAX package's `assemble_cohort` sample by
  sample (rounds, stats, panel, genes, phased genes included);
- `leaf_counts_dict(mesh=...)`'s re-stream of round 0 (dense with
  position-sharded counts, and slot mode) equals the reference's;
- `rambl_tpu_torch.cli assemble --device cpu --mesh 4` writes the FASTA that
  the same command without `--mesh` writes, and logs the mesh.

No tolerance.
"""

import json
import os

import numpy as np
import pytest
from test_torch_assemble import gene_fields, one_thread, round_fields
from test_torch_cli import CFG, sim
from test_torch_cohort import COHORT, cohort

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch import cli as tcli
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["cohort", "one_thread", "sim"]   # fixtures of those modules

assert CFG["batch_size"] % 4 == 0 and COHORT["batch_size"] % 3 == 0


def test_cohort_on_a_mesh(cohort):
    ref = jassemble.assemble_cohort(*cohort, JConfig(**COHORT))
    got = tassemble.assemble_cohort(
        *cohort, TConfig(**COHORT, shard_index=True),
        mesh=tmesh.data_mesh(devices=["cpu"] * 3))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert (g.n_rounds, g.converged) == (r.n_rounds, r.converged)
        assert round_fields(g) == round_fields(r)
        assert gene_fields(g.panel) == gene_fields(r.panel)
        assert gene_fields(g.genes) == gene_fields(r.genes)
    assert all(any(x.round_born == -1 for x in r.genes) for r in got)


@pytest.mark.parametrize("fields", [dict(shard_positions=True),
                                    dict(pileup_slot_nodes=1)],
                         ids=["dense_positions", "slot"])
def test_leaf_counts_dict_restream_on_a_mesh(cohort, fields):
    samples, ref_seqs, ref_lens, tax = cohort
    reads, lens = samples[0]
    taxa = np.unique(tax.ref_taxon)
    ref = jassemble.leaf_counts_dict(reads, lens, ref_seqs, ref_lens, tax,
                                     JConfig(**COHORT), taxa)
    got = tassemble.leaf_counts_dict(
        reads, lens, ref_seqs, ref_lens, tax, TConfig(**COHORT, **fields),
        taxa, mesh=tmesh.data_mesh(devices=["cpu"] * 4))
    assert sorted(got) == sorted(ref) == taxa.tolist()
    for t in ref:
        assert got[t].dtype == ref[t].dtype
        np.testing.assert_array_equal(ref[t], got[t], err_msg=str(t))
    assert sum(int(v.sum()) for v in got.values()) > 0


def test_cli_mesh_writes_the_same_fasta(sim):
    d, out = sim
    base = ["assemble", "--reads", os.path.join(out, "reads.fastq"),
            "--reference", os.path.join(out, "refs.fasta"), "--taxonomy",
            os.path.join(out, "taxonomy.tsv"), "--config",
            str(d / "cfg.json"), "--device", "cpu"]
    one, on_mesh, metrics = (str(d / "one.fasta"), str(d / "mesh.fasta"),
                             str(d / "mesh.jsonl"))
    assert tcli.main([*base, "--out", one]) == 0
    assert tcli.main([*base, "--out", on_mesh, "--mesh", "4",
                      "--metrics", metrics]) == 0
    text = open(one).read()
    assert text.startswith(">gene0|") and open(on_mesh).read() == text
    recs = [json.loads(x) for x in open(metrics)]
    assert [r["devices"] for r in recs if r["stage"] == "mesh"] == [4]
