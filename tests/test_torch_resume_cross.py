"""Checkpoints cross packages: a checkpoint and `.aux` sidecar written by
`assemble_jax` resume in the port, and the port's resume in the JAX
package, to the same final genes.

On the dataset of tests/test_faults.py (three rounds allowed), both
packages run the whole assembly with per-round checkpoints: their results,
their final checkpoints (header, panel) and their sidecars' arrays are
equal; each package then resumes from the other's checkpoint with its
sidecar and reaches the other's final genes. No tolerance.
"""

import numpy as np
import pytest
from test_torch_assemble import gene_fields, one_thread, round_fields
from test_torch_resume import FAULTS, prob

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.pipeline.assemble import assemble_jax
from rambl_tpu.utils import checkpoint as jckpt
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.utils import checkpoint as tckpt

__all__ = ["one_thread", "prob"]      # fixtures shared with those modules


def args_of(prob):
    _, ds, tax = prob
    return ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax


@pytest.fixture(scope="module")
def both(prob, tmp_path_factory):
    d = tmp_path_factory.mktemp("cross")
    jck, tck = str(d / "jax.ckpt"), str(d / "torch.ckpt")
    jres = assemble_jax(*args_of(prob), JConfig(**FAULTS),
                        checkpoint_path=jck)
    tres = tassemble.assemble(*args_of(prob), TConfig(**FAULTS),
                              checkpoint_path=tck, device="cpu")
    return jres, jck, tres, tck


def test_runs_and_checkpoints_agree(both):
    jres, jck, tres, tck = both
    assert (tres.n_rounds, tres.converged) == (jres.n_rounds, jres.converged)
    assert round_fields(tres) == round_fields(jres)
    assert gene_fields(tres.genes) == gene_fields(jres.genes)
    jh, jp = jckpt.load_checkpoint(jck)
    th, tp = tckpt.load_checkpoint(tck)
    assert th == jh and th["fingerprint"] == tckpt.config_fingerprint(
        TConfig(**FAULTS)) == jckpt.config_fingerprint(JConfig(**FAULTS))
    assert gene_fields(tp) == gene_fields(jp) == gene_fields(jres.panel)
    with np.load(jck) as jz, np.load(tck) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)
    with np.load(jck + ".aux") as jz, np.load(tck + ".aux") as tz:
        assert sorted(jz.files) == sorted(tz.files) == ["header",
                                                        "node_counts"]
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype
            np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)


def test_port_resumes_a_jax_checkpoint(prob, both):
    jres, jck, _, _ = both
    cfg = TConfig(**FAULTS)
    header, panel = tckpt.load_checkpoint(jck)
    assert panel and all(type(g) is Gene for g in panel)
    aux = tckpt.load_aux_evidence(jck + ".aux", cfg)
    got = tassemble.assemble(*args_of(prob), cfg, initial_panel=panel,
                             initial_aux=aux, device="cpu")
    assert got.round_stats[0]["aux_restored"] is True and got.converged
    assert gene_fields(got.genes, born=False) == gene_fields(jres.genes,
                                                             born=False)


def test_jax_resumes_a_port_checkpoint(prob, both):
    jres, _, tres, tck = both
    cfg = JConfig(**FAULTS)
    header, panel = jckpt.load_checkpoint(tck)
    aux = jckpt.load_aux_evidence(tck + ".aux", cfg)
    got = assemble_jax(*args_of(prob), cfg, initial_panel=panel,
                       initial_aux=aux)
    assert got.round_stats[0]["aux_restored"] is True and got.converged
    assert gene_fields(got.genes, born=False) == gene_fields(tres.genes,
                                                             born=False)
