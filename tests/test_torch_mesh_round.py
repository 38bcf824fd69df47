"""The port's round on a mesh == the JAX package's, bit for bit.

`rambl_tpu_torch.pipeline.assemble.assemble_round(mesh=data_mesh(devices=
["cpu"] * 4))` against `assemble_round_jax(mesh=data_mesh(8))` on the 8 fake
CPU devices, on the dataset of tests/test_assembly_parity.py, dense and in
slot mode (pileup_slot_nodes=1): genes field by field, the round's stats,
and the round-0 evidence handed to aux_out (rank 0's replica: whole rows,
host-fetchable as on one device). The same round with shard_positions
(counts merged as column slices, then gathered once) gives the dense
round's genes and evidence. Everything is integer: no tolerance.
"""

import numpy as np
import pytest
from test_torch_round import BASE, _check_round, _genes, one_thread, tiny

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.parallel import mesh as jmesh
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["one_thread", "tiny"]     # the fixtures shared with that module

MODES = {"dense": {}, "slot": dict(pileup_slot_nodes=1)}


@pytest.fixture(scope="module")
def jax_rounds(tiny):
    ds, tax = tiny
    out = {}
    for mode, extra in MODES.items():
        aux = {}
        genes, stats = jassemble.assemble_round_jax(
            ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
            JConfig(**BASE, **extra), 0, aux_out=aux,
            mesh=jmesh.data_mesh(8))
        out[mode] = (genes, stats, aux)
    return out


def _mesh_round(tiny, fields):
    ds, tax = tiny
    aux = {}
    genes, stats = tassemble.assemble_round(
        ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
        TConfig(**fields), 0, aux_out=aux,
        mesh=tmesh.data_mesh(devices=["cpu"] * 4))
    return genes, stats, aux


@pytest.mark.parametrize("mode", list(MODES))
def test_assemble_round_on_a_mesh(tiny, jax_rounds, mode):
    _check_round(jax_rounds[mode], _mesh_round(tiny, dict(BASE,
                                                          **MODES[mode])))


def test_assemble_round_on_a_mesh_position_sharded(tiny, jax_rounds):
    genes, stats, aux = _mesh_round(tiny, dict(BASE, shard_positions=True))
    _check_round(jax_rounds["dense"], (genes, stats, aux))
    ds, tax = tiny
    assert tuple(aux["node_counts"].shape) == (tax.n_nodes,
                                               ds.ref_seqs.shape[1] * 4)
    assert _genes(genes) and np.asarray(aux["node_counts"]).sum() > 0
