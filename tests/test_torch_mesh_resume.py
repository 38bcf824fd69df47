"""Slot mode and resume on a mesh: the port == the JAX reference, bit for
bit, and checkpoints cross between a mesh and one device.

On the dataset of tests/test_assembly_parity.py with pileup_slot_nodes=1
(slot-compacted accumulators, polish's slot path):

- `assemble(mesh=4 CPU ranks)` equals the JAX package's single-device
  `assemble_jax` (which tests/test_distributed.py holds equal to its mesh
  run): n_rounds, converged, round stats, panel, polish's `changed`, genes;
  its aux evidence is rank 0's host-fetchable slot accumulator;
- a run killed as round 1 starts leaves round 0's checkpoint and `.aux`
  sidecar; resumed on the other side (mesh -> one device with the sidecar,
  one device -> mesh without it, so polish re-streams round 0 on the mesh
  through `make_slot_pileup_step`) it reaches the same final genes.

No tolerance.
"""

import pytest
from test_torch_assemble import (
    PARITY,
    args_of,
    check_result,
    gene_fields,
    one_thread,
    round_fields,
    tiny,
)

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.utils.checkpoint import load_aux_evidence, load_checkpoint

__all__ = ["one_thread", "tiny"]      # fixtures shared with that module

SLOT = dict(PARITY, pileup_slot_nodes=1)


def _mesh():
    return tmesh.data_mesh(devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def jax_slot(tiny):
    return jassemble.assemble_jax(*args_of(*tiny), JConfig(**SLOT))


def test_assemble_slot_on_a_mesh(tiny, jax_slot):
    aux = {}
    got = tassemble.assemble(*args_of(*tiny), TConfig(**SLOT), aux_out=aux,
                             mesh=_mesh())
    check_result(jax_slot, got)
    counts, node2slot = aux["slot_counts"]
    assert list(aux) == ["slot_counts"] and counts.shape[0] % 64 == 0
    assert int((node2slot >= 0).sum()) <= counts.shape[0]


class Killed(RuntimeError):
    pass


@pytest.mark.parametrize("first,then,with_aux",
                         [("mesh", "one", True), ("one", "mesh", False)],
                         ids=["mesh_then_one", "one_then_mesh"])
def test_resume_across_mesh_and_one_device(tiny, jax_slot, tmp_path,
                                           monkeypatch, first, then,
                                           with_aux):
    cfg = TConfig(**SLOT)
    where = {"mesh": dict(mesh=_mesh()), "one": dict(device="cpu")}
    ck = str(tmp_path / "panel.ckpt")
    real_round = tassemble.assemble_round
    calls = {"n": 0}

    def dying_round(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:          # round 0 done, round 1 starting
            raise Killed()
        return real_round(*a, **kw)

    monkeypatch.setattr(tassemble, "assemble_round", dying_round)
    with pytest.raises(Killed):
        tassemble.assemble(*args_of(*tiny), cfg, checkpoint_path=ck,
                           **where[first])
    monkeypatch.setattr(tassemble, "assemble_round", real_round)

    header, panel = load_checkpoint(ck)
    aux = load_aux_evidence(ck + ".aux", cfg)
    assert header["round"] == 0 and list(aux) == ["slot_counts"]
    assert len(panel) == jax_slot.round_stats[0]["genes"] > 0
    got = tassemble.assemble(*args_of(*tiny), cfg, initial_panel=panel,
                             initial_aux=aux if with_aux else None,
                             **where[then])
    assert got.round_stats[0]["aux_restored"] is with_aux
    assert (got.n_rounds, got.converged) == (jax_slot.n_rounds,
                                             jax_slot.converged)
    assert round_fields(got)[1:] == round_fields(jax_slot)[1:]
    assert gene_fields(got.panel) == gene_fields(jax_slot.panel)
    assert got.round_stats[-1]["changed"] == jax_slot.round_stats[-1][
        "changed"]
    assert gene_fields(got.genes) == gene_fields(jax_slot.genes)
