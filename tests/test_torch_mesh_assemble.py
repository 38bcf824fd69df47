"""The port's whole assembly on a mesh == the JAX reference, bit for bit.

`rambl_tpu_torch.pipeline.assemble.assemble(mesh=data_mesh(devices=["cpu"]
* n))` on tests/test_distributed.py's end-to-end problem (the dataset of
tests/test_assembly_parity.py: 400 reads, 6 refs, batch 128, 2 iterations,
polish on) in three of the reference's mesh modes: a replicated index, a
ring-sharded index (`shard_index`, the plain rotation on CPU ranks) and
position-sharded pileups (`shard_positions`), each on another number of
ranks, since the outputs do not depend on the mesh's size. Each equals the
JAX package's single-device `assemble_jax` (which tests/test_distributed.py
holds equal to its mesh runs): n_rounds, converged, every round's stats,
the pre-polish panel, polish's `changed` and every final gene. Slot mode,
resume across mesh and one device, the cohort and `--mesh`:
tests/test_torch_mesh_resume.py and tests/test_torch_mesh_cohort.py.
Everything is integer: no tolerance.
"""

import pytest
from test_torch_assemble import (
    PARITY,
    args_of,
    check_result,
    jax_dense,
    one_thread,
    tiny,
)

from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["jax_dense", "one_thread", "tiny"]   # fixtures of that module

MODES = {
    # name: (ranks, config fields)
    "replicated": (4, {}),
    "shard_index": (2, dict(shard_index=True)),
    "shard_positions": (8, dict(shard_positions=True)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_assemble_on_a_mesh(tiny, jax_dense, mode):
    n, extra = MODES[mode]
    got = tassemble.assemble(*args_of(*tiny), TConfig(**PARITY, **extra),
                             mesh=tmesh.data_mesh(devices=["cpu"] * n))
    check_result(jax_dense, got)
    assert got.n_rounds == 2 and len(got.round_stats) == 3
