"""The port's whole assembly == the JAX reference in forced slot mode.

`assemble(device="cpu")` against `assemble_jax` with pileup_slot_nodes=1 on
the dataset of tests/test_assembly_parity.py, polish on and off: the round
keeps slot-compacted accumulators, and polish takes its evidence through
`leaf_counts_dict`'s slot path. Checks and dense mode:
tests/test_torch_assemble.py. No tolerance.
"""

import pytest
from test_torch_assemble import (
    PARITY,
    args_of,
    check_result,
    one_thread,
    tiny,
)

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.pipeline import assemble as jassemble
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.pipeline import assemble as tassemble

__all__ = ["one_thread", "tiny"]      # fixtures shared with that module

SLOT = dict(PARITY, pileup_slot_nodes=1)


@pytest.fixture(scope="module")
def jax_slot(tiny):
    return jassemble.assemble_jax(*args_of(*tiny), JConfig(**SLOT))


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "no_polish"])
def test_assemble_slot(tiny, jax_slot, polish):
    aux = {}
    got = tassemble.assemble(*args_of(*tiny), TConfig(**SLOT, polish=polish),
                             aux_out=aux, device="cpu")
    check_result(jax_slot, got, polished=polish)
    counts, node2slot = aux["slot_counts"]
    assert list(aux) == ["slot_counts"] and counts.shape[0] % 64 == 0
    assert int((node2slot >= 0).sum()) <= counts.shape[0]
