"""Mock-community simulator (copy of rambl_tpu.data.simulate)."""

from rambl_tpu_torch.data.simulate import (  # noqa: F401
    SimulatedDataset,
    simulate_dataset,
)
