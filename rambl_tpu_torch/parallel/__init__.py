"""Data parallelism over a mesh of ranks in one process (`mesh`, with the
multi-host setup), the ring-sharded seed index (`ring`) with its rotation
K4 (`ring_dma`), and the round's data-parallel steps (`steps`)."""

from rambl_tpu_torch.parallel.mesh import data_mesh  # noqa: F401
from rambl_tpu_torch.parallel.steps import make_align_pileup_step  # noqa: F401
