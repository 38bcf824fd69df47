"""Utilities of the port."""

from rambl_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from rambl_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
