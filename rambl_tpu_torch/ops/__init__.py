"""Device ops of the port: plain PyTorch twins (`sw`, `seed`) and the
hand-written CUDA kernels with their wrappers (`sw_cuda`, `sw_variants`,
`cluster_cuda`).
`seed_candidates` is the counterpart of the reference's
`seed_candidates_jax`."""

from rambl_tpu_torch.ops.seed import seed_candidates  # noqa: F401
from rambl_tpu_torch.ops.sw import (  # noqa: F401
    sw_align,
    sw_score,
    sw_traceback,
)
