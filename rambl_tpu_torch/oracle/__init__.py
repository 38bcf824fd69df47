"""Pure-NumPy oracle: the port's copy of the executable specification in
`rambl_tpu/oracle/` that the kernels and the align step are held against."""

from rambl_tpu_torch.oracle.sw import (  # noqa: F401
    sw_batch,
    sw_scalar,
    traceback_batch,
)
