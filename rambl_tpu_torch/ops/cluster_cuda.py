"""Wrapper of DP-means' center recount kernel (`csrc/cluster.cu`).

`dp_recount_centers` recounts a block's centers once an iteration of
`pipeline.cluster.dp_means_leaves`. On a CUDA tensor it launches
`dp_recount_kernel` (a block a leaf, the leaf's counts in shared memory, only
the covered entries added) or raises; it never falls back. On CPU tensors it
runs the plain version, `pipeline.cluster.recount_centers`, which the CPU
tests hold against the JAX package. The kernel replaces no Pallas kernel
(the source says why it exists). `LAUNCHES` counts its launches, one per
launch and nowhere else. The kernel is held against the plain version on a
card by `python -m pytest --noconftest tests/test_torch_kernels_cuda.py`
and by `python3 chip_smoke.py`, from the repository root.

It is built into the library of `ops.sw_cuda` with the other sources of
`csrc/`.
"""

from __future__ import annotations

import torch

from rambl_tpu_torch.ops.sw_cuda import (
    _on_cpu,
    _raise_on,
    _stream,
    load_library,
)
from rambl_tpu_torch.ops.sw_variants import MAX_SMEM
from rambl_tpu_torch.pipeline import cluster as _twin

LAUNCHES = {"recount": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def recount_adds(feat: torch.Tensor, cov: torch.Tensor):
    """The adds one recount of feat (NL, M, P) makes on its device, and those
    of them that count nothing, as (adds, inert) ints or 0-d tensors: the
    kernel adds the covered entries (`cov`, feat >= 0) alone; the plain
    version adds every entry, each uncovered one into its inert slot."""
    if _on_cpu(feat, cov):
        return feat.numel(), (~cov).sum()
    return cov.sum(), 0


def _check(feat, assign, fallback, kact, K: int) -> None:
    NL, M, P = feat.shape
    for name, t, dtype, shape in (("feat", feat, torch.int8, (NL, M, P)),
                                  ("assign", assign, torch.int32, (NL, M)),
                                  ("fallback", fallback, torch.int8, (NL, P)),
                                  ("kact", kact, torch.int32, (NL,))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
    if M * P >= 1 << 31:
        raise ValueError(f"a leaf of {M} x {P} entries exceeds int32")
    if 16 * K * P > MAX_SMEM:
        raise ValueError(f"K={K} x P={P} counts take {16 * K * P} bytes of "
                         f"shared memory, over the {MAX_SMEM} a block may use")


def dp_recount_centers(feat: torch.Tensor, assign: torch.Tensor,
                       fallback: torch.Tensor, kact: torch.Tensor,
                       K: int) -> torch.Tensor:
    """feat (NL, M, P) int8 (-1 = uncovered), assign (NL, M) int32 in
    [0, K), fallback (NL, P) int8, kact (NL,) int32 -> centers (NL, K, P)
    int8: each (k, p) the base most members of cluster k carry at column p
    (ties to the lowest base), fallback[p] where none covers it, 0 for
    k >= kact. Bit for bit `pipeline.cluster.recount_centers`."""
    if _on_cpu(feat, assign, fallback, kact):
        return _twin.recount_centers(feat, assign, fallback, kact, K)
    _check(feat, assign, fallback, kact, K)
    NL, M, P = feat.shape
    out = torch.empty((NL, K, P), dtype=torch.int8, device=feat.device)
    if NL and K * P:
        with torch.cuda.device(feat.device):
            rc = load_library().rambl_dp_recount(
                feat.data_ptr(), assign.data_ptr(), fallback.data_ptr(),
                kact.data_ptr(), out.data_ptr(), NL, M, P, K, _stream(feat))
        _raise_on(rc, "dp_recount")
        LAUNCHES["recount"] += 1
    return out
