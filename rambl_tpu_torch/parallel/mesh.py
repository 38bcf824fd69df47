"""A data-parallel mesh of ranks in one process.

Port of `rambl_tpu/parallel/mesh.py` for the single-process case: the
reference drives N local devices from one process through a 1-D `jax`
mesh over the 'data' axis. Here a `DataMesh` is an explicit list of
`torch.device`s, one per rank, and each rank on a CUDA card gets its own
stream. A `shard_map` step becomes a loop over ranks, each rank's work
issued on its device and stream between a `fork` (every rank stream waits
for the caller's stream) and a `join` (the caller's stream waits for every
rank stream). `psum` is an integer sum of the ranks' tensors (exact in
int32, wrapping as the reference's does), `psum_scatter` that sum with each
rank keeping its own column slice.

A caller may list one card more than once: virtual ranks, each with its
own stream, share that card's memory. Ranks on different cards reach each
other through peer pointers (unified addressing with peer access enabled,
`ring_dma` does that). Multi-host meshes (`init_distributed`,
`broadcast_host_config`, ...) are not ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from rambl_tpu_torch.device import require_cuda

DATA_AXIS = "data"


class DataMesh:
    """Ranks of the 'data' axis: one device (and, on a card, one stream)
    each. `scratch` holds per-mesh state of the collectives (ring flags)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a mesh is all CPU or all CUDA ranks, got "
                             f"{[str(d) for d in self.devices]}")
        self.devices = [torch.device("cuda", d.index or 0)
                        if d.type == "cuda" else d for d in self.devices]
        self.on_card = kinds == {"cuda"}
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if self.on_card else [None] * len(self.devices))
        self.scratch: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"

    def rank(self, r: int):
        """Context for rank r's work: its device and stream on a card."""
        if not self.on_card:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[r])

    def fork(self) -> None:
        """Every rank stream waits for the work already issued on the
        caller's current stream of its device."""
        if self.on_card:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self) -> None:
        """The caller's current streams wait for every rank stream."""
        if self.on_card:
            for d, s in zip(self.devices, self.streams):
                torch.cuda.current_stream(d).wait_stream(s)


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DataMesh:
    """1-D mesh over the data axis: every visible CUDA card by default (the
    first `n_devices` of them), or the listed devices ("cpu" ranks for the
    plain path; one card listed several times gives virtual ranks)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return DataMesh(devices)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def put_sharded(x, mesh: DataMesh) -> list:
    """Split dim 0 evenly over the ranks -> per-rank tensors."""
    t = _as_tensor(x)
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not divide the "
                         f"{n}-rank mesh")
    k = t.shape[0] // n
    return [t[r * k:(r + 1) * k].to(d, non_blocking=True)
            for r, d in enumerate(mesh.devices)]


def put_replicated(x, mesh: DataMesh) -> list:
    """The whole of x on every rank. Ranks on one device share one copy:
    replicas are only read."""
    t = _as_tensor(x)
    copies: dict = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = t.to(d)
    return [copies[d] for d in mesh.devices]


def psum(ts: Sequence[torch.Tensor], mesh: DataMesh) -> list:
    """Integer sum of the ranks' tensors, on every rank."""
    total = ts[0].to(mesh.devices[0], copy=True)
    for t in ts[1:]:
        total += t.to(total.device)
    return put_replicated(total, mesh)


def psum_scatter(ts: Sequence[torch.Tensor], mesh: DataMesh) -> list:
    """The sum of the ranks' (rows, cols) tensors, rank r keeping the r-th
    of n equal column slices (`jax.lax.psum_scatter(..., scatter_dimension=1,
    tiled=True)`)."""
    total = psum(ts, mesh)[0]
    n = mesh.size
    if total.shape[1] % n:
        raise ValueError(f"{total.shape[1]} columns do not divide the "
                         f"{n}-rank mesh")
    return [s.contiguous().to(d) for s, d in
            zip(torch.chunk(total, n, dim=1), mesh.devices)]
