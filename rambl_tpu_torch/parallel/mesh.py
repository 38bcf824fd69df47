"""A data-parallel mesh of ranks in one process, and the multi-host setup.

Port of `rambl_tpu/parallel/mesh.py`. The reference drives N local devices
from one process through a 1-D `jax` mesh over the 'data' axis. Here a `DataMesh` is an explicit list of
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
`ring_dma` does that).

Multi-host setup over `torch.distributed` (the reference's over
`jax.distributed`): `init_distributed` joins the process group the
environment describes, `broadcast_host_config` sends process 0's bytes to
every process, and `sync_host_config` / `assert_hosts_agree` hold every
process to process 0's config and inputs; in a world of one process all
three are the identity. A mesh whose ranks span processes needs a
cross-process psum and K4 between processes, neither of which one card can
run, so `data_mesh` refuses to build one (ROADMAP item 15). The reference's
`shard_spec` returns a `jax.sharding.PartitionSpec`, which means nothing
without `shard_map`; it has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from rambl_tpu_torch.device import require_cuda
from rambl_tpu_torch.utils.errors import UserError

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


def init_distributed() -> bool:
    """Join the process group the environment describes; True when this
    process runs in one.

    Gated on the environment, so that a single process is a no-op that
    returns False: RAMBL_DISTRIBUTED, or torchrun's WORLD_SIZE > 1 with
    MASTER_ADDR (the reference reads JAX_COORDINATOR_ADDRESS there).
    `init_process_group` reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE
    itself; the backend is nccl where CUDA is present, else gloo. Calling it
    again is harmless."""
    import torch.distributed as dist

    want = bool(os.environ.get("RAMBL_DISTRIBUTED")
                or (int(os.environ.get("WORLD_SIZE", "1")) > 1
                    and os.environ.get("MASTER_ADDR")))
    if not want:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo")
    return True


def process_count() -> int:
    """Processes in the initialized process group (1 without one)."""
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def broadcast_host_config(payload: bytes) -> bytes:
    """Process 0's bytes on every process (small host metadata: the config
    JSON, an input fingerprint), the length first. A world of one process:
    the identity."""
    if process_count() == 1:
        return payload
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if process_index() == 0:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes()


def sync_host_config(cfg):
    """Process 0's PipelineConfig on every process. Every process must run
    the same pipeline; a process whose flags drifted (a stale launch
    script, another preset) is told on stderr and adopts process 0's. A
    world of one process: the identity. Returns the config to use."""
    if process_count() == 1:
        return cfg
    from rambl_tpu_torch.config import PipelineConfig

    payload = cfg.to_json().encode()
    got = broadcast_host_config(payload)
    if got != payload:
        print(f"warning: process {process_index()} config differs from "
              "process 0; adopting process 0's config", file=sys.stderr)
    return PipelineConfig.from_json(got.decode())


def assert_hosts_agree(tag: str, payload: bytes) -> None:
    """Raise ValueError when this process's payload (the reference's
    fingerprint) differs from process 0's: every process must read the same
    inputs, or the merged pileups mean nothing. A world of one process: a
    no-op."""
    if process_count() == 1:
        return
    if broadcast_host_config(payload) != payload:
        raise ValueError(
            f"multi-host mismatch: {tag} on process {process_index()} "
            "differs from process 0 (all hosts must load identical inputs)")


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DataMesh:
    """1-D mesh over the data axis: every visible CUDA card by default (the
    first `n_devices` of them; more than are visible is a UserError), or
    the listed devices ("cpu" ranks for the plain path; one card listed
    several times gives virtual ranks). Refused (UserError) in a process
    group of more than one process: a mesh across processes is not ported
    (ROADMAP item 15), and each process must not quietly run alone."""
    if process_count() > 1:
        raise UserError(
            f"a mesh across {process_count()} processes is not ported "
            "(ROADMAP item 15: it needs a cross-process psum and K4 between "
            "processes); run one process")
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devices):
                raise UserError(f"a mesh of {n_devices} cards asked for, "
                                f"{len(devices)} visible")
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
