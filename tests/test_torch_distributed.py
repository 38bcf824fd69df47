"""The port's multi-host setup (`rambl_tpu_torch.parallel.mesh`), against
the JAX package's contract (`rambl_tpu/parallel/mesh.py:14-88`,
tests/test_distributed.py::test_host_config_sync_exercises_broadcast).

- Two processes joined by `init_distributed` through the environment that
  torchrun sets (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT on a free local
  port; the gloo backend): a second call is harmless; process 0's bytes
  reach both, length first; process 0's config wins and the drifted process
  says so on stderr; a drifted fingerprint raises on that process alone;
  `data_mesh` and the CLI's `--mesh` refuse a mesh across the processes.
- One process: `init_distributed` is a no-op that returns False, and the
  three helpers are the identity.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket

import pytest
import torch
import torch.multiprocessing as mp

from rambl_tpu_torch import cli as tcli
from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.utils.errors import UserError

DRIFTED = dict(batch_size=4096)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _process(rank: int, port: int, out: str, cli_argv: list) -> None:
    """One process of the 2-process world: its readings to out/<rank>.json."""
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    got = {"init": tmesh.init_distributed(),
           "again": tmesh.init_distributed(),
           "world": [tmesh.process_count(), tmesh.process_index()]}
    cfg0 = PipelineConfig()
    mine = cfg0 if rank == 0 else dataclasses.replace(cfg0, **DRIFTED)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        adopted = tmesh.sync_host_config(mine)
    got["adopted"] = adopted == cfg0
    got["warned"] = "adopting process 0's config" in err.getvalue()
    got["bytes"] = tmesh.broadcast_host_config(
        f"from process {rank}".encode() * (rank + 1)).decode()
    tmesh.assert_hosts_agree("reference FASTA", b"same on both")
    try:
        tmesh.assert_hosts_agree("reference FASTA", b"fingerprint %d" % rank)
        got["drift"] = None
    except ValueError as e:
        got["drift"] = str(e)
    try:
        tmesh.data_mesh(devices=["cpu"])
        got["mesh"] = None
    except UserError as e:
        got["mesh"] = str(e)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got["cli"] = [tcli.main(cli_argv), err.getvalue()]
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"{rank}.json"), "w") as f:
        json.dump(got, f)


def test_helpers_in_two_gloo_processes(tmp_path):
    sim = str(tmp_path / "sim")
    assert tcli.main(["simulate", "--out", sim, "--species", "1",
                      "--strains", "1", "--reads", "8"]) == 0
    argv = ["assemble", "--reads", os.path.join(sim, "reads.fastq"),
            "--reference", os.path.join(sim, "refs.fasta"), "--out",
            str(tmp_path / "g.fasta"), "--device", "cpu", "--mesh", "2"]
    mp.spawn(_process, args=(_free_port(), str(tmp_path), argv), nprocs=2,
             join=True)
    got = [json.load(open(tmp_path / f"{r}.json")) for r in range(2)]
    for r, g in enumerate(got):
        assert g["init"] is True and g["again"] is True
        assert g["world"] == [2, r]
        assert g["adopted"] is True                    # process 0 wins
        assert g["bytes"] == "from process 0"          # its length too
        assert "a mesh across 2 processes is not ported" in g["mesh"]
        assert g["cli"][0] == 2
        assert "a mesh across 2 processes" in g["cli"][1]
    assert [g["warned"] for g in got] == [False, True]
    assert got[0]["drift"] is None
    assert got[1]["drift"].startswith(
        "multi-host mismatch: reference FASTA on process 1 differs")
    assert not os.path.exists(tmp_path / "g.fasta")


def test_one_process_is_the_identity(monkeypatch):
    for var in ("RAMBL_DISTRIBUTED", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_count(), tmesh.process_index()) == (1, 0)
    cfg = dataclasses.replace(PipelineConfig(), **DRIFTED)
    assert tmesh.sync_host_config(cfg) is cfg
    assert tmesh.broadcast_host_config(b"abc") == b"abc"
    tmesh.assert_hosts_agree("reference FASTA", b"anything")
    assert tmesh.data_mesh(devices=["cpu"] * 2).size == 2


def test_data_mesh_refuses_a_mesh_across_processes(monkeypatch):
    monkeypatch.setattr(tmesh, "process_count", lambda: 3)
    for kw in ({}, dict(devices=["cpu"] * 2)):
        with pytest.raises(UserError, match="across 3 processes.*item 15"):
            tmesh.data_mesh(**kw)
