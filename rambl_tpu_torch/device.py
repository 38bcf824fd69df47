"""Explicit device placement.

Callers put tensors on a device themselves; the port keeps no global device
state and never falls back from the card to the CPU on its own.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device `index`, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda})")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"cuda:{index} requested but only {torch.cuda.device_count()} "
            "device(s) are visible")
    return torch.device("cuda", index)


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them, for printing beside every
    time measured on it; "cpu, host clock" for a CPU device."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu, host clock"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def to_host(x):
    """A tensor on any device, or an array, as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def resolve(device) -> torch.device:
    """An entry point's device: the first CUDA card when None, else the
    device the caller asked for ("cpu" for the plain PyTorch path)."""
    return require_cuda() if device is None else torch.device(device)
