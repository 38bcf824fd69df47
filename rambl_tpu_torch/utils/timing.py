"""Device timing with CUDA events.

PyTorch returns before the card finishes, so a host clock without a
synchronize measures the enqueue. `trial_times` brackets each trial of
`iters` calls with two CUDA events on the current stream after `warmup`
calls, and gives the bench entry points one number per trial. `cuda_time` is
one such trial, and fails on a machine without a card rather than timing the
CPU.
"""

from __future__ import annotations

import time

import torch

from rambl_tpu_torch.device import require_cuda


def cuda_time(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean device milliseconds per call of fn(*args)."""
    return trial_times(fn, *args, device=require_cuda(), trials=1,
                       iters=iters, warmup=warmup)[0]


def trial_times(fn, *args, device, trials: int = 3, iters: int = 8,
                warmup: int = 1, host_clock: bool = False) -> list[float]:
    """Milliseconds per call of fn(*args), one number per trial of `iters`
    back-to-back calls, after `warmup` calls.

    On a CUDA device a trial is bracketed by CUDA events on the current
    stream, or, with host_clock, by the host clock around calls that end in
    a synchronize (a step time with the host's gaps in it). On the CPU,
    which a caller must ask for, the host clock is the only clock.
    """
    on_card = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args)
    out = []
    for _ in range(trials):
        if on_card:
            torch.cuda.synchronize()
        if on_card and not host_clock:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / iters)
            continue
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        if on_card:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def median_spread(times: list[float]) -> tuple[float, float]:
    """(median, (max - min) / median in percent) of a list of trial times."""
    ts = sorted(times)
    med = ts[len(ts) // 2]
    return med, 100.0 * (ts[-1] - ts[0]) / med
