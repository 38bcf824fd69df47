"""Device timing with CUDA events.

PyTorch returns before the card finishes, so a host clock without a
synchronize measures the enqueue. `trial_times` brackets each trial of
`iters` calls with two CUDA events on the current stream after `warmup`
calls, and gives the bench entry points one number per trial. `cuda_time` is
one such trial, and fails on a machine without a card rather than timing the
CPU. A kernel shorter than the host's time to launch it needs more: its
launches go into one CUDA graph, timed by the same events (`graph_ms`), or
torch.profiler reads its device time (`kernel_ms`).

A profiled run's device busy time (`busy_ms_of`) and its longest device
operations (`device_ops`), both of one call (`profiled`, which reruns a
call whose device records were lost: `kernel_records`), and the host
syncs of a call as `torch.cuda.set_sync_debug_mode("warn")` reports them
(`syncs_of`) serve `chip_smoke.py` and the profiling scripts.
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


def kernel_ms(fn, *args, kernel: str, iters: int = 20,
              warmup: int = 2) -> float:
    """Device milliseconds per call of fn(*args) spent in the kernels whose
    name holds `kernel`, from torch.profiler over `iters` calls: a kernel's
    own time, without the host's gaps between launches, which CUDA events
    around a short kernel would count."""
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.self_device_time_total > 0]
    if not hits:
        raise AssertionError(f"the profiler saw no kernel named {kernel}")
    return sum(e.self_device_time_total for e in hits) / iters / 1e3


def graph_ms(fn, *args, iters: int = 50, trials: int = 3) -> list[float]:
    """Milliseconds per call of fn(*args), one number per trial: CUDA
    events around a replay of one CUDA graph that holds `iters` calls. The
    launches of a graph follow each other on the card with no host work
    between them, so a kernel shorter than the host's launch time is timed
    as the card runs it back to back, on the same clock as `cuda_time`."""
    dev = require_cuda()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*args)                       # build and allocate outside the graph
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()                      # warm
    out = []
    for _ in range(trials):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end) / iters)
    return out


def busy_ms_of(prof) -> float:
    """Device busy ms of a profiled run: the union of the device's kernel
    and copy intervals (streams may overlap, so their times do not add)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device work")
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def device_ops(prof) -> list:
    """The profiled run's kernels and copies (the events with no host time
    of their own), most device time first."""
    return sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total == 0
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)


#: the host calls that launch one kernel each, as torch.profiler names them
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                          "cuLaunchKernelEx"})


def kernel_records(prof) -> tuple[int, int]:
    """(kernel launches, kernels run) of a profiled run: the launch calls
    recorded on the host and the kernels recorded on the device (its
    events less its copies and sets)."""
    from torch.autograd import DeviceType

    launched = ran = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ran += not e.name.startswith(("Memcpy", "Memset"))
        elif e.name in LAUNCH_CALLS:
            launched += 1
    return launched, ran


def profiled(work, attempts: int = 3) -> tuple:
    """(device busy ms, device operations) of one synchronized run of
    work() under torch.profiler (`busy_ms_of`, `device_ops`).

    A run that recorded fewer kernels than it launched (`kernel_records`)
    by more than 2 and more than 1% of its launches lost device records,
    and its busy time would read low: it is run again, and after
    `attempts` such runs this raises. (Whole runs on an H100 left 1 of
    163 and 2 of 9,464 launch calls without a kernel record; a run that
    lost records kept a few kernels of each piece.)"""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        launched, ran = kernel_records(prof)
        if launched - ran <= max(2, launched // 100):
            return busy_ms_of(prof), device_ops(prof)
    raise AssertionError(
        f"torch.profiler lost device records in {attempts} runs: the last "
        f"recorded {ran} kernels of {launched} launches")


def sync_lines(caught):
    """{source line: count} of the host-sync warnings among `caught`."""
    import collections

    return collections.Counter(
        f"{w.filename.rsplit('rambl_tpu_torch/', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))


def syncs_of(run) -> tuple:
    """(result of run(), {source line: host syncs}) as
    torch.cuda.set_sync_debug_mode("warn") reports them over the whole
    call."""
    import warnings

    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sync_lines(caught)
