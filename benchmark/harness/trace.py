"""The traced window: torch.profiler over the measured loop, read back as
the device's busy time, its longest operations and the host's activity in
its idle gaps.

`busy_s` is the union of the device's kernel and copy intervals inside the
window (streams may overlap, so their times do not add), as the port's
`utils/timing.py::busy_ms_of` takes it. A profile that recorded fewer
kernels than the host launched, by more than 2 and more than 1% of the
launches, lost device records and would read its busy time low; the window
is then run again, as `utils/timing.py::profiled` does, and after
`ATTEMPTS` such windows the run fails.
"""

from __future__ import annotations

import time

ATTEMPTS = 2
SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
#: the host calls that launch one kernel each, as torch.profiler names them
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                          "cuLaunchKernelEx"})


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every recorded event."""
    from torch.autograd import DeviceType

    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    out = []
    if res is not None:
        for e in res.events():
            s = e.start_ns()
            out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                        s + e.duration_ns()))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                     int(e.time_range.start * 1e3),
                     int(e.time_range.end * 1e3)))
    return out


def _union(spans):
    busy, end = 0, None
    merged = []
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            merged.append([lo, hi])
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            merged[-1][1] = hi
            end = hi
    return busy, merged


class Trace:
    """What a traced window recorded, in seconds."""

    def __init__(self, events):
        win = [e for e in events if not e[1] and e[0] == WINDOW_SPAN]
        if len(win) != 1:
            raise AssertionError(f"the profile holds {len(win)} windows")
        self.w0, self.w1 = win[0][2], win[0][3]
        self.window_s = (self.w1 - self.w0) / 1e9
        # the device events less the benchmark's own spans, which the
        # profiler also records on the device's timeline
        dev = [(n, max(s, self.w0), min(t, self.w1)) for n, d, s, t in events
               if d and t > self.w0 and s < self.w1
               and not n.startswith(SPAN_PREFIX)]
        self.device = dev
        busy, self.merged = _union([(s, t) for _, s, t in dev])
        self.busy_s = busy / 1e9
        self.host = [(n, s, t) for n, d, s, t in events
                     if not d and t > self.w0 and s < self.w1
                     and n != WINDOW_SPAN]
        self.launched = sum(n in LAUNCH_CALLS for n, _, _ in self.host)
        self.ran = sum(not n.startswith(("Memcpy", "Memset"))
                       for n, _, _ in dev)

    def lost_records(self) -> bool:
        return self.launched - self.ran > max(2, self.launched // 100)

    def device_seconds(self, name_part: str) -> float:
        return sum(t - s for n, s, t in self.device if name_part in n) / 1e9

    def device_ops(self, top: int = 10):
        tot = {}
        for n, s, t in self.device:
            tot[n] = tot.get(n, 0) + (t - s)
        return [[n, v / 1e9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The idle time inside the window by what the host was doing: each
        gap between device intervals is named by the innermost host event
        open at its midpoint (a benchmark span there means the host was in
        the port's Python between torch operations), and the gaps' seconds
        are summed by name."""
        edges = [self.w0] + [x for iv in self.merged for x in iv] + [self.w1]
        gaps = sorted((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i])
        host = sorted(self.host, key=lambda e: (e[1], -e[2]))
        tot, stack, j = {}, [], 0
        for gs, ge in gaps:
            mid = (gs + ge) // 2
            while j < len(host) and host[j][1] <= mid:
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            # an event below the top may have ended; the innermost open one
            # is the last one on the stack that is still open at mid
            label = next((n for n, s_, t in reversed(stack) if t >= mid),
                         "(no host event)")
            tot[label] = tot.get(label, 0) + (ge - gs)
        return [[n, v / 1e9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def traced(window, deadline: float | None = None):
    """Run `window(span)` under torch.profiler, where `span` is a context
    manager the window opens around its whole measured loop, and return
    (its result, the `Trace`). A window is run again only while it can end,
    and be read, before `deadline` (epoch seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(ATTEMPTS):
        t1 = time.time()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = window(lambda: record_function(WINDOW_SPAN))
            torch.cuda.synchronize()
        tr = Trace(_events(prof))
        if not tr.lost_records():
            return out, tr
        if deadline is not None and time.time() + (time.time() - t1) > \
                deadline:
            break                       # no time left for another window
    raise AssertionError(
        f"torch.profiler lost device records: the last window recorded "
        f"{tr.ran} kernels of {tr.launched} launches")
