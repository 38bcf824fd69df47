"""The traced window: torch.profiler over the measured loop, read back as
the cards' busy time, their longest operations and the host's activity in
their idle gaps.

A card's busy time is the union of its kernel and copy intervals inside
the window (streams may overlap, so their times do not add), as the port's
`utils/timing.py::busy_ms_of` takes it. `busy_s` is the mean of the
cell's cards' busy times, so `1 - busy_s / window_s` is a card's mean idle
share; a card that recorded nothing counts as idle for the whole window.
`device_ops` and `idle_gaps` sum card-seconds over the cards. On one card
each of these is that card's own reading.

A profile that recorded fewer kernels than the host launched, by more than
2 and more than 1% of the launches, lost device records and would read its
busy time low; the window is then run again, as `utils/timing.py::profiled`
does, and after `ATTEMPTS` such windows the run fails.
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
    """(name, on_device, start_ns, end_ns, card) of every recorded event;
    `card` is a device event's card index, None on the host."""
    from torch.autograd import DeviceType

    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    out = []
    if res is not None:
        for e in res.events():
            s = e.start_ns()
            on = e.device_type() == DeviceType.CUDA
            out.append((e.name(), on, s, s + e.duration_ns(),
                        e.device_index() if on else None))
        return out
    for e in prof.events():
        on = e.device_type == DeviceType.CUDA
        out.append((e.name, on, int(e.time_range.start * 1e3),
                    int(e.time_range.end * 1e3),
                    e.device_index if on else None))
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
    """What a traced window recorded on the cell's `cards` (their indices),
    in seconds.

    `card_merged[c]` is card c's busy intervals (sorted, disjoint, in ns)
    and `card_busy_s[c]` their length; `busy_s` is their mean. There is no
    union across the cards: a reader of idle time takes each card's
    intervals and the mean over the cards, as `busy_s` does. `device` holds
    every card's operations as (name, start, end)."""

    def __init__(self, events, cards=(0,)):
        win = [e for e in events if not e[1] and e[0] == WINDOW_SPAN]
        if len(win) != 1:
            raise AssertionError(f"the profile holds {len(win)} windows")
        self.w0, self.w1 = win[0][2], win[0][3]
        self.window_s = (self.w1 - self.w0) / 1e9
        # the device events less the benchmark's own spans, which the
        # profiler also records on the device's timeline
        dev = [(n, max(s, self.w0), min(t, self.w1), c)
               for n, d, s, t, c in events
               if d and t > self.w0 and s < self.w1
               and not n.startswith(SPAN_PREFIX)]
        per = {c: [] for c in cards}
        for _, s, t, c in dev:
            if c not in per:
                raise AssertionError(f"device work on card {c}, outside "
                                     f"the cell's cards {list(cards)}")
            per[c].append((s, t))
        busy, self.card_merged = {}, {}
        for c, spans in per.items():
            busy[c], self.card_merged[c] = _union(spans)
        self.card_busy_s = {c: b / 1e9 for c, b in busy.items()}
        self.busy_s = sum(busy.values()) / len(busy) / 1e9
        self.device = [(n, s, t) for n, s, t, _ in dev]
        self.host = [(n, s, t) for n, d, s, t, _ in events
                     if not d and t > self.w0 and s < self.w1
                     and n != WINDOW_SPAN]
        self.launched = sum(n in LAUNCH_CALLS for n, _, _ in self.host)
        self.ran = sum(not n.startswith(("Memcpy", "Memset"))
                       for n, _, _ in self.device)

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
        gap between a card's device intervals is named by the innermost
        host event open at its midpoint (a benchmark span there means the
        host was in the port's Python between torch operations), and the
        gaps' card-seconds are summed by name over the cards."""
        host = sorted(self.host, key=lambda e: (e[1], -e[2]))
        tot = {}
        for merged in self.card_merged.values():
            edges = [self.w0] + [x for iv in merged for x in iv] + [self.w1]
            gaps = sorted((edges[i], edges[i + 1])
                          for i in range(0, len(edges), 2)
                          if edges[i + 1] > edges[i])
            stack, j = [], 0
            for gs, ge in gaps:
                mid = (gs + ge) // 2
                while j < len(host) and host[j][1] <= mid:
                    stack.append(host[j])
                    j += 1
                while stack and stack[-1][2] < mid:
                    stack.pop()
                # an event below the top may have ended; the innermost open
                # one is the last one on the stack that is still open at mid
                label = next((n for n, s_, t in reversed(stack) if t >= mid),
                             "(no host event)")
                tot[label] = tot.get(label, 0) + (ge - gs)
        return [[n, v / 1e9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def traced(window, deadline: float | None = None, devices=None):
    """Run `window(span)` under torch.profiler, where `span` is a context
    manager the window opens around its whole measured loop, and return
    (its result, the `Trace` of the cell's cards `devices`, by default the
    current card). Every card is synchronized before the window and after
    it. A window is run again only while it can end, and be read, before
    `deadline` (epoch seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cards = [torch.device(d).index for d in devices or ["cuda"]]
    cards = [torch.cuda.current_device() if c is None else c for c in cards]

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    for _ in range(ATTEMPTS):
        t1 = time.time()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = window(lambda: record_function(WINDOW_SPAN))
            sync()
        tr = Trace(_events(prof), cards)
        if not tr.lost_records():
            return out, tr
        if deadline is not None and time.time() + (time.time() - t1) > \
                deadline:
            break                       # no time left for another window
    raise AssertionError(
        f"torch.profiler lost device records: the last window recorded "
        f"{tr.ran} kernels of {tr.launched} launches")
