"""The port's spans and counters, kept in memory.

`span(name)` records (name, start ns, end ns, parent span name) of a block
of host code at a layer's boundary; `count(name, n)` records (name, time
ns, n, enclosing span name) of work done there. The clock is
`time.time_ns()`, the clock torch.profiler stamps its events with, so the
entries line up with a profile of the same process.

The recorder is on only while torch.profiler records, or inside a round or
polish pass whose `Stages` clock was made with RAMBL_STAGE_TIMING=1 in the
environment. When it is off, `span` returns one shared object that does
nothing, after a single flag check, and `count` returns at once: no tensor
is made, no work is launched and nothing is synchronized.

While torch.profiler records, each span also opens a profiler range of the
same name (`_RecordFunctionFast`, function scope), which the profiler puts
on the host's timeline only: a profile names the program's layers, and the
device's timeline gains no event.

A count may be a 0-d device tensor. It is kept as it is, without a
synchronize, and read with the others at the next `settle()` (the cluster
stage calls it once a block's outputs are on the host) or when the counts
are read.

There is one recorder a process (`RECORDER`), and it is not thread-safe:
the port records from the thread that runs it.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import torch
from torch.autograd import profiler as _profiler

#: entries kept of each kind; the oldest go first
KEEP = 200_000


class Recorder:
    """Spans (name, t0 ns, t1 ns, parent) and counts [name, t ns, n, span]
    in bounded deques, the counts still held as tensors, and the stack of
    open spans."""

    def __init__(self):
        self.spans = collections.deque(maxlen=KEEP)
        self.counts = collections.deque(maxlen=KEEP)
        self.held: list = []
        self.open: list = []
        self.forced = 0       # Stages clocks entered under RAMBL_STAGE_TIMING

    def clear(self) -> None:
        self.spans.clear()
        self.counts.clear()
        self.held.clear()


RECORDER = Recorder()


def on() -> bool:
    """Whether spans and counts are recorded now."""
    return RECORDER.forced > 0 or _profiler._is_profiler_enabled


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    __slots__ = ("name", "t0", "t1", "parent", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self):
        r = RECORDER
        self.parent = r.open[-1].name if r.open else None
        r.open.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        r = RECORDER
        r.open.pop()
        r.spans.append((self.name, self.t0, self.t1, self.parent))
        return False


def span(name: str):
    """A context manager that records the block it encloses as `name`."""
    if not (RECORDER.forced or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name)


def count(name: str, n) -> None:
    """Record `n` (an int, or a 0-d tensor read at the next `settle`) of
    `name` at the innermost open span."""
    r = RECORDER
    if not (r.forced or _profiler._is_profiler_enabled):
        return
    e = [name, time.time_ns(), n, r.open[-1].name if r.open else None]
    r.counts.append(e)
    if isinstance(n, torch.Tensor):
        r.held.append(e)


def settle() -> None:
    """Read the counts still held as tensors: one copy to the host for
    each device that holds some."""
    r = RECORDER
    by_dev: dict = {}
    for e in r.held:
        by_dev.setdefault(e[2].device, []).append(e)
    r.held = []
    for es in by_dev.values():
        vals = torch.stack([e[2].to(torch.int64) for e in es]).tolist()
        for e, v in zip(es, vals):
            e[2] = v


def spans() -> list:
    """The recorded spans: (name, t0 ns, t1 ns, parent name or None)."""
    return list(RECORDER.spans)


def counts() -> list:
    """The recorded counts: (name, t ns, n, enclosing span name or None)."""
    settle()
    return [tuple(e) for e in RECORDER.counts]


def clear() -> None:
    RECORDER.clear()


class Stages:
    """The stage clock of a round or of the polish pass, read from spans.

    Made, it reads RAMBL_STAGE_TIMING. When that is 1, the recorder is on
    while the clock is entered, and `stages(name, key)` opens a span that
    waits for the CUDA devices among `devices` (the round's) at its end,
    the only waits the clock adds, and adds its seconds to `t_<key>`,
    which `into(stats)` writes. Otherwise `stages(name, key)` is
    `span(name)` and `into` writes nothing."""

    def __init__(self, devices=()):
        self.on = bool(int(os.environ.get("RAMBL_STAGE_TIMING", "0")))
        self.cards = [d for d in dict.fromkeys(map(torch.device, devices))
                      if d.type == "cuda"]
        self.t: dict = {}

    def __enter__(self):
        RECORDER.forced += self.on
        return self

    def __exit__(self, *exc):
        RECORDER.forced -= self.on
        return False

    def __call__(self, name: str, key: str):
        return _Stage(name, self, key) if self.on else span(name)

    def into(self, stats: dict) -> None:
        stats.update({f"t_{k}": v for k, v in self.t.items()})


class _Stage(Span):
    __slots__ = ("clock", "key")

    def __init__(self, name: str, clock: Stages, key: str):
        super().__init__(name)
        self.clock, self.key = clock, key

    def __exit__(self, *exc):
        for d in self.clock.cards:
            torch.cuda.synchronize(d)
        super().__exit__(*exc)
        dt = self.seconds
        t = self.clock.t
        t[self.key] = round(t.get(self.key, 0.0) + dt, 2)
        if dt > 5.0:
            # live progress for long runs: stage boundaries as they happen
            print(f"[stage] {self.key} +{dt:.0f}s", file=sys.stderr,
                  flush=True)
        return False
