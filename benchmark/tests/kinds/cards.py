"""A traffic kind of the harness's own tests, with a known load on each of
the context's cards: card i holds (i + 1) x `alloc_bytes` of bytes and
adds one to each of them `adds` times a step, so its peak allocation and
its work grow with i + 1. The work is the steps run; the check counts the
cards whose bytes do not all hold the number of adds made."""

from __future__ import annotations

import time

import torch

from benchmark.harness.cells import sync


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        n = self.ctx.config["alloc_bytes"]
        self.held = [torch.zeros((i + 1) * n, dtype=torch.uint8, device=d)
                     for i, d in enumerate(self.ctx.devices)]
        self.steps = 0
        self._step()
        sync(self.ctx)

    def _step(self) -> None:
        for _ in range(self.ctx.config["adds"]):
            for b in self.held:
                b.add_(1)
        self.steps += 1

    def window(self, seconds: float, span) -> int:
        steps = 0
        with span():
            t0 = time.perf_counter()
            while True:
                self._step()
                sync(self.ctx)
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        return steps

    def check(self, control: bool = False) -> dict:
        want = self.steps * self.ctx.config["adds"] % 256
        bad = sum(bool((b != want).any()) for b in self.held)
        return {"cards_differing": (bad, 0)}

    def release(self) -> None:
        self.held = None
