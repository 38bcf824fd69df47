"""What every runner of the scale ladder (`run_config2` .. `run_config5`)
records of an assembly beyond the reference scripts' lines: per round its
stage spans (when RAMBL_STAGE_TIMING=1), the col maps' build time,
K1 and K2 + K3 launches, peak device memory and what is allocated at its
start; and the launches of polish. Every such line ends with the card's
name and power limit.

`RoundRecorder` wraps `pipeline.assemble.assemble_round` and
`pipeline.assemble.build_col_maps` while it is entered (the stream looks
both up in that module), and restores them on exit.
"""

from __future__ import annotations

import time

import torch

from rambl_tpu_torch.ops import sw_cuda
from rambl_tpu_torch.pipeline import assemble as tassemble


class RoundRecorder:
    """Records each `assemble_round` called while entered: {"wall",
    "stats", "start" (bytes allocated on the card at its start), "peak"
    (bytes), "colmap" (s), "launches" {"score", "align"}} in `rounds`;
    `polish_launches` are the launches outside the rounds. On a CPU
    device the memory fields are None and no kernel counts."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.rounds: list = []
        self.total: dict = {}
        self._col_s = 0.0

    def sync(self):
        """Wait for the card (the runners read their walls after it)."""
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def _maps(self, *a, **kw):
        t0 = time.perf_counter()
        out = self._real_maps(*a, **kw)
        self._col_s += time.perf_counter() - t0
        return out

    def _round(self, *a, **kw):
        self.sync()
        before, maps0 = dict(sw_cuda.LAUNCHES), self._col_s
        start = torch.cuda.memory_allocated(self.dev) if self.cuda else None
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        out = self._real_round(*a, **kw)
        self.sync()
        self.rounds.append(dict(
            wall=time.perf_counter() - t0, stats=out[1], start=start,
            colmap=self._col_s - maps0,
            peak=(torch.cuda.max_memory_allocated(self.dev) if self.cuda
                  else None),
            launches={k: sw_cuda.LAUNCHES[k] - before[k] for k in before}))
        return out

    def __enter__(self):
        self._real_round = tassemble.assemble_round
        self._real_maps = tassemble.build_col_maps
        self._l0 = dict(sw_cuda.LAUNCHES)
        tassemble.assemble_round = self._round
        tassemble.build_col_maps = self._maps
        return self

    def __exit__(self, *exc):
        tassemble.assemble_round = self._real_round
        tassemble.build_col_maps = self._real_maps
        self.total = {k: sw_cuda.LAUNCHES[k] - self._l0[k] for k in self._l0}
        return False

    @property
    def polish_launches(self) -> dict:
        return {k: self.total[k] - sum(r["launches"][k] for r in self.rounds)
                for k in self.total}

    def check(self, what: str) -> None:
        """On the card: K1 and K2 + K3 launched in every round and not in
        polish, and what is allocated at the start of each panel round does
        not climb (round 0's retained evidence, which every later round
        carries alike, aside). Raises AssertionError."""
        if not self.cuda:
            return
        for r in self.rounds:
            if r["launches"]["score"] <= 0 or r["launches"]["align"] <= 0:
                raise AssertionError(
                    f"{what}: round {r['stats']['round']} launched "
                    f"{r['launches']}: K1 and K2+K3 must launch in every round")
        if any(self.polish_launches.values()):
            raise AssertionError(f"{what}: polish launched "
                                 f"{self.polish_launches}")
        starts = [r["start"] for r in self.rounds
                  if r["stats"]["round"] != 0]
        if starts and max(starts) > starts[0] + (1 << 20):
            raise AssertionError(f"{what}: device memory at the start of "
                                 f"each panel round climbs: {starts}")

    def report(self, card: str, out=print) -> None:
        """One line a round, one for polish's launches."""
        gb = (lambda b: "n/a" if b is None else f"{b / 1e9:.3f} GB")
        for r in self.rounds:
            st = r["stats"]
            stages = ", ".join(f"{k[2:]} {v:.2f} s" for k, v in st.items()
                               if k.startswith("t_"))
            out(f"  round {st['round']}: {st['genes']} genes, "
                f"{st.get('n_leaves')} leaves, {st.get('aligned')} aligned; "
                f"wall {r['wall']:.3f} s"
                + (f"; stages {stages}" if stages else "")
                + f"; col maps {r['colmap']:.2f} s (inside align); launches "
                f"K1 {r['launches']['score']}, K2+K3 {r['launches']['align']}"
                f"; peak {gb(r['peak'])}, allocated at start "
                f"{gb(r['start'])} [{card}]")
        out(f"  polish: launches K1 {self.polish_launches.get('score', 0)}, "
            f"K2+K3 {self.polish_launches.get('align', 0)} [{card}]")

    def summary(self) -> list:
        """The recorded rounds as plain dicts (for the runners' results)."""
        return [dict(round=r["stats"]["round"], wall_s=r["wall"],
                     colmap_s=r["colmap"], peak_bytes=r["peak"],
                     start_bytes=r["start"], launches=dict(r["launches"]),
                     stages={k[2:]: v for k, v in r["stats"].items()
                             if k.startswith("t_")})
                for r in self.rounds]
