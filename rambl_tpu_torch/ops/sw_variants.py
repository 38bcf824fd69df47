"""K1 variants (S1) and K1 on pre-transposed inputs (S2), the kernels of the
bench scripts (`csrc/sw_variants.cu`), with their plain PyTorch versions.

- `make_score_fn(sc, L, W, *, threads, unroll, stage_q)` ports
  `scripts/bench_sw_variants.py::make_score_fn`: it returns `score(q, w)` with
  the contract of that script's `score`: q (B, L) and w (B, W) int8 codes ->
  (score, i_end, j_end) (B,) int32; window codes >= 4 never match; no `rows`
  truncation; any W; ties to the lowest (i, j); (0, 0, 0) for a pair with no
  positive cell. That is K1's function, so the plain version is
  `ops.sw.sw_score`.

  The TPU script's knobs `preshift`, `phases` and `rowkey` remove roll and
  select work of its anti-diagonal layout. The CUDA kernel sweeps columns
  and does none of that work, so they have no counterpart here. Its knobs
  are `threads` per block (64, 128, 256; the TPU's `tile`), the `unroll` of
  the inner row loop (4 or 8; the TPU's `mid_unroll`) and `stage_q`, which
  stages the block's q tile in shared memory with coalesced loads.
- `score_pretransposed(qT, wT, sc, W)` ports `scripts/ablate_prep.py::
  kernel_only`: qT (L, B) and wT (>= W, B) int32, batch-minor, -> the raw
  (B,) int32 key that `rambl_tpu/ops/sw_pallas.py::_score_kernel` leaves in
  row 0 of its output tile (`ops.sw.sw_raw_key`); `decode_raw_key` turns it
  into (score, i_end, j_end).
- `prep(q, w)` is that script's input preparation (cast, transpose, pad) in
  plain PyTorch: what the S2 ablation times against the kernel.

As in `ops.sw_cuda`, a CUDA tensor launches the kernel or raises, a CPU tensor
takes the plain version, and `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.ops import sw as _twin
from rambl_tpu_torch.ops.sw_cuda import (
    _check_key,
    _check_scores,
    _on_cpu,
    _raise_on,
    _scoring_args,
    _stream,
    load_library,
)

LAUNCHES = {"variant": 0, "pretransposed": 0}

THREADS = (64, 128, 256)
UNROLLS = (4, 8)
#: shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Variant(NamedTuple):
    """One build of the S1 kernel (`csrc/sw_variants.cu`)."""

    threads: int
    unroll: int
    stage_q: bool

    @property
    def name(self) -> str:
        return (f"t{self.threads}-u{self.unroll}"
                + ("-smem" if self.stage_q else ""))

    def smem_bytes(self, L: int) -> int:
        """Dynamic shared memory of one block at L query rows."""
        words = (L + 1) * self.threads
        if self.stage_q:
            words += (L // 4) * (self.threads + 1)
        return 4 * words


VARIANTS = tuple(Variant(t, u, s) for t in THREADS for u in UNROLLS
                 for s in (False, True))


def make_score_fn(sc: ScoringParams, L: int, W: int, *, threads: int = 128,
                  unroll: int = 4, stage_q: bool = False):
    """S1: a `score(q, w)` for (B, L) x (B, W) int8 pairs (module
    docstring)."""
    v = Variant(threads, unroll, bool(stage_q))
    if threads not in THREADS or unroll not in UNROLLS:
        raise ValueError(f"no S1 kernel for threads={threads}, unroll="
                         f"{unroll} (built: threads {THREADS}, unroll "
                         f"{UNROLLS})")
    if L < 4 or W < 1 or L % 4:
        raise ValueError(f"L={L}, W={W}: the kernel reads q four codes at a "
                         "time, so L must be a positive multiple of 4")
    _check_key(L, W)
    _check_scores(L, sc)
    if v.smem_bytes(L) > MAX_SMEM:
        raise ValueError(f"variant {v.name} needs {v.smem_bytes(L)} B of "
                         f"shared memory at L={L} (> {MAX_SMEM})")

    def score(q: torch.Tensor, w: torch.Tensor):
        if q.dim() != 2 or w.dim() != 2 or q.shape[1] != L or w.shape[1] != W:
            raise ValueError(f"q/w shapes {tuple(q.shape)}/{tuple(w.shape)} "
                             f"do not match L={L}, W={W}")
        if q.shape[0] != w.shape[0]:
            raise ValueError(f"pair counts differ: q {q.shape[0]} "
                             f"w {w.shape[0]}")
        if _on_cpu(q, w):
            return _twin.sw_score(q, w, sc)
        for name, t in (("q", q), ("w", w)):
            if t.dtype != torch.int8 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int8 tensor, "
                                 f"got {t.dtype}")
        if q.data_ptr() % 4:
            raise ValueError("q must be 4-byte aligned")
        n = q.shape[0]
        if n >= 1 << 31:
            raise ValueError(f"batch of {n} pairs exceeds int32")
        out = [torch.empty((n,), dtype=torch.int32, device=q.device)
               for _ in range(3)]
        if n:
            with torch.cuda.device(q.device):
                rc = load_library().rambl_sw_variant_score(
                    q.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in out),
                    n, L, W, *_scoring_args(sc), v.threads, v.unroll,
                    int(v.stage_q), _stream(q))
            _raise_on(rc, f"sw_variant {v.name}")
            LAUNCHES["variant"] += 1
        return tuple(out)

    return score


def score_pretransposed(qT: torch.Tensor, wT: torch.Tensor,
                        sc: ScoringParams, W: int) -> torch.Tensor:
    """S2: qT (L, B) and wT (>= W, B) integer codes, batch-minor -> the raw
    (B,) int32 best key (module docstring). Only rows 0..W-1 of wT are
    read; the match test is qT == wT on the codes as given."""
    if qT.dim() != 2 or wT.dim() != 2 or wT.shape[1] != qT.shape[1]:
        raise ValueError(f"qT {tuple(qT.shape)} and wT {tuple(wT.shape)} "
                         "must be (L, B) and (>= W, B)")
    L, n = qT.shape
    if L < 1 or W < 1 or wT.shape[0] < W:
        raise ValueError(f"wT has {wT.shape[0]} rows; W={W} needs >= 1 and "
                         f"<= that, and L={L} >= 1")
    _check_key(L, W)
    _check_scores(L, sc)
    if _on_cpu(qT, wT):
        return _twin.sw_raw_key(qT.t().contiguous(),
                                wT[:W].t().contiguous(), sc)
    for name, t in (("qT", qT), ("wT", wT)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype}")
    if (L + 1) * 128 * 4 > MAX_SMEM:
        raise ValueError(f"L={L} needs more shared memory than a block has")
    key = torch.empty((n,), dtype=torch.int32, device=qT.device)
    if n:
        with torch.cuda.device(qT.device):
            rc = load_library().rambl_sw_pretransposed(
                qT.data_ptr(), wT.data_ptr(), key.data_ptr(), n, L, W,
                *_scoring_args(sc), _stream(qT))
        _raise_on(rc, "sw_pretransposed")
        LAUNCHES["pretransposed"] += 1
    return key


def decode_raw_key(key: torch.Tensor, W: int):
    """Raw best keys -> (score, i_end, j_end), as `sw_score_pallas` decodes
    the kernel's output (a key <= 0 means no positive cell: (0, 0, 0))."""
    return _twin.decode_best(key, W)


def prep(q: torch.Tensor, w: torch.Tensor):
    """`scripts/ablate_prep.py`'s input preparation: q (B, L) and w (B, W)
    int8 -> qT (L, B) int32 and wT (W + L + 1, B) int32, the window padded
    with code 4 (no sentinel remap, as in that script)."""
    B, L = q.shape
    qT = q.to(torch.int32).t().contiguous()
    pad = torch.full((B, L + 1), 4, dtype=torch.int32, device=w.device)
    wT = torch.cat([w.to(torch.int32), pad], dim=1).t().contiguous()
    return qT, wT
