"""K1's function under a sweep of designs (S1) and on pre-transposed inputs
(S2), the kernels of the bench scripts, with their plain PyTorch versions.
Both are instances of one CUDA strip kernel built on K1's design,
`csrc/sw_variants.cu::sw_strip_kernel<kStrips, kWarps, kPairs, Load, Out>`.

- `make_score_fn(sc, L, W, *, strips, warps, arith)` ports
  `scripts/bench_sw_variants.py::make_score_fn`: it returns `score(q, w)` with
  the contract of that script's `score`: q (B, L) and w (B, W) int8 codes ->
  (score, i_end, j_end) (B,) int32; window codes >= 4 never match; no `rows`
  truncation; any W; ties to the lowest (i, j); (0, 0, 0) for a pair with no
  positive cell. That is K1's function, so the plain version is
  `ops.sw.sw_score`; `ops.sw.sw_score_strips` runs the kernel's schedule in
  its 16-bit arithmetic.

  The knobs, one CUDA instance a `Variant`:
  - `strips` (1, 2, 4): a pair's rows cut into strips on as many lanes, each
    a column behind the one above it. More strips, more resident warps on
    the same shared memory (K1 ships 2 at 104 rows);
  - `warps` a block (1, 4): the scope of the barriers around each staged
    chunk of w against the number of blocks an SM holds;
  - `arith` ("s16x2", "s32"): two pairs a thread in packed 16-bit DPX, K1's,
    or one pair a thread in 32-bit DPX, K2 + K3's: whether the packing pays
    at 128 rows.

  The TPU script's knobs have no counterpart here, or give way to one:
  `preshift` stores the diagonal predecessor pre-rolled and `phases` splits
  the band loop so that the anti-diagonal layout's masks cost nothing; the
  column sweep rolls nothing and masks only the strips' fill and drain, so
  neither has a counterpart. `rowkey` defers the row term of the best key;
  the kernel's column key (H << rbits) + (2^rbits - i) already costs one
  multiply-add a cell, K1's, so it has none either. `tile` (pairs a grid
  step) becomes the pairs a block, which `strips`, `warps` and `arith` set
  (8 to 256). `mid_unroll` unrolled the TPU's band loop; the inner loop here
  is unrolled by a fixed factor as in K1, and `strips` sets its trip count.
- `score_pretransposed(qT, wT, sc, W)` ports `scripts/ablate_prep.py::
  kernel_only`: qT (L, B) and wT (>= W, B) int32, batch-minor, codes compared
  as given -> the raw (B,) int32 key that `rambl_tpu/ops/sw_pallas.py::
  _score_kernel` leaves in row 0 of its output tile (`ops.sw.sw_raw_key`);
  `decode_raw_key` turns it into (score, i_end, j_end). One design,
  `S2_VARIANT`; a block whose q codes all lie in 0..126 compares codes as
  bytes (a w code outside that range equals none of them), any other block
  in 32 bits (`csrc/sw_variants.cu`).
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
    _on_cpu,
    _raise_on,
    _stream,
    load_library,
)

LAUNCHES = {"variant": 0, "pretransposed": 0}

STRIPS = (1, 2, 4)
WARPS = (1, 4)
ARITHS = ("s16x2", "s32")
#: shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Variant(NamedTuple):
    """One instance of the strip kernel (`csrc/sw_variants.cu`)."""

    strips: int
    warps: int
    arith: str

    @property
    def name(self) -> str:
        return f"s{self.strips}-w{self.warps}-{self.arith}"

    @property
    def pairs(self) -> int:
        """Pairs a thread."""
        return 2 if self.arith == "s16x2" else 1

    @property
    def block_pairs(self) -> int:
        return self.warps * (32 // self.strips) * self.pairs

    def kernel(self, load: str = "S1Load", out: str = "TripleOut") -> str:
        """The instance's name as `chip_smoke.ptxas_report` gives it."""
        return (f"sw_strip_kernel<{self.strips},{self.warps},{self.pairs},"
                f"{load},{out}>")

    def smem_bytes(self, L: int) -> int:
        """Dynamic shared memory of one block at L query rows: a warp's
        column state and q planes, and a chunk of w (`StripLayout`)."""
        lanes = 32 // self.strips
        r4 = -(-L // 4)
        q_words = -(-r4 // self.strips) | 1
        col = (4 * r4 + self.strips - 1) * lanes * 8
        q = self.pairs * self.strips * q_words * lanes * 4
        w = (32 * (self.block_pairs + 4) + 15) & ~15
        return self.warps * (col + q) + w


VARIANTS = tuple(Variant(s, g, a) for s in STRIPS for g in WARPS
                 for a in ARITHS)
#: S2's one design (`csrc/sw_variants.cu` kS2Strips, kS2Warps)
S2_VARIANT = Variant(8, 4, "s16x2")


def make_score_fn(sc: ScoringParams, L: int, W: int, *, strips: int = 2,
                  warps: int = 1, arith: str = "s16x2", **old):
    """S1: a `score(q, w)` for (B, L) x (B, W) int8 pairs (module
    docstring)."""
    if old:
        raise ValueError(f"make_score_fn has no {sorted(old)}: the S1 knobs "
                         "are strips, warps and arith")
    if strips not in STRIPS or warps not in WARPS or arith not in ARITHS:
        raise ValueError(f"no S1 kernel for strips={strips}, warps={warps}, "
                         f"arith={arith!r} (built: strips {STRIPS}, warps "
                         f"{WARPS}, arith {ARITHS})")
    v = Variant(strips, warps, arith)
    if L < 4 or W < 1 or L % 4:
        raise ValueError(f"L={L}, W={W}: the kernel reads q four codes at a "
                         "time, so L must be a positive multiple of 4")
    _check_key(L, W)
    rbits = _twin.check_packed16(L, sc)
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
                rc = load_library().rambl_sw_strip_score(
                    q.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in out),
                    n, L, W, sc.match, sc.mismatch, sc.gap_open,
                    sc.gap_extend, rbits, v.strips, v.warps, v.pairs,
                    _stream(q))
            _raise_on(rc, f"sw_strip {v.name}")
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
    rows = -(-L // 4) * 4           # the kernel's rows: whole q words
    rbits = _twin.check_packed16(rows, sc)
    if _on_cpu(qT, wT):
        return _twin.sw_raw_key(qT.t().contiguous(),
                                wT[:W].t().contiguous(), sc)
    for name, t in (("qT", qT), ("wT", wT)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype}")
    if S2_VARIANT.smem_bytes(rows) > MAX_SMEM:
        raise ValueError(f"L={L} needs more shared memory than a block has")
    key = torch.empty((n,), dtype=torch.int32, device=qT.device)
    if n:
        with torch.cuda.device(qT.device):
            rc = load_library().rambl_sw_pretransposed(
                qT.data_ptr(), wT.data_ptr(), key.data_ptr(), n, L, W,
                sc.match, sc.mismatch, sc.gap_open, sc.gap_extend, rbits,
                _stream(qT))
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
