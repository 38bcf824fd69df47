"""Wrappers of the hand-written Hopper SW kernels (`csrc/sw.cu`).

- `sw_score_cuda` runs K1 (replaces `rambl_tpu/ops/sw_pallas.py::
  _score_kernel`) on every (query, window) pair of a batch: two pairs a
  thread in packed 16-bit DPX arithmetic on q and w tiles staged in shared
  memory;
- `sw_align_traceback_cuda` runs K2 + K3 in one launch (replaces
  `sw_pallas.py::_align_kernel` and `sw_pallas.py::sw_traceback_packed`):
  the same DP in 32-bit arithmetic, a warp a pair with the rows across its
  lanes, the direction codes kept in shared memory and walked there into
  ref_col, as the align step calls it;
- `sw_align_cuda` launches the same kernel with its optional output on: every
  cell's direction code as a byte, for the tests (`ops.sw.sw_align`'s
  dirs).

On a CUDA tensor a wrapper launches its kernel or raises; it never falls
back. On CPU tensors it runs the plain PyTorch twin from `ops.sw`, which is
what the CPU tests exercise (`python -m pytest tests/test_torch_sw.py`; they
also hold K1's 16-bit arithmetic, `ops.sw.sw_score_packed16`, against the
twin and the JAX package; tests/test_torch_sw_align_lanes.py holds the
fused kernel's schedule, `ops.sw.sw_align_traceback_lanes`, against the
twins and the JAX package). `LAUNCHES` counts kernel launches, one per
launch and nowhere else, so a run can show that it went through the kernels.
The kernels themselves are held against the twins on a card by
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py` and by
`python3 chip_smoke.py`, both from the repository root.

The library is built from every source in `csrc/` (these kernels, those
of `ops.sw_variants`, K4 of `parallel.ring_dma` and DP-means' recount of
`ops.cluster_cuda`) with nvcc for sm_90a at
first use into `_build/` (ignored by git) and rebuilt when the sources or
flags change. The C entry points take plain pointers and the stream, loaded
with ctypes.

`rows` keeps the reference contract (`sw_pallas.py::sw_score_pallas`): only
the first `rows` query rows are swept (0 = all). That is exact whenever every
real read fits in `rows`, because a pad-row cell can never win the DP.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.ops import sw as _twin

LAUNCHES = {"score": 0, "align": 0}
#: the fused kernel takes at most 32 lanes x 8 rows
MAX_ALIGN_ROWS = 256

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LIB_NAME = "librambl_sw.so"
#: nvcc's command line and output of the last build, including the
#: `-Xptxas -v` report of registers, shared memory and spills per kernel
BUILD_LOG = os.path.join(_BUILD, "nvcc.log")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def _in(folder: str, suffix: str) -> list[str]:
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.endswith(suffix))


def build_library() -> str:
    """Compile every csrc/*.cu into _build/librambl_sw.so unless an
    up-to-date build exists; returns the library path. One nvcc a source,
    all started together, then one link. The compilers' output is kept in
    BUILD_LOG."""
    srcs = _in(_CSRC, ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + _in(_CSRC, ".cuh"):
        with open(s, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    lib = os.path.join(_BUILD, _LIB_NAME)
    stamp = lib + ".sha256"
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return lib
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib}.{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(srcs))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for o, s in zip(objs, srcs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    if ok:
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", tag + ".tmp", *objs])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        ok = link.returncode == 0
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    with open(BUILD_LOG, "w") as f:
        f.write(log)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if not ok:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tag + ".tmp", lib)
    with open(stamp, "w") as f:
        f.write(digest)
    return lib


def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rambl_sw_score.argtypes = [P] * 5 + [I] * 9 + [P]
            lib.rambl_sw_align.argtypes = [P] * 7 + [I] * 9 + [P]
            lib.rambl_sw_strip_score.argtypes = [P] * 5 + [I] * 11 + [P]
            lib.rambl_sw_pretransposed.argtypes = [P] * 3 + [I] * 8 + [P]
            # K4 (csrc/ring.cu, wrapped by parallel.ring_dma)
            lib.rambl_ring_copy.argtypes = [P, P, P, I, I, I, P, P, P]
            lib.rambl_ring_wait.argtypes = [P, I, I, LL, P, P]
            lib.rambl_ring_barrier.argtypes = [P, P, P, I, LL, P, P]
            lib.rambl_ring_enable_peer.argtypes = [I, I]
            lib.rambl_ring_layout.argtypes = [P, P, P]
            lib.rambl_ring_layout.restype = None
            # DP-means' recount (csrc/cluster.cu, wrapped by ops.cluster_cuda)
            lib.rambl_dp_recount.argtypes = [P] * 5 + [I] * 4 + [P]
            for fn in (lib.rambl_sw_score, lib.rambl_sw_align,
                       lib.rambl_sw_strip_score,
                       lib.rambl_sw_pretransposed, lib.rambl_ring_copy,
                       lib.rambl_ring_wait, lib.rambl_ring_barrier,
                       lib.rambl_ring_enable_peer, lib.rambl_dp_recount):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _rows(rows: int, L: int) -> int:
    """Validated row count of the sweep (reference contract)."""
    if rows and rows < L:
        if rows % 8:
            raise ValueError(f"rows={rows} must be a multiple of 8")
        return rows
    return L


def _check_key(rows: int, W: int) -> None:
    # the packed best-cell key is H * 32768 - pos with pos = i*(W+1)+j; the
    # decode mis-reads silently if pos can reach 32768
    if rows * (W + 1) + W >= _twin.TIE:
        raise ValueError(
            f"best-key overflow: rows={rows}, W={W} gives max pos "
            f"{rows * (W + 1) + W} >= {_twin.TIE}; shrink read_len_max/"
            "window_margin")


def _check_scores(rows: int, sc: ScoringParams) -> None:
    # H and E share one 32-bit word in the kernels (csrc/sw_common.cuh)
    if rows * sc.match >= 1 << 15 or sc.gap_open + sc.gap_extend >= 1 << 15:
        raise ValueError("scores out of the kernel's 16-bit H/E range")


def _check_pair_cuda(q: torch.Tensor, w: torch.Tensor, rows: int,
                     sc: ScoringParams) -> None:
    for name, t in (("q", q), ("w", w)):
        if t.dtype != torch.int8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int8 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if q.shape[0] != w.shape[0]:
        raise ValueError(f"pair counts differ: q {q.shape[0]} w {w.shape[0]}")
    L = q.shape[1]
    if L % 4 or rows % 4 or q.data_ptr() % 4:
        raise ValueError(f"the kernel reads q four codes at a time: L={L} "
                         f"and rows={rows} must be multiples of 4 and q "
                         "4-byte aligned")
    _check_scores(rows, sc)
    if q.shape[0] >= 1 << 31:
        raise ValueError(f"batch of {q.shape[0]} pairs exceeds int32")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _scoring_args(sc: ScoringParams):
    return (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend, sc.neg_inf)


def sw_score_cuda(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams,
                  rows: int = 0):
    """K1. q (n, L) int8, w (n, W) int8 -> (score, i_end, j_end) (n,) int32.

    On the card the kernel works in packed 16-bit halves (two pairs a
    thread, `csrc/sw.cu`); `ops.sw.check_packed16` raises on shapes
    or scores whose values would not fit a half. `ops.sw.sw_score_packed16`
    is that arithmetic in plain PyTorch, held against `ops.sw.sw_score`
    (the twin the CPU path runs) in tests/test_torch_sw.py."""
    L, W = q.shape[1], w.shape[1]
    rows = _rows(rows, L)
    _check_key(rows, W)
    if _on_cpu(q, w):
        return _twin.sw_score(q[:, :rows], w, sc)
    _check_pair_cuda(q, w, rows, sc)
    rbits = _twin.check_packed16(rows, sc)
    n = q.shape[0]
    out = [torch.empty((n,), dtype=torch.int32, device=q.device)
           for _ in range(3)]
    if n:
        with torch.cuda.device(q.device):
            rc = load_library().rambl_sw_score(
                q.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in out),
                n, L, W, rows, sc.match, sc.mismatch, sc.gap_open,
                sc.gap_extend, rbits, _stream(q))
        _raise_on(rc, "sw_score")
        LAUNCHES["score"] += 1
    return tuple(out)


def _align_launch(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams,
                  rows: int, dirs: torch.Tensor | None):
    """One launch of the fused K2 + K3 kernel on checked card tensors ->
    (score, i_end, j_end, ref_col (n, L) int32). `dirs`, when given, is a
    zeroed (rows + W - 1, rows, n) uint8 buffer that also receives every
    cell's code."""
    _check_pair_cuda(q, w, rows, sc)
    if rows > MAX_ALIGN_ROWS:
        raise ValueError(f"rows={rows} exceeds the align kernel's "
                         f"{MAX_ALIGN_ROWS} (32 lanes x 8 rows)")
    n, L = q.shape
    out = [torch.empty((n,), dtype=torch.int32, device=q.device)
           for _ in range(3)]
    ref_col = torch.empty((n, L), dtype=torch.int32, device=q.device)
    if n:
        with torch.cuda.device(q.device):
            rc = load_library().rambl_sw_align(
                q.data_ptr(), w.data_ptr(), *(o.data_ptr() for o in out),
                ref_col.data_ptr(), 0 if dirs is None else dirs.data_ptr(),
                n, L, w.shape[1], rows, *_scoring_args(sc), _stream(q))
        _raise_on(rc, "sw_align_traceback")
        LAUNCHES["align"] += 1
    return (*out, ref_col)


def sw_align_cuda(q: torch.Tensor, w: torch.Tensor, sc: ScoringParams,
                  rows: int = 0):
    """The fused K2 + K3 kernel with its direction output on -> (score,
    i_end, j_end, dirs) with dirs (rows + W - 1, rows, n) uint8: the twin's
    anti-diagonal layout with the batch axis last (`dirs.permute(0, 2, 1)`
    is `ops.sw.sw_align`'s dirs). For the tests: the align step calls
    `sw_align_traceback_cuda`, which writes no dirs."""
    L, W = q.shape[1], w.shape[1]
    rows = _rows(rows, L)
    _check_key(rows, W)
    if _on_cpu(q, w):
        s, ie, je, dirs = _twin.sw_align(q[:, :rows], w, sc)
        return s, ie, je, dirs.permute(0, 2, 1).contiguous()
    dirs = torch.zeros((rows + W - 1, rows, q.shape[0]), dtype=torch.uint8,
                       device=q.device)
    return (*_align_launch(q, w, sc, rows, dirs)[:3], dirs)


def sw_align_traceback_cuda(q: torch.Tensor, w: torch.Tensor,
                            sc: ScoringParams, rows: int, L: int, W: int):
    """K2 + K3 in one launch -> (score, i_end, j_end, ref_col (n, L) int32):
    the window column of each query position on a diagonal move of the
    traceback, -1 elsewhere."""
    if q.shape[1] != L or w.shape[1] != W:
        raise ValueError(f"q/w shapes {tuple(q.shape)}/{tuple(w.shape)} "
                         f"do not match L={L}, W={W}")
    rows = _rows(rows, L)
    _check_key(rows, W)
    if _on_cpu(q, w):
        s, ie, je, dirs = _twin.sw_align(q[:, :rows], w, sc)
        return s, ie, je, _twin.sw_traceback(dirs, ie, je, L, W)
    return _align_launch(q, w, sc, rows, None)
