"""Ring rotation of per-rank shards: K4 (`csrc/ring.cu`) and its plain twin.

Port of `rambl_tpu/parallel/ring_dma.py`. `ring_rotate(state, mesh, impl)`
moves every rank's tuple of arrays one hop around the ring (rank r's
arrays land on rank (r + 1) % n), bitwise `lax.ppermute(i -> i+1)`:

- impl="ppermute": the plain version, one `Tensor.copy_` per rank and
  array, the counterpart of the reference's XLA collective; the only path
  for CPU ranks;
- impl="dma" / "dma_barrier": K4, `ring_permute_dma`, a hand-written copy
  kernel that writes into the neighbour's buffer (a peer pointer when the
  neighbour is another card): ONE launch a rank moves its whole tuple (at
  most MAX_ARRAYS arrays) through a ring of tiles in shared memory with
  bulk copies (`csrc/ring.cu`; `copy_walk` mirrors how it cuts the tuple
  up). "dma" is ordered by CUDA events, as the plain rotation is;
  "dma_barrier" runs the reference's neighbour entry barrier and signals
  with epoch flags instead (below). K4 raises on CPU tensors: it has no CPU
  mode and never falls back to the copy.

The launch order and the walk are checked on the CPU (`python -m pytest
tests/test_torch_ring.py`); the kernel runs only on a card (`python -m
pytest --noconftest tests/test_torch_kernels_cuda.py`, `python3
chip_smoke.py` phases 9-11).

Call between `mesh.fork()` and `mesh.join()`: the rotation runs on the rank
streams, and rank r's work issued after it (on its stream) sees its new
arrays. `out` gives the receive buffers (rank r's tuple is written by rank
r - 1); without it fresh ones are allocated.

BUFFER REUSE (the reference's ordering invariant, made explicit). The TPU's
barrier-less kernel is safe because every XLA rotation writes into a fresh
buffer. PyTorch's allocator reuses memory, and the ring reuses its receive
buffers on purpose (ping-pong: the shard a rank just probed becomes the
buffer its left neighbour writes next). So a rank writes into its right
neighbour's buffer only after the neighbour has finished every read of it
that it issued before this rotation, and reads its own new buffer only
after its left neighbour's copy into it has finished:

- "ppermute" and "dma": every rank records a start event on its stream, and
  rank r's copy waits for rank r + 1's; after its copies rank r records a
  sent event, and rank r's later work waits for rank r - 1's (stream order,
  no spinning; `_rotate_by_events`);
- "dma_barrier": the barrier kernel, which rank r passes only once both
  neighbours' barrier kernels have run, i.e. once the neighbours' streams
  got there (the reference's entry barrier); the copy kernel's last block,
  once its bulk stores have completed, release-stores the rotation's epoch
  into the receiver's one flag, and the receiver's wait kernel acquires it.
  These flags are system-scope, so the same protocol holds across cards.

dma_barrier's spinning kernels are one block each; the barrier waits only
on the other barriers, and each wait kernel is issued after every copy of
the rotation, so no spinner waits for work the host has not issued. Spins
are bounded: on timeout the kernel sets a status word and returns, and
`check_ring(mesh)` raises; the mesh `stream_align` calls it at the stream's
end.
"""

from __future__ import annotations

import ctypes

import torch

from rambl_tpu_torch.parallel.mesh import DataMesh

LAUNCHES = {"ring": 0}
IMPLS = ("ppermute", "dma", "dma_barrier")
#: a dma_barrier waiter gives up after this long (the work it waits for is
#: in flight)
TIMEOUT_NS = 10_000_000_000
#: The constants of K4's walk, which `copy_walk` mirrors: most arrays one
#: launch takes, words of a bulk tile, threads a block that copy the scalar
#: part (csrc/ring.cu kMaxArrays, kTileWords, kCopyThreads - 1). On a card
#: `kernel_layout` reads them from the built library, and the ring refuses
#: to start if they differ.
MAX_ARRAYS = 4
TILE_WORDS = 16384
SCALAR_THREADS = 127


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rotation_plan(n: int, barrier: bool) -> list[tuple]:
    """One rotation of n ranks in issue order, as the wrappers issue it (and
    as tests/test_torch_ring.py model-checks it):

    ("record", r, tag)     record rank r's `tag` event on its stream
    ("after", r, s, tag)   rank r's stream waits for rank s's `tag` event
    ("barrier", r)         rank r's entry barrier kernel
    ("copy", r)            rank r's copy of its whole tuple into rank r+1's
                           buffers (with barrier, it then releases rank
                           r+1's flag)
    ("wait", r)            rank r's wait kernel on its own flag
    """
    copies = [("copy", r) for r in range(n)]
    if barrier:
        return ([("barrier", r) for r in range(n)] + copies
                + [("wait", r) for r in range(n)])
    return ([("record", r, "start") for r in range(n)]
            + [("after", r, (r + 1) % n, "start") for r in range(n)]
            + copies
            + [("record", r, "sent") for r in range(n)]
            + [("after", r, (r - 1) % n, "sent") for r in range(n)])


def copy_walk(words: list[int], aligned: list[bool], blocks: int,
              tile_words: int = TILE_WORDS,
              scalar_threads: int = SCALAR_THREADS) -> list[dict]:
    """Which block of K4's launch copies which words: the mirror of the walk
    in `csrc/ring.cu`, for the CPU tests (every word exactly once).

    words[a] is array a's word count and aligned[a] whether its src and dst
    are both 16-byte aligned. Returns one dict a block: "tiles", the
    (array, first word, word count) bulk tiles it takes in turn (tile b,
    b + blocks, ... of the tiles numbered through the arrays), and "scalar",
    the ranges of words (array, range) that its scalar threads copy one by
    one."""
    bulk = [w & ~3 if al else 0 for w, al in zip(words, aligned)]
    tiles = [(a, first, min(tile_words, b - first))
             for a, b in enumerate(bulk) for first in range(0, b, tile_words)]
    stride = blocks * scalar_threads
    return [{"tiles": tiles[b::blocks],
             "scalar": [(a, range(bulk[a] + tid, words[a], stride))
                        for a in range(len(words))
                        for tid in range(b * scalar_threads,
                                         (b + 1) * scalar_threads)
                        if bulk[a] + tid < words[a]]}
            for b in range(blocks)]


def kernel_layout(lib) -> dict:
    """The walk's constants as the built kernel has them."""
    out = [ctypes.c_int() for _ in range(3)]
    lib.rambl_ring_layout(*(ctypes.byref(x) for x in out))
    return dict(zip(("TILE_WORDS", "SCALAR_THREADS", "MAX_ARRAYS"),
                    (x.value for x in out)))


class _Ring:
    """K4's state for one mesh: peer access and the copy grid; for
    dma_barrier, on rank r's device, flags[r] holds the receive flag then
    the barrier's "from left" and "from right" slots, arrive[r] the copy
    blocks' arrival counter; one status word (on rank 0's device) for
    all."""

    def __init__(self, mesh: DataMesh):
        from rambl_tpu_torch.ops.sw_cuda import load_library

        lib = load_library()
        mine = {"TILE_WORDS": TILE_WORDS, "SCALAR_THREADS": SCALAR_THREADS,
                "MAX_ARRAYS": MAX_ARRAYS}
        if kernel_layout(lib) != mine:
            raise RuntimeError(f"csrc/ring.cu walks {kernel_layout(lib)}, "
                               f"copy_walk mirrors {mine}")
        n = mesh.size
        devs = mesh.devices
        for r in range(n):
            for peer in {devs[(r + 1) % n], devs[(r - 1) % n], devs[0]}:
                if peer != devs[r]:
                    _raise_on(lib.rambl_ring_enable_peer(devs[r].index,
                                                         peer.index),
                              "enable peer access")
        i32 = torch.int32
        self.flags = [torch.zeros(3, dtype=i32, device=d) for d in devs]
        self.arrive = [torch.zeros(1, dtype=i32, device=d) for d in devs]
        self.status = torch.zeros(1, dtype=i32, device=devs[0])
        # persistent blocks, one an SM, each with a 192 KB ring of tiles
        self.blocks = [torch.cuda.get_device_properties(d)
                       .multi_processor_count for d in devs]
        self.epoch = 0
        for d in set(devs):
            torch.cuda.synchronize(d)       # flags are zero before any use


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _ring(mesh: DataMesh) -> _Ring:
    if "ring" not in mesh.scratch:
        mesh.scratch["ring"] = _Ring(mesh)
    return mesh.scratch["ring"]


def _check_state(state, out, mesh: DataMesh, cuda: bool) -> None:
    n = mesh.size
    if len(state) != n or (out is not None and len(out) != n):
        raise ValueError(f"need one tuple of arrays per rank of the "
                         f"{n}-rank mesh")
    for r, arrays in enumerate(state):
        if len(arrays) != len(state[0]):
            raise ValueError("every rank holds the same number of arrays")
        for a, x in enumerate(arrays):
            if x.shape != state[0][a].shape or x.dtype != state[0][a].dtype:
                raise ValueError(f"array {a}: rank {r} holds {x.dtype} "
                                 f"{tuple(x.shape)}, rank 0 "
                                 f"{state[0][a].dtype} "
                                 f"{tuple(state[0][a].shape)}")
            if x.device != mesh.devices[r]:
                raise ValueError(f"rank {r}'s array {a} is on {x.device}, "
                                 f"not {mesh.devices[r]}")
            if cuda and (x.element_size() != 4 or not x.is_contiguous()):
                raise ValueError("K4 ships contiguous 32-bit words (the "
                                 f"seed-table arrays are int32); got {x.dtype}"
                                 f" {tuple(x.shape)}")
            if out is not None:
                o = out[r][a]
                if (o.shape != x.shape or o.dtype != x.dtype
                        or o.device != x.device
                        or (cuda and not o.is_contiguous())):
                    raise ValueError(f"out[{r}][{a}] does not match the state")


def _receive_buffers(state, mesh: DataMesh):
    """Fresh buffers, each allocated on its owner's stream."""
    out = []
    for r, arrays in enumerate(state):
        with mesh.rank(r):
            out.append(tuple(torch.empty_like(x) for x in arrays))
    return out


def _rotate_by_events(state, mesh: DataMesh, copy) -> None:
    """Issue `rotation_plan(barrier=False)` on the rank streams of a card
    mesh; `copy(r, stream)` issues rank r's copy of its tuple."""
    n = mesh.size
    events = {}
    for op in rotation_plan(n, barrier=False):
        kind, r = op[0], op[1]
        s = mesh.streams[r]
        if kind == "record":
            events[op[2], r] = torch.cuda.Event()
            events[op[2], r].record(s)
        elif kind == "after":
            s.wait_event(events[op[3], op[2]])
        else:                                             # "copy"
            copy(r, s)


def ring_permute_dma(state, mesh: DataMesh, *, out=None,
                     barrier: bool = False, timeout_ns: int = TIMEOUT_NS):
    """K4: rotate each rank's tuple of at most MAX_ARRAYS int32 arrays one
    hop (r -> r+1) into `out` (fresh buffers when None) and return `out`:
    one kernel launch a rank. Raises on CPU tensors. With `barrier`, a wait
    that times out sets the ring's status word; `check_ring(mesh)` reads
    it."""
    if not mesh.on_card:
        raise RuntimeError(
            "K4 (ring_impl='dma'/'dma_barrier') runs only on CUDA ranks; "
            "the plain rotation is ring_impl='ppermute'")
    _check_state(state, out, mesh, cuda=True)
    from rambl_tpu_torch.ops.sw_cuda import load_library

    lib = load_library()
    n, n_arrays = mesh.size, len(state[0])
    if not 1 <= n_arrays <= MAX_ARRAYS:
        raise ValueError(f"K4 moves 1 to {MAX_ARRAYS} arrays a rank in one "
                         f"launch, got {n_arrays}")
    ring = _ring(mesh)
    if out is None:
        out = _receive_buffers(state, mesh)
    ring.epoch += 1
    epoch = ring.epoch
    flags = ring.flags
    pointers = ctypes.c_void_p * n_arrays
    counts = ctypes.c_longlong * n_arrays

    def copy(r, s, signal=False):
        dst = out[(r + 1) % n]
        flag = flags[(r + 1) % n].data_ptr() if signal else None
        arrive = ring.arrive[r].data_ptr() if signal else None
        with torch.cuda.device(mesh.devices[r]):
            rc = lib.rambl_ring_copy(
                pointers(*(x.data_ptr() for x in state[r])),
                pointers(*(x.data_ptr() for x in dst)),
                counts(*(x.numel() for x in state[r])), n_arrays,
                ring.blocks[r], epoch, flag, arrive, s.cuda_stream)
        _raise_on(rc, "ring_copy kernel launch")
        LAUNCHES["ring"] += 1

    if not barrier:
        _rotate_by_events(state, mesh, copy)
        return out
    for op in rotation_plan(n, barrier=True):
        kind, r = op[0], op[1]
        s = mesh.streams[r]
        if kind == "barrier":
            left, right = (r - 1) % n, (r + 1) % n
            with torch.cuda.device(mesh.devices[r]):
                rc = lib.rambl_ring_barrier(
                    flags[left].data_ptr() + 8, flags[right].data_ptr() + 4,
                    flags[r].data_ptr() + 4, epoch, timeout_ns,
                    ring.status.data_ptr(), s.cuda_stream)
            _raise_on(rc, "ring_barrier kernel launch")
        elif kind == "copy":
            copy(r, s, signal=True)
        else:                                             # "wait"
            with torch.cuda.device(mesh.devices[r]):
                rc = lib.rambl_ring_wait(
                    flags[r].data_ptr(), 1, epoch, timeout_ns,
                    ring.status.data_ptr(), s.cuda_stream)
            _raise_on(rc, "ring_wait kernel launch")
    return out


def check_ring(mesh: DataMesh) -> None:
    """Raise if a dma_barrier wait or barrier of this mesh timed out
    (synchronizes the mesh's cards first)."""
    ring = mesh.scratch.get("ring")
    if ring is None:
        return
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    code = int(ring.status.item())
    if code:
        what = {1: "entry barrier", 2: "receive wait"}.get(code, code)
        raise RuntimeError(
            f"K4 ring {what} timed out at epoch <= {ring.epoch}: a "
            "neighbour never signalled")


def _rotate_plain(state, mesh: DataMesh, out):
    """The plain rotation: out[r + 1] <- state[r] with `copy_`, ordered by
    events on the rank streams as K4's "dma" is (module docstring)."""
    n = mesh.size
    if not mesh.on_card:
        for r in range(n):
            for x, o in zip(state[r], out[(r + 1) % n]):
                o.copy_(x)
        return out

    def copy(r, s):
        with torch.cuda.stream(s):
            for x, o in zip(state[r], out[(r + 1) % n]):
                o.copy_(x, non_blocking=True)

    _rotate_by_events(state, mesh, copy)
    return out


def ring_rotate(state, mesh: DataMesh, impl: str = "ppermute", *, out=None,
                timeout_ns: int = TIMEOUT_NS):
    """Rotate a per-rank list of array tuples one hop (r -> r+1); returns
    the per-rank list of rotated tuples (`out` when given). `timeout_ns`
    bounds dma_barrier's waits."""
    if impl not in IMPLS:
        raise ValueError(f"ring_impl {impl!r} is not one of {IMPLS}")
    if impl != "ppermute":
        return ring_permute_dma(state, mesh, out=out,
                                barrier=impl == "dma_barrier",
                                timeout_ns=timeout_ns)
    _check_state(state, out, mesh, cuda=False)
    if out is None:
        out = _receive_buffers(state, mesh)
    return _rotate_plain(state, mesh, out)
