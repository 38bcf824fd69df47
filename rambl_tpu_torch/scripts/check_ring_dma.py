"""Bitwise check of the ring rotation's transports: the port of
scripts/check_ring_dma.py.

Rotates the reference's arrays one hop round an n-rank mesh under every
`ring_impl` of `parallel.ring_dma.ring_rotate`: "ppermute" (the plain
`copy_` rotation), "dma" (K4, `csrc/ring.cu`, ordered by CUDA events) and
"dma_barrier" (K4 behind the neighbour entry barrier, signalled by epoch
flags), and holds each result to `np.roll` of the host arrays, bit for bit.
The arrays are (n * 4096, 4) entries `arange(n * 4096 * 4)` and n * 128
bucket starts `arange(n * 128)`, rank r holding the r-th slice of each.

It is the ready-to-run certification of K4 across cards: on a machine with
at least n cards the ranks are the first n cards, and the copies cross
between them. With fewer, the ranks are n virtual ranks of one card (one
stream each, one memory), which runs K4's whole launch and signalling
protocol but not a cross-card copy; the script says so.

    python -m rambl_tpu_torch.scripts.check_ring_dma [n] [--device D]

On CPU ranks (`--device cpu`) only the plain rotation runs (`--impls
ppermute`): K4 has no CPU mode and raises there.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.parallel.mesh import data_mesh, put_sharded
from rambl_tpu_torch.parallel.ring_dma import IMPLS, check_ring, ring_rotate

ROWS, COLS, STARTS = 4096, 4, 128


def run(n: int = 4, impls=IMPLS, *, device=None, out=print) -> dict:
    """Rotate the arrays once under each of `impls` on an n-rank mesh and
    check every result against np.roll; returns {impl: (entries, bucket
    starts)}, the rotated arrays on the host, and raises on the first
    mismatch. `device` None: the first n cards when the machine
    has them, else n virtual ranks of the first card; a device: n ranks of
    it."""
    dev = resolve(device)
    if device is None and torch.cuda.device_count() >= n:
        mesh = data_mesh(n)
    else:
        mesh = data_mesh(devices=[dev] * n)
    cards = len(set(mesh.devices))
    out(f"ranks: {[str(d) for d in mesh.devices]}")
    ent = np.arange(n * ROWS * COLS, dtype=np.int32).reshape(n * ROWS, COLS)
    bs = np.arange(n * STARTS, dtype=np.int32)
    want_e = np.roll(ent.reshape(n, ROWS, COLS), 1, 0).reshape(-1, COLS)
    want_b = np.roll(bs.reshape(n, STARTS), 1, 0).reshape(-1)
    state = list(zip(put_sharded(ent, mesh), put_sharded(bs, mesh)))
    done = {}
    for impl in impls:
        mesh.fork()
        got = ring_rotate(state, mesh, impl)
        mesh.join()
        if mesh.on_card:
            check_ring(mesh)
        e2 = torch.cat([g[0].cpu() for g in got]).numpy()
        b2 = torch.cat([g[1].cpu() for g in got]).numpy()
        for what, g, w in (("entries", e2, want_e), ("bucket starts", b2,
                                                     want_b)):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"{impl}: the rotated {what} differ "
                                     "from np.roll of the host arrays")
        done[impl] = (e2, b2)
        out(f"  {impl:12s}: bitwise OK on {n} rank(s), {cards} device(s)")
    note = ""
    if cards < n or n == 1:
        note = (f" ({n} virtual rank(s) of {mesh.devices[0]}: cross-card "
                f"ordering is not certified; rerun on a machine with >= "
                f"{max(n, 2)} cards)")
    out(f"ring rotation: {', '.join(done)} bitwise OK" + note)
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=4,
                    help="ranks of the ring (default 4)")
    ap.add_argument("--impls", nargs="+", default=list(IMPLS),
                    choices=IMPLS)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the first n "
                    "cards, or virtual ranks of the first card)")
    args = ap.parse_args(argv)
    run(args.n, tuple(args.impls), device=args.device)


if __name__ == "__main__":
    main()
