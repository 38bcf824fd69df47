"""The port's `scripts/check_ring_dma.py` on CPU ranks against the JAX
package's rotation, bit for bit.

`run(n, impls=("ppermute",), device="cpu")` at n = 1, 2 and 4 rotates the
reference script's arrays (entries `arange(n*4096*4)` as (n*4096, 4),
bucket starts `arange(n*128)`) one hop: the result equals `np.roll` and
the JAX `ring_rotate(..., impl="ppermute")` under `shard_map` on the first
n of the 8 CPU devices that tests/conftest.py forces. K4 ("dma",
"dma_barrier") has no CPU mode: on CPU ranks it raises, never falls back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from rambl_tpu.parallel.mesh import DATA_AXIS, data_mesh
from rambl_tpu.parallel.ring_dma import ring_rotate
from rambl_tpu_torch.scripts import check_ring_dma


def _jax_rotation(n):
    mesh = data_mesh(n)
    ent = jnp.arange(n * 4096 * 4, dtype=jnp.int32).reshape(n * 4096, 4)
    bs = jnp.arange(n * 128, dtype=jnp.int32)
    f = jax.jit(jax.shard_map(
        lambda e, b: ring_rotate((e, b), DATA_AXIS, impl="ppermute"),
        mesh=mesh, in_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)), check_vma=False))
    return [np.asarray(x) for x in f(ent, bs)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_plain_rotation_matches_jax(n):
    lines = []
    got = check_ring_dma.run(n, ("ppermute",), device="cpu",
                             out=lines.append)
    assert list(got) == ["ppermute"]
    want_e, want_b = _jax_rotation(n)
    for g, w in zip(got["ppermute"], (want_e, want_b)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        want_e, np.roll(np.arange(n * 4096 * 4, dtype=np.int32).reshape(
            n, 4096, 4), 1, 0).reshape(-1, 4))
    assert "ppermute" in lines[-1] and "not certified" in lines[-1]


@pytest.mark.parametrize("impl", ["dma", "dma_barrier"])
def test_k4_on_cpu_ranks_raises(impl):
    with pytest.raises(RuntimeError, match="runs only on CUDA ranks"):
        check_ring_dma.run(2, ("ppermute", impl), device="cpu",
                           out=lambda *a: None)
