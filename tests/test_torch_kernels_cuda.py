"""The hand-written CUDA kernels == their plain PyTorch versions, on the
card: K1 and the fused K2 + K3 (`ops.sw_cuda`), the bench kernels S1 (every
variant) and S2 (`ops.sw_variants`), K4, the ring rotation
(`parallel.ring_dma`), on virtual ranks of one card, and DP-means' center
recount (`ops.cluster_cuda`).

Needs an NVIDIA GPU (sm_90a) and nvcc; every test here skips with a reason
elsewhere. The file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Kernel and twin get the same inputs on the card and must agree bit for bit;
256 pairs are also held against the port's NumPy oracle
`rambl_tpu_torch.oracle.sw`.
"""

import numpy as np
import pytest
import torch

from rambl_tpu_torch.config import ScoringParams
from rambl_tpu_torch.oracle.sw import sw_batch, traceback_batch
from rambl_tpu_torch.ops import sw as tsw
from rambl_tpu_torch.ops import sw_cuda
from rambl_tpu_torch.ops import sw_variants as sv
from rambl_tpu_torch.parallel import ring_dma
from rambl_tpu_torch.parallel.mesh import data_mesh
from rambl_tpu_torch.utils.ring_cases import TUPLE_CASES, ring_tuples
from rambl_tpu_torch.utils.sw_cases import (
    adversarial_pairs,
    gapped_pairs,
    planted_pairs,
    short_reads,
)

SC = ScoringParams()
L, W, ROWS = 128, 160, 104           # the align step's shapes at sw_rows=104

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernels have no CPU "
                    "mode (their CPU twins are tested in test_torch_sw.py)")
    return torch.device("cuda", 0)


def _on(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("rows", [0, ROWS])
def test_score_kernel_matches_twin(dev, rows):
    if rows:
        q, w = short_reads(0, 4096, L, W, rows, min_len=60)
    else:
        q, w = planted_pairs(0, 4096, L, W)
    qt, wt = _on(dev, q, w)
    before = sw_cuda.LAUNCHES["score"]
    got = sw_cuda.sw_score_cuda(qt, wt, SC, rows=rows)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES["score"] == before + 1
    _equal(got, tsw.sw_score(qt[:, :rows or L], wt, SC))


@pytest.mark.parametrize("n", [1, 2, 31, 33, 63, 64, 65, 1000 + 37])
@pytest.mark.parametrize("rows", [0, ROWS])
def test_score_kernel_ragged_sizes(dev, n, rows):
    # n = 1, odd n (the last thread's second half has no pair), n not a
    # multiple of a block's pairs; the results beyond n stay untouched
    q, w = short_reads(n, n, L, W, ROWS, min_len=40)
    qt, wt = _on(dev, q, w)
    got = sw_cuda.sw_score_cuda(qt, wt, SC, rows=rows)
    torch.cuda.synchronize()
    _equal(got, tsw.sw_score(qt[:, :rows or L], wt, SC))
    for g, r in zip(got, sw_batch(q[:64], w[:64], SC, want_dirs=False)):
        np.testing.assert_array_equal(r, g[:64].cpu().numpy())


def test_score_kernel_empty_batch_launches_nothing(dev):
    q = torch.zeros((0, L), dtype=torch.int8, device=dev)
    w = torch.zeros((0, W), dtype=torch.int8, device=dev)
    before = sw_cuda.LAUNCHES["score"]
    got = sw_cuda.sw_score_cuda(q, w, SC, rows=ROWS)
    assert sw_cuda.LAUNCHES["score"] == before
    assert all(g.shape == (0,) and g.dtype == torch.int32 for g in got)


@pytest.mark.parametrize("shape", [(4, 9), (12, 21), (16, 24), (20, 33),
                                   (24, 33), (32, 48), (48, 161), (128, 161)])
def test_score_kernel_other_shapes(dev, shape):
    # small and odd widths: uneven strips of rows (1, 3 and 5 q words), a
    # window that is not a multiple of the staged chunk or of 4 bytes
    Ls, Ws = shape
    q, w = planted_pairs(9, 300, Ls, Ws)
    q[-3:], w[-3:] = 4, 4                              # all-N pairs
    qt, wt = _on(dev, q, w)
    got = sw_cuda.sw_score_cuda(qt, wt, SC)
    _equal(got, tsw.sw_score(qt, wt, SC))
    assert not any(int(g[-3:].abs().sum()) for g in got)


def test_score_kernel_adversarial_pairs(dev):
    # the CPU tests' cases of the 16-bit arithmetic, on the kernel
    q, w = adversarial_pairs(10, L, W)
    qt, wt = _on(dev, q, w)
    for rows in (0, ROWS):
        got = sw_cuda.sw_score_cuda(qt, wt, SC, rows=rows)
        _equal(got, tsw.sw_score(qt[:, :rows or L], wt, SC))
        assert (got[0][:32] == (rows or L)).all()
        assert (got[0][128:160] == 0).all()
        for g, r in zip(got, tsw.sw_score_packed16(
                qt[:160, :rows or L].cpu(), wt[:160].cpu(), SC)):
            assert torch.equal(g[:160].cpu(), r)


def test_score_kernel_rejects_scores_beyond_16_bits(dev):
    q, w = _on(dev, *planted_pairs(4, 8, L, W))
    with pytest.raises(ValueError, match="16-bit"):
        sw_cuda.sw_score_cuda(q, w, ScoringParams(match=2))


def test_score_kernel_matches_oracle(dev):
    q, w = planted_pairs(1, 256, L, W)
    got = sw_cuda.sw_score_cuda(*_on(dev, q, w), SC)
    ref = sw_batch(q, w, SC, want_dirs=False)[:3]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(r, g.cpu().numpy())


#: (L, W, rows) of the fused K2 + K3 kernel: 26 lanes of 4 rows at the
#: path's 104, 2 at 8, 32 at 128, R = 8 from 129 rows (200: 25 lanes; 132:
#: a last lane of 4 live rows)
ALIGN_SHAPES = [(L, W, 0), (L, W, 8), (L, W, ROWS), (136, W, 128),
                (200, W, 0), (132, W, 0), (136, W, 136)]


def _gapped_with_all_n(seed, n, Ls, Ws):
    q, w = gapped_pairs(seed, n, Ls, Ws)
    q[-16:], w[-16:] = 4, 4                      # all-N pairs: nothing traced
    return q, w


def _align_twin(qt, wt, rows, Ls, Ws):
    s, ie, je, dirs = tsw.sw_align(qt[:, :rows], wt, SC)
    return s, ie, je, tsw.sw_traceback(dirs, ie, je, Ls, Ws), dirs


@pytest.mark.parametrize("Ls,Ws,rows", ALIGN_SHAPES)
def test_align_traceback_kernels_match_twin(dev, Ls, Ws, rows):
    # one launch each: the main path's (no dirs) and the tests' (every
    # cell's code as a byte, also against the twin's dirs)
    q, w = _gapped_with_all_n(2, 1024 + 5, Ls, Ws)
    qt, wt = _on(dev, q, w)
    nrows = rows or Ls
    s, ie, je, rc, dirs = _align_twin(qt, wt, nrows, Ls, Ws)
    before = sw_cuda.LAUNCHES["align"]
    got = sw_cuda.sw_align_traceback_cuda(qt, wt, SC, rows, Ls, Ws)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES["align"] == before + 1
    _equal(got, (s, ie, je, rc))
    assert (got[0][-16:] == 0).all() and (got[3][-16:] == -1).all()
    gs, gie, gje, gdirs = sw_cuda.sw_align_cuda(qt, wt, SC, rows)
    _equal((gs, gie, gje, gdirs.permute(0, 2, 1)), (s, ie, je, dirs))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 33, 171])
def test_align_traceback_kernel_ragged_sizes(dev, n):
    # n not a multiple of a block's warps: the warps past n leave
    q, w = short_reads(n, n, L, W, ROWS, min_len=40)
    qt, wt = _on(dev, q, w)
    got = sw_cuda.sw_align_traceback_cuda(qt, wt, SC, ROWS, L, W)
    _equal(got, _align_twin(qt, wt, ROWS, L, W)[:4])


def test_align_traceback_kernel_empty_batch_launches_nothing(dev):
    q = torch.zeros((0, L), dtype=torch.int8, device=dev)
    w = torch.zeros((0, W), dtype=torch.int8, device=dev)
    before = sw_cuda.LAUNCHES["align"]
    got = sw_cuda.sw_align_traceback_cuda(q, w, SC, ROWS, L, W)
    assert sw_cuda.LAUNCHES["align"] == before
    assert [tuple(g.shape) for g in got] == [(0,), (0,), (0,), (0, L)]


def test_traceback_kernel_matches_oracle(dev):
    q, w = gapped_pairs(3, 256, L, W)
    _, _, _, rc = sw_cuda.sw_align_traceback_cuda(*_on(dev, q, w), SC, 0, L, W)
    _, ie, je, dirp = sw_batch(q, w, SC, want_dirs=True)
    np.testing.assert_array_equal(traceback_batch(dirp, ie, je, L),
                                  rc.cpu().numpy())


def test_kernel_wrappers_reject_bad_inputs(dev):
    q, w = _on(dev, *planted_pairs(4, 8, L, W))
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_score_cuda(q.to(torch.int32), w, SC)
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_score_cuda(q.t().contiguous().t(), w, SC)
    with pytest.raises(ValueError, match="different devices"):
        sw_cuda.sw_score_cuda(q, w.cpu(), SC)
    with pytest.raises(ValueError, match="multiples of 4"):
        sw_cuda.sw_score_cuda(q[:, :126].contiguous(), w, SC)
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_align_traceback_cuda(q.long(), w, SC, ROWS, L, W)
    with pytest.raises(ValueError, match="different devices"):
        sw_cuda.sw_align_traceback_cuda(q, w.cpu(), SC, ROWS, L, W)
    with pytest.raises(ValueError, match="do not match"):
        sw_cuda.sw_align_traceback_cuda(q, w, SC, ROWS, L, W + 1)
    # 264 rows pass the key check at W = 16 but exceed 32 lanes x 8 rows
    q2, w2 = _on(dev, *planted_pairs(5, 8, 264, 16))
    with pytest.raises(ValueError, match="exceeds the align kernel"):
        sw_cuda.sw_align_traceback_cuda(q2, w2, SC, 0, 264, 16)
    with pytest.raises(ValueError, match="exceeds the align kernel"):
        sw_cuda.sw_align_cuda(q2, w2, SC)


S1_L, S1_W = 128, 161                # the S1 sweep's shapes (odd W)


@pytest.mark.parametrize("variant", sv.VARIANTS, ids=lambda v: v.name)
def test_variant_kernel_matches_twin(dev, variant):
    q, w = planted_pairs(5, 4096 + 37, S1_L, S1_W)   # a ragged last block
    qt, wt = _on(dev, q, w)
    fn = sv.make_score_fn(SC, S1_L, S1_W, strips=variant.strips,
                          warps=variant.warps, arith=variant.arith)
    before = sv.LAUNCHES["variant"]
    got = fn(qt, wt)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["variant"] == before + 1
    _equal(got, tsw.sw_score(qt, wt, SC))
    for g, r in zip(got, sw_batch(q[:256], w[:256], SC, want_dirs=False)):
        np.testing.assert_array_equal(r, g[:256].cpu().numpy())


@pytest.mark.parametrize("n", [1, 31, 33, 1000 + 37])
@pytest.mark.parametrize("variant", sv.VARIANTS, ids=lambda v: v.name)
def test_variant_kernel_ragged_sizes(dev, variant, n):
    # fewer pairs than a block or a warp holds, and a ragged last block
    q, w = planted_pairs(n, n, S1_L, S1_W)
    q[: n // 4] = 4
    qt, wt = _on(dev, q, w)
    fn = sv.make_score_fn(SC, S1_L, S1_W, strips=variant.strips,
                          warps=variant.warps, arith=variant.arith)
    got = fn(qt, wt)
    torch.cuda.synchronize()
    _equal(got, tsw.sw_score(qt, wt, SC))


def _s2_codes(seed, L, W, n, traps):
    """Batch-minor int32 codes with homology planted in a third of the
    pairs; with `traps`, the codes S2 compares as given in some blocks
    only (4 == 4, -1, 256 against 0, 1000 on both sides; 256 and -1 in w
    only, where the block's q codes all lie in 0..126)."""
    rng = np.random.default_rng(seed)
    qT = rng.integers(0, 5, (L, n)).astype(np.int32)
    wT = rng.integers(0, 4, (W + L + 1, n)).astype(np.int32)
    m = min(L, W) - 8
    wT[2:2 + m, : n // 3] = qT[1:1 + m, : n // 3] % 4
    if traps:
        qT[:, 40:48], wT[:, 40:48] = 4, 4
        qT[:, 48:56], wT[:, 48:56] = -1, -1
        qT[:, 100:108], wT[:, 100:108] = 256, 0
        qT[::2, 200:208], wT[::3, 200:208] = 1000, 1000
        wT[:, 300:304], wT[:, 304:308] = 256, -1    # q's blocks in 0..126
    return qT, wT


@pytest.mark.parametrize("L,W", [(128, 160), (16, 24), (14, 25)])
def test_pretransposed_kernel_trap_codes(dev, L, W):
    qT, wT = _s2_codes(L + W, L, W, 4096 + 37, traps=True)
    qt, wt = _on(dev, qT, wT)
    key = sv.score_pretransposed(qt, wt, SC, W)
    torch.cuda.synchronize()
    q, w = qt.t().contiguous(), wt[:W].t().contiguous()
    _equal([key], [tsw.sw_raw_key(q, w, SC)])
    assert (key[100:108] == -(W + 2)).all()     # 256 never equals 0
    assert (key[300:308] == -(W + 2)).all()
    assert (key[40:56] > 0).all()               # 4 == 4 and -1 == -1 score
    _equal([key[:256].cpu()], [tsw.sw_score_strips(
        q[:256].cpu(), w[:256].cpu(), SC, sv.S2_VARIANT.strips,
        raw_key=True)])


@pytest.mark.parametrize("n", [1, 31, 33, 1000 + 37])
def test_pretransposed_kernel_ragged_sizes(dev, n):
    qT, wT = _s2_codes(n, L, W, n, traps=n > 256)
    qt, wt = _on(dev, qT, wT)
    key = sv.score_pretransposed(qt, wt, SC, W)
    torch.cuda.synchronize()
    _equal([key], [tsw.sw_raw_key(qt.t().contiguous(),
                                  wt[:W].t().contiguous(), SC)])


def test_pretransposed_kernel_matches_twin(dev):
    rng = np.random.default_rng(6)
    n, W = 4096 + 37, 160
    qT = rng.integers(0, 5, (L, n)).astype(np.int32)
    wT = rng.integers(0, 4, (W + L + 1, n)).astype(np.int32)
    wT[2:L - 6, : n // 3] = qT[1:L - 7, : n // 3] % 4     # planted homology
    qT[:, -64:] = 4                                      # no positive cell
    qt, wt = _on(dev, qT, wT)
    before = sv.LAUNCHES["pretransposed"]
    key = sv.score_pretransposed(qt, wt, SC, W)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["pretransposed"] == before + 1
    _equal([key], [tsw.sw_raw_key(qt.t().contiguous(),
                                  wt[:W].t().contiguous(), SC)])
    assert (key[-64:] == key[-1]).all() and int(key[-1]) < 0
    ref = sw_batch(qT[:, :256].T.astype(np.int8), wT[:W, :256].T.astype(
        np.int8), SC, want_dirs=False)
    for g, r in zip(sv.decode_raw_key(key[:256], W), ref[:3]):
        np.testing.assert_array_equal(r, g.cpu().numpy())


def test_bench_wrappers_reject_bad_inputs(dev):
    q, w = _on(dev, *planted_pairs(7, 8, S1_L, S1_W))
    fn = sv.make_score_fn(SC, S1_L, S1_W)
    with pytest.raises(ValueError, match="int8"):
        fn(q.to(torch.int32), w)
    with pytest.raises(ValueError, match="different devices"):
        fn(q, w.cpu())
    qT, wT = sv.prep(q[:, :L].contiguous(), w[:, :W].contiguous())
    with pytest.raises(ValueError, match="int32"):
        sv.score_pretransposed(qT.to(torch.int8), wT, SC, W)
    with pytest.raises(ValueError, match="int32"):
        sv.score_pretransposed(qT.t().contiguous().t(), wT, SC, W)


# ---- K4: the ring rotation on virtual ranks of one card ----------------------

def _ring_state(dev, n, seed, words=100_003, rows=4097):
    """Per-rank (flat int32 of an odd word count, (rows, 3) int32)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31 - 1, (n, words),
                     dtype=np.int64).astype(np.int32)
    b = rng.integers(-1, 1 << 20, (n, rows, 3)).astype(np.int32)
    return a, b, [tuple(_on(dev, a[r], b[r])) for r in range(n)]


def _rotate(mesh, state, impl, **kw):
    mesh.fork()
    out = ring_dma.ring_rotate(state, mesh, impl, **kw)
    mesh.join()
    return out


@pytest.mark.parametrize("impl", ["dma", "dma_barrier"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_kernel_matches_plain(dev, n, impl):
    mesh = data_mesh(devices=[dev] * n)
    a, b, state = _ring_state(dev, n, seed=n)
    before = ring_dma.LAUNCHES["ring"]
    got = _rotate(mesh, state, impl)
    want = _rotate(mesh, state, "ppermute")
    torch.cuda.synchronize()
    ring_dma.check_ring(mesh)
    assert ring_dma.LAUNCHES["ring"] == before + n      # one launch a rank
    for g, w in zip(got, want):
        _equal(g, w)
    np.testing.assert_array_equal(np.roll(a, 1, 0)[0], got[0][0].cpu())
    np.testing.assert_array_equal(np.roll(b, 1, 0)[n - 1],
                                  got[n - 1][1].cpu())


@pytest.mark.parametrize("impl", ["dma", "dma_barrier"])
@pytest.mark.parametrize("words,misalign", TUPLE_CASES)
def test_ring_kernel_arrays_tails_and_misaligned_views(dev, impl, words,
                                                       misalign):
    # 1 to 4 arrays a rank in ONE launch: odd word counts (scalar tails),
    # arrays smaller than a tile, views that are not 16-byte aligned (all
    # scalar), and several tiles a block
    n = 3
    mesh = data_mesh(devices=[dev] * n)
    host, state, out = ring_tuples(dev, n, len(words), words, misalign)
    before = ring_dma.LAUNCHES["ring"]
    got = _rotate(mesh, state, impl, out=out)
    torch.cuda.synchronize()
    ring_dma.check_ring(mesh)
    assert ring_dma.LAUNCHES["ring"] == before + n
    want = _rotate(mesh, state, "ppermute")
    for r in range(n):
        for a in range(len(words)):
            assert got[r][a].data_ptr() == out[r][a].data_ptr()
            np.testing.assert_array_equal(host[(r - 1) % n][a],
                                          got[r][a].cpu().numpy())
            assert torch.equal(got[r][a], want[r][a])


def test_ring_walk_mirror_has_the_kernels_constants(dev):
    # copy_walk (held on the CPU to cover every word once) mirrors the
    # kernel's walk only while both cut the tuple up by the same numbers
    assert ring_dma.kernel_layout(sw_cuda.load_library()) == {
        "TILE_WORDS": ring_dma.TILE_WORDS,
        "SCALAR_THREADS": ring_dma.SCALAR_THREADS,
        "MAX_ARRAYS": ring_dma.MAX_ARRAYS}


def test_ring_kernel_takes_at_most_four_arrays(dev):
    mesh = data_mesh(devices=[dev] * 2)
    _, state, _ = ring_tuples(dev, 2, 0, (8,) * 5)
    with pytest.raises(ValueError, match="1 to 4 arrays"):
        ring_dma.ring_permute_dma(state, mesh)


@pytest.mark.parametrize("impl", ["dma", "dma_barrier"])
def test_ring_kernel_repeated_rotations(dev, impl):
    # persistent ping-pong buffers, a reader of every rank's shard between
    # rotations (as the probe is), 64 rotations: every rank must read the
    # shard np.roll says, every time
    n, T = 4, 64
    mesh = data_mesh(devices=[dev] * n)
    a, b, state = _ring_state(dev, n, seed=7, words=1_000_003, rows=33_333)
    spare = [tuple(torch.empty_like(x) for x in s) for s in state]
    weights = torch.arange(1, a.shape[1] + 1, dtype=torch.int64, device=dev)
    sums = []
    mesh.fork()
    for _ in range(T):
        out = ring_dma.ring_rotate(state, mesh, impl, out=spare)
        spare, state = state, out
        for r in range(n):
            with mesh.rank(r):
                sums.append((state[r][0].long() * weights).sum())
    mesh.join()
    torch.cuda.synchronize()
    ring_dma.check_ring(mesh)
    want = (a.astype(np.int64) * np.arange(1, a.shape[1] + 1)).sum(1)
    got = torch.stack(sums).cpu().numpy().reshape(T, n)
    for t in range(T):
        np.testing.assert_array_equal(np.roll(want, t + 1), got[t])
    for r in range(n):
        np.testing.assert_array_equal(np.roll(a, T, 0)[r], state[r][0].cpu())
        np.testing.assert_array_equal(np.roll(b, T, 0)[r], state[r][1].cpu())


@pytest.mark.parametrize("waiter", ["barrier", "wait"])
def test_ring_kernel_times_out_instead_of_hanging(dev, waiter):
    # dma_barrier with a neighbour that never signals: the spinning kernel
    # gives up after its timeout, sets the status word, and check_ring raises
    mesh = data_mesh(devices=[dev] * 2)
    _, _, state = _ring_state(dev, 2, seed=3)
    mesh.fork()
    if waiter == "barrier":
        # the first rotation sets the ring's flags up (and synchronizes);
        # then rank 1's stream is busy far beyond rank 0's barrier timeout
        ring_dma.ring_rotate(state, mesh, "dma_barrier")
        with mesh.rank(1):
            torch.cuda._sleep(2_000_000_000)   # ~1 s at the card's clock
        ring_dma.ring_rotate(state, mesh, "dma_barrier", timeout_ns=1_000_000)
    else:
        # rank 0 waits for an epoch no rank will send
        ring_dma.ring_rotate(state, mesh, "dma_barrier")
        ring = mesh.scratch["ring"]
        rc = sw_cuda.load_library().rambl_ring_wait(
            ring.flags[0].data_ptr(), 1, ring.epoch + 1,
            1_000_000, ring.status.data_ptr(), mesh.streams[0].cuda_stream)
        assert rc == 0
    mesh.join()
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="timed out"):
        ring_dma.check_ring(mesh)


def test_ring_kernel_rejects_bad_inputs(dev):
    mesh = data_mesh(devices=[dev] * 2)
    _, _, state = _ring_state(dev, 2, seed=4, words=64, rows=8)
    with pytest.raises(ValueError, match="32-bit words"):
        ring_dma.ring_permute_dma([(x[0].long(),) for x in state], mesh)
    with pytest.raises(ValueError, match="32-bit words"):
        ring_dma.ring_permute_dma([(x[1].t(),) for x in state], mesh)
    with pytest.raises(ValueError, match="not cuda:0"):
        ring_dma.ring_permute_dma([(state[0][0].cpu(),), (state[1][0],)],
                                  mesh)


def test_mesh_stream_with_k4_matches_single_device(dev):
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.builder import build_seed_index
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.pipeline.assemble import stream_align

    ds = simulate_dataset(n_species=5, refs_per_species=2, n_reads=700,
                          seed=1)
    cfg = PipelineConfig(batch_size=256, sw_rows=ROWS, shard_index=True,
                         ring_impl="dma", shard_positions=True)
    index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=cfg.k)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    args = (ds.reads, ds.read_lens, index, ds.ref_seqs, ds.ref_lens, tax, cfg)
    before = ring_dma.LAUNCHES["ring"]
    mg, cg, sg, rg = stream_align(*args, mesh=data_mesh(devices=[dev] * 4))
    torch.cuda.synchronize()
    assert ring_dma.LAUNCHES["ring"] > before
    one, c1, s1, r1 = stream_align(*args, device=dev)
    for k in ("bins", "score", "ref", "strand"):
        assert torch.equal(one[k], mg[k][0])
    nb, _, L = mg["query"][0].shape
    for k in ("query", "ref_col"):
        flat = torch.cat(mg[k], dim=1).reshape(nb * 256, L)[:700]
        assert torch.equal(one[k], flat)
    assert torch.equal(c1, torch.cat(cg, dim=1))
    assert torch.equal(s1, sg[0]) and torch.equal(r1, rg[0])


# ---------------------------------------------------------------------------
# DP-means' center recount (`ops.cluster_cuda`) against its plain version,
# `pipeline.cluster.recount_centers`, run on the same card tensors.
# ---------------------------------------------------------------------------

def _recount_case(name):
    """(feat, assign, fallback, kact, K) as numpy arrays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    NL, M, P, K = {"cell": (512, 4096, 64, 16), "dense": (4, 4096, 64, 16),
                   "ties": (8, 256, 64, 8), "empty": (16, 512, 64, 16),
                   "ragged": (1, 29, 37, 5), "unaligned": (5, 29, 37, 5)}[name]
    cover = {"cell": 0.002, "dense": 1.0}.get(name, 0.6)
    feat = np.where(rng.integers(0, 10_000, (NL, M, P), dtype=np.int16)
                    < cover * 10_000,
                    rng.integers(0, 4, (NL, M, P), dtype=np.int8),
                    np.int8(-1)).astype(np.int8)
    kact = rng.integers(1, K + 1, NL).astype(np.int32)
    assign = (rng.integers(0, 1 << 20, (NL, M))
              % kact[:, None]).astype(np.int32)
    if name == "cell":
        feat[:, M // 2:] = -1                      # padded member rows
    if name == "dense":                            # counts up to M on a word
        feat[0], assign[0], kact[0] = 2, 0, K
        assign[1] = 0
    if name == "ties":                             # two bases tie everywhere
        hi, lo = rng.integers(2, 4, (NL, 1, P)), rng.integers(0, 2, (NL, 1, P))
        feat = np.where(np.arange(M)[None, :, None] % 2, hi,
                        lo).astype(np.int8)
        assign = np.repeat(assign[:, ::2], 2, axis=1)
    if name == "empty":                            # clusters with no member
        assign = np.minimum(assign, 2).astype(np.int32)
        feat[:, :, P // 2:] = -1                   # columns no member covers
        kact[:4] = 1
    fallback = rng.integers(0, 4, (NL, P)).astype(np.int8)
    return feat, assign, fallback, kact, K


@pytest.mark.parametrize("name", ["cell", "dense", "ties", "empty", "ragged",
                                  "unaligned"])
def test_recount_kernel_matches_twin(dev, name):
    from rambl_tpu_torch.ops import cluster_cuda
    from rambl_tpu_torch.pipeline import cluster as tc

    feat, assign, fallback, kact, K = _recount_case(name)
    args = _on(dev, feat, assign, fallback, kact)
    if name == "unaligned":                        # leaves off 16-byte bounds
        buf = torch.zeros(feat.size + 21, dtype=torch.int8, device=dev)
        args[0] = buf[5:5 + feat.size].view(feat.shape)
        args[0].copy_(torch.from_numpy(feat))
        assert args[0].data_ptr() % 16
    before = cluster_cuda.LAUNCHES["recount"]
    got = cluster_cuda.dp_recount_centers(*args, K)
    torch.cuda.synchronize()
    assert cluster_cuda.LAUNCHES["recount"] == before + 1
    _equal([got], [tc.recount_centers(*args, K)])
    if name == "dense":
        assert (got[0, 0] == 2).all()


def test_recount_kernel_rejects_bad_inputs(dev):
    from rambl_tpu_torch.ops import cluster_cuda

    feat, assign, fallback, kact, K = _recount_case("ragged")
    args = _on(dev, feat, assign, fallback, kact)
    before = cluster_cuda.LAUNCHES["recount"]
    with pytest.raises(ValueError, match="shared memory"):
        cluster_cuda.dp_recount_centers(*args, cluster_cuda.MAX_SMEM // 37)
    with pytest.raises(ValueError, match="assign"):
        cluster_cuda.dp_recount_centers(args[0], args[1].long(), *args[2:], K)
    with pytest.raises(ValueError, match="feat"):
        cluster_cuda.dp_recount_centers(args[0].transpose(1, 2).contiguous()
                                        .transpose(1, 2), *args[1:], K)
    assert cluster_cuda.LAUNCHES["recount"] == before


def _dp_leaves(seed, NL=12, M=256, P=32):
    """feat (NL, M, P) int8 of 1-4 haplotypes a leaf, read-like covered runs
    and 8 padded rows; can_seed (NL, M) bool."""
    rng = np.random.default_rng(seed)
    feat = np.full((NL, M, P), -1, np.int8)
    for a in range(NL):
        haps = rng.integers(0, 4, (1 + a % 4, P))
        if a == 0:                                       # ties everywhere
            haps = np.stack([np.zeros(P, int), np.ones(P, int)])
        for m in range(M - 8):
            lo = int(rng.integers(0, P - 4))
            hi = int(rng.integers(lo + 4, P + 1))
            row = haps[m % len(haps)].copy()
            row[rng.random(P) < 0.02] = rng.integers(0, 4)
            feat[a, m, lo:hi] = row[lo:hi]
    can_seed = rng.random((NL, M)) < 0.7
    can_seed[-1] = False
    return feat, can_seed


def test_dp_means_counts_the_kernels_adds(dev, monkeypatch):
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.ops import cluster_cuda
    from rambl_tpu_torch.pipeline import cluster as tc
    from rambl_tpu_torch.utils import trace

    feat, can_seed = _dp_leaves(51)
    cfg = PipelineConfig(max_clusters_per_bin=4, dp_spawn_min_orphans=2)
    iters = cfg.dp_max_iters
    monkeypatch.setenv("RAMBL_STAGE_TIMING", "1")
    trace.clear()
    before = cluster_cuda.LAUNCHES["recount"]
    try:
        with trace.Stages():
            gpu = tc.dp_means_leaves(*_on(dev, feat, can_seed), cfg)
        got = {n: v for n, _, v, _ in trace.counts()}
    finally:
        trace.clear()
    assert cluster_cuda.LAUNCHES["recount"] == before + iters
    assert got["dp.recount_adds"] == int((feat >= 0).sum()) * iters
    assert got["dp.recount_inert_adds"] == 0
    _equal(gpu, tc.dp_means_leaves(torch.from_numpy(feat),
                                   torch.from_numpy(can_seed), cfg))
    assert int(gpu.kact.max()) >= 2


# ---------------------------------------------------------------------------
# round 0 on the card: pileup merge, clustering, consensus, the round itself.
# These are plain PyTorch (no hand-written kernel); each is held against the
# same function on CPU tensors, which the CPU tests hold against the JAX
# package, bit for bit.
# ---------------------------------------------------------------------------

def _toy_tables():
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables

    parent = np.array([0, 0, 0, 1, 1, 2, 3, 3], np.int32)
    depth = np.array([0, 1, 1, 2, 2, 2, 3, 3], np.int32)
    return build_taxonomy_tables(parent, depth,
                                 np.array([4, 5, 6, 7], np.int32))


def _both(dev, fn, *arrays, **kw):
    """fn on CPU tensors and on the card's, outputs flattened to tuples."""
    def flat(out):
        return tuple(out) if isinstance(out, tuple) else (out,)

    cpu = [torch.from_numpy(np.array(a)) for a in arrays]
    return flat(fn(*cpu, **kw)), flat(fn(*[t.to(dev) for t in cpu], **kw))


@pytest.mark.parametrize("share", [10, 3, 1, 0])
def test_round_pileups_on_card(dev, share):
    from rambl_tpu_torch.pipeline import pileup as tp

    tax = _toy_tables()
    rng = np.random.default_rng(30 + share)
    B, Lr, ref_len = 2000, 32, 200
    q = rng.integers(0, 5, (B, Lr)).astype(np.int8)
    rc = np.sort(rng.integers(-1, ref_len, (B, Lr)), axis=1).astype(np.int16)
    bins = rng.integers(-1, tax.n_nodes, B).astype(np.int32)
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    node2slot = np.full(tax.n_nodes, -1, np.int32)
    node2slot[[1, 3, 4, 7]] = np.arange(4, dtype=np.int32)   # chains cut
    cnt_c, cnt_g = _both(dev, tp.node_pileup, q, rc, bins, n_nodes=8,
                         ref_len=ref_len)
    _equal(cnt_g, cnt_c)
    _equal(*_both(dev, lambda c, s, lv, a, d: tp.leaf_pileup(
        c, s, lv, a, d, share), *[t.numpy() for t in cnt_c], nodes,
        tax.anc_path, tax.depth)[::-1])
    sl_c, sl_g = _both(dev, tp.node_slot_pileup, q, rc, bins, node2slot,
                       n_slots=64, ref_len=ref_len)
    _equal(sl_g, sl_c)
    _equal(*_both(dev, lambda c, s, n2s, lv, a, d: tp.leaf_pileup_slots(
        c, s, n2s, lv, a, d, share), *[t.numpy() for t in sl_c], node2slot,
        nodes, tax.anc_path, tax.depth)[::-1])
    lc = tp.leaf_pileup(*cnt_c, torch.from_numpy(nodes),
                        torch.from_numpy(tax.anc_path),
                        torch.from_numpy(tax.depth))[0]
    _equal(*_both(dev, tp.polymorphic_mask, lc.numpy(), min_coverage=2,
                  poly_min_minor_count=1, poly_minor_frac_num=1,
                  poly_minor_frac_den=10, max_poly_cols=5)[::-1])


@pytest.mark.parametrize("M", [4, 1024])
def test_round_membership_and_features_on_card(dev, M):
    from rambl_tpu_torch.pipeline import cluster as tc

    tax = _toy_tables()
    rng = np.random.default_rng(40 + M)
    bins = rng.integers(-1, tax.n_nodes, 3000).astype(np.int32)
    srt_c, srt_g = _both(dev, tc.bin_sort, bins, n_nodes=tax.n_nodes)
    _equal(srt_g, srt_c)
    nodes = np.arange(tax.n_nodes, dtype=np.int32)
    for share in (10, 1, 0):
        _equal(*_both(dev, lambda o, s, e, lv, a, d: tc.member_table_ranges(
            o, s, e, lv, a, d, M, share), *[t.numpy() for t in srt_c],
            nodes, tax.anc_path, tax.depth)[::-1])
    NL, Mf, Lr, ref_len = 6, 64, 48, 300
    qm = rng.integers(0, 6, (NL, Mf, Lr)).astype(np.int8)
    rcm = np.sort(rng.integers(-1, ref_len, (NL, Mf, Lr)), axis=2)
    rcm[:, ::3, 5] = rcm[:, ::3, 4]                      # column collisions
    mv = rng.random((NL, Mf)) < 0.8
    pc = rng.integers(0, ref_len + 9, (NL, 16)).astype(np.int32)
    pv = rng.random((NL, 16)) < 0.8
    _equal(*_both(dev, tc.leaf_features_dense, qm, rcm.astype(np.int32), mv,
                  pc, pv, ref_len=ref_len)[::-1])


def test_round_dp_means_on_card(dev):
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.pipeline import cluster as tc

    feat, can_seed = _dp_leaves(50)
    for fields in ({}, dict(max_clusters_per_bin=4, dp_spawn_min_orphans=2)):
        cpu, gpu = _both(dev, tc.dp_means_leaves, feat, can_seed,
                         cfg=PipelineConfig(**fields))
        _equal(gpu, cpu)
        assert int(cpu[2].max()) >= 2           # kact: leaves spawned


def test_round_consensus_on_card(dev):
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.pipeline import consensus as tcons

    cfg = PipelineConfig()
    rng = np.random.default_rng(60)
    NL, M, Lr, ref_len = 5, 200, 40, 256
    q = rng.integers(0, 5, (NL, M, Lr)).astype(np.int8)
    start = rng.integers(0, ref_len - Lr, (NL, M, 1))
    rc = (start + np.arange(Lr)).astype(np.int32)
    rc[rng.random(rc.shape) < 0.05] = -1
    valid = rng.random((NL, M)) < 0.9
    assign = rng.integers(0, 3, (NL, M)).astype(np.int32)
    leaf_counts = rng.integers(0, 12, (NL, ref_len, 4)).astype(np.int32)
    leaf_span = (leaf_counts.sum(-1) + 1).astype(np.int32)
    pm = rng.random((NL, ref_len)) < 0.3
    _equal(*_both(dev, tcons.cluster_consensus_leaves, q, rc, valid, assign,
                  pm, leaf_counts, leaf_span, cfg=cfg)[::-1])
    excl = leaf_counts.copy()
    excl[:, ::5, 1] = excl[:, ::5, 0] // 3 + 4
    _equal(*_both(dev, tcons.minor_haplotype_leaves, excl, leaf_counts,
                  leaf_span, cfg=cfg)[::-1])


@pytest.mark.parametrize("slot", [False, True], ids=["dense", "slot"])
def test_assemble_round_on_card(dev, slot):
    """Round 0 on the card == on CPU tensors == the port's NumPy oracle,
    gene by gene, on the dataset of tests/test_assembly_parity.py."""
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
    from rambl_tpu_torch.oracle.pipeline import assemble_round as oracle
    from rambl_tpu_torch.ops import sw_cuda
    from rambl_tpu_torch.pipeline.assemble import assemble_round

    ds = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(max_assembly_iters=2, batch_size=128,
                         pileup_slot_nodes=1 if slot else 4096)
    args = (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax, cfg, 0)
    before = sw_cuda.LAUNCHES["score"]
    g_card, s_card = assemble_round(*args, device=dev)
    assert sw_cuda.LAUNCHES["score"] > before

    def key(genes):
        return [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon, g.offset)
                for g in genes]

    g_cpu, s_cpu = assemble_round(*args, device="cpu")
    assert key(g_card) == key(g_cpu) and s_card == s_cpu
    assert key(g_card) == key(oracle(*args)[0]) and len(g_card) > 3


def _parity_inputs(slot=False, **fields):
    """The dataset of tests/test_assembly_parity.py and its config."""
    from rambl_tpu_torch.config import PipelineConfig
    from rambl_tpu_torch.data.simulate import simulate_dataset
    from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables

    ds = simulate_dataset(n_species=3, refs_per_species=2, n_reads=400,
                          seed=2, skewed_abundance=False)
    tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
    cfg = PipelineConfig(**{**dict(max_assembly_iters=2, batch_size=128,
                                   pileup_slot_nodes=1 if slot else 4096),
                            **fields})
    return (ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax), cfg


def _fields(genes, born=True):
    return [(g.key(), g.n_reads, g.leaf, g.cluster, g.taxon, g.offset)
            + ((g.round_born,) if born else ()) for g in genes]


@pytest.mark.parametrize("slot", [False, True], ids=["dense", "slot"])
def test_assemble_on_card(dev, slot):
    """The whole assembly on the card == on CPU tensors == the port's NumPy
    oracle: rounds, pre-polish panel and polished genes."""
    from rambl_tpu_torch.oracle.pipeline import assemble as oracle
    from rambl_tpu_torch.pipeline.assemble import assemble

    args, cfg = _parity_inputs(slot)
    sw_cuda.reset_launches()
    card = assemble(*args, cfg, device=dev)
    assert sw_cuda.LAUNCHES["score"] >= card.n_rounds
    cpu = assemble(*args, cfg, device="cpu")
    want = oracle(*args, cfg)
    for other in (cpu, want):
        assert (card.n_rounds, card.converged) == (other.n_rounds,
                                                   other.converged)
        assert _fields(card.panel) == _fields(other.panel)
        assert _fields(card.genes) == _fields(other.genes)
    assert card.round_stats == cpu.round_stats and len(card.genes) > 3


def test_polish_from_retained_counts_on_card(dev):
    """Polish from round 0's retained counts (a CUDA tensor) == polish that
    re-streams round 0 on the card; only the re-stream launches K1."""
    from rambl_tpu_torch.pipeline.assemble import assemble, polish

    args, cfg = _parity_inputs()
    aux = {}
    res = assemble(*args, cfg, aux_out=aux, device=dev)
    assert aux["node_counts"].is_cuda
    reads, lens, ref_seqs, ref_lens, tax = args
    sw_cuda.reset_launches()
    kept = polish(reads, lens, res.panel, ref_seqs, ref_lens, tax, cfg,
                  node_counts=aux["node_counts"], device=dev)
    assert sw_cuda.LAUNCHES["score"] == 0
    again = polish(reads, lens, res.panel, ref_seqs, ref_lens, tax, cfg,
                   device=dev)
    assert sw_cuda.LAUNCHES["score"] > 0
    assert kept[1] == again[1] == res.round_stats[-1]["changed"] > 0
    assert _fields(kept[0]) == _fields(again[0]) == _fields(res.genes)


def test_resume_from_checkpoint_on_card(dev, tmp_path):
    """A run checkpointed on the card resumes on the card, from its final
    panel and `.aux` sidecar, to the same final genes."""
    from rambl_tpu_torch.pipeline.assemble import assemble
    from rambl_tpu_torch.utils.checkpoint import (
        load_aux_evidence,
        load_checkpoint,
    )

    args, cfg = _parity_inputs(max_assembly_iters=3)
    ck = str(tmp_path / "panel.ckpt")
    full = assemble(*args, cfg, checkpoint_path=ck, device=dev)
    _, panel = load_checkpoint(ck)
    aux = load_aux_evidence(ck + ".aux", cfg)
    sw_cuda.reset_launches()
    resumed = assemble(*args, cfg, initial_panel=panel, initial_aux=aux,
                       device=dev)
    assert sw_cuda.LAUNCHES["score"] > 0
    assert resumed.round_stats[0]["aux_restored"] is True
    assert _fields(panel) == _fields(full.panel)
    assert _fields(resumed.genes, born=False) == _fields(full.genes,
                                                         born=False)


def test_assemble_on_virtual_ranks_matches_one_card(dev):
    """The whole assembly on a mesh of 4 virtual ranks of the card (the
    leaf-sharded cluster step, the merged pileups) == the same call on one
    card: rounds, round stats, pre-polish panel and polished genes."""
    from rambl_tpu_torch.pipeline.assemble import assemble

    args, cfg = _parity_inputs()
    one = assemble(*args, cfg, device=dev)
    sw_cuda.reset_launches()
    mesh = assemble(*args, cfg, mesh=data_mesh(devices=[dev] * 4))
    assert sw_cuda.LAUNCHES["score"] >= 4 * mesh.n_rounds
    assert (mesh.n_rounds, mesh.converged) == (one.n_rounds, one.converged)
    assert mesh.round_stats == one.round_stats
    assert _fields(mesh.panel) == _fields(one.panel)
    assert _fields(mesh.genes) == _fields(one.genes) and len(one.genes) > 3


def test_ring_dma_assembly_launches_k4_every_round(dev, monkeypatch):
    """shard_index with ring_impl="dma" on 4 virtual ranks: K4 rotates the
    index shards in every round, and the genes are the one-card run's."""
    from rambl_tpu_torch.pipeline import assemble as asm

    args, cfg = _parity_inputs(shard_index=True, ring_impl="dma")
    real_round, k4 = asm.assemble_round, []

    def counted_round(*a, **kw):
        before = ring_dma.LAUNCHES["ring"]
        out = real_round(*a, **kw)
        k4.append(ring_dma.LAUNCHES["ring"] - before)
        return out

    monkeypatch.setattr(asm, "assemble_round", counted_round)
    mesh = asm.assemble(*args, cfg, mesh=data_mesh(devices=[dev] * 4))
    monkeypatch.setattr(asm, "assemble_round", real_round)
    assert len(k4) == mesh.n_rounds and all(n > 0 for n in k4), k4
    one = asm.assemble(*args, cfg, device=dev)
    assert _fields(mesh.genes) == _fields(one.genes)
    assert mesh.round_stats == one.round_stats


def test_graft_entry_on_card_matches_cpu(dev):
    """The entry hook's align step on the card (K1, and K2 + K3 on the
    gapped reads) == its rerun on CPU tensors, field for field."""
    from rambl_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert args[0].is_cuda
    sw_cuda.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES["score"] == 1
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    _equal(got, want)


def test_check_ring_dma_every_impl(dev):
    """scripts/check_ring_dma on 2 virtual ranks: every transport, K4
    included, gives np.roll bit for bit."""
    from rambl_tpu_torch.scripts import check_ring_dma

    ring_dma.reset_launches()
    done = check_ring_dma.run(2, device=dev, out=lambda *a: None)
    assert list(done) == list(ring_dma.IMPLS)
    assert ring_dma.LAUNCHES["ring"] == 4      # one a rank, two K4 impls
