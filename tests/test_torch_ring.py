"""The port's ring-sharded index and mesh stream == the JAX reference, bit
for bit, on CPU ranks.

`rambl_tpu_torch.parallel.{mesh,ring,ring_dma,steps}` and the mesh branch of
`pipeline.assemble.stream_align` against `rambl_tpu.parallel.*` and
`rambl_tpu.pipeline.assemble._stream_align(mesh=...)` on the 8 fake CPU
devices that tests/conftest.py forces, with ring_impl="ppermute" on both
sides (K4 itself runs only on a card: tests/test_torch_kernels_cuda.py).
Inputs are the shared `small_ds` mock community and numpy-seeded arrays.
Everything is integer: no tolerance.

The last tests model-check the rotation's launch order
(`ring_dma.rotation_plan`, one copy a rank) over random schedules of the rank
streams, and hold the mirror of K4's tile walk (`ring_dma.copy_walk`) to
covering every word of every array exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.ops import seed as jseed
from rambl_tpu.parallel import mesh as jmesh
from rambl_tpu.parallel import ring as jring
from rambl_tpu.parallel.ring_dma import ring_rotate as j_ring_rotate
from rambl_tpu.pipeline.assemble import _stream_align
from rambl_tpu_torch.config import PipelineConfig as TConfig
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.ops import seed as tseed
from rambl_tpu_torch.parallel import mesh as tmesh
from rambl_tpu_torch.parallel import ring as tring
from rambl_tpu_torch.parallel import ring_dma
from rambl_tpu_torch.pipeline import assemble as tassemble
from rambl_tpu_torch.utils.errors import UserError

N_STREAM = 200          # reads streamed in the mesh cases


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(n):
    return tmesh.data_mesh(devices=["cpu"] * n)


# ---- (a) shards ------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 8])
def test_build_ring_shards_matches_reference(small_index, n):
    got = tring.build_ring_shards(small_index, n)
    ref = jring.build_ring_shards(small_index, n)
    np.testing.assert_array_equal(ref["bucket_start"], got["bucket_start"])
    ent = got["entries"]
    assert ent.dtype == np.int32 and ent.shape[0] == n and ent.shape[2] == 3
    keys = []
    for s in range(n):
        # the reference packs 32 entries a row: keys, refs, pos in lanes
        # 0:32, 32:64, 64:96
        cols = [ref["entries"][s, :, 32 * f:32 * (f + 1)].reshape(-1)
                for f in range(3)]
        emax = ent.shape[1]
        assert (cols[0][emax:] == -1).all()
        np.testing.assert_array_equal(cols[0][:emax], ent[s, :, 0])
        real = ent[s, :, 0] >= 0
        for f in (1, 2):
            np.testing.assert_array_equal(cols[f][:emax][real],
                                          ent[s, real, f])
        assert (ent[s, ~real] == -1).all()
        keys.append(ent[s, real, 0])
    # every entry exactly once
    assert sum(k.size for k in keys) == small_index.n_entries
    np.testing.assert_array_equal(np.sort(np.concatenate(keys)),
                                  np.sort(small_index.entry_key))


# ---- (b) probe of a bucket-range shard ---------------------------------------

@pytest.mark.parametrize("n", [3, 8])
def test_probe_bucket_lo_matches_reference(small_ds, small_index, cfg, n):
    reads, lens = small_ds.reads[:96], small_ds.read_lens[:96]
    keys, valid = tseed.query_kmers(_t(reads), _t(lens), TConfig())
    bucket = tseed.hash_kmer(keys, small_index.n_bits)
    got_s = tring.build_ring_shards(small_index, n)
    ref_s = jring.build_ring_shards(small_index, n)
    Pn = got_s["bucket_start"].shape[1] - 1
    hits = 0
    for s in range(n):
        ent = torch.from_numpy(got_s["entries"][s])
        table = tseed.SeedTable(torch.from_numpy(got_s["bucket_start"][s]),
                                ent[:, 0], ent[:, 1], ent[:, 2],
                                small_index.n_bits)
        got = tseed.probe(keys, valid, bucket, table, TConfig(),
                          bucket_lo=s * Pn).numpy()
        ref = np.asarray(jseed.probe(
            jnp.asarray(keys.numpy()), jnp.asarray(valid.numpy()),
            jnp.asarray(bucket.numpy()),
            jnp.asarray(ref_s["bucket_start"][s]),
            jnp.asarray(ref_s["entries"][s]), cfg, bucket_lo=s * Pn))
        # the reference's extra chunk-row slots are always misses: after
        # sorting each slot row, its first cap slots are the port's
        cap = cfg.bucket_cap
        ref = np.sort(ref, axis=-1)
        assert (ref[..., cap:] == tseed.BIGK).all()
        np.testing.assert_array_equal(ref[..., :cap], np.sort(got, axis=-1))
        hits += int((got != tseed.BIGK).sum())
    whole = tseed.probe(keys, valid, bucket,
                        tseed.SeedTable.from_index(small_index, "cpu"),
                        TConfig())
    assert hits == int((whole != tseed.BIGK).sum()) > 0


def test_probe_whole_table_is_bucket_lo_zero(small_ds, small_index):
    keys, valid = tseed.query_kmers(_t(small_ds.reads[:64]),
                                    _t(small_ds.read_lens[:64]), TConfig())
    bucket = tseed.hash_kmer(keys, small_index.n_bits)
    table = tseed.SeedTable.from_index(small_index, "cpu")
    ref = tseed.probe(keys, valid, bucket, table, TConfig())
    # the same table seen as the second of two shards of a doubled range
    got = tseed.probe(keys, valid, bucket + 1000, table, TConfig(),
                      bucket_lo=1000)
    assert torch.equal(ref, got)
    # buckets outside the shard's range never hit
    none = tseed.probe(keys, valid, bucket, table, TConfig(),
                       bucket_lo=table.bucket_start.shape[0])
    assert (none == tseed.BIGK).all()


# ---- (c) the plain rotation ----------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 8])
def test_plain_rotation_matches_ppermute(n):
    rng = np.random.default_rng(n)
    a = rng.integers(-2**31, 2**31 - 1, (n * 7,), dtype=np.int64).astype(
        np.int32)
    b = rng.integers(0, 1000, (n * 5, 3)).astype(np.int32)
    mesh = jmesh.data_mesh(n)
    f = jax.jit(jax.shard_map(
        lambda x, y: j_ring_rotate((x, y), jmesh.DATA_AXIS, impl="ppermute"),
        mesh=mesh, in_specs=(P(jmesh.DATA_AXIS), P(jmesh.DATA_AXIS, None)),
        out_specs=(P(jmesh.DATA_AXIS), P(jmesh.DATA_AXIS, None)),
        check_vma=False))
    ref = [np.asarray(x) for x in f(a, b)]
    tm = _cpu_mesh(n)
    state = list(zip(tmesh.put_sharded(a, tm), tmesh.put_sharded(b, tm)))
    got = ring_dma.ring_rotate(state, tm, "ppermute")
    np.testing.assert_array_equal(ref[0], torch.cat([g[0] for g in got]))
    np.testing.assert_array_equal(ref[1], torch.cat([g[1] for g in got]))
    # n hops bring every shard home
    for _ in range(n - 1):
        got = ring_dma.ring_rotate(got, tm, "ppermute")
    np.testing.assert_array_equal(a, torch.cat([g[0] for g in got]))


def test_ring_rotate_guards():
    tm = _cpu_mesh(2)
    state = [(torch.zeros(4, dtype=torch.int32),)] * 2
    with pytest.raises(RuntimeError, match="only on CUDA"):
        ring_dma.ring_rotate(state, tm, "dma")
    with pytest.raises(RuntimeError, match="only on CUDA"):
        ring_dma.ring_permute_dma(state, tm, barrier=True)
    with pytest.raises(ValueError, match="not one of"):
        ring_dma.ring_rotate(state, tm, "nccl")
    with pytest.raises(ValueError, match="rank 1"):
        ring_dma.ring_rotate([state[0], (torch.zeros(5, dtype=torch.int32),)],
                             tm)


def test_mesh_collectives():
    tm = _cpu_mesh(4)
    x = np.arange(8 * 12, dtype=np.int32).reshape(8, 12)
    sh = tmesh.put_sharded(x, tm)
    assert [tuple(s.shape) for s in sh] == [(2, 12)] * 4
    tot = tmesh.psum(sh, tm)
    want = x.reshape(4, 2, 12).sum(0)
    for t in tot:
        np.testing.assert_array_equal(want, t)
    sc = tmesh.psum_scatter(sh, tm)
    np.testing.assert_array_equal(want, torch.cat(sc, dim=1))
    assert [tuple(s.shape) for s in sc] == [(2, 3)] * 4
    with pytest.raises(ValueError, match="divide"):
        tmesh.put_sharded(x[:7], tm)
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.DataMesh(["cpu", "meta"])


# ---- (d) the mesh stream -------------------------------------------------------

CASES = {
    # name: (ranks, config fields)
    "ring8-positions": (8, dict(shard_index=True, shard_positions=True)),
    "ring3-slot": (3, dict(shard_index=True, pileup_slot_nodes=1)),
    "replicated8": (8, dict(shard_index=False)),
}


def _stream_pair(ds, index, tax, n, fields):
    fields = dict(batch_size=24 * n, sw_rows=104, **fields)
    reads, lens = ds.reads[:N_STREAM], ds.read_lens[:N_STREAM]
    cmap = build_col_maps(ds.ref_seqs, ds.ref_lens, tax.ref_taxon)
    ref = _stream_align(reads, lens, index, ds.ref_seqs, ds.ref_lens, tax,
                        JConfig(**fields), mesh=jmesh.data_mesh(n),
                        col_maps=cmap)
    got = tassemble.stream_align(reads, lens, index, ds.ref_seqs, ds.ref_lens,
                                 tax, TConfig(**fields), mesh=_cpu_mesh(n),
                                 col_maps=cmap)
    return ref, got, TConfig(**fields)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_stream_matches_reference(small_ds, small_index, small_tax,
                                       case):
    n, fields = CASES[case]
    (mr, cr, sr, rr), (mg, cg, sg, rg), tcfg = _stream_pair(
        small_ds, small_index, small_tax, n, fields)
    assert list(mg) == list(mr)
    for k in ("bins", "score", "ref", "strand"):
        r = np.asarray(mr[k])
        assert len(mg[k]) == n and r.shape == (N_STREAM,)
        for g in mg[k]:                                 # replicated
            assert g.numpy().dtype == r.dtype
            np.testing.assert_array_equal(r, g.numpy(), err_msg=k)
    for k in ("query", "ref_col", "bins_sh"):
        r = np.asarray(mr[k])
        bl = tcfg.batch_size // n
        assert all(g.shape[1] == bl for g in mg[k])     # rank d's rows
        g = torch.cat(mg[k], dim=1).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(r, g, err_msg=k)
    assert mg["ref_col"][0].dtype == torch.int16
    for g in rg:
        np.testing.assert_array_equal(np.asarray(rr), g.numpy())
    assert int(rg[0].sum()) == int((mg["bins"][0] >= 0).sum()) > 0
    if tcfg.pileup_slot_nodes < small_tax.n_nodes:
        assert cr is sr is cg is sg is None
        return
    ref_len = small_ds.ref_seqs.shape[1]
    for g in sg:                                        # trimmed, replicated
        assert tuple(g.shape) == (small_tax.n_nodes, ref_len + 1)
        np.testing.assert_array_equal(np.asarray(sr), g.numpy())
    if tcfg.shard_positions:
        assert all(c.shape[1] == ref_len * 4 // n for c in cg)
        np.testing.assert_array_equal(np.asarray(cr), torch.cat(cg, 1))
    else:
        for g in cg:
            np.testing.assert_array_equal(np.asarray(cr), g.numpy())


def test_mesh_stream_equals_single_device_stream(small_ds, small_index,
                                                 small_tax):
    ds = small_ds
    cfg = TConfig(batch_size=64, sw_rows=104, shard_index=True)
    args = (ds.reads[:150], ds.read_lens[:150], small_index, ds.ref_seqs,
            ds.ref_lens, small_tax, cfg)
    one = tassemble.stream_align(*args, device="cpu")
    mg, cg, sg, rg = tassemble.stream_align(*args, mesh=_cpu_mesh(4))
    for k in ("bins", "score", "ref", "strand"):
        assert torch.equal(one[0][k], mg[k][2])
    nb, bl, L = mg["query"][0].shape
    for k in ("query", "ref_col"):
        flat = torch.cat(mg[k], dim=1).reshape(nb * 64, L)[:150]
        assert torch.equal(one[0][k], flat)
    assert torch.equal(one[1], cg[0]) and torch.equal(one[2], sg[3])
    assert torch.equal(one[3], rg[1])
    # prebuilt shards, used by two streams in a row: the ring brings them
    # home after each batch, so both equal the stream that built its own
    mesh = _cpu_mesh(4)
    shards = tring.RingShards(tring.build_ring_shards(small_index, 4), mesh)
    for _ in range(2):
        again = tassemble.stream_align(*args, mesh=mesh, ring_shards=shards)
        for k in mg:
            for x, y in zip(mg[k], again[0][k]):
                assert torch.equal(x, y), k
        for x, y in zip(cg, again[1]):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="this mesh"):
        tassemble.stream_align(*args, mesh=_cpu_mesh(4), ring_shards=shards)


def test_mesh_stream_with_prebuilt_tables(small_ds, small_index, small_tax):
    # per-rank StreamTables uploaded before the stream, as the shards are:
    # the outputs equal those of the stream that builds its own, bit for bit
    ds = small_ds
    cfg = TConfig(batch_size=64, sw_rows=104, shard_index=True)
    args = (ds.reads[:150], ds.read_lens[:150], small_index, ds.ref_seqs,
            ds.ref_lens, small_tax, cfg)
    col_maps = build_col_maps(ds.ref_seqs, ds.ref_lens, small_tax.ref_taxon)
    mesh = _cpu_mesh(4)
    own = tassemble.stream_align(*args, mesh=mesh, col_maps=col_maps)
    tabs = tassemble.StreamTables.from_host(ds.ref_seqs, small_tax, col_maps,
                                          "cpu")
    pre = tassemble.stream_align(*args, mesh=mesh, col_maps=col_maps,
                                 stream_tables=[tabs] * 4)
    for k in own[0]:
        for x, y in zip(own[0][k], pre[0][k]):
            assert torch.equal(x, y), k
    for a, b in zip(own[1:], pre[1:]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="one a rank"):
        tassemble.stream_align(*args, mesh=mesh, stream_tables=[tabs] * 3)
    with pytest.raises(ValueError, match="one a rank"):
        tassemble.stream_align(*args, mesh=mesh,
                               stream_tables=[tabs._replace(
                                   ref_seqs=tabs.ref_seqs[:-1])] * 4)
    with pytest.raises(ValueError, match="need a mesh"):
        tassemble.stream_align(*args, device="cpu", stream_tables=[tabs])


# ---- (e) guards -------------------------------------------------------------

def test_mesh_stream_guards(small_ds, small_index, small_tax):
    ds = small_ds
    args = (ds.reads[:64], ds.read_lens[:64], small_index, ds.ref_seqs,
            ds.ref_lens, small_tax)
    with pytest.raises(UserError, match="must divide the 3-rank mesh"):
        tassemble.stream_align(*args, TConfig(batch_size=64, sw_rows=104),
                               mesh=_cpu_mesh(3))
    with pytest.raises(RuntimeError, match="only on CUDA"):
        tassemble.stream_align(*args, TConfig(batch_size=64, sw_rows=104,
                                              shard_index=True,
                                              ring_impl="dma"),
                               mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="divide the 3-rank mesh"):
        from rambl_tpu_torch.parallel.steps import make_pileup_merge_step

        make_pileup_merge_step(_cpu_mesh(3), 4, 100, shard_positions=True)


# ---- (f) model check of K4's protocol ------------------------------------------

def _program(n, rotations, barrier, drop=()):
    """Per-rank stream programs, in issue order, of `rotations` rounds of
    (every rank reads its shard; rotate), as the wrapper issues them from
    `rotation_plan` (minus the ops whose kind, or (kind, event tag), is in
    `drop`, for the mutation check). Rank r's shard of round t lives in its
    buffer t % 2 (ping-pong)."""
    progs = [[] for _ in range(n)]
    issued = {}                            # (rank, tag) -> records issued
    for t in range(rotations):
        cur, nxt = t % 2, (t + 1) % 2
        epoch = t + 1
        for r in range(n):
            progs[r] += [("read", r, cur, (r - t) % n, "begin"),
                         ("read", r, cur, (r - t) % n, "end")]
        plan = ring_dma.rotation_plan(n, barrier)
        assert sum(op[0] == "copy" for op in plan) == n     # one a rank
        for op in plan:
            kind, r = op[0], op[1]
            if kind in drop or (kind, op[-1]) in drop:
                continue
            if kind == "record":
                issued[r, op[2]] = issued.get((r, op[2]), 0) + 1
                progs[r].append(("record", r, op[2]))
            elif kind == "after":
                progs[r].append(("after", r, op[2], op[3],
                                 issued.get((op[2], op[3]), 0)))
            elif kind == "barrier":
                progs[r] += [("bsignal", r, epoch), ("bwait", r, epoch)]
            elif kind == "copy":
                # the kernel reads and writes the whole tuple, then
                # (dma_barrier) releases the receiver's flag
                dst = (r + 1) % n
                progs[r] += [("cbegin", r, cur, dst, nxt),
                             ("cend", r, cur, dst, nxt,
                              epoch if barrier else None)]
            else:
                progs[r].append(("wait", r, epoch))
    return progs


def _run_model(n, progs, rng):
    """Execute the stream programs in a random interleaving. Returns None,
    or the first violation: a write into a buffer its owner is reading,
    a read of a buffer that does not hold the expected shard, or a
    deadlock."""
    pc = [0] * n
    recorded = {}                          # (rank, tag) -> records run
    flags = {}                             # rank -> epoch
    bar = {}                               # (rank, side) -> epoch
    content = {(r, 0): r for r in range(n)}    # (rank, buf) -> shard id
    reading, writing = [], []              # buffers (rank, buf) in use

    def ready(op):
        kind = op[0]
        if kind == "after":
            return recorded.get((op[2], op[3]), 0) >= op[4]
        if kind == "bwait":
            return all(bar.get((op[1], s), 0) >= op[2] for s in (0, 1))
        if kind == "wait":
            return flags.get(op[1], 0) >= op[2]
        return True

    while any(pc[r] < len(progs[r]) for r in range(n)):
        live = [r for r in range(n)
                if pc[r] < len(progs[r]) and ready(progs[r][pc[r]])]
        if not live:
            return "deadlock"
        r = live[int(rng.integers(len(live)))]
        op = progs[r][pc[r]]
        pc[r] += 1
        kind = op[0]
        if kind == "read":
            _, _, buf, shard, phase = op
            if phase == "begin":
                if (r, buf) in writing:
                    return f"rank {r} reads buffer {buf} while it is written"
                if content.get((r, buf)) != shard:
                    return f"rank {r} reads a stale shard in buffer {buf}"
                reading.append((r, buf))
            else:
                reading.remove((r, buf))
        elif kind == "record":
            recorded[r, op[2]] = recorded.get((r, op[2]), 0) + 1
        elif kind == "bsignal":
            bar[((r - 1) % n, 1)] = op[2]          # left's "from right"
            bar[((r + 1) % n, 0)] = op[2]          # right's "from left"
        elif kind == "cbegin":
            _, _, src, dst, dbuf = op
            if (dst, dbuf) in reading:
                return f"rank {r} writes rank {dst}'s buffer being read"
            reading.append((r, src))
            writing.append((dst, dbuf))
        elif kind == "cend":
            _, _, src, dst, dbuf, epoch = op
            content[(dst, dbuf)] = content[(r, src)]
            reading.remove((r, src))
            writing.remove((dst, dbuf))
            if epoch is not None:
                flags[dst] = epoch
    return None


@pytest.mark.parametrize("barrier", [False, True], ids=["dma", "dma_barrier"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_k4_protocol_model(n, barrier):
    """Random schedules of the rank streams: no deadlock, no rank writes a
    receive buffer its owner is still reading, and every read sees the
    shard the ring should have brought."""
    rng = np.random.default_rng(n)
    progs = _program(n, rotations=6, barrier=barrier)
    for _ in range(150):
        assert _run_model(n, progs, rng) is None


def test_k4_protocol_model_catches_missing_ordering():
    rng = np.random.default_rng(0)

    def found(barrier, drop):
        progs = _program(4, rotations=6, barrier=barrier, drop=drop)
        return {_run_model(4, progs, rng) for _ in range(200)}

    # without the start events, "dma" lets a fast rank overwrite a buffer
    # its slow neighbour is still probing: the model must find that
    assert any(f and "being read" in f
               for f in found(False, {("after", "start")}))
    # without the sent events, a rank reads a shard before it arrived
    assert any(f and ("stale" in f or "while it is written" in f)
               for f in found(False, {("after", "sent")}))
    # without the receive waits of dma_barrier, the same
    assert any(f and ("stale" in f or "while it is written" in f)
               for f in found(True, {"wait"}))


# ---- (g) the mirror of K4's tile walk -------------------------------------------

@settings(max_examples=200, deadline=None)
@given(arrays=st.lists(st.tuples(st.integers(0, 200), st.booleans()),
                       min_size=1, max_size=ring_dma.MAX_ARRAYS),
       blocks=st.integers(1, 9), tile_words=st.sampled_from([4, 8, 32]),
       scalar_threads=st.integers(1, 5))
def test_k4_copy_walk_covers_every_word_once(arrays, blocks, tile_words,
                                             scalar_threads):
    words = [w for w, _ in arrays]
    aligned = [al for _, al in arrays]
    walk = ring_dma.copy_walk(words, aligned, blocks, tile_words,
                              scalar_threads)
    assert len(walk) == blocks
    seen = [np.zeros(w, np.int32) for w in words]
    runs = []
    for block in walk:
        for a, first, count in block["tiles"]:
            # a bulk copy: a 16-byte aligned array, offset and size
            assert aligned[a] and first % 4 == 0 and count % 4 == 0
            assert 0 < count <= tile_words
            seen[a][first:first + count] += 1
            runs.append((a, first))
        for a, rng in block["scalar"]:
            seen[a][list(rng)] += 1
    for a, w in enumerate(words):
        assert (seen[a] == 1).all(), (a, seen[a])
        if not aligned[a]:                       # all of it word by word
            assert all(t[0] != a for t in runs)
    # the grid sweeps the arrays together: round k of the blocks takes
    # tiles k * blocks .. (k + 1) * blocks - 1, in the arrays' order
    by_round = [t for k in range(max(len(b["tiles"]) for b in walk))
                for b in walk for t in b["tiles"][k:k + 1]]
    assert [t[:2] for t in by_round] == sorted(runs) and len(runs) == len(
        by_round)
    sizes = [len(b["tiles"]) for b in walk]
    assert max(sizes) - min(sizes) <= 1


def test_k4_copy_walk_at_the_cohort_shards():
    # the path's shards: 2^25 + 1 words (one tail word) and 3 x 38.4 M words
    words = [(1 << 25) + 1, 3 * 38_400_000]
    blocks = 132
    walk = ring_dma.copy_walk(words, [True, True], blocks)
    tiles = [t for b in walk for t in b["tiles"]]
    assert sum(c for _, _, c in tiles) == (1 << 25) + 3 * 38_400_000
    # 2,048 whole tiles, then 7,031 and a quarter
    assert sorted({c for _, _, c in tiles}) == [ring_dma.TILE_WORDS // 4,
                                                ring_dma.TILE_WORDS]
    assert len(tiles) == 2048 + 7032
    assert walk[5]["tiles"][:2] == [(0, 5 * ring_dma.TILE_WORDS,
                                     ring_dma.TILE_WORDS),
                                    (0, 137 * ring_dma.TILE_WORDS,
                                     ring_dma.TILE_WORDS)]
    scalar = [(a, list(r)) for b in walk for a, r in b["scalar"]]
    assert scalar == [(0, [1 << 25])]
    # an unaligned view of the same arrays goes word by word
    walk = ring_dma.copy_walk([1001, 64], [False, True], 2)
    assert [t for b in walk for t in b["tiles"]] == [(1, 0, 64)]
    assert sum(len(r) for b in walk for _, r in b["scalar"]) == 1001
