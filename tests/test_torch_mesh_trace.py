"""The mesh stream's spans and counters (`rambl_tpu_torch.utils.trace`) on
four CPU ranks with the ring-sharded index and the plain rotation
(ring_impl="ppermute"; K4 has no CPU mode): the spans nest as named, the
ring's counts follow from the batches and the shards' sizes, and the
outputs are bit for bit the same with the recorder on and off.
"""

import numpy as np
import pytest
import torch

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.colmap import build_col_maps
from rambl_tpu_torch.parallel.mesh import data_mesh
from rambl_tpu_torch.parallel.ring import RingShards, build_ring_shards
from rambl_tpu_torch.pipeline import assemble
from rambl_tpu_torch.utils import trace

RANKS = 4
N_READS = 200
BATCH = 64              # 16 reads a rank a batch; 4 batches, the last padded
N_BATCHES = -(-N_READS // BATCH)

#: each span of the mesh stream and the span it opens in
PARENT = {
    "stream": None,
    "stream.prepare": "stream",
    "stream.ring_shards": "stream.prepare",
    "stream.tables_upload": "stream.prepare",
    "stream.col_maps": "stream.tables_upload",
    "stream.pad": "stream.prepare",
    "stream.pin": "stream.prepare",
    "stream.buffers": "stream.prepare",
    "stream.loop": "stream",
    "stream.batch": "stream.loop",
    "align.seed": "stream.batch",
    "ring.probe": "align.seed",
    "ring.rotate": "ring.probe",
    "align.score": "stream.batch",
    "align.gapped": "stream.batch",
    "align.bin": "stream.batch",
    "stream.retain": "stream.batch",
    "stream.merge": "stream",
    "stream.replicate": "stream",
}
#: the spans a call makes only when it builds the shards and the tables
BUILT = ("stream.ring_shards", "stream.tables_upload", "stream.col_maps")


@pytest.fixture(scope="module")
def runs(small_ds, small_index, small_tax):
    """The stream with the recorder off, then on (building its own shards
    and tables), then on with prebuilt ones: each run's outputs, spans and
    counts."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ds = small_ds
    cfg = PipelineConfig(batch_size=BATCH, sw_rows=104, shard_index=True,
                         ring_impl="ppermute")
    args = (ds.reads[:N_READS], ds.read_lens[:N_READS], small_index,
            ds.ref_seqs, ds.ref_lens, small_tax, cfg)
    mesh = data_mesh(devices=["cpu"] * RANKS)
    host_shards = build_ring_shards(small_index, RANKS)
    col_maps = build_col_maps(ds.ref_seqs, ds.ref_lens, small_tax.ref_taxon)
    tables = assemble.StreamTables.from_host(ds.ref_seqs, small_tax,
                                             col_maps, "cpu")
    prebuilt = dict(ring_shards=RingShards(host_shards, mesh),
                    stream_tables=[tables] * RANKS)
    out = {}
    try:
        trace.clear()
        out["off"] = (assemble.stream_align(*args, mesh=mesh), [], [])
        for name, kw in (("on", {}), ("prebuilt", prebuilt)):
            trace.RECORDER.forced += 1
            try:
                res = assemble.stream_align(*args, mesh=mesh, **kw)
            finally:
                trace.RECORDER.forced -= 1
            out[name] = (res, trace.spans(), trace.counts())
            trace.clear()
    finally:
        torch.set_num_threads(n_threads)
    words = sum(a.size for a in host_shards.values())
    return out, words


def test_mesh_trace_spans_nest_as_named(runs):
    out, _ = runs
    assert out["off"][1] == []
    for name in ("on", "prebuilt"):
        spans = out[name][1]
        seen = {}
        for n, t0, t1, parent in spans:
            assert n in PARENT, n
            assert parent == PARENT[n], (n, parent)
            assert t0 <= t1
            seen[n] = seen.get(n, 0) + 1
        want = {"stream": 1, "stream.loop": 1, "stream.merge": 1,
                "stream.replicate": 1, "stream.batch": N_BATCHES,
                "align.seed": N_BATCHES, "stream.retain": N_BATCHES,
                "align.bin": N_BATCHES, "ring.probe": 2 * N_BATCHES,
                "ring.rotate": 2 * RANKS * N_BATCHES,
                "align.score": RANKS * N_BATCHES}
        for n, k in want.items():
            assert seen[n] == k, (name, n, seen[n])
        built = [n for n in BUILT if n in seen]
        assert built == (list(BUILT) if name == "on" else []), name
        # each span lies inside its parent's latest opening before it
        opened = {}
        for n, t0, t1, parent in sorted(spans, key=lambda s: (s[1], -s[2])):
            if parent is not None:
                p0, p1 = opened[parent]
                assert p0 <= t0 and t1 <= p1, (n, parent)
            opened[n] = (t0, t1)


def test_mesh_trace_ring_counts(runs, small_index):
    out, words = runs
    # a shard is Pn + 1 bucket offsets and 3 words an entry of the largest
    # shard's entries (build_ring_shards' layout)
    P = small_index.n_buckets
    Pn = -(-P // RANKS)
    bst = small_index.bucket_start
    emax = max(int(bst[min((s + 1) * Pn, P)] - bst[min(s * Pn, P)])
               for s in range(RANKS))
    assert words == RANKS * (Pn + 1 + 3 * max(emax, 1))
    rotations = 2 * RANKS * N_BATCHES
    for name in ("on", "prebuilt"):
        counts = out[name][2]
        assert {c[0] for c in counts} == {"ring.rotations", "ring.words"}
        assert all(span == "ring.rotate" for _, _, _, span in counts)
        rot = [n for m, _, n, _ in counts if m == "ring.rotations"]
        sent = [n for m, _, n, _ in counts if m == "ring.words"]
        assert rot == [1] * rotations
        assert sum(rot) == rotations
        assert sent == [words] * rotations
        assert sum(sent) == rotations * words


def test_mesh_trace_outputs_equal_with_recorder_on_and_off(runs):
    out, _ = runs
    off = out["off"][0]
    for name in ("on", "prebuilt"):
        got = out[name][0]
        assert set(got[0]) == set(off[0])
        for k in off[0]:
            for a, b in zip(off[0][k], got[0][k]):
                assert torch.equal(a, b), (name, k)
        for part in (1, 2, 3):              # counts, span_diff, read_count
            assert len(got[part]) == RANKS
            for a, b in zip(off[part], got[part]):
                assert torch.equal(a, b), (name, part)
    assert int(off[3][0].sum()) == int(np.count_nonzero(
        torch.cat(off[0]["bins_sh"], 1).numpy().reshape(-1)[:N_READS] >= 0))
