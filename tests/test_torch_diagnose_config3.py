"""Config 3's miss diagnosis (`rambl_tpu_torch/scripts/diagnose_config3.py`)
and the panel dump it reads (`run_config3.write_dump` / `load_dump`), held
to the reference script `scripts/diagnose_config3.py`.

The reference's `main` reads two pickles: the panel and the dataset cache.
It is loaded by path and handed reference-typed objects (`rambl_tpu.oracle.
pipeline.Gene`s and a `rambl_tpu` dataset) through its module-level `open`
and `pickle.load`; the port's `main` reads its own dump and `.npz` cache of
the same content. Their printed lines must be equal, whole.

- A planted panel on the tiny config-3 dataset (a leaf per reference, 20
  references) reaches every miss class (near-miss, few-wrong-bases,
  short/truncated, many-wrong-bases, no-gene-for-taxon) and, through
  planted slot counts at each wrong base, every wrong-base class
  (thin-evidence, poly-guard, tied-winner, no-majority, winner-wrong,
  winner-right-gene-wrong); one missed leaf has no slot, one taxon holds
  two genes of equal containment (the first is kept).
- `run_config3.run` at that shape (slot mode forced, batch 128, two
  rounds) writes its dump; it reloads with `allow_pickle=False` to the
  run's genes, recovered and detectable references, stats and slot counts
  (memory-mapped), and both diagnoses agree on it.
- A taxonomy that is not leaf per ref is refused.
"""

import os
import types

import numpy as np
import pytest
from test_torch_assemble import one_thread
from test_torch_scale_runners import _script

from rambl_tpu.data import simulate as jsim
from rambl_tpu.oracle.pipeline import Gene as JGene
from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.colmap import _nw_map
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts import diagnose_config3, run_config3

__all__ = ["one_thread"]      # the fixture shared with that module

N_READS, N_REFS, N_PRESENT = 300, 20, 8
K = PipelineConfig().k
CLASSES, BASE_CLASSES = diagnose_config3.CLASSES, diagnose_config3.BASE_CLASSES


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("c3")
    caches.config3(N_READS, N_REFS, N_PRESENT, directory=str(d),
                   out=lambda *a: None)
    return d


@pytest.fixture(scope="module")
def data(cache_dir):
    return caches.load_cache(str(cache_dir / caches.cache_name(
        "config3", N_READS, N_REFS, K)))


def _reference_lines(monkeypatch, capsys, dump):
    """The reference script's lines on `dump` (`load_dump`'s dict)."""
    mod = _script("diagnose_config3")
    ds = jsim.simulate_dataset(n_species=N_REFS // 5, refs_per_species=5,
                               n_reads=N_READS, seed=13, leaf_per_ref=True,
                               n_present=N_PRESENT)
    st = dict(genes=[JGene(**vars(g)) for g in dump["genes"]],
              recovered=set(dump["recovered"]),
              detectable=np.asarray(dump["detectable"]),
              stats=dump["stats"], slot_counts=(
                  None if dump["slot_counts"] is None else
                  (np.asarray(dump["slot_counts"][0]),
                   dump["slot_counts"][1])))
    loads = iter([st, (ds, None)])
    monkeypatch.setattr(mod, "open", lambda *a, **k: open(os.devnull, "rb"),
                        raising=False)
    monkeypatch.setattr(mod, "pickle",
                        types.SimpleNamespace(load=lambda f: next(loads)))
    monkeypatch.setattr("sys.argv", ["diagnose_config3.py"])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def _port_lines(capsys, path, cache_dir):
    capsys.readouterr()
    diagnose_config3.main([str(path), "--cache-dir", str(cache_dir)])
    return capsys.readouterr().out.splitlines()


def _mutate(ref, rng, n_sub, lo=0):
    """`ref` with n_sub substitutions, 40 columns apart from column lo+20."""
    g = ref.copy()
    for p in lo + 20 + 40 * np.arange(n_sub):
        g[p] = (g[p] + 1 + rng.integers(3)) % 4
    return g


def _planted(data):
    """A panel, recovered/detectable sets and slot counts that reach every
    class of the tool."""
    rng = np.random.default_rng(3)
    ref = [data.ref_seqs[r, : data.ref_lens[r]].copy() for r in range(12)]
    tax = data.ref_taxon

    def gene(r, seq, n_reads=None, **kw):
        return Gene(seq=np.asarray(seq, np.int8),
                    n_reads=int(5 + r) if n_reads is None else n_reads,
                    leaf=int(tax[r]), cluster=r % 3, round_born=r % 4,
                    taxon=int(tax[r]), **kw)

    far = _mutate(ref[6], rng, 20)
    genes = [
        gene(0, ref[0]),                                # recovered
        gene(3, _mutate(ref[3], rng, 1)),               # near-miss
        gene(3, _mutate(ref[3], rng, 1), n_reads=99),   # its equal: not kept
        gene(3, _mutate(ref[3], rng, 12)),              # worse
        gene(4, _mutate(ref[4], rng, 7)),               # few-wrong-bases
        gene(5, _mutate(ref[5], rng, 10, lo=900)[600:], offset=600),
        # many-wrong-bases, with 2 inserted bases and 3 deleted columns
        gene(6, np.concatenate([far[:700], [0, 1], far[700:900],
                                far[903:]])),
        gene(7, _mutate(ref[7], rng, 9)),               # many, no slot
        gene(8, _mutate(ref[8], rng, 30)),              # many-wrong-bases
    ]
    detectable = np.arange(10, dtype=np.int64)
    recovered = {0, 1, 11}                 # 2 and 9 have no gene
    slotted = (3, 4, 5, 6, 8)
    node2slot = np.full(data.tax_parent.shape[0], -1, np.int32)
    node2slot[tax[list(slotted)]] = np.arange(len(slotted))
    ref_len = data.ref_seqs.shape[1]
    counts = np.zeros((64, ref_len, 4), np.int32)
    k = 0
    for g in genes[1:]:
        r = int(np.nonzero(tax == g.taxon)[0][0])
        if r not in slotted:
            continue
        s = node2slot[g.taxon]
        counts[s, np.arange(len(ref[r])), ref[r]] = 10
        m = _nw_map(ref[r], g.seq)
        for p in np.nonzero((m >= 0) & (ref[r][np.maximum(m, 0)]
                                        != g.seq))[0]:
            c, b = int(m[p]), int(ref[r][m[p]])
            o1, o2 = (b + 1) % 4, (b + 2) % 4
            pattern = {0: {b: 2}, 1: {b: 10, o1: 5}, 2: {b: 3, o1: 3},
                       3: {b: 3, o1: 2, o2: 1}, 4: {b: 0, o1: 10},
                       5: {b: 10}}[k % 6]
            counts[s, c] = 0
            for base, n in pattern.items():
                counts[s, c, base] = n
            k += 1
    return genes, recovered, detectable, (counts.reshape(64, -1), node2slot)


def test_planted_panel_reaches_every_class(tmp_path, data, cache_dir,
                                           monkeypatch, capsys):
    genes, recovered, detectable, slot = _planted(data)
    path = tmp_path / "dump"
    run_config3.write_dump(str(path), genes, recovered, detectable,
                           [dict(round=0, genes=len(genes))], slot,
                           N_READS, N_REFS, K)
    dump = run_config3.load_dump(str(path))
    classes, base_classes, rows = diagnose_config3.run(
        dump, data.ref_seqs, data.ref_lens, data.ref_taxon,
        out=lambda *a: None)
    assert sorted(classes) == sorted(CLASSES), classes
    assert sorted(base_classes) == sorted(BASE_CLASSES), base_classes
    assert [r["ref"] for r in rows] == [2, 3, 4, 5, 6, 7, 8, 9]
    by_ref = {r["ref"]: r for r in rows}
    assert by_ref[3]["reads"] == 8 and by_ref[3]["cls"] == CLASSES[0]
    assert by_ref[6]["ins"] == 2 and by_ref[7]["bases"] is None
    assert _port_lines(capsys, path, cache_dir) == _reference_lines(
        monkeypatch, capsys, dump)


def test_dump_round_trip_and_diagnosis_of_a_run(tmp_path, cache_dir, data,
                                                monkeypatch, capsys):
    path = tmp_path / "run_dump"
    out = run_config3.run(N_READS, N_REFS, n_present=N_PRESENT, device="cpu",
                          data=data, dump=str(path),
                          overrides=dict(batch_size=128, pileup_slot_nodes=1,
                                         cluster_leaf_block=8,
                                         max_assembly_iters=2),
                          out=lambda *a: None)
    assert out["dump_bytes"] > 0
    with np.load(path / "panel.npz", allow_pickle=False) as z:
        assert "node2slot" in z.files
    np.load(path / "slot_counts.npy", allow_pickle=False)
    dump = run_config3.load_dump(str(path))
    res = out["result"]
    assert [vars(g) for g in dump["genes"]] != []
    for got, want in zip(dump["genes"], res.genes, strict=True):
        np.testing.assert_array_equal(got.seq, want.seq)
        assert {k: v for k, v in vars(got).items() if k != "seq"} == {
            k: int(v) for k, v in vars(want).items() if k != "seq"}
    assert dump["recovered"] == set(out["recovered_refs"].tolist())
    np.testing.assert_array_equal(dump["detectable"], out["detectable_refs"])
    assert dump["stats"] == res.round_stats
    counts, node2slot = dump["slot_counts"]
    assert isinstance(counts, np.memmap)
    np.testing.assert_array_equal(counts, out["aux"]["slot_counts"][0])
    np.testing.assert_array_equal(node2slot, out["aux"]["slot_counts"][1])
    assert (dump["n_reads"], dump["n_refs"], dump["k"]) == (N_READS, N_REFS,
                                                            K)
    assert _port_lines(capsys, path, cache_dir) == _reference_lines(
        monkeypatch, capsys, dump)


def test_wrong_base_classes_need_leaf_per_ref(tmp_path, data):
    genes, recovered, detectable, slot = _planted(data)
    path = tmp_path / "dump"
    run_config3.write_dump(str(path), genes, recovered, detectable, [], slot,
                           N_READS, N_REFS, K)
    taxon = data.ref_taxon.copy()
    taxon[1] = taxon[0]                    # two references share a leaf
    with pytest.raises(ValueError, match="leaf-per-ref"):
        diagnose_config3.run(run_config3.load_dump(str(path)),
                             data.ref_seqs, data.ref_lens, taxon,
                             out=lambda *a: None)


def test_dump_replaces_only_a_dump(tmp_path, data):
    genes, recovered, detectable, slot = _planted(data)

    def write(path):
        return run_config3.write_dump(str(path), genes[:2], recovered,
                                      detectable, [], None, N_READS, N_REFS,
                                      K)

    path = tmp_path / "dump"
    assert write(path) > 0 and write(path) > 0      # a dump is replaced
    assert sorted(os.listdir(path)) == ["panel.npz"]
    other = tmp_path / "other"
    other.mkdir()
    (other / "keep.txt").write_text("x")
    (tmp_path / "file").write_text("x")
    (tmp_path / "busy.tmp").mkdir()
    (tmp_path / "busy.tmp" / "keep.txt").write_text("x")
    for target in (other, tmp_path / "file", tmp_path / "busy"):
        with pytest.raises(FileExistsError):
            write(target)
        with pytest.raises(FileExistsError):    # before the assembly runs
            run_config3.run(N_READS, N_REFS, device="cpu", data=data,
                            dump=str(target), out=lambda *a: None)
    assert (other / "keep.txt").read_text() == "x"
    assert (tmp_path / "busy.tmp" / "keep.txt").read_text() == "x"
    assert not (tmp_path / "busy").exists()
    with pytest.raises(SystemExit):                 # no --dump option
        run_config3.main(["--dump", str(other)])
