"""Config 4's state cache and its three diagnoses, held to the reference
scripts.

- `cache_config4_state.run(device="cpu")` on a cut cohort (2 species x 3
  strains, 2 samples of 300 reads, seed 5; two rounds, batch 300): its
  `.npz` reloads with `allow_pickle=False` to the genes, counts, reads,
  sources, panel and config that `assemble_cohort` and `leaf_counts_dict`
  gave in memory, with counts for every leaf of the panel in every sample
  (those two are held to the JAX package in `test_torch_cohort.py` and
  `test_torch_polish.py`).
- `census_config4.run`, `diagnose_impure.run` and
  `demonstrate_c4_ambiguity.run` print the lines of `scripts/
  census_config4.py`, `scripts/diagnose_impure.py` and `scripts/
  demonstrate_c4_ambiguity.py` (loaded by path), whole, on that state and
  on five planted states. The reference census runs its own cohort inside
  `main`: its `simulate_cohort`, `PipelineConfig`, `rambl_tpu.pipeline.
  assemble.{assemble_cohort, leaf_counts_dict}` and `rambl_tpu.index.
  builder.build_seed_index` hand it the state instead. The other two read
  a pickle: their `open` and `pickle.load` hand them the state as
  reference-typed objects (`rambl_tpu.oracle.pipeline.Gene`s, the
  reference's `PipelineConfig`).
- The planted states keep the cut cohort's panel. Four (`planted`) draw
  counts from strain mixtures with noise, thin stretches, tied minors and
  foreign alleles, genes from the strains with substitutions, indels and
  cut ends, and sometimes a small `cohort_max_cols` or one DP-means pass;
  one (`reversion`) is built to part the emitter's column map from the
  demonstration's.
  Across the cases every bucket of the census and its gate breakdown, every
  wrong-base kind of `diagnose_impure` and every kind of the demonstration
  occurs, except the census's major-side gate: 2 x the second-largest
  count never exceeds the total, so that gate is unreachable in the
  reference too.

Each package's exact NW map (`index.colmap._nw_map`) is computed once for
each distinct input, to stay inside the suite's time; each side is handed
its own package's map, and where both sides map one input the two maps
are held equal.
"""

import dataclasses
import os
import re
import types
from collections import Counter

import numpy as np
import pytest
from test_torch_assemble import one_thread
from test_torch_scale_runners import _script

import rambl_tpu.index.builder as jbuilder
import rambl_tpu.index.colmap as jcolmap
import rambl_tpu.pipeline.assemble as jassemble
import rambl_tpu_torch.index.colmap as tcolmap
from rambl_tpu.config import PipelineConfig as JConfig
from rambl_tpu.oracle.pipeline import Gene as JGene
from rambl_tpu_torch.data.simulate import simulate_cohort
from rambl_tpu_torch.oracle.pipeline import Gene
from rambl_tpu_torch.scripts import cache_config4_state as c4s
from rambl_tpu_torch.scripts import (
    census_config4,
    demonstrate_c4_ambiguity,
    diagnose_impure,
)

__all__ = ["one_thread"]      # the fixture shared with that module

COHORT = dict(n_species=2, refs_per_species=3, n_samples=2,
              reads_per_sample=300, seed=5)
CUT = dict(max_assembly_iters=2, batch_size=300, max_genes=32)
PLANTED = (0, 1, 7, 63)
CASES = ("cohort", "reversion") + tuple(f"planted-{s}" for s in PLANTED)
TOOLS = {"census": census_config4, "impure": diagnose_impure,
         "demonstrate": demonstrate_c4_ambiguity}
WANT = {
    "census": ("no-backbone", "few-true-cols", "cols-not-qualifying",
               "grouped-wrongly", "emitted-low-support", "emitted-impure",
               "'depth'", "'min_abs'", "'frac'", "'non-unique-2nd'",
               "'cap/other'", "'qual-but-other-allele'"),
    "impure": ("qual-own-col", "qual-other-group", "substituted-not-ours",
               "qual-wrong-allele", "'backbone'", "gate-depth",
               "gate-min_abs", "gate-frac", "gate-non-unique-2nd",
               "gate-cap/other"),
    "demonstrate": ("invisible/not-qualifying", "invisible/minor-is-not-true",
                    "linkage-only/reversion", "ambiguous/group-margin",
                    "fixable/group-margin"),
}



@pytest.fixture(scope="module", autouse=True)
def memo_nw():
    """Each package's exact NW map, once a distinct input; the port's and
    the reference's maps of one input are held equal."""
    memo = {}

    def memoized(side, real):
        def nw_map(a, b):
            a, b = np.asarray(a), np.asarray(b)
            seen = memo.setdefault(
                (a.dtype.str, b.dtype.str, a.tobytes(), b.tobytes()), {})
            if side not in seen:
                seen[side] = real(a, b)
                for other in seen.values():
                    np.testing.assert_array_equal(seen[side], other)
            return seen[side].copy()
        return nw_map

    port = memoized("port", tcolmap._nw_map)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tcolmap, diagnose_impure, demonstrate_c4_ambiguity):
            mp.setattr(mod, "_nw_map", port)
        mp.setattr(jcolmap, "_nw_map", memoized("reference", jcolmap._nw_map))
        yield


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("c4") / "state.npz")
    st = c4s.run(co=simulate_cohort(**COHORT), device="cpu", path=path,
                 overrides=CUT, out=lambda *a: None)
    return st, path


def planted(st, seed, n_samples=3):
    """A state on `st`'s panel with drawn counts and genes (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(
        st.cfg, cohort_max_cols=int(rng.choice([512, 512, 8])),
        cohort_max_iters=int(rng.choice([8, 1])))
    L = st.ref_seqs.shape[1]
    ref_taxon = np.asarray(st.ref_taxon)
    taxa = np.unique(ref_taxon)
    refs = {int(t): np.nonzero(ref_taxon == t)[0] for t in taxa}
    seqs = [st.ref_seqs[r, : st.ref_lens[r]] for r in range(st.n_refs)]
    counts_list = [{} for _ in range(n_samples)]
    tie_cols, foreign = {}, {}
    for t in taxa.tolist():
        depth = np.rint(rng.lognormal(2.3, 1.2, (n_samples, refs[t].size)))
        low = rng.random(refs[t].size) < 0.3
        depth[:, low] = rng.integers(0, 3, (n_samples, int(low.sum())))
        cs = [np.zeros((L, 4), np.int32) for _ in range(n_samples)]
        for s in range(n_samples):
            for k, r in enumerate(refs[t]):
                cs[s][np.arange(seqs[r].size), seqs[r]] += int(depth[s, k])
            noisy = rng.random(L) < 0.02
            cs[s][noisy, rng.integers(0, 4, L)[noisy]] += rng.integers(
                1, 8, L)[noisy]
        Lr = int(min(seqs[r].size for r in refs[t]))
        # in some leaves, a stretch of one read's bases in one sample
        lo, n_thin = int(rng.integers(0, Lr - 60)), int(rng.choice([0, 40]))
        for s in range(n_samples):
            cs[s][lo: lo + n_thin] = 0
        cs[0][np.arange(lo, lo + n_thin), rng.integers(0, 4, n_thin)] = 1
        # in some leaves, tied minors and two foreign alleles
        n_odd = int(rng.choice([0, 6]))
        at = rng.choice(Lr, n_odd, replace=False)
        fc = rng.choice(Lr, n_odd, replace=False)
        fx = (seqs[refs[t][0]][fc] + 1) % 4
        tie_cols[t], foreign[t] = at, (fc, fx)
        for s in range(n_samples):
            cs[s][at] = 0
            cs[s][at, 0] = 20
            cs[s][at, 1] = 3
            cs[s][at, 2] = 3
            cs[s][fc] = 0
            cs[s][fc, fx] = 14
            cs[s][fc, (fx + 1) % 4] = 4
            counts_list[s][t] = cs[s]
    geneses = []
    drop = int(rng.choice(taxa)) if rng.random() < 0.3 else None
    for s in range(n_samples):
        genes = []
        for r in range(st.n_refs):
            t = int(ref_taxon[r])
            if t == drop or rng.random() < 0.3:
                continue
            g = seqs[r].copy()
            n_sub = int(rng.choice([0, 3, 8, 15, 25]))
            at = rng.choice(g.size, n_sub, replace=False)
            other = seqs[refs[t][rng.integers(refs[t].size)]]
            g[at] = np.where(rng.random(n_sub) < 0.5,
                             other[np.minimum(at, other.size - 1)],
                             (g[at] + rng.integers(1, 4, n_sub)) % 4)
            # some of the strain's private columns, tied and foreign ones
            n = min(g.size, other.size)
            own = np.nonzero(g[:n] != other[:n])[0]
            own = own[rng.random(own.size) < 0.3]
            g[own] = other[own]
            tc = tie_cols[t][tie_cols[t] < g.size]
            g[tc[rng.random(tc.size) < 0.5]] = 0
            fc, fx = foreign[t]
            keep = (fc < g.size) & (rng.random(fc.size) < 0.5)
            g[fc[keep]] = fx[keep]
            if rng.random() < 0.3:
                p = int(rng.integers(100, g.size - 100))
                g = np.concatenate([g[:p], g[p + int(rng.integers(1, 5)):]])
            if rng.random() < 0.3:
                p = int(rng.integers(100, g.size - 100))
                g = np.concatenate([g[:p], rng.integers(
                    0, 4, int(rng.integers(1, 4))), g[p:]])
            diff = np.nonzero(seqs[r] != seqs[refs[t][0]][:seqs[r].size])[0]
            if diff.size and rng.random() < 0.5:
                # a base inserted beside a column where the strain differs
                p = int(diff[rng.integers(diff.size)]) + 1
                g = np.concatenate([g[:p], [int(rng.integers(4))], g[p:]])
            head = int(rng.choice([0, 0, 30]))
            tail = int(rng.choice([0, 0, 40]))
            genes.append(Gene(seq=g[head: g.size - tail].astype(np.int8),
                              n_reads=int(rng.integers(1, 60)), leaf=t,
                              cluster=len(genes), round_born=0, taxon=t,
                              offset=head))
        geneses.append(genes)
    true_ref = [np.repeat(np.arange(st.n_refs),
                          rng.integers(0, 120, st.n_refs))
                for _ in range(n_samples)]
    samples = [(np.zeros((0, 128), np.int8), np.zeros(0, np.int32))
               ] * n_samples
    return dataclasses.replace(st, samples=samples, true_ref=true_ref,
                               geneses=geneses, counts_list=counts_list,
                               cfg=cfg)


def reversion(st):
    """The leaf of reference 0 alone: its three strains mixed in three
    samples at depths that set strains 1 and 2 apart, and one gene, the
    backbone: the anchor with ten substitutions off the strains' columns
    and an A inserted after the sixth column where strain 1 differs. The
    emitter maps that column through the backbone, the demonstration
    through the phased gene, and the two maps part there: the
    demonstration's linkage-only/reversion kind."""
    ref_taxon = np.asarray(st.ref_taxon)
    t = int(ref_taxon[0])
    a0, a1, a2 = (st.ref_seqs[r, : st.ref_lens[r]]
                  for r in np.nonzero(ref_taxon == t)[0])
    n = min(a0.size, a1.size, a2.size)
    varied = (a0[:n] != a1[:n]) | (a0[:n] != a2[:n])
    p = int(np.nonzero(a1[:n] != a0[:n])[0][5])
    depth = ((40, 12, 3), (40, 3, 12), (40, 8, 8))
    counts_list = []
    for d in depth:
        c = np.zeros((st.ref_seqs.shape[1], 4), np.int32)
        for k, a in zip(d, (a0, a1, a2)):
            c[np.arange(a.size), a] += k
        counts_list.append({u: np.zeros_like(c) for u in st.counts_list[0]})
        counts_list[-1][t] = c
    sub = np.random.default_rng(0).choice(np.setdiff1d(
        np.arange(100, n - 100), np.nonzero(varied)[0]), 10, replace=False)
    bb = a0.copy()
    bb[sub] = (bb[sub] + 1) % 4
    bb = np.concatenate([bb[: p + 1], [0], bb[p + 1:]]).astype(np.int8)
    return dataclasses.replace(
        st, samples=[st.samples[0]] * 3, counts_list=counts_list,
        true_ref=[np.repeat(np.arange(st.n_refs), 100)] * 3,
        geneses=[[Gene(seq=bb, n_reads=100, leaf=t, cluster=0, round_born=0,
                       taxon=t)], [], []])


@pytest.fixture(scope="module")
def cases(state):
    st = state[0]
    return {"cohort": st, "reversion": reversion(st),
            **{f"planted-{s}": planted(st, s) for s in PLANTED}}


@pytest.fixture(scope="module")
def port(cases):
    """{(case, tool): (printed lines, what run returned)}, each run once."""
    out = {}
    for case, st in cases.items():
        for name, tool in TOOLS.items():
            lines = []
            got = tool.run(st, out=lines.append)
            out[case, name] = ("\n".join(lines).splitlines(), got)
    return out


def _fields(genes):
    return [(g.seq.tobytes(), g.n_reads, g.leaf, g.cluster, g.round_born,
             g.taxon, g.offset) for g in genes]


def test_state_reloads_to_what_was_computed(state):
    st, path = state
    with np.load(path, allow_pickle=False) as z:
        assert {"counts", "count_taxa", "gene_seq", "config"} <= set(z.files)
    back = c4s.load_state(path)
    assert back.cfg == st.cfg and st.cfg.sw_rows == 104
    assert [_fields(g) for g in back.geneses] == [_fields(g)
                                                  for g in st.geneses]
    assert any(g.round_born == -1 for gs in back.geneses for g in gs)
    leaves = set(np.unique(st.ref_taxon).tolist())
    for got, want in zip(back.counts_list, st.counts_list, strict=True):
        assert set(got) == set(want) == leaves
        for t in want:
            assert got[t].dtype == want[t].dtype
            np.testing.assert_array_equal(got[t], want[t])
    for (r, n), (r0, n0) in zip(back.samples, st.samples, strict=True):
        np.testing.assert_array_equal(r, r0)
        np.testing.assert_array_equal(n, n0)
    for a, b in zip(back.true_ref, st.true_ref, strict=True):
        np.testing.assert_array_equal(a, b)
    for f in c4s._PANEL:
        np.testing.assert_array_equal(getattr(back, f), getattr(st, f))


def _reference_state(st):
    ds = types.SimpleNamespace(
        **{f: getattr(st, f) for f in c4s._PANEL}, n_refs=st.n_refs)
    return dict(ds=ds, cfg=JConfig.from_json(st.cfg.to_json()),
                counts_list=st.counts_list, co_true_ref=st.true_ref,
                results=[([JGene(**vars(g)) for g in gs],)
                         for gs in st.geneses])


def _reference_lines(name, st, monkeypatch, capsys):
    ref = _reference_state(st)
    mod = _script(name)
    if name == "census_config4":
        co = types.SimpleNamespace(ds=ref["ds"], samples=st.samples,
                                   true_ref=st.true_ref)
        counts = iter(st.counts_list)
        monkeypatch.setattr(mod, "simulate_cohort", lambda **kw: co)
        monkeypatch.setattr(mod, "PipelineConfig", lambda **kw: ref["cfg"])
        monkeypatch.setattr(jassemble, "assemble_cohort", lambda *a, **k: [
            types.SimpleNamespace(genes=g) for (g,) in ref["results"]])
        monkeypatch.setattr(jassemble, "leaf_counts_dict",
                            lambda *a, **k: next(counts))
        monkeypatch.setattr(jbuilder, "build_seed_index", lambda *a, **k: 0)
        argv = [name, "0", str(len(st.samples)), "0"]
    else:
        monkeypatch.setattr(mod, "open", lambda *a, **k: open(os.devnull),
                            raising=False)
        monkeypatch.setattr(mod, "pickle",
                            types.SimpleNamespace(load=lambda f: ref))
        argv = [name]
    monkeypatch.setattr("sys.argv", argv)
    capsys.readouterr()
    mod.main()
    return [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("cohort assembly:")]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_prints_the_reference_lines(tool, case, cases, port,
                                         monkeypatch, capsys):
    script = {"census": "census_config4", "impure": "diagnose_impure",
              "demonstrate": "demonstrate_c4_ambiguity"}[tool]
    want = _reference_lines(script, cases[case], monkeypatch, capsys)
    assert port[case, tool][0] == want


def test_every_bucket_and_kind_occurs(port):
    for tool, words in WANT.items():
        text = "\n".join(ln for case in CASES for ln in port[case, tool][0])
        missing = [w for w in words if w not in text]
        assert not missing, (tool, missing)
    census = sum((port[c, "census"][1] for c in CASES), Counter())
    assert set(census) == set(WANT["census"][:6])
    impure = [port[c, "impure"][1][0] for c in CASES]
    assert sum(t["emit-holes"] for t in impure) > 0
    assert sum(t["missing-cols"] for t in impure) > 0
    demo = [port[c, "demonstrate"][1] for c in CASES]
    assert sum(d[2] for d in demo) > 0          # fixable somewhere
    for total, rows, n_fix, n_all in demo:
        assert n_all == sum(total.values())
        assert n_fix == total.get("fixable/group-margin", 0)
        assert sum(sum(per.values()) for *_, per in rows) == n_all
    assert not any(re.search(r"'major-side'|gate-major-side", ln)
                   for case in CASES for tool in ("census", "impure")
                   for ln in port[case, tool][0])
