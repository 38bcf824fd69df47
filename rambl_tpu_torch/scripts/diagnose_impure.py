"""Base-level diagnosis of config 4's impure misses: the port of
scripts/diagnose_impure.py.

    python -m rambl_tpu_torch.scripts.diagnose_impure [state.npz]

Reads `cache_config4_state`'s state (its default file unless a path is
given). A strain is missed when the best gene that matches it best (each
gene goes to the reference it shares the most distinct 25-mers with, the
first of equals) has a containment in (.5, .95]. Each miss is then held
against its own leaf's best gene (the gene of that leaf with the highest
containment of the strain; the first of equals), mapped onto the leaf's
anchor by the exact NW map (`index.colmap._nw_map`: the cohort emitter's
coordinates). Every wrong base is classed:

  qual-own-col          the column qualified with the strain's base as the
                        minor and in this gene's group, yet the base is wrong
  qual-other-group      it qualified, but its minor went to another group
  substituted-not-ours  it qualified; the strain's base is the pooled major,
                        the gene carries a substituted minor
  qual-wrong-allele     it qualified with neither allele the strain's
  backbone              it did not qualify and the strain's base is the
                        pooled major
  gate-depth, gate-min_abs, gate-frac, gate-major-side,
  gate-non-unique-2nd, gate-cap/other
                        it did not qualify: the first gate it failed

Each line adds `emit-holes` (gene bases with no anchor column inside the
strain) and `missing-cols` (the strain's columns the gene does not reach);
the TOTAL line orders every kind by count. The gene's group is the most
common group over the qualifying columns where it carries the minor.

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np

from rambl_tpu_torch.index.colmap import _nw_map, anchor_of_leaf
from rambl_tpu_torch.oracle.cohort import phase_columns, qualifying_columns
from rambl_tpu_torch.scripts import cache_config4_state
from rambl_tpu_torch.scripts.census_config4 import _gate, leaf_stack
from rambl_tpu_torch.scripts.quality_bench import coverage, shared_kmers


def _best_genes(st, tax, detectable):
    """({ref: (containment, gene)} under each gene's best reference,
    {ref: (containment, gene)} under its own leaf's genes), first strictly
    greater gene kept, over the samples' genes in order."""
    genes = [g for gs in st.geneses for g in gs]
    shared, n_kmers = shared_kmers([g.seq for g in genes], st.ref_seqs,
                                   st.ref_lens, np.arange(st.n_refs))
    best = {int(r): (0.0, None) for r in detectable}
    best_own = {int(r): (0.0, None) for r in detectable}
    for gi, g in enumerate(genes):
        r = int(np.argmax(shared[gi]))
        if r in best:
            c = int(shared[gi, r]) / int(n_kmers[gi])
            if c > best[r][0]:
                best[r] = (c, g)
        for r2 in np.nonzero(tax.ref_taxon == int(g.taxon))[0].tolist():
            if r2 in best_own:
                c2 = int(shared[gi, r2]) / int(n_kmers[gi])
                if c2 > best_own[r2][0]:
                    best_own[r2] = (c2, g)
    return best, best_own


def _kinds(st, r, t, g, anc_r, cfg):
    """The wrong-base kinds of strain `r` against gene `g` -> (kinds,
    wrong bases, group id, gene-only positions, anchor columns absent)."""
    stack = leaf_stack(st, t)
    cols, b1, b2, m, tt = qualifying_columns(stack, cfg)
    assign = phase_columns(m, tt, cfg) if cols.size else np.zeros(0, int)
    colset = {int(c): i for i, c in enumerate(cols.tolist())}
    pool = stack.sum(axis=0)
    tot = pool.sum(axis=1)
    srt = np.sort(pool, axis=1)
    pb1 = np.argmax(pool, axis=1)
    L = int(st.ref_lens[r])
    rseq = st.ref_seqs[r, :L]
    gseq = np.asarray(g.seq)
    # gene positions onto anchor columns by the cohort emitter's NW map
    # (substitution-only strains share the anchor's coordinates)
    gcols = _nw_map(st.ref_seqs[anc_r, : int(st.ref_lens[anc_r])], gseq)
    pairs = [(i, int(gcols[i])) for i in range(gseq.shape[0])
             if 0 <= int(gcols[i]) < L]
    wrong_pairs = [(i, c) for i, c in pairs if gseq[i] != rseq[c]]
    # the gene's own group: the most common over the qualifying columns
    # where it carries the minor
    pos_of_col = {c: i for i, c in pairs}
    own_groups = Counter(int(assign[colset[int(c)]]) for ci, c in
                         enumerate(cols.tolist()) if c in pos_of_col
                         and gseq[pos_of_col[c]] == b2[ci])
    gid = own_groups.most_common(1)[0][0] if own_groups else -1
    kinds = Counter()
    for i, c in wrong_pairs:
        trueb = int(rseq[c])
        if c in colset:
            ci = colset[c]
            if int(b2[ci]) == trueb:
                kinds["qual-other-group" if int(assign[ci]) != gid
                      else "qual-own-col"] += 1
            elif int(b1[ci]) == trueb:
                kinds["substituted-not-ours"] += 1
            else:
                kinds["qual-wrong-allele"] += 1
        elif trueb == int(pb1[c]):
            kinds["backbone"] += 1
        else:
            kinds["gate-" + _gate(c, srt, tot, cfg)] += 1
    n_holes = gseq.shape[0] - len(pairs)
    missing = L - len(pairs)
    kinds["emit-holes"] = n_holes
    kinds["missing-cols"] = missing
    return kinds, len(wrong_pairs), gid, n_holes, missing


def run(st, out=print):
    """Diagnose `st` (`cache_config4_state.State`) -> (TOTAL Counter, rows:
    (ref, leaf, containment, group, wrong bases, kinds) a diagnosed miss)."""
    tax = st.tables()
    detectable = np.nonzero(coverage(st, st.true_ref) >= 5.0)[0]
    best, best_own = _best_genes(st, tax, detectable)
    missed = [r for r, (c, _) in best.items() if 0.5 < c <= 0.95]
    out(f"diagnosing {len(missed)} missed refs (cont .5-.95)")
    anchor = anchor_of_leaf(tax.ref_taxon)
    total, rows = Counter(), []
    for r in missed:
        contain, g = best_own[r]
        if g is None:
            continue
        t = int(tax.ref_taxon[r])
        kinds, n_wrong, gid, n_holes, missing = _kinds(
            st, r, t, g, int(anchor[r]), st.cfg)
        total.update(kinds)
        rows.append((r, t, contain, gid, n_wrong, kinds))
        out(f"  ref {r} (leaf {t}, cont {contain:.3f}, grp {gid}): "
            f"{n_wrong} wrong bases, {n_holes} gene-only pos, "
            f"{missing} anchor cols absent: {dict(kinds)}")
    out(f"TOTAL: {dict(total.most_common())}")
    return total, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("state", nargs="?", default=None,
                    help="cache_config4_state's file (default: "
                    "config4_torch_state.npz in $RAMBL_SCALE_CACHE or "
                    "_scale_cache/)")
    args = ap.parse_args(argv)
    run(cache_config4_state.load_state(
        args.state or cache_config4_state.state_path()),
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
