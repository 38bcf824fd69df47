"""Show which of config 4's residual wrong bases no column-frequency phasing
could fix: the port of scripts/demonstrate_c4_ambiguity.py.

    python -m rambl_tpu_torch.scripts.demonstrate_c4_ambiguity [state.npz]

Reads `cache_config4_state`'s state (its default file unless a path is
given). For every strain with abundance, it phases the strain's leaf again
(`oracle.cohort.cohort_genes_for_leaf` on the leaf's stacked counts and
`_pick_backbone`'s backbone) and takes the phased gene of highest 25-mer
containment (the first of equals); a strain whose best lies in [.5, .95)
is diagnosed. Each wrong base, in the leaf anchor's columns (both the gene
and the strain mapped by `index.colmap._nw_map`), is one of:

  invisible/not-qualifying     the column never qualified: at cohort scale
                               the variant is indistinguishable from noise
  invisible/minor-is-not-true  neither pooled allele is the strain's base:
                               no method that hands out the pooled minor
                               can emit it
  linkage-only/reversion       the right minor in the strain's own group,
                               overwritten by a reversion substitution: only
                               read-level linkage tells which strains carry
                               a dominant's private allele
  ambiguous/group-margin       its frequency vector is at least as close
                               (the exact chi-square of `oracle.cohort.
                               _group_dist`, its own counts left out of the
                               group it joined) to that group as to the
                               strain's own
  fixable/group-margin         strictly closer to the strain's own group: a
                               better grouping pass could fix it

and the last line counts those that are invisible or ambiguous against
those a better grouping could fix. Every leaf of the panel has counts in
every sample (`cache_config4_state`), so a leaf's counts are read
directly, as the reference reads them. A leaf is phased once, whatever
the number of its strains.

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np

from rambl_tpu_torch.index.colmap import _nw_map
from rambl_tpu_torch.io.pack import decode_seq
from rambl_tpu_torch.oracle.cohort import (
    _group_dist,
    _pick_backbone,
    cohort_genes_for_leaf,
    phase_columns,
    qualifying_columns,
)
from rambl_tpu_torch.oracle.polish import anchor_seqs_of
from rambl_tpu_torch.scripts import cache_config4_state
from rambl_tpu_torch.scripts.quality_bench import kmers


def _phased_leaf(st, t, anchor_seq):
    """Leaf `t` phased again -> None without a backbone or genes, else
    (genes, stack, qualifying_columns' cols, b1, b2, m, tt, assignment)."""
    stack = np.stack([c[t] for c in st.counts_list])
    bb = _pick_backbone(st.geneses, t)
    if bb is None:
        return None
    genes = cohort_genes_for_leaf(stack, bb, anchor_seq, st.cfg)
    if not genes:
        return None
    cols, b1, b2, m, tt = qualifying_columns(stack, st.cfg)
    return genes, cols, b1, b2, m, tt, phase_columns(m, tt, st.cfg)


def _per_base(leaf, seq, grp, ref, aseq, min_depth) -> Counter:
    """The kinds of the wrong bases of phased gene `seq` (group `grp`)
    against strain `ref`, in the anchor's columns."""
    _, cols, b1, b2, m, tt, assign = leaf
    gm = _nw_map(aseq, seq)
    rm = _nw_map(aseq, ref)
    ref_at = {int(c): int(ref[i]) for i, c in enumerate(rm) if c >= 0}
    col_ix = {int(c): i for i, c in enumerate(cols.tolist())}
    per = Counter()
    for i, c in enumerate(gm.tolist()):
        if c < 0 or c not in ref_at or int(seq[i]) == ref_at[c]:
            continue
        ci = col_ix.get(c)
        if ci is None:
            per["invisible/not-qualifying"] += 1
            continue
        if int(b2[ci]) != ref_at[c] and int(b1[ci]) != ref_at[c]:
            per["invisible/minor-is-not-true"] += 1
            continue
        g_joined = int(assign[ci])
        if g_joined == grp and int(b2[ci]) == ref_at[c]:
            per["linkage-only/reversion"] += 1
            continue

        def dist_to(g):
            # the group's pooled counts, the column's own left out of the
            # group it joined; exact Fractions
            sel = assign == g
            M = m[sel].sum(axis=0).astype(np.int64)
            T = tt[sel].sum(axis=0).astype(np.int64)
            if g == g_joined:
                M = M - m[ci]
                T = T - tt[ci]
            if int(T.sum()) == 0:
                return None
            return _group_dist(m[ci].astype(np.int64),
                               tt[ci].astype(np.int64), M, T, min_depth)

        d_own, d_joined = dist_to(grp), dist_to(g_joined)
        if d_own is None or d_joined is None or d_joined <= d_own:
            per["ambiguous/group-margin"] += 1
        else:
            per["fixable/group-margin"] += 1
    return per


def run(st, out=print):
    """Demonstrate on `st` (`cache_config4_state.State`) -> (TOTAL Counter,
    rows: (ref, leaf, containment, kinds) a strain with a wrong base,
    fixable, all)."""
    tax = st.tables()
    anchors = anchor_seqs_of(st.ref_seqs, st.ref_lens, tax.ref_taxon)
    ref_taxon = np.asarray(st.ref_taxon)
    leaves, total, rows = {}, Counter(), []
    for r in range(st.n_refs):
        if st.abundance[r] <= 0:
            continue
        t = int(ref_taxon[r])
        if t not in leaves:
            leaves[t] = _phased_leaf(st, t, anchors[t])
        if leaves[t] is None:
            continue
        ref = np.asarray(st.ref_seqs[r, : st.ref_lens[r]])
        refk = kmers(decode_seq(ref))
        scored = []
        for seq, _, _, g in leaves[t][0]:
            gk = kmers(decode_seq(seq))
            scored.append((len(gk & refk) / max(len(gk), 1), seq, g))
        cont, seq, grp = max(scored, key=lambda x: x[0])
        if cont >= 0.95 or cont < 0.5:
            continue
        per = _per_base(leaves[t], seq, grp, ref, anchors[t],
                        st.cfg.cohort_min_depth)
        if per:
            out(f"ref {r} leaf {t} cont {cont:.3f}: {dict(per)}")
            total.update(per)
            rows.append((r, t, cont, per))
    out(f"\nTOTAL: {dict(total)}")
    n_fix = total.get("fixable/group-margin", 0)
    n_all = sum(total.values())
    out(f"{n_all - n_fix}/{n_all} residual wrong bases are invisible or "
        f"ambiguous to column-frequency phasing; {n_fix} are potentially "
        f"fixable by a better grouping pass")
    return total, rows, n_fix, n_all


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
