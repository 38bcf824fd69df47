"""Diagnose the residual consensus errors behind quality_bench's near-misses:
the port of scripts/diagnose_quality.py.

    python -m rambl_tpu_torch.scripts.diagnose_quality [scenario ...]

Each scenario of `quality_bench.SCENARIOS` (all of them by default) is
assembled by the port's NumPy oracle (`oracle.pipeline.assemble`,
max_assembly_iters 4, batch 512), as the reference assembles it with its
oracle. Each gene is matched to the reference it shares the most distinct
25-mers with (the first of equals); a reference keeps the first of its
genes at the highest containment. For each reference at >= 5x simulated
coverage the tool prints ok (containment > .95), NO GENE, or MISS; for a
miss it aligns the gene onto the truth by the exact NW map
(`index.colmap._nw_map`) and prints each inserted gene base, each
substituted column and each reference column inside the gene's span that
the gene skips, with the depth of reads truly drawn from that column and
whether the column tells the reference from its sibling strain (the first
other reference of its species: STRAIN-COL) or not (backbone), then a line
of counts.

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import simulate_dataset
from rambl_tpu_torch.index.colmap import _nw_map
from rambl_tpu_torch.index.taxonomy import build_taxonomy_tables
from rambl_tpu_torch.oracle.pipeline import assemble
from rambl_tpu_torch.scripts import quality_bench
from rambl_tpu_torch.scripts.quality_bench import best_matches, coverage

BASES = "ACGTN"
CONFIG = dict(max_assembly_iters=4, batch_size=512)
READ_LEN = 100


def truth_depth(ds, ref, read_len=READ_LEN):
    """Each column's depth of the reads truly drawn from `ref`."""
    L = int(ds.ref_lens[ref])
    start = ds.true_pos[ds.true_ref == ref].astype(np.int64)
    diff = np.zeros(L + 1, np.int64)
    np.add.at(diff, np.minimum(start, L), 1)
    np.add.at(diff, np.minimum(start + read_len, L), -1)
    return np.cumsum(diff[:L]).astype(np.int32)


def _sibling_bases(ds, r, ref):
    """(len(ref),) int8: the sibling strain's base at each column of `ref`
    (by its NW map), -1 where it has none or no sibling exists."""
    sp = ds.ref_names[r].split("_")[0]
    sib = [j for j in range(ds.n_refs)
           if j != r and ds.ref_names[j].startswith(sp + "_")]
    out = np.full(len(ref), -1, np.int8)
    if sib:
        sib_seq = ds.ref_seqs[sib[0], : ds.ref_lens[sib[0]]]
        sib_map = _nw_map(ref, sib_seq)
        okm = sib_map >= 0
        out[sib_map[okm]] = sib_seq[okm]
    return out


def _miss(ds, r, g, out) -> dict:
    """A missed reference's wrong columns, printed and returned."""
    ref = ds.ref_seqs[r, : ds.ref_lens[r]]
    m = _nw_map(ref, g.seq)
    depth = truth_depth(ds, r)
    sib_base = _sibling_bases(ds, r, ref)

    def tag(rp):
        return ("STRAIN-COL" if sib_base[rp] >= 0 and sib_base[rp] != ref[rp]
                else "backbone")

    ins, subs, dels = [], [], []
    last = -1
    for gp in range(len(g.seq)):
        rp = int(m[gp])
        if rp < 0:
            ins.append((gp, int(g.seq[gp]), last))
            out(f"    gene[{gp}] INSERTION base {BASES[g.seq[gp]]} "
                f"(between ref {last}..)")
            continue
        last = rp
        if g.seq[gp] != ref[rp]:
            sibinfo = (f" sib={BASES[sib_base[rp]]}" if sib_base[rp] >= 0
                       else "")
            called_sib = bool(sib_base[rp] >= 0 and g.seq[gp] == sib_base[rp])
            subs.append((rp, int(ref[rp]), int(g.seq[gp]), int(sib_base[rp]),
                         int(depth[rp]), tag(rp), called_sib))
            out(f"    ref[{rp}] SUB truth {BASES[ref[rp]]} -> called "
                f"{BASES[g.seq[gp]]}{sibinfo} depth {depth[rp]} "
                f"{tag(rp)}{' (=sibling base!)' if called_sib else ''}")
    okm = m >= 0
    covered = np.zeros(len(ref), bool)
    covered[m[okm]] = True
    lo = int(m[okm].min()) if okm.any() else 0
    hi = int(m[okm].max()) if okm.any() else -1
    for rp in range(lo, hi + 1):
        if not covered[rp]:
            dels.append((rp, int(ref[rp]), int(depth[rp]), tag(rp)))
            out(f"    ref[{rp}] DELETED truth {BASES[ref[rp]]} "
                f"depth {depth[rp]} {tag(rp)}")
    head, tail = lo, len(ref) - 1 - hi
    out(f"    -> {len(subs)} subs, {len(dels)} dels, uncovered ends "
        f"head {head} tail {tail}")
    return dict(subs=subs, dels=dels, ins=ins, head=head, tail=tail)


def diagnose(name, ds, res, out=print) -> list:
    """One scenario's records, a dict a detectable reference: "ref",
    "status" ("ok", "NO GENE" or "MISS"), "cont", "gene" and, for a miss,
    `_miss`'s "subs", "dels", "ins", "head" and "tail"."""
    cov = coverage(ds)
    out(f"=== {name}: {len(res.genes)} genes, rounds {res.n_rounds} ===")
    best_gene = {}
    ids, conts = best_matches([g.seq for g in res.genes], ds.ref_seqs,
                              ds.ref_lens, np.arange(ds.n_refs))
    for gi, (b, c) in enumerate(zip(ids.tolist(), conts.tolist())):
        if b not in best_gene or c > best_gene[b][0]:
            best_gene[b] = (c, gi)
    records = []
    for r in np.nonzero(cov >= 5)[0].tolist():
        head = f"  ref {r} ({ds.ref_names[r]}) cov {cov[r]:.0f}x:"
        if r not in best_gene:
            out(f"{head} NO GENE")
            records.append(dict(ref=r, status="NO GENE"))
            continue
        c, gi = best_gene[r]
        if c > 0.95:
            out(f"{head} ok cont {c:.3f}")
            records.append(dict(ref=r, status="ok", cont=c, gene=gi))
            continue
        g = res.genes[gi]
        out(f"{head} MISS cont {c:.3f} gene len {len(g.seq)} (gene #{gi}, "
            f"leaf {g.leaf} clus {g.cluster} n_reads {g.n_reads} "
            f"off {g.offset})")
        records.append(dict(ref=r, status="MISS", cont=c, gene=gi,
                            **_miss(ds, r, g, out)))
    return records


def run(names=None, out=print) -> dict:
    """Assemble each named scenario of `quality_bench.SCENARIOS` (all by
    default) with the NumPy oracle and diagnose it -> {name: records}."""
    scenarios = dict(quality_bench.SCENARIOS)
    cfg = PipelineConfig(**CONFIG)
    result = {}
    for name in names or list(scenarios):
        ds = simulate_dataset(**scenarios[name])
        tax = build_taxonomy_tables(ds.tax_parent, ds.tax_depth, ds.ref_taxon)
        res = assemble(ds.reads, ds.read_lens, ds.ref_seqs, ds.ref_lens, tax,
                       cfg)
        result[name] = diagnose(name, ds, res, out)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help="scenarios of quality_bench.SCENARIOS (default: all)")
    args = ap.parse_args(argv)
    run(args.names, out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
