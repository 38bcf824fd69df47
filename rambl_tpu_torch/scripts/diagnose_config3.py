"""Classify config 3's misses: the port of scripts/diagnose_config3.py.

    python -m rambl_tpu_torch.scripts.diagnose_config3 [dump] [--cache-dir DIR]

Loads the panel dump that `run_config3` writes (by default its dump at
10 M reads x 100,000 references) and config 3's dataset from the cache
`build_scale_caches.cache_name("config3", n_reads, n_refs, k)` that the
dump's key names. For every detectable reference that no gene recovered,
it reports what the panel holds for the reference's taxon: the gene of
best 25-mer containment, its wrong bases, inserted bases and missing span
through the exact NW map onto the reference (`index.colmap._nw_map_batch`,
all misses in one batch), and one class:

  near-miss(>.90)     containment above .90
  few-wrong-bases     at most 8 wrong bases and under 100 reference columns
                      outside the gene's span
  short/truncated     100 or more reference columns outside its span
  many-wrong-bases    the rest
  no-gene-for-taxon   the panel holds no gene of the taxon (no line)

Where the dump holds round 0's slot counts, each wrong base is classed by
why polish did not fix it (or fixed it wrongly), the gates taken in this
order with `PipelineConfig`'s polish and poly fields: thin-evidence (depth
under polish_min_depth), poly-guard (a polymorphic column), tied-winner,
no-majority, winner-wrong (the pileup's winner is not the reference's
base), winner-right-gene-wrong. The gene's map onto the reference
addresses its leaf's slot row: that holds only because config 3 is leaf
per ref (each reference is its own leaf's anchor), and the classifier
raises on any other taxonomy.

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.index.colmap import _nw_map_batch
from rambl_tpu_torch.io.pack import decode_seq
from rambl_tpu_torch.scripts import build_scale_caches as caches
from rambl_tpu_torch.scripts import run_config3
from rambl_tpu_torch.scripts.quality_bench import kmers

CLASSES = ("near-miss(>.90)", "few-wrong-bases", "short/truncated",
           "many-wrong-bases", "no-gene-for-taxon")
BASE_CLASSES = ("thin-evidence", "poly-guard", "tied-winner", "no-majority",
                "winner-wrong", "winner-right-gene-wrong")

def _base_class(c, true_b: int, cfg: PipelineConfig) -> str:
    """Why polish left a wrong base at a column of leaf counts `c` (4,)."""
    tot = int(c.sum())
    srt = np.sort(c)
    minor = tot - int(srt[-1])
    poly = (minor >= cfg.poly_min_minor_count and
            minor * cfg.poly_minor_frac_den
            >= cfg.poly_minor_frac_num * max(tot, 1))
    if tot < cfg.polish_min_depth:
        return "thin-evidence"
    if poly:
        return "poly-guard"
    if srt[-1] == srt[-2]:
        return "tied-winner"
    if srt[-1] * cfg.polish_maj_den < cfg.polish_maj_num * tot:
        return "no-majority"
    if int(np.argmax(c)) != true_b:
        return "winner-wrong"
    return "winner-right-gene-wrong"


def run(dump: dict, ref_seqs, ref_lens, ref_taxon, cfg=None, out=print):
    """Classify the misses of `dump` (`run_config3.load_dump`'s dict) on
    the dataset's references. -> (classes Counter, wrong-base classes
    Counter, rows: a dict a missed reference in the reference's order,
    with "ref", "taxon", "cls", "cont" and, where a gene exists, "len_gene",
    "len_ref", "wrong", "ins", "missing_span", "reads", "cluster", "born"
    and "bases" (a Counter, None without slot counts))."""
    cfg = PipelineConfig() if cfg is None else cfg
    ref_taxon = np.asarray(ref_taxon)
    genes, recovered = dump["genes"], dump["recovered"]
    detectable = np.asarray(dump["detectable"])
    missed = [int(r) for r in detectable if int(r) not in recovered]
    out(f"{len(missed)} missed / {detectable.size} detectable")
    by_taxon = {}
    for g in genes:
        by_taxon.setdefault(int(g.taxon), []).append(g)

    classes, base_classes = Counter(), Counter()
    rows, jobs = [], []
    for r in missed:
        t = int(ref_taxon[r])
        ref = np.asarray(ref_seqs[r, : ref_lens[r]])
        cands = by_taxon.get(t, [])
        if not cands:
            classes["no-gene-for-taxon"] += 1
            rows.append(dict(ref=r, taxon=t, cls="no-gene-for-taxon",
                             cont=0.0))
            continue
        refk = kmers(decode_seq(ref))
        best, cont = None, -1.0
        for g in cands:
            gk = kmers(decode_seq(g.seq))
            c = len(gk & refk) / max(len(gk), 1)
            if c > cont:
                best, cont = g, c
        rows.append(dict(ref=r, taxon=t, cont=cont))
        jobs.append((rows[-1], ref, best))

    slot = dump.get("slot_counts")
    if slot is not None and np.unique(ref_taxon).size != ref_taxon.size:
        raise ValueError("the wrong-base classes address a leaf's slot row "
                         "by the reference's columns: they need a leaf-per-"
                         "ref taxonomy (config 3's)")
    maps = _nw_map_batch([j[1] for j in jobs], [j[2].seq for j in jobs])
    for (row, ref, best), m in zip(jobs, maps):
        gseq = np.asarray(best.seq)
        ok = m >= 0
        aligned = int(ok.sum())
        wrong_mask = np.zeros(len(gseq), bool)
        wrong_mask[ok] = ref[np.clip(m, 0, len(ref) - 1)][ok] != gseq[ok]
        wrong = int(wrong_mask.sum())
        span = (int(m[ok].min()), int(m[ok].max())) if aligned else (0, 0)
        short = len(ref) - (span[1] - span[0] + 1)
        if row["cont"] > 0.90:
            cls = "near-miss(>.90)"
        elif wrong <= 8 and short < 100:
            cls = "few-wrong-bases"
        elif short >= 100:
            cls = "short/truncated"
        else:
            cls = "many-wrong-bases"
        classes[cls] += 1
        per, detail = None, ""
        t = row["taxon"]
        if slot is not None and int(slot[1][t]) >= 0:
            # the slot rows are flat (ref_len * 4): one row is the leaf's
            # (ref_len, 4) pileup, read from the map
            c_leaf = np.asarray(slot[0][int(slot[1][t])]).reshape(-1, 4)
            per = Counter(_base_class(c_leaf[int(m[p])], int(ref[m[p]]), cfg)
                          for p in np.nonzero(wrong_mask)[0])
            base_classes.update(per)
            detail = f" {dict(per)!r}"
        row.update(cls=cls, len_gene=len(gseq), len_ref=len(ref), wrong=wrong,
                   ins=int((~ok).sum()), missing_span=short,
                   reads=best.n_reads, cluster=best.cluster,
                   born=best.round_born, bases=per)
        out(f"ref {row['ref']} taxon {t}: cont {row['cont']:.3f} "
            f"len(g)={len(gseq)} len(ref)={len(ref)} wrong={wrong} "
            f"ins={row['ins']} missing_span={short} reads={best.n_reads} "
            f"cluster={best.cluster} born={best.round_born} [{cls}]{detail}")
    out(f"\nclass counts: {dict(classes)}")
    if base_classes:
        out(f"wrong-base classes: {dict(base_classes)}")
    return classes, base_classes, rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", nargs="?", default=None,
                    help="run_config3's panel dump (default: its dump at "
                    f"{run_config3.N_READS} reads x {caches.N_REFS} refs)")
    ap.add_argument("--cache-dir", default="",
                    help="directory of the dump and the dataset cache "
                    "(default: $RAMBL_SCALE_CACHE or _scale_cache/)")
    args = ap.parse_args(argv)
    directory = args.cache_dir or caches.cache_dir()
    path = args.dump or run_config3.dump_path(run_config3.N_READS,
                                              caches.N_REFS,
                                              directory=directory)
    dump = run_config3.load_dump(path)
    data = caches.load_cache(os.path.join(directory, caches.cache_name(
        "config3", dump["n_reads"], dump["n_refs"], dump["k"])))
    run(dump, data.ref_seqs, data.ref_lens, data.ref_taxon,
        out=lambda *a: print(*a, flush=True))


if __name__ == "__main__":
    main()
