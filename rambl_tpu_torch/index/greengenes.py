"""Real-Greengenes ingestion: taxonomy file + pre-aligned (PyNAST) MSA. The
port's copy of `rambl_tpu/index/greengenes.py`.

The reference pipeline runs against the Greengenes 16S database
(SURVEY.md section 2.1 "Greengenes index build"; BASELINE.json:5). Its two
shipped artifacts need format-specific handling the generic CLI loaders do
not provide:

- ``gg_*_taxonomy.txt``: ``<otu_id>\\t<k__...; p__...; ...; g__; s__>``.
  Unresolved ranks are EMPTY placeholders (``g__``), not missing fields; a
  placeholder carries no information, so the lineage is truncated at the
  first empty rank (interior placeholders end the resolved lineage too -
  Greengenes never resolves below an unresolved rank).
- ``gg_*_pynast.fasta``: every reference pre-aligned to one global template
  with ``-``/``.`` gap characters. These columns ARE the database's own
  coordinate system, so per-leaf column maps derived from them are exact by
  construction and replace the pairwise banded-NW maps (index/colmap.py)
  at discovery time: two same-leaf references agree on a column if and only
  if the database's own alignment says so.

Both loaders are host-side NumPy (index build is offline; SURVEY.md
section 7.1 step 1) and feed the same TaxonomyTables / col_maps contracts
the synthetic path uses, so everything downstream (device and oracle,
bit-parity included) is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rambl_tpu_torch.index.taxonomy import TaxonomyTables, build_taxonomy_tables

#: characters PyNAST/greengenes alignments use for gaps (``.`` marks
#: terminal/padding gaps, ``-`` internal ones; both are non-positions)
GAP_CHARS = frozenset(".-")


def parse_gg_lineage(lineage: str) -> List[str]:
    """Split one Greengenes lineage string into its resolved rank names.

    ``"k__Bacteria; p__Firmicutes; c__Bacilli; o__; f__; g__; s__"`` ->
    ``["k__Bacteria", "p__Firmicutes", "c__Bacilli"]``. A rank is empty when
    nothing follows its ``__`` marker (or the field is blank); the lineage is
    truncated at the first empty rank.
    """
    out: List[str] = []
    for field in lineage.split(";"):
        name = field.strip()
        if not name or name.endswith("__"):
            break
        out.append(name)
    return out


def load_gg_taxonomy(path: str, ref_names: Sequence[str]) -> TaxonomyTables:
    """Greengenes taxonomy file -> TaxonomyTables over `ref_names`.

    Same tree construction as the CLI's generic TSV path (cli._load_taxonomy)
    but with real-Greengenes lineage semantics (empty-rank truncation via
    parse_gg_lineage). Every reference becomes its own leaf below its
    resolved lineage; references absent from the file sit directly under the
    root (depth-1 leaves).
    """
    lineages: Dict[str, List[str]] = {}
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            name, _, lin = line.partition("\t")
            if not _:
                # some distributions use space separation after the OTU id
                name, _, lin = line.partition(" ")
            lineages[name.strip()] = parse_gg_lineage(lin)

    parent = [0]
    depth = [0]
    node_of: Dict[tuple, int] = {(): 0}

    def node(pathq: tuple) -> int:
        if pathq in node_of:
            return node_of[pathq]
        p = node(pathq[:-1])
        nid = len(parent)
        parent.append(p)
        depth.append(len(pathq))
        node_of[pathq] = nid
        return nid

    ref_taxon = [
        node(tuple(lineages.get(name, ())) + (f"__ref__{name}",))
        for name in ref_names
    ]
    return build_taxonomy_tables(
        np.asarray(parent, np.int32), np.asarray(depth, np.int32),
        np.asarray(ref_taxon, np.int32),
    )


def _open_text(path: str):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    return open(path)


def load_gg_msa(path: str, ref_names: Sequence[str],
                ref_len_max: int) -> np.ndarray:
    """Aligned (PyNAST) FASTA -> per-reference MSA-column positions.

    Returns ``(n_refs, ref_len_max) int32``: row r, entry i = the global MSA
    column of reference r's i-th base (-1 past the reference's length or for
    references missing from the file). The ungapped base order must match the
    unaligned reference FASTA the pipeline aligns against (Greengenes ships
    both from the same records, so it does).
    """
    cols_of: Dict[str, np.ndarray] = {}
    name, chunks = None, []

    def _flush():
        if name is None:
            return
        aln = "".join(chunks)
        codes = np.frombuffer(aln.encode(), np.uint8)
        isbase = ~np.isin(codes, np.frombuffer("".join(GAP_CHARS).encode(),
                                               np.uint8))
        cols_of[name] = np.nonzero(isbase)[0].astype(np.int32)

    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                _flush()
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
        _flush()

    out = np.full((len(ref_names), ref_len_max), -1, np.int32)
    for r, nm in enumerate(ref_names):
        c = cols_of.get(nm)
        if c is None:
            continue
        n = min(c.shape[0], ref_len_max)
        out[r, :n] = c[:n]
    return out


def col_maps_from_msa(msa_cols: np.ndarray, ref_lens: np.ndarray,
                      ref_taxon: np.ndarray) -> np.ndarray:
    """Per-leaf anchor column maps from the database's own alignment.

    Same contract as index.colmap.build_col_maps: ``(n_refs, ref_len_max)``
    int32, entry (r, i) = the LEAF-ANCHOR column holding reference r's i-th
    base, -1 where the anchor has no corresponding base (an insertion
    relative to the anchor). Derivation: r's base i sits at MSA column
    ``msa_cols[r, i]``; if the leaf's anchor also has a base at that MSA
    column, the two are aligned by the database itself. Exact - no pairwise
    heuristics - and consistent across every reference of the leaf.

    References missing from the MSA (msa_cols row all -1) fall back to the
    identity map when they ARE the anchor; non-anchor missing references get
    an all -1 map (their reads still align and bin; their pileup columns are
    dropped exactly like read insertions).
    """
    from rambl_tpu_torch.index.colmap import anchor_of_leaf

    n_refs, Lmax = msa_cols.shape
    anchors = anchor_of_leaf(np.asarray(ref_taxon))
    cmap = np.full((n_refs, Lmax), -1, np.int32)
    ident = np.arange(Lmax, dtype=np.int32)
    # one inverse table per distinct anchor: MSA column -> anchor position
    inv_of: Dict[int, Optional[np.ndarray]] = {}
    n_msa = int(msa_cols.max(initial=0)) + 1
    for r in range(n_refs):
        Lr = int(ref_lens[r])
        ar = int(anchors[r])
        if ar == r:
            cmap[r, :Lr] = ident[:Lr]
            continue
        if ar not in inv_of:
            La = int(ref_lens[ar])
            ca = msa_cols[ar, :La]
            if La == 0 or ca[0] < 0:
                inv_of[ar] = None
            else:
                inv = np.full((n_msa,), -1, np.int32)
                inv[ca] = ident[:La]
                inv_of[ar] = inv
        inv = inv_of[ar]
        if inv is None:
            continue
        cr = msa_cols[r, :Lr]
        valid = cr >= 0
        cmap[r, :Lr] = np.where(valid, inv[np.clip(cr, 0, n_msa - 1)], -1)
    return cmap
