"""Host-only builder of the config-3 and config-5 dataset + index caches:
the port of scripts/build_scale_caches.py.

The scale runs (`run_config3`, `run_config5`) spend minutes of host work
(a 10-20 M-read simulation and the 153.6 M-entry seed index of 100,000
references) before they touch the card; this script builds exactly the
caches they look for, so a scale run can start on the card at once. Run it
in the background while the card is busy with something else:

    python -m rambl_tpu_torch.scripts.build_scale_caches [config3|config5|both]
        [--device D] [--cache-dir DIR]

- config 3: `simulate_dataset(n_refs // 5 species x 5, n_reads, seed 13,
  leaf_per_ref=True, n_present=500)`, then `build_seed_index`;
- config 5: the same panel with `n_reads=1` (the panel and its abundances
  are drawn before the reads), then the reads in 5 M chunks, chunk i from
  `default_rng(977 + 13 i)` through `data.simulate._gen_reads` (one
  50 M-read float64 error mask would take ~40 GB of host memory), then the
  index.

The caches hold plain arrays in `.npz` files, loaded with
`allow_pickle=False`: a pickle would tie them to the classes of whichever
package wrote them. The file name keys every input the arrays depend on:
n_reads, n_refs, k, the generator version `_GEN_V` (bump it when the
simulator changes) and the seed. The directory is `$RAMBL_SCALE_CACHE`, or
`_scale_cache/` at the repository root (git-ignored).

The device is checked, as every entry point of the port checks it (the
first CUDA card by default; `--device cpu` for a host without one), and
never touched: the caches are host arrays.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from rambl_tpu_torch.config import PipelineConfig
from rambl_tpu_torch.data.simulate import _gen_reads, simulate_dataset
from rambl_tpu_torch.device import resolve
from rambl_tpu_torch.index.builder import SeedIndex, build_seed_index

_GEN_V = 3  # v3: scrambled within-bucket entry order (unbiased capped scans)
SEED = 13
N_REFS = 100_000
N_PRESENT = 500
CHUNK = 5_000_000           # config 5's reads a generator chunk
READ_LEN, READ_LEN_MAX = 100, 128
SUB_ERROR, INDEL_ERROR = 0.004, 0.0005

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PANEL = ("ref_seqs", "ref_lens", "tax_parent", "tax_depth", "ref_taxon",
          "abundance")
_INDEX = ("bucket_start", "entry_key", "entry_ref", "entry_pos")


@dataclasses.dataclass
class ScaleData:
    """A scale run's inputs as plain arrays: the reference panel, its
    taxonomy and abundances, the reads and the seed index. `true_ref` is
    the source reference of every read (config 3), or None where the reads
    were generated in chunks (config 5 scores by expected depth)."""

    ref_seqs: np.ndarray
    ref_lens: np.ndarray
    tax_parent: np.ndarray
    tax_depth: np.ndarray
    ref_taxon: np.ndarray
    abundance: np.ndarray
    reads: np.ndarray
    read_lens: np.ndarray
    index: SeedIndex
    true_ref: np.ndarray | None = None

    @property
    def n_refs(self) -> int:
        return int(self.ref_seqs.shape[0])

    @property
    def n_reads(self) -> int:
        return int(self.reads.shape[0])

    @staticmethod
    def of(ds, index: SeedIndex, reads=None, read_lens=None) -> "ScaleData":
        """From a `SimulatedDataset` and its index; `reads`/`read_lens`
        replace the dataset's reads (config 5's chunked reads on its
        panel), and then no `true_ref` is kept."""
        own = reads is None
        return ScaleData(
            **{f: getattr(ds, f) for f in _PANEL},
            reads=ds.reads if own else reads,
            read_lens=ds.read_lens if own else read_lens,
            index=index, true_ref=ds.true_ref if own else None)


def cache_dir() -> str:
    return os.environ.get("RAMBL_SCALE_CACHE",
                          os.path.join(REPO, "_scale_cache"))


def cache_name(which: str, n_reads: int, n_refs: int, k: int,
               gen_v: int = _GEN_V, seed: int = SEED) -> str:
    """The cache file of `which` ("config3" or "config5"): every input the
    arrays depend on is part of the name."""
    return (f"{which}_torch_cache_{n_reads}_{n_refs}_k{k}_v{gen_v}"
            f"_seed{seed}.npz")


def save_cache(path: str, data: ScaleData) -> None:
    """Write `data` as plain arrays, atomically (a temporary file renamed)."""
    idx = data.index
    arrays = {f: getattr(data, f) for f in _PANEL + ("reads", "read_lens")}
    arrays.update({f"index_{f}": getattr(idx, f) for f in _INDEX})
    arrays.update(index_k=np.int64(idx.k), index_n_bits=np.int64(idx.n_bits),
                  index_n_refs=np.int64(idx.n_refs),
                  index_max_bucket=np.int64(idx.max_bucket))
    if data.true_ref is not None:
        arrays["true_ref"] = data.true_ref
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_cache(path: str) -> ScaleData:
    """Read a cache written by `save_cache`; a file that holds a pickle
    raises ValueError (nothing is unpickled)."""
    z = np.load(path, allow_pickle=False)
    if not hasattr(z, "files"):
        raise ValueError(f"{path} is not an .npz cache")
    with z:
        index = SeedIndex(
            k=int(z["index_k"]), n_bits=int(z["index_n_bits"]),
            **{f: z[f"index_{f}"] for f in _INDEX},
            n_refs=int(z["index_n_refs"]),
            max_bucket=int(z["index_max_bucket"]))
        return ScaleData(
            **{f: z[f] for f in _PANEL + ("reads", "read_lens")},
            index=index,
            true_ref=z["true_ref"] if "true_ref" in z.files else None)


def config5_reads(ds, n_reads: int, chunk: int = CHUNK):
    """Config 5's reads on `ds`'s panel, in chunks: chunk i is drawn from
    default_rng(977 + 13 i), as the reference's run_config5 draws them.
    Returns (reads (n_reads, 128) int8, lens (n_reads,) int32)."""
    reads = np.empty((n_reads, READ_LEN_MAX), np.int8)
    lens = np.empty((n_reads,), np.int32)
    for i, lo in enumerate(range(0, n_reads, chunk)):
        hi = min(lo + chunk, n_reads)
        rng = np.random.default_rng(977 + 13 * i)
        r, ln, _, _, _ = _gen_reads(rng, ds.ref_seqs, ds.ref_lens,
                                    ds.abundance, hi - lo, READ_LEN,
                                    READ_LEN_MAX, SUB_ERROR, INDEL_ERROR)
        reads[lo:hi] = r
        lens[lo:hi] = ln
    return reads, lens


def _panel_dataset(n_refs: int, n_reads: int, n_present: int):
    return simulate_dataset(n_species=n_refs // 5, refs_per_species=5,
                            n_reads=n_reads, seed=SEED, leaf_per_ref=True,
                            n_present=n_present)


def _cached(which, n_reads, n_refs, k, directory, build, out, load=True):
    path = (None if directory is None else
            os.path.join(directory, cache_name(which, n_reads, n_refs, k)))
    if path is not None and os.path.exists(path):
        if not load:
            out(f"{which} cache exists: {path}")
            return None
        t0 = time.time()
        data = load_cache(path)
        out(f"loaded cached dataset+index from {path} in "
            f"{time.time() - t0:.0f}s")
        return data
    data = build()
    if path is not None:
        t0 = time.time()
        save_cache(path, data)
        out(f"wrote {path} ({os.path.getsize(path) / 1e9:.1f} GB) in "
            f"{time.time() - t0:.0f}s")
    return data


def config3(n_reads: int = 10_000_000, n_refs: int = N_REFS,
            n_present: int = N_PRESENT, k: int | None = None,
            directory: str | None = "", out=print,
            load: bool = True) -> ScaleData | None:
    """Config 3's dataset and index: loaded from the cache in `directory`
    ("" = `cache_dir()`) when there (load=False: left there, None
    returned), else built and written there (None: built, never cached).
    The key does not hold n_present: give a cache directory only for the
    default 500."""
    k = PipelineConfig().k if k is None else k
    directory = cache_dir() if directory == "" else directory

    def build():
        t0 = time.time()
        ds = _panel_dataset(n_refs, n_reads, n_present)
        out(f"config3 dataset in {time.time() - t0:.0f}s")
        t1 = time.time()
        index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=k)
        out(f"config3 index ({index.n_entries} entries) in "
            f"{time.time() - t1:.0f}s")
        return ScaleData.of(ds, index)

    return _cached("config3", n_reads, n_refs, k, directory, build, out,
                   load)


def config5(n_reads: int = 20_000_000, n_refs: int = N_REFS,
            n_present: int = N_PRESENT, k: int | None = None,
            directory: str | None = "", chunk: int = CHUNK,
            out=print, load: bool = True) -> ScaleData | None:
    """Config 5's panel, chunked reads and index, cached as `config3`'s."""
    k = PipelineConfig().k if k is None else k
    directory = cache_dir() if directory == "" else directory

    def build():
        t0 = time.time()
        ds = _panel_dataset(n_refs, 1, n_present)
        reads, lens = config5_reads(ds, n_reads, chunk)
        out(f"config5 panel and {n_reads} reads in {time.time() - t0:.0f}s")
        t1 = time.time()
        index = build_seed_index(ds.ref_seqs, ds.ref_lens, k=k)
        out(f"config5 index in {time.time() - t1:.0f}s")
        return ScaleData.of(ds, index, reads, lens)

    return _cached("config5", n_reads, n_refs, k, directory, build, out,
                   load)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", default="both",
                    choices=("config3", "config5", "both"))
    ap.add_argument("--device", default=None,
                    help="torch device the caches are for (default: the "
                    "first CUDA card; checked, never touched)")
    ap.add_argument("--cache-dir", default="",
                    help="directory of the caches (default: "
                    "$RAMBL_SCALE_CACHE or _scale_cache/)")
    args = ap.parse_args(argv)
    resolve(args.device)
    if args.what in ("config3", "both"):
        config3(directory=args.cache_dir, load=False)
    if args.what in ("config5", "both"):
        config5(directory=args.cache_dir, load=False)


if __name__ == "__main__":
    main()
