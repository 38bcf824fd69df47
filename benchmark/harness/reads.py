"""A sample's reads, made on the device from the run's seed.

The read model is that of the port's `data/simulate.py` (`_gen_reads`),
rewritten in PyTorch so that ten million reads take seconds rather than the
host's minutes: reads are drawn from abundance-weighted references, each at
a uniform start on its reference and on a uniform strand; every base is
substituted with probability `sub_error` (by a uniform shift of 1-3 codes);
a read carries one indel with probability `indel_error * read_len` (half of
them a one-base deletion, half a one-base insertion of a uniform base, at a
uniform position in [1, read_len - 3]; as in the original, the bases
after an insertion repeat the fragment from its start); reverse-strand
reads are reverse complemented within their own length; reads are padded
with code 4.

The seed draws the sample: which references are present (`n_present` of
them, all when absent) and their lognormal abundances (host NumPy), and the
reads (a `torch.Generator` on the device). The reads are handed to the port
as host arrays, the way its callers hand them.
"""

from __future__ import annotations

import numpy as np
import torch

_COMP = (3, 2, 1, 0, 4)
_CHUNK = 1 << 18


def abundances(n_refs: int, seed: int, n_present: int | None,
               sigma: float) -> np.ndarray:
    """(n_refs,) float64 sampling weights summing to 1."""
    rng = np.random.default_rng(seed)
    ab = rng.lognormal(0.0, sigma, size=n_refs)
    if n_present is not None and n_present < n_refs:
        mask = np.zeros(n_refs, bool)
        mask[rng.choice(n_refs, size=n_present, replace=False)] = True
        ab = np.where(mask, ab, 0.0)
    return ab / ab.sum()


def _chunk(g, refs, lens, cdf, n, read_len, read_len_max, sub_error,
           indel_error, dev):
    i64 = torch.int64
    u = torch.rand((n,), generator=g, device=dev, dtype=torch.float64)
    ref = torch.clamp(torch.searchsorted(cdf, u, right=True), 0,
                      refs.shape[0] - 1)
    strand = torch.randint(0, 2, (n,), generator=g, device=dev)
    span = torch.clamp(lens[ref] - read_len, min=1)
    pos = (torch.rand((n,), generator=g, device=dev, dtype=torch.float64)
           * span).to(i64)
    cols = pos[:, None] + torch.arange(read_len, device=dev)[None, :]
    frag = refs[ref[:, None], cols].to(i64)
    sub = torch.rand((n, read_len), generator=g, device=dev) < sub_error
    shift = torch.randint(1, 4, (n, read_len), generator=g, device=dev)
    frag = torch.where(sub, (frag + shift) % 4, frag)
    # one indel in some reads
    has = torch.rand((n,), generator=g, device=dev) < indel_error * read_len
    ip = torch.randint(1, read_len - 2, (n,), generator=g, device=dev)
    is_del = torch.rand((n,), generator=g, device=dev) < 0.5
    ins_base = torch.randint(0, 4, (n,), generator=g, device=dev)
    jj = torch.arange(read_len, device=dev)[None, :]
    nxt = torch.cat([frag[:, 1:], torch.full((n, 1), 4, device=dev,
                                             dtype=i64)], 1)
    # an insertion is followed by the fragment from its own start again:
    # data/simulate.py concatenates frag[:ip], the base and frag[:read_len]
    again = torch.gather(frag, 1, torch.clamp(jj - ip[:, None] - 1, 0,
                                              read_len - 1))
    deleted = torch.where(jj < ip[:, None], frag, nxt)
    deleted[:, read_len - 1] = 4
    inserted = torch.where(jj < ip[:, None], frag,
                           torch.where(jj == ip[:, None], ins_base[:, None],
                                       again))
    frag = torch.where((has & is_del)[:, None], deleted,
                       torch.where((has & ~is_del)[:, None], inserted, frag))
    rlen = torch.where(has & is_del, read_len - 1, read_len)
    # reverse complement within each read's own length
    comp = torch.tensor(_COMP, device=dev, dtype=i64)[frag]
    idx = rlen[:, None] - 1 - jj
    rc = torch.gather(comp, 1, torch.clamp(idx, 0, read_len - 1))
    rc = torch.where(idx >= 0, rc, 4)
    frag = torch.where(strand[:, None] == 1, rc, frag)
    out = torch.full((n, read_len_max), 4, device=dev, dtype=torch.int8)
    out[:, :read_len] = torch.where(jj < rlen[:, None], frag, 4).to(torch.int8)
    return out, rlen.to(torch.int32), ref.to(torch.int32), pos.to(
        torch.int32), strand.to(torch.int8)


def make_reads(ref_seqs: np.ndarray, ref_lens: np.ndarray, sample: dict,
               seed: int, device, truth: bool = False):
    """(reads (N, read_len_max) int8, lens (N,) int32) host arrays of the
    sample drawn by `seed`; with truth, also (source ref, start, strand)."""
    dev = torch.device(device)
    ab = abundances(ref_seqs.shape[0], seed, sample.get("n_present"),
                    sample["abundance_sigma"])
    cdf = torch.as_tensor(np.cumsum(ab), device=dev)
    cdf[-1] = 1.0
    refs = torch.as_tensor(ref_seqs, device=dev)
    lens = torch.as_tensor(ref_lens.astype(np.int64), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    n = int(sample["n_reads"])
    parts = []
    for s in range(0, n, _CHUNK):
        parts.append([t.cpu() for t in _chunk(
            g, refs, lens, cdf, min(_CHUNK, n - s), sample["read_len"],
            sample["read_len_max"], sample["sub_error"],
            sample["indel_error"], dev)])
    cols = [torch.cat([p[i] for p in parts]).numpy() for i in range(5)]
    return (cols[0], cols[1], *cols[2:]) if truth else (cols[0], cols[1])
