"""Seeding by the repository's rules, over the reference's own seed table.

The table: every k-mer window of every reference (valid when it holds no N
and lies inside the reference's length), hashed into 2^n_bits buckets by
the multiplicative hash (key * 2654435769 mod 2^32) >> (32 - n_bits), with
n_bits = min(27, max(8, ceil(log2(2 * entries + 1)))). Within a bucket the
entries are ordered by key, then by the 32-bit mix scramble(ref, pos) read
as a signed int, then by reference and position; a probe scans the first
`bucket_cap` entries of its bucket. Only the buckets that the checked
reads probe are built (`bucket_table`).

A read's candidates: k-mers at positions 0, stride, 2 stride, ... that fit
its length and hold no N vote for (ref, diagonal bin) on every hit; the top
`max_candidates` by (votes desc, candidate key asc) give the windows.
"""

from __future__ import annotations

import numpy as np
import torch

_HASH = 2654435769
_MIX = 2246822519
_M32 = 0xFFFFFFFF
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def revcomp(reads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse complement of each read within its own length; pad 4."""
    L = reads.shape[1]
    idx = lens[:, None] - 1 - np.arange(L)[None, :]
    comp = _COMP[np.clip(reads, 0, 4)]
    out = np.take_along_axis(comp, np.clip(idx, 0, L - 1), axis=1)
    return np.where(idx >= 0, out, np.int8(4)).astype(np.int8)


def hash_keys(keys: np.ndarray, n_bits: int) -> np.ndarray:
    h = (np.asarray(keys).astype(np.uint64) * np.uint64(_HASH)) & np.uint64(
        _M32)
    return (h >> np.uint64(32 - n_bits)).astype(np.int64)


def _windows(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """Keys (R, n_win) int64 and validity of every k-mer window."""
    n_win = codes.shape[1] - k + 1
    c = codes.to(torch.int64)
    key = torch.zeros((codes.shape[0], n_win), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        key = (key << 2) | (c[:, j:j + n_win] & 3)
    bad = (codes >= 4).to(torch.int32)
    nbad = torch.nn.functional.avg_pool1d(
        bad[:, None, :].float(), k, 1)[:, 0, :] * k
    pos = torch.arange(n_win, device=codes.device)
    valid = (nbad < 0.5) & (pos[None, :] <= (lens[:, None] - k))
    return key, valid


def n_bits_of(ref_seqs: np.ndarray, ref_lens: np.ndarray, k: int, device,
              rows: int = 4096) -> int:
    """The table's bucket bits, from its entry count."""
    n = 0
    for r0 in range(0, ref_seqs.shape[0], rows):
        codes = torch.as_tensor(ref_seqs[r0:r0 + rows], device=device)
        lens = torch.as_tensor(ref_lens[r0:r0 + rows].astype(np.int64),
                               device=device)
        n += int(_windows(codes, lens, k)[1].sum())
    return min(27, max(8, int(np.ceil(np.log2(max(n, 1) * 2 + 1)))))


def bucket_table(ref_seqs: np.ndarray, ref_lens: np.ndarray, k: int,
                 n_bits: int, buckets: np.ndarray, cap: int, device,
                 rows: int = 4096):
    """(keys, refs, pos) (len(buckets), cap) int64 of the first `cap`
    entries of each of the sorted unique `buckets`; key -1 marks empty.

    References are scanned in blocks of `rows`, in order; after each block
    only the first `cap` entries of every bucket are kept. A bucket's order
    is (key, scramble, ref, pos) and references come in ascending order,
    so a stable sort of the kept entries followed by the block's new ones
    keeps the first `cap` of the whole bucket."""
    dev = torch.device(device)
    i64 = torch.int64
    need = torch.zeros((1 << n_bits,), dtype=torch.bool, device=dev)
    need[torch.as_tensor(buckets, device=dev)] = True
    kept = torch.zeros((4, 0), dtype=i64, device=dev)   # bucket, key, ref, pos
    for r0 in range(0, ref_seqs.shape[0], rows):
        codes = torch.as_tensor(ref_seqs[r0:r0 + rows], device=dev)
        lens = torch.as_tensor(ref_lens[r0:r0 + rows].astype(np.int64),
                               device=dev)
        key, valid = _windows(codes, lens, k)
        b = ((key * _HASH) & _M32) >> (32 - n_bits)
        rr, pp = torch.nonzero(valid & need[b], as_tuple=True)
        new = torch.stack([b[rr, pp], key[rr, pp], rr + r0, pp])
        e = torch.cat([kept, new], 1)
        scr = ((e[2] * _MIX) & _M32) ^ e[3]
        scr = (scr * _HASH) & _M32
        scr = torch.where(scr >= (1 << 31), scr - (1 << 32), scr)  # as int32
        order = torch.sort((e[1] << 32) + scr, stable=True)[1]
        e = e[:, order]
        e = e[:, torch.sort(e[0], stable=True)[1]]
        first = torch.searchsorted(e[0], e[0])
        kept = e[:, torch.arange(e.shape[1], device=dev) - first < cap]
    b, key, ref, pos = kept.cpu().numpy()
    first = np.searchsorted(b, buckets)
    last = np.searchsorted(b, buckets, side="right")
    keys = np.full((buckets.size, cap), -1, np.int64)
    refs = np.zeros((buckets.size, cap), np.int64)
    poss = np.zeros((buckets.size, cap), np.int64)
    for j in range(cap):
        at = first + j
        ok = at < last
        keys[ok, j] = key[at[ok]]
        refs[ok, j] = ref[at[ok]]
        poss[ok, j] = pos[at[ok]]
    return keys, refs, poss


def seed_positions(p) -> np.ndarray:
    return np.arange(0, p.read_len_max - p.k + 1, p.seed_stride,
                     dtype=np.int64)


def query_kmers(reads: np.ndarray, lens: np.ndarray, p):
    """(keys (B, Q) int64, valid (B, Q) bool) at the static positions."""
    pos = seed_positions(p)
    keys = np.zeros((reads.shape[0], pos.shape[0]), np.int64)
    valid = np.ones(keys.shape, bool)
    for j in range(p.k):
        c = reads[:, pos + j].astype(np.int64)
        valid &= c < 4
        keys = (keys << 2) | (c & 3)
    valid &= (pos[None, :] + p.k) <= lens[:, None]
    return keys, valid


def candidates(reads: np.ndarray, lens: np.ndarray, table, n_bits: int, p):
    """(cand_ref, cand_wstart, cand_valid) (B, C) of each read. `table` is
    (buckets, keys, refs, pos) from `bucket_table`."""
    buckets, ekeys, erefs, epos = table
    pos = seed_positions(p)
    keys, valid = query_kmers(reads, lens, p)
    B = keys.shape[0]
    row = np.searchsorted(buckets, hash_keys(keys, n_bits))
    bk, href, hpos = ekeys[row], erefs[row], epos[row]   # (B, Q, cap)
    hit = (bk == keys[..., None]) & valid[..., None]
    dbin = (hpos - pos[None, :, None] + p.read_len_max) // p.diag_bin
    ckey = np.where(hit, href * p.n_diag_bins + dbin, -1).reshape(B, -1)
    C = p.max_candidates
    cand = np.full((B, C), -1, np.int64)
    for b in range(B):
        r = ckey[b][ckey[b] >= 0]
        if r.size == 0:
            continue
        uniq, counts = np.unique(r, return_counts=True)
        order = np.lexsort((uniq, -counts))[:C]
        cand[b, :order.size] = uniq[order]
    ok = cand >= 0
    cref = np.where(ok, cand // p.n_diag_bins, 0)
    cbin = np.where(ok, cand % p.n_diag_bins, 0)
    wstart = (cbin * p.diag_bin - p.read_len_max + p.diag_bin // 2
              - p.window_margin)
    return cref, wstart, ok


def windows(ref_seqs: np.ndarray, cref: np.ndarray, wstart: np.ndarray,
            W: int) -> np.ndarray:
    """(B, C, W) int8 reference windows; outside the array, code 4."""
    cols = wstart[..., None] + np.arange(W)
    inside = (cols >= 0) & (cols < ref_seqs.shape[1])
    g = ref_seqs[cref[..., None], np.clip(cols, 0, ref_seqs.shape[1] - 1)]
    return np.where(inside, g, np.int8(4)).astype(np.int8)
