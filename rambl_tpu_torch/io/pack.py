"""Base codes and 2-bit packing on the host: the port's copy of
`rambl_tpu/io/pack.py`.

Code space: A=0, C=1, G=2, T=3, N/pad=4. Code 4 never matches in alignment
and is excluded from k-mer seeds and pileup counts. `pack_2bit` packs 16
bases a uint32 word for compact storage; `kmer_keys` gives a sequence's
k-mer keys.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGTN"
BASE_TO_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE_TO_CODE[ord(_b)] = _i
    BASE_TO_CODE[ord(_b.lower())] = _i
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

PAD = np.int8(4)

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)  # A<->T, C<->G, N->N


def encode_seq(seq: str) -> np.ndarray:
    """ASCII string -> int8 codes (A0 C1 G2 T3, other->4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return BASE_TO_CODE[raw]


def encode_batch(seqs, length: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode + pad a list of sequences to (n, length) int8 plus lengths (n,).

    Sequences longer than `length` are truncated (callers choose `length` =
    config.read_len_max / ref_len_max so this only clips pathological input).
    """
    n = len(seqs)
    out = np.full((n, length), PAD, dtype=np.int8)
    lens = np.zeros((n,), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s)[:length]
        out[i, : len(c)] = c
        lens[i] = len(c)
    return out, lens


def decode_seq(codes: np.ndarray) -> str:
    """int8 codes -> ASCII string (code 4 -> 'N'). Trailing pads are kept."""
    codes = np.asarray(codes)
    return CODE_TO_BASE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray, lens: np.ndarray | None = None) -> np.ndarray:
    """Reverse-complement int8 code arrays.

    For padded batches (2D input + lens), each row is reversed within its own
    length so pads stay on the right.
    """
    codes = np.asarray(codes)
    if codes.ndim == 1:
        return _COMP[codes[::-1]]
    if lens is None:
        raise ValueError("batched revcomp needs per-row lengths")
    n, L = codes.shape
    out = np.full_like(codes, PAD)
    comp = _COMP[codes]
    for i in range(n):
        li = int(lens[i])
        out[i, :li] = comp[i, :li][::-1]
    return out


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack int8 codes (values 0..3; caller must mask 4s) into uint32 words.

    16 bases per word, base b at bit position 2*(b%16), little-endian in word.
    Length is padded up to a multiple of 16 with zeros (A) — callers keep
    explicit lengths.
    """
    codes = np.asarray(codes).astype(np.uint32) & 0x3
    L = codes.shape[-1]
    Lp = (L + 15) // 16 * 16
    if Lp != L:
        pad_width = [(0, 0)] * (codes.ndim - 1) + [(0, Lp - L)]
        codes = np.pad(codes, pad_width)
    codes = codes.reshape(codes.shape[:-1] + (Lp // 16, 16))
    shifts = (2 * np.arange(16, dtype=np.uint32)).reshape((1,) * (codes.ndim - 1) + (16,))
    return (codes << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_2bit -> int8 codes of given length."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32)).reshape((1,) * words.ndim + (16,))
    codes = (words[..., None] >> shifts) & 0x3
    codes = codes.reshape(words.shape[:-1] + (words.shape[-1] * 16,))
    return codes[..., :length].astype(np.int8)


def kmer_keys(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer keys of a 1D code array.

    Returns (keys, valid): keys[i] = sum_j codes[i+j] << 2*(k-1-j) (big-endian
    within the k-mer so lexicographic order == numeric order), valid[i] = False
    if any base in the window is N. keys fit in int64; for k<=15 they fit int32.
    """
    codes = np.asarray(codes)
    L = codes.shape[0]
    n = max(L - k + 1, 0)
    if n == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), bool)
    key = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        c = codes[j : j + n].astype(np.int64)
        valid &= c < 4
        key = (key << 2) | (c & 0x3)
    return key, valid
