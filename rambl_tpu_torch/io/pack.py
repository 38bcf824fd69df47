"""Base codes on the host: the port's copy of the parts of `rambl_tpu/io/pack.py`
that the simulator, the oracle and the file loaders use.

Code space: A=0, C=1, G=2, T=3, N/pad=4. Code 4 never matches in alignment
and is excluded from k-mer seeds and pileup counts.
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
