"""Base codes on the host: the port's copy of the parts of `rambl_tpu/io/pack.py`
that the simulator and the oracle use.

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
