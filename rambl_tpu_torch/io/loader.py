"""ctypes bindings for the native C++ data loader (native/loader.cpp): the
port's copy of `rambl_tpu/io/loader.py`.

FASTQ/FASTA bytes go straight into padded int8 code arrays with no Python
string objects. Falls back to the pure-Python parser
(rambl_tpu_torch.io.fasta) when the shared library is absent; outputs are
identical (tests/test_torch_host_layers.py runs both).

The library is built in place with `make -C native` on first use.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from rambl_tpu_torch.utils.errors import UserError

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "librambl_loader.so",
)

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        # fresh checkout: build the tiny C++ library in place (best effort;
        # absence is handled by the pure-Python fallback either way)
        # the Makefile links to a temp name and mv's into place, so a
        # concurrent importer never CDLLs a half-written .so
        import logging
        import subprocess
        try:
            proc = subprocess.run(
                ["make", "-C", os.path.dirname(_LIB_PATH)],
                capture_output=True, timeout=120, check=False)
            if proc.returncode != 0:
                logging.getLogger(__name__).debug(
                    "native loader build failed (rc=%d): %s",
                    proc.returncode, proc.stderr.decode(errors="replace"))
        except (OSError, subprocess.TimeoutExpired) as e:
            logging.getLogger(__name__).debug("native loader build failed: %s", e)
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    c_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rambl_fastq_count.restype = ctypes.c_long
    lib.rambl_fastq_count.argtypes = [ctypes.c_char_p]
    lib.rambl_fasta_count.restype = ctypes.c_long
    lib.rambl_fasta_count.argtypes = [ctypes.c_char_p]
    lib.rambl_fastq_parse.restype = ctypes.c_long
    lib.rambl_fastq_parse.argtypes = [
        ctypes.c_char_p, c_i8p, c_i32p, ctypes.c_long, ctypes.c_int]
    lib.rambl_fasta_parse.restype = ctypes.c_long
    lib.rambl_fasta_parse.argtypes = [
        ctypes.c_char_p, c_i8p, c_i32p, ctypes.c_long, ctypes.c_int]
    lib.rambl_revcomp_batch.restype = None
    lib.rambl_revcomp_batch.argtypes = [
        c_i8p, c_i32p, c_i8p, ctypes.c_long, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def load_fastq_codes(path: str, lmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """FASTQ[.gz] -> (codes (n, lmax) int8, lens (n,) int32)."""
    lib = _load()
    if lib is None:
        from rambl_tpu_torch.io.fasta import read_fastq
        from rambl_tpu_torch.io.pack import encode_batch

        recs = read_fastq(path)
        return encode_batch([s for _, s, _ in recs], lmax)
    n = lib.rambl_fastq_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    codes = np.full((n, lmax), 4, np.int8)
    lens = np.zeros((n,), np.int32)
    got = lib.rambl_fastq_parse(path.encode(), codes, lens, n, lmax)
    if got < 0:
        raise UserError(f"malformed FASTQ: {path}")
    return codes[:got], lens[:got]


def load_fasta_codes(path: str, lmax: int) -> Tuple[np.ndarray, np.ndarray]:
    """FASTA[.gz] -> (codes (n, lmax) int8, lens (n,) int32)."""
    lib = _load()
    if lib is None:
        from rambl_tpu_torch.io.fasta import read_fasta
        from rambl_tpu_torch.io.pack import encode_batch

        recs = read_fasta(path)
        return encode_batch([s for _, s in recs], lmax)
    n = lib.rambl_fasta_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    codes = np.full((n, lmax), 4, np.int8)
    lens = np.zeros((n,), np.int32)
    got = lib.rambl_fasta_parse(path.encode(), codes, lens, n, lmax)
    if got < 0:
        raise UserError(f"malformed FASTA: {path}")
    return codes[:got], lens[:got]


def revcomp_batch_native(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Native batched reverse-complement; identical to io.pack.revcomp_codes."""
    lib = _load()
    if lib is None:
        from rambl_tpu_torch.io.pack import revcomp_codes

        return revcomp_codes(codes, lens)
    codes = np.ascontiguousarray(codes, np.int8)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.empty_like(codes)
    lib.rambl_revcomp_batch(codes, lens, out, codes.shape[0], codes.shape[1])
    return out
