"""FASTA/FASTQ I/O: the port's copy of `rambl_tpu/io/fasta.py`.

Sequence text is parsed once on the host into dense integer arrays
(`rambl_tpu_torch.io.pack`). Plain-python line parsing is deliberately
simple; the bulk path for large runs is `rambl_tpu_torch.io.loader` (the
native C++ packer when built).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Sequence, Tuple

from rambl_tpu_torch.utils.errors import UserError


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path: str) -> List[Tuple[str, str]]:
    """Parse a FASTA file -> list of (name, sequence). Name is up to first ws."""
    out: List[Tuple[str, str]] = []
    name = None
    chunks: List[str] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line.upper())
        if name is not None:
            out.append((name, "".join(chunks)))
    return out


def write_fasta(path: str, records: Sequence[Tuple[str, str]], width: int = 70) -> None:
    with _open(path, "wt") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def read_fastq(path: str) -> List[Tuple[str, str, str]]:
    """Parse FASTQ -> list of (name, sequence, quality-string)."""
    out: List[Tuple[str, str, str]] = []
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            h = h.strip()
            if not h:
                continue
            if not h.startswith("@"):
                raise UserError(f"bad FASTQ header: {h!r}")
            seq = f.readline().strip().upper()
            plus = f.readline()
            if not plus.startswith("+"):
                raise UserError("bad FASTQ separator line")
            qual = f.readline().strip()
            out.append((h[1:].split()[0], seq, qual))
    return out


def write_fastq(path: str, records: Sequence[Tuple[str, str, str]]) -> None:
    with _open(path, "wt") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def iter_fastq(path: str) -> Iterator[Tuple[str, str, str]]:
    """Streaming FASTQ iterator for large files."""
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.strip()
            if not h:
                continue
            seq = f.readline().strip().upper()
            f.readline()
            qual = f.readline().strip()
            yield (h[1:].split()[0], seq, qual)
