"""FASTA reading (the port of edlib_tpu/io/fasta.py).

The reference CLI's reader (apps/aligner/aligner.cpp:290-328): '>' header
lines skipped, CR and LF ignored inside sequences, headerless files
tolerated (data before any '>' forms the first record).  The native
engine's reader where it is loaded, else the Python one
(native_loader.read_fasta).
"""

from __future__ import annotations

from typing import List

from edlib_tpu_torch import native_loader


def read_fasta_bytes(path: str) -> List[bytes]:
    return native_loader.read_fasta(path)


def read_fasta_strings(path: str) -> List[str]:
    return [s.decode("latin-1") for s in native_loader.read_fasta(path)]
