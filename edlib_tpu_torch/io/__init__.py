"""FASTA reading, as edlib_tpu.io reads it."""

from edlib_tpu_torch.io.fasta import read_fasta_bytes, read_fasta_strings

__all__ = ["read_fasta_bytes", "read_fasta_strings"]
