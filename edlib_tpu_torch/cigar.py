"""CIGAR encoding/decoding (edlibAlignmentToCigar, edlib.cpp:303-350).

Copied from the JAX package: the native engine's encoder where it is loaded
(native_loader.cigar_encode_native), else run-length encoding over the
mapped characters in numpy; both give the reference's per-op loop's
strings.  Ops outside 0..3 raise ValueError (the reference returns NULL,
edlib.cpp:334-336).
"""

from __future__ import annotations

import re
from typing import Union

import numpy as np

from edlib_tpu_torch import native_loader
from edlib_tpu_torch.types import CigarFormat

_EXTENDED_CHARS = np.array(list("=IDX"))
_STANDARD_CHARS = np.array(list("MIDM"))

_CIGAR_RE = re.compile(r"(\d+)([=IDXM])")


def alignment_to_cigar(alignment: Union[np.ndarray, list],
                       cigar_format: CigarFormat = CigarFormat.EXTENDED) -> str:
    """CIGAR string of EDOP_* codes; STANDARD merges match and mismatch runs
    into one 'M' run (edlib.cpp:312-321)."""
    cigar_format = CigarFormat(cigar_format)
    ops = np.asarray(alignment, dtype=np.int64).ravel()
    if ops.size == 0:
        return ""
    if ops.min() < 0 or ops.max() > 3:
        raise ValueError("alignment contains invalid op codes (must be 0..3)")
    native = native_loader.cigar_encode_native(
        ops, cigar_format == CigarFormat.EXTENDED)
    if native is not None:
        return native
    chars = (_STANDARD_CHARS if cigar_format == CigarFormat.STANDARD
             else _EXTENDED_CHARS)[ops]
    boundaries = np.nonzero(chars[1:] != chars[:-1])[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(chars)]])
    return "".join(f"{e - s}{chars[s]}" for s, e in zip(starts, ends))


def cigar_to_alignment(cigar: str) -> np.ndarray:
    """Inverse transform (no reference equivalent).  Extended symbols decode
    exactly; 'M' decodes to EDOP_MATCH (0), since match and mismatch cannot
    be told apart without the sequences."""
    code = {"=": 0, "I": 1, "D": 2, "X": 3, "M": 0}
    out = []
    pos = 0
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise ValueError(f"invalid CIGAR string: {cigar!r}")
        pos = m.end()
        out.extend([code[m.group(2)]] * int(m.group(1)))
    if pos != len(cigar):
        raise ValueError(f"invalid CIGAR string: {cigar!r}")
    return np.array(out, dtype=np.uint8)
