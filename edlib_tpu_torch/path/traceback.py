"""Alignment traceback over decoded DP cell values.

Copied from the JAX package's path/traceback.py: the reference's traceback
(obtainAlignmentTraceback, edlib.cpp:942-1141) walks the NW matrix back from
the bottom-right cell with the move preference up (INSERT), then left
(DELETE), then diagonal (MATCH/MISMATCH), and the same boundary emissions.
Columns are decoded to integer cells on demand (a ColumnProvider) instead of
chasing P/M bits through banded blocks: identical cell values + identical
preference give identical ops.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from edlib_tpu_torch.types import (EDOP_DELETE, EDOP_INSERT, EDOP_MATCH,
                                   EDOP_MISMATCH)


class ColumnProvider(Protocol):
    def cells(self, c: int) -> np.ndarray:
        """int64[Q+1]; entry 0 = boundary cell D[-1][c], entry r+1 =
        cell(r, c).  Must also accept c == -1 (the init column: value r+1 at
        entry r+1)."""


def traceback(provider: ColumnProvider, qlen: int, tlen: int,
              best_score: int) -> np.ndarray:
    """Ops (EDOP_* codes, uint8) aligning the full query to the full window,
    walked from cell (qlen-1, tlen-1) of the NW matrix back to the origin."""
    ops = []
    r, c = qlen - 1, tlen - 1
    v = best_score
    while True:
        if r == -1:
            ops.extend([EDOP_DELETE] * (c + 1))
            break
        if c == -1:
            ops.extend([EDOP_INSERT] * (r + 1))
            break
        cur = provider.cells(c)
        left = provider.cells(c - 1)
        u = int(cur[r])        # cell(r-1, c)
        l = int(left[r + 1])   # cell(r,   c-1)
        ul = int(left[r])      # cell(r-1, c-1)
        if u + 1 == v:
            # Up: insertion to target (edlib.cpp:1020-1052).
            ops.append(EDOP_INSERT)
            r -= 1
            v = u
        elif l + 1 == v:
            # Left: deletion from target (edlib.cpp:1054-1083).
            ops.append(EDOP_DELETE)
            c -= 1
            v = l
        else:
            # Up-left: (mis)match (edlib.cpp:1085-1130).
            ops.append(EDOP_MATCH if ul == v else EDOP_MISMATCH)
            r -= 1
            c -= 1
            v = ul
    return np.array(ops[::-1], dtype=np.uint8)
