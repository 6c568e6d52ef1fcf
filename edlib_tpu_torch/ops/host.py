"""Host Myers engine over Python big-ints, for the host PATH route.

Copied from the JAX package's ops/host.py (the parts path/ and longpair.py
use).  The
whole Q-bit column lives in ONE arbitrary-precision integer, so the
carry-propagating add in ``(Eq & Pv) + Pv`` needs no word decomposition
(contrast the reference's 64-bit block chain, edlib.cpp:412-447).  No
padding: bit i is query row i and the tracked score is exactly cell(Q-1, c).

The port reconstructs windows here that the batched capture route does not
take (path/hirschberg.py), and runs the long-pair functions' "native"
backend here (longpair.py); the JAX package hands both to its native C++
engine when it is built, which gives the same answers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from edlib_tpu_torch.types import AlignMode


def advance_column(Pv: int, Mv: int, Eq: int, hin: int,
                   mask: int, high_bit: int) -> Tuple[int, int, int]:
    """One DP column update over the full Q-bit state.

    Pv/Mv bit i encode cell(i,c) - cell(i-1,c) = +1 / -1.  hin in {-1,0,+1}
    is the horizontal delta entering the top; returns (Pv', Mv', hout) where
    hout = cell(Q-1,c) - cell(Q-1,c-1).
    """
    Xv = Eq | Mv
    if hin < 0:
        Eq |= 1
    Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq
    Ph = Mv | (~(Xh | Pv) & mask)
    Mh = Pv & Xh
    if Ph & high_bit:
        hout = 1
    elif Mh & high_bit:
        hout = -1
    else:
        hout = 0
    Ph = ((Ph << 1) & mask) | (1 if hin > 0 else 0)
    Mh = ((Mh << 1) & mask) | (1 if hin < 0 else 0)
    PvOut = Mh | (~(Xv | Ph) & mask)
    MvOut = Ph & Xv
    return PvOut, MvOut, hout


@dataclass
class ColumnState:
    """Carried state of the sweep after some column."""
    Pv: int
    Mv: int
    score: int  # cell(Q-1, c)


def semiglobal_scores(peq: Sequence[int], t_ids: np.ndarray, qlen: int,
                      mode) -> np.ndarray:
    """Bottom-row scores cell(Q-1, c) for every target column c.

    HW feeds hin=0 at the top boundary (free gap before query,
    edlib.cpp:584); SHW feeds hin=1.
    """
    mask = (1 << qlen) - 1
    high_bit = 1 << (qlen - 1)
    hin0 = 0 if AlignMode.parse(mode) == AlignMode.HW else 1
    Pv, Mv, score = mask, 0, qlen
    out = np.empty(len(t_ids), dtype=np.int64)
    for c, sym in enumerate(t_ids):
        Pv, Mv, hout = advance_column(Pv, Mv, peq[sym], hin0, mask, high_bit)
        score += hout
        out[c] = score
    return out


def nw_run(peq: Sequence[int], t_ids: np.ndarray, qlen: int,
           stop: Optional[int] = None,
           store_columns: bool = False
           ) -> Tuple[ColumnState, Optional[List[Tuple[int, int]]]]:
    """Global sweep.  Returns (final/stop state, stored (Pv, Mv) per column
    if requested).

    ``stop`` mirrors targetStopPosition (edlib.cpp:896-908): run columns
    0..stop inclusive and return that column's state — the Hirschberg
    primitive.
    """
    mask = (1 << qlen) - 1
    high_bit = 1 << (qlen - 1)
    Pv, Mv, score = mask, 0, qlen
    end = len(t_ids) if stop is None else stop + 1
    cols = [] if store_columns else None
    for c in range(end):
        Pv, Mv, hout = advance_column(Pv, Mv, peq[t_ids[c]], 1, mask,
                                      high_bit)
        score += hout
        if store_columns:
            cols.append((Pv, Mv))
    return ColumnState(Pv, Mv, score), cols


def decode_cells(Pv: int, Mv: int, qlen: int, boundary: int) -> np.ndarray:
    """Cell values of a column from its bit state.

    boundary is D[-1][c] (NW/SHW: c+1, HW: 0).  Returns int64[qlen] with
    entry r = cell(r, c) (getBlockCellValues/readBlock, edlib.cpp:470-516,
    vectorised).
    """
    nbytes = (qlen + 7) // 8
    pb = np.frombuffer(Pv.to_bytes(nbytes, "little"), dtype=np.uint8)
    mb = np.frombuffer(Mv.to_bytes(nbytes, "little"), dtype=np.uint8)
    p_bits = np.unpackbits(pb, bitorder="little")[:qlen].astype(np.int64)
    m_bits = np.unpackbits(mb, bitorder="little")[:qlen].astype(np.int64)
    return boundary + np.cumsum(p_bits - m_bits)


class HostColumnProvider:
    """Lazy NW-window cell access for the traceback walker.

    cells(c)[i] = cell(i-1, c) with i=0 the boundary row (value c+1).
    Column -1 (the init column) is the rows' boundary: cell(r, -1) = r+1.
    """

    def __init__(self, peq: Sequence[int], t_ids: np.ndarray, qlen: int):
        _, cols = nw_run(peq, t_ids, qlen, store_columns=True)
        self._cols = cols
        self._qlen = qlen
        self._cache = {}

    def cells(self, c: int) -> np.ndarray:
        if c == -1:
            return np.arange(0, self._qlen + 1, dtype=np.int64)
        got = self._cache.get(c)
        if got is None:
            Pv, Mv = self._cols[c]
            body = decode_cells(Pv, Mv, self._qlen, c + 1)
            got = np.concatenate([[c + 1], body])
            self._cache[c] = got
        return got
