"""Brute-force O(Q*T) edit-distance oracle (the port's copy of
edlib_tpu/oracle.py).

Replicates the reference test oracle calcEditDistanceSimple
(test/SimpleEditDistance.h:24-106) exactly: two-column DP, modes expressed as
boundary conditions (HW: free top row; SHW/HW: best over last row; NW: last
cell only), same empty-sequence conventions, returns (score, all end
positions with minimal score, ascending).

Extended beyond the reference oracle with optional equality matrices so the
randomized differential suites can also cover additionalEqualities.

The inner column recurrence is vectorised: the sequential "up" dependency
newC[r] = min(m[r], newC[r-1]+1) is a prefix-min of (m[r] - r) plus r.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from edlib_tpu_torch.types import AlignMode


def edit_distance_simple(q_ids: np.ndarray, t_ids: np.ndarray,
                         mode: AlignMode,
                         eq: Optional[np.ndarray] = None
                         ) -> Tuple[int, List[int]]:
    """Score and all minimal end positions, ascending.

    q_ids / t_ids: integer arrays (transformed symbols).
    eq: optional sigma x sigma bool equality matrix; identity if None.
    Empty-sequence conventions per SimpleEditDistance.h:32-47:
      NW: score max(Q,T), positions [T-1]; SHW/HW: score Q, positions [-1].
    """
    mode = AlignMode.parse(mode)
    Q, T = len(q_ids), len(t_ids)
    if Q == 0 or T == 0:
        if mode == AlignMode.NW:
            return max(Q, T), [T - 1]
        return Q, [-1]

    q = np.asarray(q_ids, dtype=np.int64)
    t = np.asarray(t_ids, dtype=np.int64)
    if eq is None:
        def matches(c):
            return q == c
    else:
        eqb = np.asarray(eq, dtype=bool)

        def matches(c):
            return eqb[q, c]

    rows = np.arange(1, Q + 1, dtype=np.int64)
    C = rows.copy()  # column -1 boundary: C[r] = r+1
    best = -1
    positions: List[int] = []
    hw = mode == AlignMode.HW
    check_all = mode != AlignMode.NW
    for c in range(T):
        top = 0 if hw else c + 1          # boundary cell D[-1][c]
        prev_top = 0 if hw else c          # boundary cell D[-1][c-1]
        sub = np.where(matches(t[c]), 0, 1)
        diag = np.empty(Q, dtype=np.int64)
        diag[0] = prev_top + sub[0]
        diag[1:] = C[:-1] + sub[1:]
        m = np.minimum(diag, C + 1)            # diag & left terms
        m[0] = min(m[0], top + 1)              # up term for row 0
        # newC[r] = min_{j<=r} m[j] + (r - j)  (the sequential up-chain)
        newC = np.minimum.accumulate(m - rows) + rows
        C = newC
        if check_all or c == T - 1:
            s = int(C[-1])
            if best == -1 or s <= best:
                if s < best:
                    positions.clear()
                best = s
                positions.append(c)
    return best, positions


def full_dp_matrix(q_ids: np.ndarray, t_ids: np.ndarray,
                   mode: AlignMode,
                   eq: Optional[np.ndarray] = None) -> np.ndarray:
    """(Q+1) x (T+1) DP matrix including boundaries, for traceback tests."""
    mode = AlignMode.parse(mode)
    Q, T = len(q_ids), len(t_ids)
    D = np.zeros((Q + 1, T + 1), dtype=np.int64)
    D[:, 0] = np.arange(Q + 1)
    D[0, :] = 0 if mode == AlignMode.HW else np.arange(T + 1)
    q = np.asarray(q_ids, dtype=np.int64)
    t = np.asarray(t_ids, dtype=np.int64)
    for c in range(1, T + 1):
        if eq is None:
            sub = np.where(q == t[c - 1], 0, 1)
        else:
            sub = np.where(np.asarray(eq, bool)[q, t[c - 1]], 0, 1)
        m = np.minimum(D[:-1, c - 1] + sub, D[1:, c - 1] + 1)
        rows = np.arange(1, Q + 1)
        m0 = np.minimum(m, np.concatenate([[D[0, c]], np.full(Q - 1, 1 << 60)]) + 1)
        D[1:, c] = np.minimum.accumulate(m0 - rows) + rows
    return D
