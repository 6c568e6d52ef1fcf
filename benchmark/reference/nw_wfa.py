"""Plain reference of the long pair: edlib's NW edit distance, exact.

The diagonal-transition algorithm (Ukkonen 1985; Landau and Vishkin 1989)
in plain PyTorch: for each score s = 0, 1, ... and each diagonal k = j - i,
the furthest query row F[k] that a path of cost s reaches on k, then the
slide along matches.  Row and column steps change a DP cell by at most one,
so a candidate past the matrix edge is clamped to it.  The distance is the
first s whose F on diagonal n - m reaches row m: O((m + n) + d^2) work and
d sequential steps, where the DP has m + n.  The slide compares 21 bases at
once as 3-bit codes packed into int64.  It shares nothing with the port's
banded Myers wavefront or its k ladder, and imports nothing of it.

Several pairs of one length run side by side.  ``band`` keeps only the
diagonals within that many of the band min(0, n - m) .. max(0, n - m): a
banded answer, not always the distance; with a narrow band it is the
control that the comparison must reject.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

_NEG = -(1 << 40)
_BASES = 21           # bases packed in one int64 word, 3 bits each
_FIXED_SLIDES = 2     # slide rounds a step before the host looks
_LOOK = 64            # steps between looks at whether every pair is done


def _packed(codes: torch.Tensor, pad: int) -> torch.Tensor:
    """int64 (P * (L + 1),), row p's element i holding codes[p, i .. i + 20]
    three bits each, code i lowest; past the end the code pad (4 for the
    query, 5 for the target: they never match, so a slide stops there)."""
    P, L = codes.shape
    c = torch.full((P, L + _BASES + 1), pad, dtype=torch.int64,
                   device=codes.device)
    c[:, :L] = codes.to(torch.int64)
    out = torch.zeros((P, L + 1), dtype=torch.int64, device=codes.device)
    for r in range(_BASES):
        out |= c[:, r:r + L + 1] << (3 * r)
    return out.reshape(-1)


def distances(queries: np.ndarray, targets: np.ndarray, device,
              k: int = -1, band: Optional[int] = None) -> List[int]:
    """NW distance of each (query, target) pair (uint8 code rows of equal
    length per side), or -1 where k >= 0 and it exceeds k."""
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    t = torch.from_numpy(np.ascontiguousarray(targets)).to(device)
    P, m = q.shape
    n = t.shape[1]
    pq, pt = _packed(q, 4), _packed(t, 5)
    kt = n - m
    k_lo, k_hi = -m, n
    if band is not None:
        k_lo = max(k_lo, min(0, kt) - band)
        k_hi = min(k_hi, max(0, kt) + band)
    # Diagonal k lives at index k - k_lo + 1; one guard cell each side.
    K = k_hi - k_lo + 1
    diag = torch.arange(k_lo - 1, k_hi + 2, dtype=torch.int64, device=device)
    i_min = (-diag).clamp(min=0)
    i_max = torch.minimum(torch.full_like(diag, m), n - diag)
    # Flat offsets: row p's (i, j) is pq[p * (m + 1) + i], pt[p * (n + 1)
    # + j]; the target's carries the diagonal, j = i + k.
    off_q = (torch.arange(P, device=device) * (m + 1))[:, None]
    off_t = (torch.arange(P, device=device) * (n + 1))[:, None] + diag

    # Equal leading bases from the lowest set bit of the xor, 2^b: b // 3,
    # looked up by 2^b mod 67 (distinct for b < 64); 0 (all equal) -> 21.
    table = torch.full((67,), _BASES, dtype=torch.int64)
    for b in range(63):
        table[(1 << b) % 67] = b // 3
    table = table.to(device)

    def slide(i, lo, hi):
        """Slide the valid diagonals of [lo, hi) (i >= 0) along their
        matches, _BASES at a time."""
        oq, ot = off_q, off_t[:, lo:hi]
        for rnd in range(1 << 30):
            ii = i.clamp(min=0)
            x = pq.take(ii + oq) ^ pt.take(ii + ot)
            step = table.take((x & -x) % 67)
            i = i + step
            if rnd + 1 >= _FIXED_SLIDES and not bool(
                    ((step == _BASES) & (i >= 0)).any()):
                return i

    F = torch.full((P, K + 2), _NEG, dtype=torch.int64, device=device)
    c0 = 1 - k_lo           # index of diagonal 0
    ct = kt - k_lo + 1      # index of the target diagonal
    F[:, c0:c0 + 1] = slide(torch.zeros((P, 1), dtype=torch.int64,
                                        device=device), c0, c0 + 1)
    # Row reached on the target diagonal after each score (it only grows);
    # the host looks every _LOOK steps whether every pair reached row m.
    reached = [F[:, ct].clone()]
    s = 0
    while not (0 <= k <= s):
        if s % _LOOK == 0 and bool((reached[-1] >= m).all()):
            break
        s += 1
        lo = max(1, c0 - s)
        hi = min(K + 1, c0 + s + 1)
        prev = F[:, lo - 1:hi + 1]
        # From diagonal k itself or k + 1 a row further, or from k - 1 in
        # the same row; values from diagonals not yet reached stay below
        # -2^39 and are never slid.
        cand = torch.maximum(torch.maximum(prev[:, 1:-1], prev[:, 2:]) + 1,
                             prev[:, :-2])
        F[:, lo:hi] = slide(torch.minimum(cand, i_max[lo:hi]), lo, hi)
        reached.append(F[:, ct].clone())
    hit = torch.stack(reached) >= m                  # (s + 1, P)
    first = torch.where(hit.any(0), hit.to(torch.int8).argmax(0), -1)
    return first.tolist()
