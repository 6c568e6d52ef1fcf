"""Plain reference of read mapping: edlib's HW best distance and first end.

The textbook edit-distance DP with a free start in the target, one query
row at a time over every target column, in plain PyTorch (int32), for a
block of reads at once.  Row i from row i - 1:

    E[j]  = min(D[i-1][j-1] + (q[i-1] != t[j]),  D[i-1][j] + 1)
    D[i][j] = min(E[j], D[i][j-1] + 1),  D[i][-1] = i,  D[0][j] = 0

and the left recurrence is a running minimum: D[i][j] = j + cummin(E[j'] -
j') over j' <= j (E[-1] = i).  It shares nothing with the port's
bit-parallel kernels, filter or routing, and imports nothing of it.

``tile`` cuts the target into tiles of that many columns with no overlap,
each swept as its own target: an alignment that crosses a tile's start is
lost.  That breaks the guarantee that the best is over the whole target;
it is the control that the comparison must reject.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

BLOCK_READS = 128     # reads a DP block: ~6 int32 arrays of R x target


def _bottom_rows(reads: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """int32 (R, n_tiles, w): the last DP row of each read over each tile
    (column -1 of a tile is the empty target prefix)."""
    R, m = reads.shape
    n_t, w = tiles.shape
    dev = tiles.device
    idx = torch.arange(-1, w, dtype=torch.int32, device=dev)
    D = torch.zeros((R, n_t, w + 1), dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        cost = (tiles[None] != reads[:, i - 1].view(R, 1, 1)).to(torch.int32)
        E = torch.empty_like(D)
        E[..., 0] = i
        torch.minimum(D[..., :-1] + cost, D[..., 1:] + 1, out=E[..., 1:])
        E -= idx
        D = torch.cummin(E, dim=-1).values
        D += idx
        del cost, E
    return D[..., 1:]


def best_ends(reads: np.ndarray, genome: np.ndarray, device,
              tile: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(best int64 (R,), first end int64 (R,)) of each read (uint8 codes,
    one length) against the genome (uint8 codes), as edlib's HW mode gives
    them with k = -1: the end is the smallest target position reaching the
    best, and -1 (the empty alignment before the target) where no position
    beats the read's length, unless that length is a multiple of 64
    (edlib's 64-bit padding)."""
    R, m = reads.shape
    n = len(genome)
    w = n if tile is None else int(tile)
    n_t = -(-n // w)
    g = np.full(n_t * w, 255, np.uint8)   # 255 matches no read code
    g[:n] = genome
    tiles = torch.from_numpy(g).to(device).view(n_t, w)
    pos_all = torch.arange(n_t * w, dtype=torch.int64, device=device)
    best = np.empty(R, np.int64)
    pos = np.empty(R, np.int64)
    for a in range(0, R, BLOCK_READS):
        r = torch.from_numpy(np.ascontiguousarray(reads[a:a + BLOCK_READS])
                             ).to(device)
        bottom = _bottom_rows(r, tiles).reshape(len(r), n_t * w)[:, :n]
        b = bottom.min(1).values
        first = torch.where(bottom == b[:, None], pos_all[:n],
                            n).min(1).values
        best[a:a + len(r)] = b.cpu().numpy()
        pos[a:a + len(r)] = first.cpu().numpy()
        del bottom
    cap = (best >= m) & (m % 64 != 0)
    return np.where(cap, m, best), np.where(cap, -1, pos)


def above_k(best: np.ndarray, pos: np.ndarray, k: int):
    """edlib's k contract: a best above k (k >= 0) is (-1, -1)."""
    if k < 0:
        return best, pos
    ok = best <= k
    return np.where(ok, best, -1), np.where(ok, pos, -1)
