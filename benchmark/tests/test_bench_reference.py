"""The plain references against a tiny full DP written out cell by cell."""

import numpy as np
import pytest

from benchmark.reference import hw_map, nw_wfa


def full_dp(q, t, free_start: bool):
    """The whole DP matrix, one cell at a time (row 0: 0 with a free start
    in t, else j)."""
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[0, :] = 0 if free_start else np.arange(n + 1)
    D[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            D[i, j] = min(D[i - 1, j - 1] + (q[i - 1] != t[j - 1]),
                          D[i - 1, j] + 1, D[i, j - 1] + 1)
    return D


def hw_answer(q, t):
    """edlib's HW (best, first end) from the full DP, with its -1 rule."""
    row = full_dp(q, t, True)[-1, 1:]
    best = int(row.min())
    if best >= len(q) and len(q) % 64:
        return len(q), -1
    return best, int(np.argmax(row == best))


def test_hw_matches_full_dp():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 700, dtype=np.uint8)
    reads = [g[100:130].copy(), g[650:690].copy(), rng.integers(
        0, 4, 35, dtype=np.uint8), g[10:45].copy()]
    reads[0][[3, 17]] ^= 1
    reads[3] = np.delete(reads[3], 5)
    for r in reads:
        best, pos = hw_map.best_ends(r[None], g, "cpu")
        assert (best[0], pos[0]) == hw_answer(r, g)


def test_hw_ties_and_edges():
    g = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8)
    # Two exact copies: the first end wins.
    assert tuple(x[0] for x in hw_map.best_ends(
        np.array([[1, 2, 3]], np.uint8), g, "cpu")) == (0, 3)
    # No base of the read in the target: best == qlen, end -1 (qlen 3).
    g2 = np.zeros(20, np.uint8)
    assert tuple(x[0] for x in hw_map.best_ends(
        np.array([[1, 2, 3]], np.uint8), g2, "cpu")) == (3, -1)
    # At a length that is a multiple of 64 edlib reports the first end.
    r64 = np.full((1, 64), 1, np.uint8)
    assert tuple(x[0] for x in hw_map.best_ends(r64, g2, "cpu")) == (64, 0)
    best, pos = hw_map.above_k(np.array([5, 3]), np.array([9, 7]), 4)
    assert best.tolist() == [-1, 3] and pos.tolist() == [-1, 7]


def test_hw_tile_control_loses_straddlers():
    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, 1000, dtype=np.uint8)
    reads = np.stack([g[240:280], g[600:640]])   # the first straddles 256
    full = hw_map.best_ends(reads, g, "cpu")
    tiled = hw_map.best_ends(reads, g, "cpu", tile=256)
    assert full[0].tolist() == [0, 0]
    assert tiled[0][0] > 0 and tiled[0][1] == 0


def nw_answer(q, t):
    return int(full_dp(q, t, False)[-1, -1])


@pytest.mark.parametrize("m,n", [(60, 60), (50, 73), (80, 41), (1, 30),
                                 (33, 1)])
def test_wfa_matches_full_dp(m, n):
    rng = np.random.default_rng(m * 100 + n)
    qs = rng.integers(0, 4, (3, m), dtype=np.uint8)
    ts = rng.integers(0, 4, (3, n), dtype=np.uint8)
    ts[1, :min(m, n)] = qs[1, :min(m, n)]       # a near pair
    ts[1, ::7] = (ts[1, ::7] + 1) % 4
    got = nw_wfa.distances(qs, ts, "cpu")
    assert got == [nw_answer(q, t) for q, t in zip(qs, ts)]


def test_wfa_long_slides_and_k():
    rng = np.random.default_rng(8)
    t = rng.integers(0, 4, 400, dtype=np.uint8)
    q = np.delete(t.copy(), [50, 300])
    q = np.insert(q, 200, [1, 1, 1])
    d = nw_answer(q, t)
    assert nw_wfa.distances(q[None], t[None], "cpu") == [d]
    assert nw_wfa.distances(q[None], t[None], "cpu", k=d) == [d]
    assert nw_wfa.distances(q[None], t[None], "cpu", k=d - 1) == [-1]


def test_wfa_band_control_overestimates():
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 300, dtype=np.uint8)
    q = np.insert(t[12:], 150, rng.integers(0, 4, 12, dtype=np.uint8))
    d = nw_answer(q, t)
    assert nw_wfa.distances(q[None], t[None], "cpu") == [d]
    assert nw_wfa.distances(q[None], t[None], "cpu", band=2)[0] > d
