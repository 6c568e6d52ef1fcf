"""The value-adaptive reduce's cluster launch on the CPU: the planner that
picks its form, cluster size, lanes a block and staging (adaptive_plan,
adaptive_plans), and the raw outputs of Sweeper.reduce_hw_adaptive against
PallasSweeper.reduce_hw_adaptive in interpret mode on the cases the kernel's
band bookkeeping turns on: widths across adaptive_classes' boundaries,
other group lengths, a strong reduce every group, k = 0, three tiles whose
windows end at different columns, and per-lane targets at hin0 = 1.

The CUDA kernel (hw_adaptive_cluster_kernel) keeps the plain version's
arithmetic line for line and only moves where the state lives and how the
tile's minima are reduced (integer minima, so the order does not matter);
chip_smoke.py holds it against hw_adaptive_plain on the card at every
cluster size.  Every comparison is exact.  Inputs come from numpy with a
fixed seed.
"""

import numpy as np
import pytest
import torch

from edlib_tpu import encode as jenc
from edlib_tpu.ops.pallas_kernel import PallasSweeper
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops.sweeper import Sweeper

SIGMA = 4
CPU = torch.device("cpu")
SMEM = 232_448                     # a block's shared memory on the H100


@pytest.mark.parametrize("s1", [5, 101])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_adaptive_plan_rules(cluster, s1):
    """lanes a block x C = 1,024; NWC the least capacity >= NW up to 32,
    the scratch form past it (or when asked); the profile rows staged only
    within the block's budget beside the minima."""
    for nw in range(1, 301):
        for regs in (True, False):
            p = ck.adaptive_plan(nw, s1, cluster, regs)
            assert p["cluster"] == cluster
            assert p["lanes"] * cluster == 1024
            if regs and nw <= 32:
                assert p["form"] == "regs"
                assert p["nwc"] in (1, 2, 4, 8, 16, 32)
                assert p["nwc"] >= nw > p["nwc"] // 2
            else:
                assert p["form"] == "scratch" and p["nwc"] == 0
            minima = 4 * 6 * min(nw, 2048)
            rows = 4 * s1 * nw * p["lanes"]
            assert p["staged"] == (minima + rows <= SMEM)
            assert p["smem"] == minima + (rows if p["staged"] else 0)
            assert p["smem"] <= SMEM


@pytest.mark.parametrize("nw", [1, 12, 32, 33, 300])
def test_adaptive_plans_order_and_cap(nw):
    """The register form from C = 16 down, then the scratch form from 16
    down; a cap only lowers C; past 32 words only the scratch form."""
    for cap in (None, 16, 8, 4, 2, 1):
        plans = ck.adaptive_plans(nw, SIGMA + 1, cap)
        cs = [c for c in (16, 8, 4, 2, 1) if cap is None or c <= cap]
        forms = ((["regs"] * len(cs) if nw <= 32 else [])
                 + ["scratch"] * len(cs))
        assert [p["form"] for p in plans] == forms
        assert [p["cluster"] for p in plans] == cs * (len(forms) // len(cs))


def test_hw_adaptive_checks_its_cluster():
    peq = torch.zeros((1024, SIGMA + 1, 1), dtype=torch.int32)
    tg = torch.zeros((1, 40), dtype=torch.int32)
    lanes = torch.zeros(1024, dtype=torch.int32)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster"):
            ck.hw_adaptive(peq, tg, lanes, lanes, lanes, lanes, 4, 0,
                           cluster=bad)
    with pytest.raises(ValueError, match="cluster"):
        ck.adaptive_plan(1, SIGMA + 1, 12)
    # The CPU runs the plain version whatever the cap; no plan is reported.
    plan = {}
    out = ck.hw_adaptive(peq, tg, lanes, lanes + 40, lanes, lanes, 4, 0,
                         cluster=2, plan=plan)
    assert plan == {} and [tuple(o.shape) for o in out] == [(1024,)] * 3


def _case(qlen, tlen, lanes, seed, per_lane=False, tile_cut=0):
    """Reads of a random target with 6% substitutions (an eighth of them
    random); per_lane: every other lane's target row changed in places;
    tile_cut: each tile's windows end that many columns before the
    previous tile's."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, SIGMA, tlen).astype(np.int32)
    nw = jenc.num_words(qlen)
    W = nw * 32 - qlen
    eq = np.eye(SIGMA, dtype=bool)
    peq = np.zeros((lanes, SIGMA + 1, nw), np.uint32)
    for b in range(lanes):
        s = rng.randint(0, tlen - qlen)
        r = target[s:s + qlen].copy()
        muts = rng.rand(qlen) < 0.06
        r[muts] = rng.randint(0, SIGMA, muts.sum())
        if b % 8 == 7:
            r = rng.randint(0, SIGMA, qlen)
        peq[b] = jenc.build_peq_words(r.astype(np.uint8), eq, n_words=nw)
    t_scan = np.concatenate([target, np.full(W, SIGMA, np.int32)])
    if per_lane:
        t_scan = np.tile(t_scan, (lanes, 1))
        at = rng.randint(0, tlen - 40, lanes // 2)
        for i, b in enumerate(range(0, lanes, 2)):
            t_scan[b, at[i]:at[i] + 40] = rng.randint(0, SIGMA, 40)
    lo = np.full(lanes, W, np.int32)
    hi = (W + tlen - tile_cut * (np.arange(lanes) // 1024)).astype(np.int32)
    return peq, t_scan, lo, hi


# (label, qlen, tlen, lanes, k, hin0, group, strong_every, chunk, per-lane
# targets, tile_cut): NW 5 and 9 across their class boundaries
# (adaptive_classes 5: 1, 2, 4, 5; 9: 1, 2, 4, 6, 8, 9), groups of 4 and
# 16, a strong reduce every group, k = 0, three tiles ending apart, and
# per-lane targets at hin0 = 1.
CASES = [
    ("nw5", 150, 600, 40, 40, 0, 8, 4, 64, False, 0),
    ("nw5-k100", 150, 600, 40, 100, 0, 8, 2, 64, False, 0),
    ("nw9", 280, 700, 40, 60, 0, 8, 4, 64, False, 0),
    ("nw9-k200", 280, 700, 40, 200, 0, 8, 0, 64, False, 0),
    ("group4", 100, 500, 40, 20, 0, 4, 4, 32, False, 0),
    ("group16", 100, 500, 40, 20, 0, 16, 2, 64, False, 0),
    ("strong1", 120, 500, 40, 30, 0, 8, 1, 64, False, 0),
    ("k0", 70, 400, 40, 0, 0, 8, 3, 64, False, 0),
    ("three-tiles", 60, 300, 2600, 12, 0, 8, 2, 32, False, 45),
    ("per-lane-hin1", 90, 400, 40, 25, 1, 8, 3, 64, True, 0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_reduce_hw_adaptive_cases_match_interpret(case):
    """Raw outputs (best, first and last position; overestimates above k
    included) equal the TPU kernel's in interpret mode, lane for lane."""
    (_, qlen, tlen, lanes, k, hin0, group, strong, chunk, per_lane,
     tile_cut) = case
    peq, targets, lo, hi = _case(qlen, tlen, lanes, qlen + tlen + lanes,
                                 per_lane, tile_cut)
    shared = not per_lane
    want = PallasSweeper(chunk=chunk, interpret=True).reduce_hw_adaptive(
        peq, targets, lo, hi, k, hin0=hin0, group=group,
        strong_every=strong, shared=shared)
    got = Sweeper(CPU, chunk).reduce_hw_adaptive(
        convert.bit_words(peq), targets, lo, hi, k, hin0=hin0, group=group,
        strong_every=strong, shared=shared)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # Some lane is within k (k = 0 aside: no read of these is exact).
    assert k == 0 or (want[0] <= k).any()


def test_tiles_ending_apart_keep_their_own_band():
    """Three tiles whose windows end at different columns: each tile's live
    word-columns stop at its own last column, and its outputs equal the
    same lanes swept as a batch of their own (a tile's band depends on its
    lanes only)."""
    peq, t_scan, lo, hi = _case(60, 300, 3072, 3, tile_cut=45)
    args = (convert.bit_words(peq), torch.from_numpy(t_scan[None]),
            torch.from_numpy(lo), torch.from_numpy(hi))
    rows = torch.arange(3072, dtype=torch.int32)
    live = torch.zeros(3, dtype=torch.int64)
    out = ck.hw_adaptive(*args, rows, rows * 0, 12, 0, live=live)
    for t in range(3):
        s = slice(t * 1024, (t + 1) * 1024)
        one = torch.zeros(1, dtype=torch.int64)
        alone = ck.hw_adaptive(args[0][s].contiguous(), args[1], args[2][s],
                               args[3][s], rows[:1024], rows[:1024] * 0, 12,
                               0, live=one)
        for o, a in zip(out, alone):
            assert torch.equal(o[s], a)
        assert int(live[t]) == int(one[0])
    assert len(set(live.tolist())) == 3
