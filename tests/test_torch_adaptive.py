"""The value-adaptive banded HW reduce (Sweeper.reduce_hw_adaptive) against
PallasSweeper.reduce_hw_adaptive in interpret mode, on the CPU.

The plain version must give the TPU kernel's raw outputs, overestimates
above k included: its band is shared by each tile of 1,024 lanes (pad lanes
take part), so a case whose lanes span two tiles is here too.  Beside that,
the exact-where-best<=k contract is held against the port's unbanded
reduce.  Inputs come from a numpy seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from edlib_tpu import encode as jenc
from edlib_tpu.ops.pallas_kernel import PallasSweeper
from edlib_tpu.ops.pallas_kernel import adaptive_classes as jclasses
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops.sweeper import Sweeper, adaptive_classes

SIGMA = 4
CPU = torch.device("cpu")
# (qlen, tlen, chunk, strong_every, lanes): the three cases of
# tests/test_adaptive_banded.py, and lanes over two tiles.
CASES = [(100, 700, 64, 4, 5), (120, 1000, 64, 0, 5), (40, 700, 32, 2, 5),
         (60, 300, 32, 2, 1500)]


def _case(qlen, tlen, lanes, seed, n_random=0):
    """Reads of a random target with 6% substitutions, the last n_random
    of them random sequences."""
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
        if b >= lanes - n_random:
            r = rng.randint(0, SIGMA, qlen)
        peq[b] = jenc.build_peq_words(r.astype(np.uint8), eq, n_words=nw)
    t_scan = np.concatenate([target, np.full(W, SIGMA, np.int32)])
    lo = np.full(lanes, W, np.int32)
    hi = np.full(lanes, W + tlen, np.int32)
    return peq, t_scan, lo, hi


def test_adaptive_classes_match_jax():
    for n in range(1, 70):
        assert adaptive_classes(n) == jclasses(n)


@pytest.mark.parametrize("k", [6, 12, 200])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}bp-{c[4]}")
def test_reduce_hw_adaptive_matches_interpret(case, k):
    """Raw outputs equal, best, first and last position, lane for lane."""
    qlen, tlen, chunk, strong, lanes = case
    peq, t_scan, lo, hi = _case(qlen, tlen, lanes, qlen + tlen)
    want = PallasSweeper(chunk=chunk, interpret=True).reduce_hw_adaptive(
        peq, t_scan, lo, hi, k, hin0=0, group=8, strong_every=strong,
        shared=True)
    got = Sweeper(CPU, chunk).reduce_hw_adaptive(
        convert.bit_words(peq), t_scan, lo, hi, k, hin0=0, group=8,
        strong_every=strong, shared=True)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_reduce_hw_adaptive_per_lane_targets_match_interpret():
    """Per-lane target rows (no shared row), SHW's hin0 = 1, and a k
    below zero (taken as 0)."""
    peq, t_scan, lo, hi = _case(70, 400, 9, 3)
    rng = np.random.RandomState(5)
    targets = np.tile(t_scan, (9, 1))
    targets[::2, 200:260] = rng.randint(0, SIGMA, (5, 60))
    for k, hin0 in ((-3, 0), (20, 1)):
        want = PallasSweeper(chunk=64, interpret=True).reduce_hw_adaptive(
            peq, targets, lo, hi, k, hin0=hin0, group=8, strong_every=3)
        got = Sweeper(CPU, 64).reduce_hw_adaptive(
            convert.bit_words(peq), targets, lo, hi, k, hin0=hin0, group=8,
            strong_every=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [6, 12, 30])
def test_reduce_hw_adaptive_exact_where_best_within_k(k):
    """Lanes whose unbanded best is <= k get it exactly (first and last
    position too); the others get a value above k."""
    peq, t_scan, lo, hi = _case(100, 700, 1100, 11, n_random=300)
    sw = Sweeper(CPU, 64)
    pt = convert.bit_words(peq)
    best, pf, pl_ = sw.reduce_hw_adaptive(pt, t_scan, lo, hi, k,
                                          strong_every=4, shared=True)
    full = sw.reduce(pt, t_scan, lo, hi, 0, shared=True)
    within = full[0] <= k
    assert within.any() and (~within).any()
    for got, want in zip((best, pf, pl_), full[:3]):
        np.testing.assert_array_equal(got[within], want[within])
    assert (best[~within] > k).all()


def test_hw_adaptive_checks_its_operands():
    peq = torch.zeros((3, SIGMA + 1, 1), dtype=torch.int32)
    tg = torch.zeros((1, 40), dtype=torch.int32)
    lanes = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 1024"):
        ck.hw_adaptive(peq, tg, lanes, lanes, lanes, lanes, 4, 0)
    out = ck.hw_adaptive_padded(peq, tg, lanes, lanes + 40, lanes, lanes, 4,
                                0)
    assert [tuple(o.shape) for o in out] == [(3,)] * 3
