"""The resumable reduce's split-lane schedule with a carry on the CPU.

reduce_resume at 1-8 words cuts every lane's segment into cores from column
0: a core whose sweep starts at column 0 starts from the carried state, the
others from the fresh state a halo before the core; the core holding hi - 1
gives last and the one holding the segment's last column the exit state
(ops/cuda_kernel.resume_cores, split_resume_plain).  The plain emulation of
that schedule is held against reduce_resume_plain and the Pallas kernel in
interpret mode (pallas_kernel.reduce_resumable_flat_device): outputs, every
word's exit Pv and Mv and the exit score.  The kernel follows the same plan
on the card, where chip_smoke.py holds it against its plain version with
forced cores.  Every output is an integer, so every comparison is exact;
inputs come from numpy with a fixed seed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.parallel import dist

SIGMA = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _edge_windows(rng, B, T):
    """lo/hi with the K1 edge lanes: hi = 0, an empty window, lo past hi,
    hi past T, both past T, and windows inside the row."""
    lo = rng.randint(0, T // 2, B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7] = T + 2
    hi[4::7] = T + 9
    return lo.astype(np.int32), hi.astype(np.int32)


def _operands(rng, B, T, nw, shared):
    peq = rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (1 if shared else B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    return peq, tg, lo, hi


def _carry(rng, B, nw, fresh):
    if fresh:
        return (np.full((B, nw), 0xFFFFFFFF, np.uint32),
                np.zeros((B, nw), np.uint32),
                np.full(B, nw * 32, np.int32))
    pv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(np.uint32)
    mv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(
        np.uint32) & ~pv
    return pv, mv, rng.randint(0, 500, B).astype(np.int32)


def _reached(rng, ops, nw):
    """A random HW state: each lane's exit state after a random row of 50
    columns from the fresh state (the carry an HW pipeline hands on; a
    random bit pattern is not one, and at hin0 = 0 the split schedule's
    fresh cores assume the carry is)."""
    peq, _, lo, hi, prow, _ = ops[:6]
    B = lo.shape[0]
    pre = _t(rng.randint(0, SIGMA + 1, (B, 50)))
    rows = torch.arange(B, dtype=torch.int32)
    fresh = tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x) for x in _carry(rng, B, nw, True))
    return ck.reduce_resume_plain(peq, pre, lo * 0, hi * 0, prow, rows,
                                  *fresh, 0)[4:]


def _port(peq, tg, lo, hi, carry, shared):
    B = lo.shape[0]
    rows = torch.arange(B, dtype=torch.int32)
    return (convert.bit_words(peq), _t(tg), _t(lo), _t(hi), rows,
            rows * 0 if shared else rows) + tuple(
                convert.carry_from_jax(carry, "kernel"))


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nw,shared,hin0,fresh", [
    (1, False, 0, False), (4, True, 0, True), (8, False, 0, False),
    (9, True, 0, False), (4, False, 1, False), (8, True, 1, True)])
def test_split_resume_matches_plain_and_pallas(nw, shared, hin0, fresh):
    """reduce_resume_plain equals the Pallas resumable kernel in interpret
    mode from a random carry, output for output and word for word; the
    emulation with forced cores of 1-40 columns (and the rule's own) equals
    reduce_resume_plain from the same carry at hin0 = 1 (one core a lane)
    and from a random HW state at hin0 = 0."""
    rng = np.random.RandomState(nw * 7 + hin0 + 3 * shared)
    B, T = 40, 128
    peq, tg, lo, hi = _operands(rng, B, T, nw, shared)
    carry = _carry(rng, B, nw, fresh)
    ops = _port(peq, tg, lo, hi, carry, shared)
    want = ck.reduce_resume_plain(*ops, hin0)
    jax_out = pk.reduce_resumable_flat_device(
        *(jnp.asarray(a) for a in (peq, tg[0] if shared else tg, lo, hi)
          + carry), hin0=hin0, chunk=32, interpret=True)
    for g, w in zip(want, jax_out):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    if hin0 == 0 and not fresh:
        ops = ops[:6] + _reached(rng, ops, nw)
        want = ck.reduce_resume_plain(*ops, hin0)
    for core in (None, 1, 3, 17, 40):
        _equal(ck.split_resume_plain(*ops, hin0, core=core), want)


@pytest.mark.parametrize("nw,core", [(1, 5), (2, 64), (4, 129), (3, None)])
def test_resume_cores_plan(nw, core):
    """Every lane's cores cover [0, T) from column 0; hin0 = 1 and lanes
    past 8 words keep one core; a forced core longer than T is one core."""
    T = 300
    c, K = ck.resume_cores(50, T, nw, 0, core)
    assert K == -(-T // c) and (K - 1) * c < T <= K * c
    if core is not None:
        assert c == core
    assert ck.resume_cores(50, T, nw, 1, 7) == (T, 1)
    assert ck.resume_cores(50, T, 9, 0, 7) == (T, 1)
    assert ck.resume_cores(50, 0, nw, 0, core)[1] == 0


@pytest.mark.parametrize("nw,hin0,core", [(1, 0, 7), (4, 0, 20), (8, 0, 2),
                                          (4, 1, 5)])
def test_split_resume_chain_equals_one_sweep(rng, nw, hin0, core):
    """Two chained segments of the emulation (the second ragged, carried
    through the first's exit state) merge into one reduce_lanes sweep of
    the joined row, and their exit state is one sweep's."""
    B, T, cut = 35, 190, 97   # the second segment ragged, shorter
    peq = convert.bit_words(rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                                        dtype=np.uint64).astype(np.uint32))
    tg = _t(rng.randint(0, SIGMA + 1, (B, T)))
    lo, hi = (_t(x) for x in _edge_windows(rng, B, T))
    rows = torch.arange(B, dtype=torch.int32)
    fresh = tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x) for x in _carry(rng, B, nw, True))
    seg = [tg[:, :cut].contiguous(), tg[:, cut:].contiguous()]
    r1 = ck.split_resume_plain(peq, seg[0], lo.clamp(max=cut),
                               hi.clamp(max=cut), rows, rows, *fresh, hin0,
                               core=core)
    r2 = ck.split_resume_plain(peq, seg[1], (lo - cut).clamp(min=0),
                               (hi - cut).clamp(min=0), rows, rows, *r1[4:],
                               hin0, core=core)
    # Lanes that see a column (the pipelines' defaults differ elsewhere).
    live = (hi > lo) & (lo < T) & (hi > 0)
    merged = dist.merge_segments([r1[:4], r2[:4]], cut, hi)
    want = ck.reduce_lanes_plain(peq, tg, lo, hi, rows, rows, hin0)
    _equal([m[live] for m in merged], [w[live] for w in want])
    whole = ck.reduce_resume_plain(peq, tg, lo, hi, rows, rows, *fresh, hin0)
    _equal(r2[4:], whole[4:])


def test_split_resume_empty_segment_keeps_the_carry(rng):
    """A segment of no columns returns the carry and the defaults."""
    B, nw = 5, 2
    peq = convert.bit_words(rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                                        dtype=np.uint64).astype(np.uint32))
    rows = torch.arange(B, dtype=torch.int32)
    carry = tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                   else x) for x in _carry(rng, B, nw, False))
    out = ck.split_resume_plain(peq, torch.zeros((B, 0), dtype=torch.int32),
                                rows * 0, rows * 0 + 3, rows, rows, *carry, 0,
                                core=4)
    _equal(out[4:], carry)
    assert bool((out[0] == 0x3FFFFFFF).all() & (out[1] == -1).all())
