"""The word-parallel lane and the score stream's warp groups on the CPU.

Where a lane cannot be cut into column cores (the resumable reduce at
hin0 = 1 or with one core a lane; the score stream) its 2-8 words run on a
segment of threads of one warp, each a tile of 16 columns behind the one
above, the tile's carries handed down as two masks in one shuffle
(ops/cuda_kernel.word_lanes_plain emulates that schedule step by step); the
score stream's lanes of 256 words and more run as the fixed-window
wavefront's warp groups (sweep_scores_groups_plain).  The emulations are
held against the plain versions (reduce_resume_plain, sweep_scores_plain,
sweep_scores_resume_plain) and the JAX package: the Pallas resumable
kernel in interpret mode (pallas_kernel.reduce_resumable_flat_device) and
jax_engine's score streams.  The kernels follow the same schedules on the
card, where chip_smoke.py holds them against their plain versions.  Every
output is an integer, so every comparison is exact; inputs come from numpy
with a fixed seed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.parallel import dist

SIGMA = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _edge_windows(rng, B, T):
    """lo/hi with the edge lanes: hi = 0, an empty window, lo past hi, hi
    past T, both past T, and windows inside the row."""
    lo = rng.randint(0, max(1, T // 2), B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7] = T + 2
    hi[4::7] = T + 9
    return lo.astype(np.int32), hi.astype(np.int32)


def _carry(rng, B, nw, fresh):
    """(pv, mv, score) uint32/int32 numpy in the kernel layout (B, NW)."""
    if fresh:
        return (np.full((B, nw), 0xFFFFFFFF, np.uint32),
                np.zeros((B, nw), np.uint32),
                np.full(B, nw * 32, np.int32))
    pv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(np.uint32)
    mv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(
        np.uint32) & ~pv
    return pv, mv, rng.randint(0, 500, B).astype(np.int32)


def _operands(rng, B, T, nw, n_rows=5):
    """Per-lane rows picked from n_rows profiles and target rows."""
    peq = rng.randint(0, 1 << 32, (n_rows, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (n_rows, T)).astype(np.int32)
    prow = rng.randint(0, n_rows, B).astype(np.int32)
    trow = rng.randint(0, n_rows, B).astype(np.int32)
    return peq, tg, prow, trow


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("hin0", [0, 1])
@pytest.mark.parametrize("nw", [2, 3, 4, 5, 6, 7, 8])
def test_word_lanes_equal_the_plain_versions(nw, hin0, fresh):
    """The word-parallel emulation equals reduce_resume_plain field for
    field (every output, every word of the exit state, the exit score) and
    sweep_scores_resume_plain / sweep_scores_plain, at every segment width
    (NW 3, 5, 6, 7 padded), both hin0, from the fresh state and a random
    carry (one core a lane takes any carry), with the edge lanes, on rows
    of 37 columns (a ragged last tile) and of 3 (fewer than the words)."""
    rng = np.random.RandomState(100 + 4 * nw + 2 * hin0 + fresh)
    for T in (37, 3):
        B = 23
        peq, tg, prow, trow = _operands(rng, B, T, nw)
        lo, hi = _edge_windows(rng, B, T)
        carry = tuple(convert.carry_from_jax(_carry(rng, B, nw, fresh),
                                             "kernel"))
        ops = (convert.bit_words(peq), _t(tg), _t(lo), _t(hi), _t(prow),
               _t(trow)) + carry
        _equal(ck.reduce_resume_words_plain(*ops, hin0),
               ck.reduce_resume_plain(*ops, hin0))
        rows = ops[:2] + ops[4:6]
        _equal(ck.word_lanes_plain(*rows, hin0, *carry),
               ck.sweep_scores_resume_plain(*rows, *carry, hin0))
        _equal([ck.word_lanes_plain(*rows, hin0)[0]],
               [ck.sweep_scores_plain(*rows, hin0)])


@pytest.mark.parametrize("nw,hin0,fresh", [(2, 1, False), (4, 0, True),
                                           (7, 1, True), (8, 0, False)])
def test_word_lanes_equal_the_pallas_resumable_kernel(nw, hin0, fresh):
    """The word-parallel reduce equals the Pallas resumable kernel in
    interpret mode from the same carry: best, pfirst, plast, last and the
    exit state, word for word."""
    rng = np.random.RandomState(7 * nw + hin0)
    B, T = 24, 64
    peq = rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    carry = _carry(rng, B, nw, fresh)
    rows = torch.arange(B, dtype=torch.int32)
    got = ck.reduce_resume_words_plain(
        convert.bit_words(peq), _t(tg), _t(lo), _t(hi), rows, rows,
        *convert.carry_from_jax(carry, "kernel"), hin0)
    want = pk.reduce_resumable_flat_device(
        *(jnp.asarray(a) for a in (peq, tg, lo, hi) + carry), hin0=hin0,
        chunk=32, interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


@pytest.mark.parametrize("nw,hin0", [(2, 0), (4, 1), (6, 1), (8, 0)])
def test_word_lanes_equal_jax_engine_streams(nw, hin0):
    """The word-parallel score stream equals jax_engine.sweep_scores from
    the fresh state, and jax_engine.sweep_scores_resumable from a random
    carry: every column's score and the state after the last."""
    rng = np.random.RandomState(31 * nw + hin0)
    B, T = 20, 45
    peq = rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (B, T)).astype(np.int32)
    rows = torch.arange(B, dtype=torch.int32)
    ops = (convert.bit_words(peq), _t(tg), rows, rows)
    want = np.asarray(jax_engine.sweep_scores(jnp.asarray(peq),
                                              jnp.asarray(tg), hin0=hin0))
    np.testing.assert_array_equal(ck.word_lanes_plain(*ops, hin0)[0].numpy(),
                                  want)
    pv, mv, s = _carry(rng, B, nw, False)
    scores, state = jax_engine.sweep_scores_resumable(
        jnp.asarray(peq), jnp.asarray(tg),
        (jnp.asarray(pv.T), jnp.asarray(mv.T), jnp.asarray(s)), hin0=hin0)
    got = ck.word_lanes_plain(*ops, hin0,
                              *convert.carry_from_jax((pv, mv, s), "kernel"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(scores))
    _equal(got[1:], convert.carry_from_jax(state, "xla"))


@pytest.mark.parametrize("nw,hin0", [(3, 0), (5, 1), (8, 1)])
def test_word_lanes_chained_segments_equal_one_sweep(rng, nw, hin0):
    """Two chained segments of the word-parallel lane (the second ragged,
    from the first's exit state) give the stream and the exit state of one
    sweep of the joined row, and their reductions the windows' reduction
    over it."""
    B, T, cut = 19, 90, 47   # the second segment ragged, shorter
    peq, tg, prow, trow = _operands(rng, B, T, nw)
    ops = (convert.bit_words(peq), _t(tg), _t(prow), _t(trow))
    carry = tuple(convert.carry_from_jax(_carry(rng, B, nw, False),
                                         "kernel"))
    seg = [ops[1][:, :cut].contiguous(), ops[1][:, cut:].contiguous()]
    s1 = ck.word_lanes_plain(ops[0], seg[0], *ops[2:], hin0, *carry)
    s2 = ck.word_lanes_plain(ops[0], seg[1], *ops[2:], hin0, *s1[1:])
    whole = ck.sweep_scores_resume_plain(*ops, *carry, hin0)
    _equal([torch.cat([s1[0], s2[0]], 1)] + list(s2[1:]), whole)
    lo, hi = (_t(x) for x in _edge_windows(rng, B, T))
    r1 = ck.reduce_resume_words_plain(ops[0], seg[0], lo.clamp(max=cut),
                                      hi.clamp(max=cut), *ops[2:], *carry,
                                      hin0)
    r2 = ck.reduce_resume_words_plain(ops[0], seg[1], (lo - cut).clamp(min=0),
                                      (hi - cut).clamp(min=0), *ops[2:],
                                      *r1[4:], hin0)
    _equal(r2[4:], whole[1:])
    # Lanes that see a column (the pipelines' defaults differ elsewhere).
    live = (hi > lo) & (lo < T) & (hi > 0)
    merged = dist.merge_segments([r1[:4], r2[:4]], cut, hi)
    want = ck.reduce_resume_plain(ops[0], ops[1], lo, hi, *ops[2:], *carry,
                                  hin0)
    _equal([m[live] for m in merged], [w[live] for w in want[:4]])


@pytest.mark.parametrize("nw,T,ring,hin0,fresh,passes", [
    (256, 100, 1, 0, False, None), (300, 90, 2, 1, False, None),
    (300, 60, 1, 0, True, None), (300, 70, 2, 1, False, 4)])
def test_score_groups_equal_the_plain_versions(nw, T, ring, hin0, fresh,
                                               passes):
    """The score stream's group emulation (tiles, tagged records in rings
    of 1 and 2 tiles, tasks and blocks) equals sweep_scores_resume_plain
    from a random carry and sweep_scores_plain from the fresh state, at 256
    words and at a ragged 300 (the last group part empty), with per-lane
    rows; also in passes of 4 groups (three launches, the records of each
    lane handed on between them)."""
    rng = np.random.RandomState(nw + T + ring)
    B = 2
    peq, tg, prow, trow = _operands(rng, B, T, nw, n_rows=2)
    rows = (convert.bit_words(peq), _t(tg), _t(prow), _t(trow))
    if fresh:
        _equal([ck.sweep_scores_groups_plain(*rows, hin0, ring=ring)[0]],
               [ck.sweep_scores_plain(*rows, hin0)])
        return
    carry = tuple(convert.carry_from_jax(_carry(rng, B, nw, False),
                                         "kernel"))
    _equal(ck.sweep_scores_groups_plain(*rows, hin0, *carry, ring=ring,
                                        pass_groups=passes, block_groups=3),
           ck.sweep_scores_resume_plain(*rows, *carry, hin0))


def test_reported_plans_name_the_forms():
    """A plan as the kernels' entries report it (form, blocks, threads a
    block, then the form's figures) reads as a dict with its set figures;
    the emulated segment is 2, 4 or 8 threads; on the CPU the plain
    versions run and a plan asked for stays empty."""
    buf = ck._plan_buffer()
    buf[:] = [1, 128, 128, 4, 1, 2_097_156, 0, 0, 0, 0]
    plan = {"stale": 1}
    ck._fill_plan(plan, buf)
    assert plan == dict(form="words", blocks=128, threads=128 * 128,
                        block=128, width=4, cores=1, core=2_097_156)
    buf[:] = [2, 16, 256, 0, 0, 0, 128, 64, 1, 128]
    ck._fill_plan(plan, buf)
    assert plan == dict(form="groups", blocks=16, threads=16 * 256,
                        block=256, groups=128, ring=64, passes=1,
                        pass_groups=128)
    ck._fill_plan(None, buf)
    for nw, width in ((2, 2), (3, 4), (4, 4), (5, 8), (8, 8)):
        assert ck.word_threads(nw) == width
    rng = np.random.RandomState(3)
    peq, tg, prow, trow = _operands(rng, 3, 20, 4)
    rows = (convert.bit_words(peq), _t(tg), _t(prow), _t(trow))
    plan = {}
    _equal([ck.sweep_scores(*rows, 1, plan=plan)],
           [ck.sweep_scores_plain(*rows, 1)])
    assert plan == {}


def test_split_resume_plain_takes_the_word_lane_at_one_core(monkeypatch):
    """Where the resumable reduce's plan is one core a lane at 2-8 words,
    its schedule emulation runs the word-parallel lane."""
    seen = []
    words = ck.reduce_resume_words_plain
    monkeypatch.setattr(ck, "reduce_resume_words_plain",
                        lambda *a: seen.append(1) or words(*a))
    rng = np.random.RandomState(5)
    B, T, nw = 9, 30, 4
    peq, tg, prow, trow = _operands(rng, B, T, nw)
    lo, hi = _edge_windows(rng, B, T)
    ops = (convert.bit_words(peq), _t(tg), _t(lo), _t(hi), _t(prow),
           _t(trow)) + tuple(convert.carry_from_jax(_carry(rng, B, nw, False),
                                                    "kernel"))
    _equal(ck.split_resume_plain(*ops, 1), ck.reduce_resume_plain(*ops, 1))
    assert seen == [1]


def test_score_stream_ring_is_checked():
    """The checks-only ring and pass size must be positive."""
    z = torch.zeros((1, 5, 300), dtype=torch.int32)
    r = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring=0"):
        ck.sweep_scores(z, torch.zeros((1, 4), dtype=torch.int32), r, r, 0,
                        ring=0)
    with pytest.raises(ValueError, match="pass_groups=0"):
        ck.sweep_scores(z, torch.zeros((1, 4), dtype=torch.int32), r, r, 0,
                        pass_groups=0)
