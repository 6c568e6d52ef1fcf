"""The split-lane schedule of K1 (reduce_lanes) and K2 (sweep_shared) on the
CPU: the plan the wrappers hand the kernels (ops/cuda_kernel.split_core and
friends), and its plain emulation (every (lane, core) from the fresh state,
merged by packed keys as the kernels merge them) against the JAX package.

The kernels themselves follow the same plan on the card, where chip_smoke.py
holds them against their plain versions with forced small cores.  Every
output is an integer, so every comparison is exact.  Inputs come from numpy
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

BIG = 0x3FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _words(rng, shape):
    """Random uint32 bit words as int32 bit patterns."""
    return rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def _edge_windows(rng, B, T):
    """lo/hi with the K1 edge lanes: hi = 0, an empty window (hi - 1 < lo),
    lo past hi, hi past T, and windows inside the row."""
    lo = rng.randint(0, T // 2, B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7] = rng.randint(0, T + 5, len(lo[4::7]))
    hi[4::7] = T + 9
    return lo.astype(np.int32), hi.astype(np.int32)


def _window_reduce(scores, lo, hi):
    """numpy (best, pfirst, plast, last) of each row over [lo, hi)."""
    B, T = scores.shape
    out = np.zeros((4, B), np.int64)
    for b in range(B):
        a, z = max(0, lo[b]), min(T, hi[b])
        if a < z:
            win = scores[b, a:z]
            m = win.min()
            hits = np.nonzero(win == m)[0]
            out[:3, b] = (m, a + hits[0], a + hits[-1])
        else:
            out[:3, b] = (BIG, -1, -1)
        out[3, b] = scores[b, hi[b] - 1] if 0 < hi[b] <= T else BIG
    return out


@pytest.mark.parametrize("nw,core", [(1, 1), (1, 7), (3, 40), (2, None)])
def test_split_cores_partition_each_lanes_scanned_columns(rng, nw, core):
    """Each lane's cores are disjoint, in order, at most `core` long and
    cover [s, end) exactly, where s <= max(lo, 0) unless the window is
    empty and end - 1 = hi - 1 whenever hi - 1 is a column; each core's
    sweep starts a halo (2 * 32 * NW) before it."""
    B, T = 200, 300
    lo, hi = _edge_windows(rng, B, T)
    c = ck.split_core(B, T, nw, 0, core)
    halo = ck.split_halo(nw)
    lane, c_lo, c_hi, start = ck.split_core_ranges(_t(lo), _t(hi), T, c, halo)
    assert torch.equal(start, (c_lo - halo).clamp(min=0))
    assert bool(((c_hi - c_lo >= 1) & (c_hi - c_lo <= c)).all())
    for b in range(B):
        mine = lane == b
        ranges = list(zip(c_lo[mine].tolist(), c_hi[mine].tolist()))
        end = min(max(hi[b], 0), T)
        if end == 0:
            assert not ranges
            continue
        s = max(0, min(lo[b], end - 1))
        assert ranges[0][0] == s and ranges[-1][1] == end
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        if lo[b] < hi[b] and lo[b] < end:
            assert s <= max(lo[b], 0)
    s, end, counts = ck.split_cores(_t(lo), _t(hi), T, c)
    off = ck.split_offsets(counts)
    assert off.dtype == torch.int32 and int(off[0]) == 0
    assert int(off[-1]) == lane.shape[0]
    assert torch.equal(off[1:] - off[:-1], counts.to(torch.int32))


@pytest.mark.parametrize("nw", range(1, 9))
def test_split_halo_and_core_length(nw):
    """The halo is 2R; a planned core is at least 4 halos, so the halo adds
    at most a quarter of the work, and a forced core is taken as given."""
    assert ck.split_halo(nw) == 2 * nw * 32
    for n_lanes, cols in ((1, 10), (39, 4_194_312), (4096, 65_783)):
        c = ck.split_core(n_lanes, cols, nw, 0)
        assert c >= 4 * ck.split_halo(nw)
        assert n_lanes * -(-cols // c) <= ck._FILL_THREADS + n_lanes
    assert ck.split_core(39, 4_194_312, nw, 0, core=5) == 5


def test_split_plan_keeps_hin1_and_wide_lanes_whole(rng):
    """hin0 = 1 (a column's score depends on column 0) and lanes past 8
    words keep one core a lane, even with a forced core."""
    B, T = 50, 500
    lo, hi = _edge_windows(rng, B, T)
    for nw, hin0 in ((4, 1), (9, 0), (9, 1), (1, 1)):
        c = ck.split_core(B, T, nw, hin0, core=3)
        assert c == T
        _, _, counts = ck.split_cores(_t(lo), _t(hi), T, c)
        assert int(counts.max()) == 1


def test_split_plan_leaves_short_lanes_whole():
    """The main path's shapes: the filter's verify lanes (392 columns) stay
    one thread each; the segmented fallback and K2's overflow stragglers
    are cut into cores that fill the card."""
    nw = 4
    assert ck.split_core(131_072, 392, nw, 0) >= 392
    c = ck.split_core(4096, 65_783, nw, 0)
    assert 10 <= -(-65_536 // c) <= 20
    c = ck.split_core(39, 4_194_312, nw, 0)
    assert 39 * -(-4_194_312 // c) >= ck._FILL_THREADS


def test_packed_keys_unpack_to_the_kernels_sentinels():
    """A lane that saw no column unpacks to (_BIG, -1, -1); a seen column to
    its score and column."""
    keys = ck._new_keys(2, 2, torch.device("cpu"))
    keys[0, 1] = (7 << 32) | 123
    keys[1, 1] = ((BIG - 7) << 32) | 456
    best, pfirst, plast = ck._unpack_keys(keys)
    assert best.tolist() == [BIG, 7]
    assert pfirst.tolist() == [-1, 123]
    assert plast.tolist() == [-1, 456]
    assert best.dtype == pfirst.dtype == torch.int32
    assert best.is_contiguous() and plast.is_contiguous()
    assert ck._unpack_keys(keys[:1])[1].tolist() == [-1, 123]


@pytest.mark.parametrize("nw,hin0,core", [
    (1, 0, 1), (1, 0, 9), (2, 0, 40), (3, 0, 5), (9, 0, 4), (1, 1, 3),
    (3, 1, 11), (9, 1, 7)])
def test_split_reduce_matches_sweep_scores_windows(rng, nw, hin0, core):
    """The emulated K1 schedule (random Peq words, forced cores of 1-40
    columns, the edge lanes) == the JAX scan engine's score streams reduced
    over each window, lanes reaching their rows by index."""
    B, T, S1, R = 70, 130, 5, 4
    peq = _words(rng, (3, S1, nw))
    rows = rng.randint(0, S1, (R, T)).astype(np.int32)
    prow = rng.randint(0, 3, B).astype(np.int32)
    trow = rng.randint(0, R, B).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(peq.view(np.uint32)[prow]), jnp.asarray(rows[trow]),
        hin0=hin0))
    want = _window_reduce(scores, lo, hi)
    got = ck.split_reduce_plain(_t(peq), _t(rows), _t(lo), _t(hi), _t(prow),
                                _t(trow), hin0, core=core)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("nw,hin0,core", [(1, 0, 1), (2, 0, 13), (3, 0, 40),
                                          (2, 1, 6)])
def test_split_reduce_matches_pallas_interpret(rng, nw, hin0, core):
    """The emulated K1 schedule == pallas_kernel.reduce_flat_device in
    interpret mode, one row a lane, padded to the chunk grain as the JAX
    wrapper pads it (a window reaching past T scans the filler)."""
    B, T, S1, chunk = 40, 90, 5, 32
    peq = _words(rng, (B, S1, nw))
    tg = rng.randint(0, S1, (B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    want = pk.reduce_flat_device(jnp.asarray(peq.view(np.uint32)),
                                 jnp.asarray(tg), jnp.asarray(lo),
                                 jnp.asarray(hi), hin0=hin0, chunk=chunk,
                                 interpret=True)
    rows = torch.arange(B, dtype=torch.int32)
    got = ck.split_reduce_plain(_t(peq), ck._pad_cols(_t(tg), S1 - 1, chunk),
                                _t(lo), _t(hi), rows, rows, hin0, core=core)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("nw,hin0,core,col_lo,col_hi", [
    (1, 0, 1, 7, 121), (2, 0, 9, 0, 128), (3, 0, 40, 33, 100),
    (2, 1, 4, 7, 121)])
def test_split_shared_matches_pallas_interpret(rng, nw, hin0, core, col_lo,
                                               col_hi):
    """The emulated K2 schedule == pallas_kernel.sweep_best_pallas_shared in
    interpret mode on a tiled target (exact repeats tie first positions
    across cores), read-built and random profiles."""
    B, sigma, chunk = 30, 4, 32
    base = rng.randint(0, sigma, 32)
    target = np.concatenate([base, base, base, base]).astype(np.int32)
    T = target.shape[0]
    q = base[(rng.randint(0, 8, B)[:, None]
              + np.arange(nw * 32 - 8)[None, :]) % 32]
    peq = np.array(pk.build_peq_device(
        jnp.asarray(q.astype(np.int32)),
        jnp.full((B,), q.shape[1], jnp.int32), sigma, nw))
    peq[B // 2:] = _words(rng, (B - B // 2, sigma + 1, nw)).view(np.uint32)
    peq_tiles = pk.pack_tiles_device(jnp.concatenate([
        jnp.asarray(peq), jnp.full((pk.B_TILE - B, sigma + 1, nw),
                                   0xFFFFFFFF, jnp.uint32)]))
    wb, wp = pk.sweep_best_pallas_shared(
        peq_tiles, jnp.asarray(target.reshape(T // chunk, 1, chunk)),
        hin0=hin0, col_lo=col_lo, col_hi=col_hi, chunk=chunk, interpret=True)
    peq_t = convert.bit_words(peq).permute(1, 2, 0).contiguous()
    best, pos = ck.split_shared_plain(peq_t, _t(target), hin0, col_lo,
                                      col_hi, core=core)
    np.testing.assert_array_equal(best.numpy(), np.asarray(wb).reshape(-1)[:B])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wp).reshape(-1)[:B])
    assert torch.equal(best, ck.sweep_shared_plain(peq_t, _t(target), hin0,
                                                   col_lo, col_hi)[0])


@pytest.mark.parametrize("nw", [1, 9])
def test_split_shared_matches_sweep_scores(rng, nw):
    """The emulated K2 schedule at 1 and 9 words (9: one core a lane) ==
    the JAX scan engine over one window inside the target."""
    B, T, S1 = 12, 200, 5
    peq = _words(rng, (B, S1, nw))
    target = rng.randint(0, S1, T).astype(np.int32)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(peq.view(np.uint32)),
        jnp.asarray(np.broadcast_to(target, (B, T))), hin0=0))
    col_lo, col_hi = 45, 171
    want = _window_reduce(scores, np.full(B, col_lo), np.full(B, col_hi))
    best, pos = ck.split_shared_plain(_t(peq).permute(1, 2, 0).contiguous(),
                                      _t(target), 0, col_lo, col_hi, core=3)
    np.testing.assert_array_equal(best.numpy(), want[0])
    np.testing.assert_array_equal(pos.numpy(), want[1])


def test_short_halo_would_change_the_answer(monkeypatch):
    """A fixed case that a halo of R/2 gets wrong: a 32-bp read planted in
    its target with an insertion after about every other symbol, so its
    best alignment spans past R + R/2 columns.  The planned halo (2R) gives
    the full sweep's answer."""
    rng = np.random.RandomState(0)
    q = rng.randint(0, 4, 32).astype(np.int32)
    t = list(rng.randint(0, 4, 40))
    for ch in q:
        t.append(ch)
        if rng.rand() < 0.5:
            t.append(rng.randint(0, 4))
    t += list(rng.randint(0, 4, 20))
    peq = ck.build_peq_device(_t(q[None]), _t([32]), 4, 1)
    tg = _t(np.asarray(t)[None])
    lanes = (_t([0]), _t([tg.shape[1]]), _t([0]), _t([0]))
    want = [w.tolist() for w in ck.reduce_lanes_plain(peq, tg, *lanes, 0)]
    assert want == [[10], [80], [80], [19]]
    got = ck.split_reduce_plain(peq, tg, *lanes, 0, core=4)
    assert [g.tolist() for g in got] == want
    monkeypatch.setattr(ck, "split_halo", lambda n_words: n_words * 16)
    short = ck.split_reduce_plain(peq, tg, *lanes, 0, core=4)
    assert [g.tolist() for g in short] != want
