"""The redesigned K3 (reduce_bitplane) and banded wavefront schedules on
the CPU, against the JAX package.

K3 at 1-8 words takes K1's split-lane plan (ops/cuda_kernel.split_core):
its plain emulation (split_bitplane_plain: every (lane, core) swept by
the bit-plane reduce from the fresh state, merged by packed keys) against
reduce_bitplane_plain, the JAX scan engine and
pallas_kernel.reduce_flat_device_bitplane in interpret mode; and the
profile its kernel expands in shared memory (bitplane_profile) against
the JAX profile builder.  The banded wavefront runs word-pipelined tiles of
32 columns (wavefront_banded_tiles_plain, the kernel's schedule thread by
thread) against the step-by-step plain version and
wavefront._wfb_call in interpret mode.  The kernels follow the same plans
on the card, where chip_smoke.py holds them against their plain versions.
Every output is an integer, so every comparison is exact; inputs come from
numpy with a fixed seed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu import encode as jenc
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu.ops import wavefront as jwf
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops.wavefront import initial_state

BIG = 0x3FFFFFFF
SIGMA = 100


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _edge_windows(rng, B, T):
    """lo/hi with the split kernels' edge lanes: hi = 0, an empty window
    (hi - 1 < lo), lo past hi, hi past T, both past T, and windows inside
    the row."""
    lo = rng.randint(0, T // 2, B)
    hi = np.minimum(lo + rng.randint(1, T + 1, B), T)
    hi[0::7] = 0
    hi[1::7] = lo[1::7]
    lo[2::7] = hi[2::7] + 3
    hi[3::7] = T + 1 + rng.randint(0, 20, len(hi[3::7]))
    lo[4::7], hi[4::7] = T + 2, T + 9
    return lo.astype(np.int32), hi.astype(np.int32)


def _bitplane_operands(rng, B, nw, n_alts, sigma=SIGMA):
    """(q_alts (B, E, NW*32), pad_words (B, NW)) of B reads of ragged
    lengths: the first alternative the read, the others a random partner
    in 30% of the rows, else the sentinel (no alternative)."""
    qmax = nw * 32
    q = rng.randint(0, sigma, (B, qmax)).astype(np.int32)
    qlens = rng.randint(1, qmax + 1, B).astype(np.int32)
    qlens[0] = qmax
    qa, pw = ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw)
    nb = ck.bitplane_nb(sigma)
    extra = [np.where(rng.rand(B, 1, qmax) < 0.3,
                      rng.randint(0, sigma, (B, 1, qmax)), (1 << nb) - 1)
             for _ in range(n_alts - 1)]
    qa = np.concatenate([qa.numpy()] + extra, 1).astype(np.int32)
    return qa, pw.numpy()


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


# --------------------------------------------------------------------------
# K3: the split-lane plan with bit-plane Eq
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nw,hin0,n_alts", [
    (1, 0, 1), (4, 0, 2), (8, 0, 1), (4, 1, 1), (8, 1, 2)])
def test_bitplane_profile_matches_eq_of_every_symbol(rng, nw, hin0, n_alts):
    """The profile K3 expands in shared memory (2^nb symbols x NW words a
    row) == Eq built from the alternatives directly: row i matches symbol
    s where it is a pad row, s is the wildcard, or some alternative id of
    row i has s's low nb bits."""
    B = 6
    nb = ck.bitplane_nb(SIGMA)
    qa, pw = _bitplane_operands(rng, B, nw, n_alts)
    prof = ck.bitplane_profile(ck.bitplane_planes(_t(qa), nb), _t(pw), nb,
                               n_alts, SIGMA).numpy().view(np.uint32)
    assert prof.shape == (B, 1 << nb, nw)
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for s in range(1 << nb):
        match = ((qa & ((1 << nb) - 1)) == s).any(1)           # (B, R)
        match |= ((pw.view(np.uint32)[:, :, None].astype(np.uint64)
                   & bits) > 0).reshape(B, -1)
        if s == SIGMA:
            match[:] = True
        want = (match.reshape(B, nw, 32) * bits).sum(2).astype(np.uint32)
        np.testing.assert_array_equal(prof[:, s], want, err_msg=f"sym {s}")


def test_bitplane_profile_matches_jax_profile(rng):
    """For identity operands the expanded profile's rows [0, sigma] are
    pallas_kernel.build_peq_device's profile (the wildcard row all ones),
    and the rows past sigma match the pad rows only."""
    B, nw, sigma = 5, 4, 40
    q = rng.randint(0, sigma, (B, nw * 32)).astype(np.int32)
    qlens = rng.randint(1, nw * 32 + 1, B).astype(np.int32)
    nb = ck.bitplane_nb(sigma)
    qa, pw = ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw)
    prof = ck.bitplane_profile(ck.bitplane_planes(qa, nb), pw, nb, 1,
                               sigma).numpy().view(np.uint32)
    want = np.asarray(pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens),
                                          sigma, nw))
    np.testing.assert_array_equal(prof[:, :sigma + 1], want)
    np.testing.assert_array_equal(
        prof[:, sigma + 1:],
        np.broadcast_to(pw.numpy().view(np.uint32)[:, None],
                        (B, (1 << nb) - sigma - 1, nw)))


def test_bitplane_plan_keeps_hin1_and_wide_lanes_whole():
    """The plan K3 shares with K1: a forced core splits HW lanes of 1-8
    words; hin0 = 1 and lanes past 8 words stay one core a lane."""
    T = 251
    for nw in (1, 4, 8):
        assert ck.split_core(300, T, nw, 0, core=3) == 3
        assert ck.split_core(300, T, nw, 1, core=3) == T
    assert ck.split_core(300, T, 9, 0, core=3) == T
    assert ck.split_core(4096, 16_631, 4, 0) == 4 * ck.split_halo(4)


@pytest.mark.parametrize("nw,hin0,n_alts,core", [
    (1, 0, 1, 1), (1, 0, 2, 40), (4, 0, 1, 7), (4, 0, 2, 1), (4, 1, 2, 7),
    (8, 0, 1, 40), (8, 0, 2, 7), (8, 1, 1, 1)])
def test_split_bitplane_matches_plain_and_sweep_scores(rng, nw, hin0, n_alts,
                                                       core):
    """The emulated K3 schedule (forced cores, the edge lanes, targets
    holding the wildcard and the symbol past it, lanes reaching their rows
    by index) == reduce_bitplane_plain == the JAX scan engine over the
    expanded profile, each window reduced in numpy."""
    B, T, R = 60, 140, 4
    nb = ck.bitplane_nb(SIGMA)
    qa, pw = _bitplane_operands(rng, 5, nw, n_alts)
    planes = ck.bitplane_planes(_t(qa), nb)
    rows = rng.randint(0, SIGMA + 2, (R, T)).astype(np.int32)
    prow = np.sort(rng.randint(0, 5, B)).astype(np.int32)
    trow = rng.randint(0, R, B).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    ops = (planes, _t(pw), _t(rows), _t(lo), _t(hi), _t(prow), _t(trow),
           hin0, nb, n_alts, SIGMA)
    got = ck.split_bitplane_plain(*ops, core=core)
    plain = ck.reduce_bitplane_plain(*ops)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    prof = ck.bitplane_profile(planes, _t(pw), nb, n_alts, SIGMA)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(prof.numpy().view(np.uint32)[prow]),
        jnp.asarray(rows[trow]), hin0=hin0))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                  _window_reduce(scores, lo, hi))


@pytest.mark.parametrize("nw,hin0,n_alts,core", [
    (1, 0, 1, 1), (1, 0, 2, 7), (1, 1, 1, 40), (4, 0, 1, 40),
    (4, 1, 2, 7)])
def test_split_bitplane_matches_pallas_interpret(rng, nw, hin0, n_alts,
                                                 core):
    """The emulated K3 schedule == pallas_kernel.reduce_flat_device_bitplane
    in interpret mode, one row a lane, padded to the chunk grain as the JAX
    wrapper pads it, with two alternatives and the wildcard in the
    targets."""
    B, T, chunk = 30, 90, 32
    nb = ck.bitplane_nb(SIGMA)
    qa, pw = _bitplane_operands(rng, B, nw, n_alts)
    tg = rng.randint(0, SIGMA + 1, (B, T)).astype(np.int32)
    lo, hi = _edge_windows(rng, B, T)
    want = pk.reduce_flat_device_bitplane(
        jnp.asarray(qa), jnp.asarray(pw.view(np.uint32)), jnp.asarray(tg),
        jnp.asarray(lo), jnp.asarray(hi), hin0=hin0, sigma=SIGMA,
        chunk=chunk, interpret=True)
    rows = torch.arange(B, dtype=torch.int32)
    got = ck.split_bitplane_plain(
        ck.bitplane_planes(_t(qa), nb), _t(pw),
        ck._pad_cols(_t(tg), SIGMA, chunk), _t(lo), _t(hi), rows, rows, hin0,
        nb, n_alts, SIGMA, core=core)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# The banded wavefront's tile schedule
# --------------------------------------------------------------------------


def _wf_operands(rng, n_words, t_scan, s1=5):
    t = _t(rng.randint(0, s1, t_scan))
    peq = _t(rng.randint(0, 1 << 32, (s1, n_words), dtype=np.uint64)
             .astype(np.uint32).view(np.int32))
    return t, peq


def test_banded_form_rule():
    """The banded entry runs the tiles from 6,144 steps a segment up to
    4,096 slots, else a step a barrier (the block forms, and the
    cooperative grid past 4,096 slots): the long ladder's 65,536- and
    32,768-step segments take the tiles, the landing walk's 4,096, 512
    and 64 a step a barrier."""
    for ns in (128, 1024, 4096):
        assert ck.wavefront_banded_form(ns, 6144) == "tiles"
        assert ck.wavefront_banded_form(ns, 65_536) == "tiles"
        assert ck.wavefront_banded_form(ns, 32_768) == "tiles"
        for n in (6143, 4096, 512, 64):
            assert ck.wavefront_banded_form(ns, n) == "steps"
    assert ck.wavefront_banded_form(8192, 65_536) == "steps"


@pytest.mark.parametrize("ns,n_words,lo,cols,segs", [
    # Segments that start and end mid-tile; slides inside tiles.
    (128, 160, -10, (0, 0), ((7, 161), (168, 250))),
    # The window reaches its cap (160 - 128 = 32 words) in the 2nd segment;
    # a tracked range whose ends cut tiles.
    (128, 160, -40, (37, 2001), ((0, 613), (613, 1500), (2113, 77))),
    # A window wider than the query (no slide at all), n_steps past t_scan.
    (128, 100, 0, (5, 3000), ((0, 500), (500, 3300))),
    # lo > 0 and short segments (every one shorter than a window).
    (128, 300, 12, (0, 0), ((3, 1), (4, 31), (35, 33), (68, 500))),
])
def test_tile_schedule_matches_step_plain(rng, ns, n_words, lo, cols, segs):
    """wavefront_banded_tiles_plain == wavefront_banded_plain, state for
    state, over chained segments of ragged starts and lengths."""
    t_scan = 3000
    t, peq = _wf_operands(rng, n_words, t_scan)
    got = want = initial_state(ns, "cpu")
    for d, n in segs:
        got = ck.wavefront_banded_tiles_plain(t, peq, got, d, n, n_words,
                                              t_scan, lo, *cols)
        want = ck.wavefront_banded_plain(t, peq, want, d, n, n_words, t_scan,
                                         lo, *cols)
        assert torch.equal(got, want), (d, n)


def test_tile_schedule_matches_step_plain_2048_slots(rng):
    """At 2,048 slots (the window of the widest block form but one) over a
    query that slides it, from a mid-tile step, two ragged segments."""
    ns, n_words, lo, t_scan = 2048, 2100, -30, 2600
    t, peq = _wf_operands(rng, n_words, t_scan)
    got = want = initial_state(ns, "cpu")
    for d, n in ((1001, 21), (1022, 37)):
        got = ck.wavefront_banded_tiles_plain(t, peq, got, d, n, n_words,
                                              t_scan, lo, 33, 2500)
        want = ck.wavefront_banded_plain(t, peq, want, d, n, n_words, t_scan,
                                         lo, 33, 2500)
        assert torch.equal(got, want), d
    assert (ck.wavefront_base(1058, lo, n_words - ns)
            > ck.wavefront_base(1000, lo, n_words - ns))         # it slid


@pytest.mark.parametrize("lo,cols,segs", [
    (-10, None, ((0, 301), (301, 299))),
    (-40, (30, 2000), ((0, 333), (333, 517))),
])
def test_tile_schedule_matches_pallas_interpret(rng, lo, cols, segs):
    """r_min = 1: a 128-slot window over 160 words slides every 33 steps;
    chained segments of ragged lengths (the second starts mid-tile) of
    _wfb_call in interpret mode against wavefront_banded_tiles_plain,
    state for state (the JAX state carries its symbol window, so its
    segments run from step 0)."""
    from tests.test_torch_wavefront import _similar
    q, t = _similar(rng, 160 * 32 - 7, 5200, 0.05)
    jb = jwf.BandedWavefront(seg_steps=600, interpret=True, r_min=1)
    n_words = jenc.num_words(len(q))
    peq_flat, rows_all, t_ext, state = jb._init(q, t, 4, n_words, 1)
    t_scan = len(t) + n_words * 32 - len(q)
    col_lo, col_hi = (0, 0) if cols is None else cols
    ours = convert.wavefront_state_from_jax(state)
    t_port, peq_port = _t(t_ext), convert.bit_words(peq_flat)
    for d, n in segs:
        state = jb._segment(state, d, n, peq_flat, rows_all, t_ext,
                            sigma=4, n_words=n_words, lo=lo, R=1,
                            t_scan=t_scan, col_lo=col_lo, col_hi=col_hi)
        ours = ck.wavefront_banded_tiles_plain(t_port, peq_port, ours, d, n,
                                               n_words, t_scan, lo, col_lo,
                                               col_hi)
        assert torch.equal(ours, convert.wavefront_state_from_jax(state))
    assert ck.wavefront_base(segs[-1][0] + segs[-1][1] - 1, lo,
                             n_words - 128) >= 8                  # it slid


def test_banded_forced_form_is_checked(rng):
    """wavefront_banded's form= (checks only) takes "tiles" up to 4,096
    slots or "steps"; any other form raises, on any device.  On the CPU
    both run the plain version."""
    t, peq = _wf_operands(rng, 160, 700)
    state = initial_state(128, "cpu")
    want = ck.wavefront_banded(t, peq, state, 0, 300, 160, 700, -10, 0, 0)
    for form in ("tiles", "steps"):
        got = ck.wavefront_banded(t, peq, state, 0, 300, 160, 700, -10, 0, 0,
                                  form=form)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="form"):
        ck.wavefront_banded(t, peq, state, 0, 300, 160, 700, -10, 0, 0,
                            form="diagonal")
    with pytest.raises(ValueError, match="8192 slots"):
        ck.wavefront_banded(t, peq, initial_state(8192, "cpu"), 0, 300, 160,
                            700, -10, 0, 0, form="tiles")


def test_tile_symbols_pads_to_whole_tiles(rng):
    """The tile kernel's 16-bit symbols: the scan columns, zeros up to the
    next whole tile (a target row may run past t_scan)."""
    t = _t(rng.randint(0, 300, 1000))
    for t_scan in (1, 31, 32, 33, 977):
        tt = ck.tile_symbols(t, t_scan)
        assert tt.dtype == torch.int16
        assert tt.shape[0] == -(-t_scan // ck.WF_TILE) * ck.WF_TILE
        assert torch.equal(tt[:t_scan].int(), t[:t_scan])
        assert not tt[t_scan:].any()


@pytest.mark.parametrize("entry", ["nw_distance", "shw_best",
                                   "shw_locations"])
def test_rung_log_lists_every_ladder_rung(rng, entry):
    """ops.wavefront.take_rungs: each banded run of the k ladder, in order
    (k = 64, 128, ...; every rung but the last unanswered), the steps it
    ran banded and in the pinned tail, whether the band died; the
    answering rung runs every step of the pair, and taking them clears
    the log."""
    from edlib_tpu_torch import encode
    from edlib_tpu_torch.ops import wavefront as twf
    from tests.test_torch_wavefront import _similar
    q, t = _similar(rng, 700, 760, 0.3)
    wfb = twf.BandedWavefront(seg_steps=128, r_min=1, device="cpu")
    twf.take_rungs()
    getattr(wfb, entry)(q, t, 4)
    rungs = twf.take_rungs()
    assert twf.take_rungs() == []
    assert len(rungs) >= 2
    assert [r["k"] for r in rungs[:-1]] == [64 << i for i in
                                            range(len(rungs) - 1)]
    assert [r["answered"] for r in rungs] == [False] * (len(rungs) - 1) + [
        True]
    assert {r["fn"] for r in rungs} == {
        dict(nw_distance="distance_bounded").get(entry, entry + "_bounded")}
    if entry != "shw_locations":   # its failing rungs here end unpinned
        assert any(r["died"] for r in rungs[:-1])
    last = rungs[-1]
    assert not last["died"]
    n_words = encode.num_words(len(q))
    tlen = len(t) if entry == "nw_distance" else min(len(t),
                                                     len(q) + last["k"])
    steps = tlen + n_words * 32 - len(q) + n_words - 1
    if entry == "shw_locations":
        assert last["tail_steps"] > 0
        assert last["banded_steps"] + last["tail_steps"] == steps
    else:
        assert last["tail_steps"] == 0
        assert last["banded_steps"] >= steps
