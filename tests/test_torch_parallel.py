"""edlib_tpu_torch.parallel, align_batch(mesh=) and map_reads(mesh=) against
edlib_tpu on its 8-device CPU mesh.

The port's grid here is eight CPU devices in the mesh's (dp, sp) shape
(convert.grid_from_mesh), so every shard runs the kernels' plain PyTorch
versions; the JAX package's mesh functions run their XLA engine.  The
resumable reduce's plain version is held against the Pallas kernel in
interpret mode, state for state.  Inputs come from a numpy seed; every
output is an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edlib_tpu
import edlib_tpu.parallel as jpar
import edlib_tpu_torch
import edlib_tpu_torch.parallel as tpar
from edlib_tpu import encode as jenc
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch import mapping as tmap
from edlib_tpu_torch.ops import cuda_kernel as ck

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

SIGMA = 4
CPU8 = ["cpu"] * 8


def _meshes(dp, sp):
    mesh = jpar.make_alignment_mesh(8, dp=dp, sp=sp)
    return mesh, convert.grid_from_mesh(mesh, CPU8)


def _np(x):
    return None if x is None else np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x)


def _bits_equal(got, want):
    """Port int32 bit words against JAX uint32 (or any integer) arrays."""
    want = np.asarray(want)
    got = _np(got)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _profiles(rng, qlens, nw, null_row=False):
    """Identity profiles of random queries: uint32 (B, S1[+1], NW), the
    wildcard row at SIGMA (and a NULL row after it)."""
    eq = np.eye(SIGMA, dtype=bool)
    qs = [rng.randint(0, SIGMA, ql).astype(np.uint8) for ql in qlens]
    peq = np.zeros((len(qs), SIGMA + 1 + null_row, nw), np.uint32)
    for b, q in enumerate(qs):
        peq[b, :SIGMA + 1] = jenc.build_peq_words(q, eq, n_words=nw)
    return qs, peq


def _plant(rng, target, qs, every=2):
    for b in range(0, len(qs), every):
        s = rng.randint(0, len(target) - len(qs[b]))
        target[s:s + len(qs[b])] = qs[b]


# --------------------------------------------------------------------------
# The grid and the host helpers
# --------------------------------------------------------------------------


def test_grid_factorisation_matches_jax():
    for n in range(1, 9):
        for kw in ({}, {"dp": 1}, {"sp": 1}, {"dp": n}, {"sp": 2}):
            try:
                want = jpar.make_alignment_mesh(n, **kw)
            except AssertionError:
                with pytest.raises(ValueError, match="dp\\*sp"):
                    tpar.make_alignment_mesh(n, devices=CPU8, **kw)
                continue
            got = tpar.make_alignment_mesh(n, devices=CPU8, **kw)
            assert got.shape == dict(zip(want.axis_names,
                                         want.devices.shape))
            assert got.axis_names == tuple(want.axis_names)
            assert got.size == n
    grid = tpar.make_alignment_mesh(devices=[torch.device("cpu")] * 4)
    assert grid.shape == {"dp": 2, "sp": 2}
    assert all(d == torch.device("cpu") for d in grid.devices.flat)
    with pytest.raises(ValueError):
        tpar.make_alignment_mesh(8, dp=3, devices=CPU8)


def test_grid_errors(monkeypatch):
    grid = tpar.make_alignment_mesh(devices=CPU8)
    peq = np.zeros((2, SIGMA + 1, 1), np.uint32)
    tg = np.zeros((2, 32), np.int32)
    with pytest.raises(ValueError, match="interpret"):
        tpar.sharded_reduce_dp(grid, peq, tg, np.zeros(2), np.ones(2), 0,
                               engine="interpret")
    with pytest.raises(ValueError, match="unknown engine"):
        tpar.sharded_reduce_dp(grid, peq, tg, np.zeros(2), np.ones(2), 0,
                               engine="tpu")
    with pytest.raises(TypeError, match="DeviceGrid"):
        edlib_tpu_torch.align_batch([b"ACG"], b"ACGT", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_alignment_mesh()


def test_parallel_names_cover_jax():
    assert set(edlib_tpu.parallel.__all__) <= set(tpar.__all__)


def test_host_helpers_match_jax(rng):
    t = rng.randint(0, SIGMA, 701).astype(np.int32)
    for n_shards, halo, w_pad, cm in ((4, 95, 16, 1), (2, 77, 3, 32),
                                      (8, 10, 0, 32)):
        got = tpar.shard_target_slices(t, SIGMA, n_shards, halo, w_pad, cm)
        want = jpar.shard_target_slices(t, SIGMA, n_shards, halo, w_pad, cm)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for n_shards, w_max in ((8, 34), (3, 0), (5, 100)):
        got = tpar.split_target_segments(t, SIGMA, n_shards, w_max)
        want = jpar.split_target_segments(t, SIGMA, n_shards, w_max)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_carry_conversion_round_trips(rng):
    B, nw = 5, 3
    state = (rng.randint(0, 1 << 32, (nw, B), dtype=np.uint64)
             .astype(np.uint32),
             rng.randint(0, 1 << 32, (nw, B), dtype=np.uint64)
             .astype(np.uint32),
             rng.randint(0, 500, B).astype(np.int32))
    port = convert.carry_from_jax(state)
    assert tuple(port[0].shape) == (B, nw)
    for a, b in zip(convert.carry_to_jax(port), state):
        np.testing.assert_array_equal(a, b)
    kernel = tuple(x.T if x.ndim == 2 else x for x in state)
    for a, b in zip(convert.carry_from_jax(kernel, "kernel"), port):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The resumable kernels' plain versions
# --------------------------------------------------------------------------


def _random_state(rng, B, nw):
    pv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(np.uint32)
    mv = rng.randint(0, 1 << 32, (B, nw), dtype=np.uint64).astype(
        np.uint32) & ~pv
    return pv, mv, rng.randint(0, 400, B).astype(np.int32)


@pytest.mark.parametrize("nw,shared,hin0", [(1, False, 0), (2, True, 1),
                                            (4, False, 1), (2, True, 0)])
def test_reduce_resume_plain_matches_pallas_interpret(nw, shared, hin0):
    """Output for output and state for state, from a random carried state,
    windows reaching past the segment and ending before it."""
    rng = np.random.RandomState(nw + 10 * hin0)
    B, T = 37, 128
    peq = rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (T,) if shared else (B, T)).astype(
        np.int32)
    lo = rng.randint(0, T, B).astype(np.int32)
    hi = (lo + rng.randint(0, 2 * T, B)).astype(np.int32)
    state = _random_state(rng, B, nw)
    want = pk.reduce_resumable_flat_device(
        *(jnp.asarray(a) for a in (peq, tg, lo, hi) + state), hin0=hin0,
        chunk=32, interpret=True)
    got = ck.reduce_resumable_flat_device(
        convert.bit_words(peq), torch.from_numpy(tg), torch.from_numpy(lo),
        torch.from_numpy(hi), *convert.carry_from_jax(state, "kernel"), hin0)
    for g, w in zip(got, want):
        _bits_equal(g, w)


@pytest.mark.parametrize("shared", [False, True])
def test_reduce_resume_chain_equals_one_sweep(rng, shared):
    """Two chained segments (the second ragged) equal one reduce_lanes
    sweep of their concatenation, and its state."""
    B, nw, T, cut = 40, 2, 203, 102
    peq = convert.bit_words(rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                                        dtype=np.uint64).astype(np.uint32))
    tg = torch.from_numpy(rng.randint(0, SIGMA + 1, (1 if shared else B, T))
                          .astype(np.int32))
    lo = torch.from_numpy(rng.randint(0, T, B).astype(np.int32))
    hi = torch.clamp(lo + torch.from_numpy(rng.randint(1, T, B).astype(
        np.int32)), max=T)
    rows = torch.arange(B, dtype=torch.int32)
    trow = torch.zeros(B, dtype=torch.int32) if shared else rows
    fresh = (torch.full((B, nw), -1, dtype=torch.int32),
             torch.zeros((B, nw), dtype=torch.int32),
             torch.full((B,), nw * 32, dtype=torch.int32))
    seg = [tg[:, :cut].contiguous(), tg[:, cut:].contiguous()]
    r1 = ck.reduce_resume(peq, seg[0], lo.clamp(max=cut), hi.clamp(max=cut),
                          rows, trow, *fresh, 1)
    r2 = ck.reduce_resume(peq, seg[1], (lo - cut).clamp(min=0),
                          (hi - cut).clamp(min=0), rows, trow, *r1[4:], 1)
    merged = tpar.dist.merge_segments([r1[:4], r2[:4]], cut, hi)
    want = ck.reduce_lanes(peq, tg, lo, hi, rows, trow, 1)
    for g, w in zip(merged, want):
        assert torch.equal(g, w)
    whole = ck.reduce_resume(peq, tg, lo, hi, rows, trow, *fresh, 1)
    for g, w in zip(r2[4:], whole[4:]):
        assert torch.equal(g, w)


def test_sweep_scores_resume_plain_matches_jax(rng):
    B, nw, T = 6, 3, 90
    peq = rng.randint(0, 1 << 32, (B, SIGMA + 1, nw),
                      dtype=np.uint64).astype(np.uint32)
    tg = rng.randint(0, SIGMA + 1, (B, T)).astype(np.int32)
    state = (np.asarray(x) for x in jax_engine.initial_state(B, nw))
    state = tuple(state)
    rows = torch.arange(B, dtype=torch.int32)
    carry = convert.carry_from_jax(state)
    for a, b in ((0, 41), (41, T)):
        want, state = jax_engine.sweep_scores_resumable(
            peq, tg[:, a:b], state, hin0=1)
        got, *carry = ck.sweep_scores_resume(
            convert.bit_words(peq), torch.from_numpy(tg[:, a:b].copy()),
            rows, rows, *carry, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for g, w in zip(convert.carry_to_jax(carry), state):
            np.testing.assert_array_equal(g, np.asarray(w))


# --------------------------------------------------------------------------
# dist / pipeline functions against their namesakes on the mesh
# --------------------------------------------------------------------------


def test_sharded_sweep_dp_matches_jax(rng):
    mesh, grid = _meshes(8, 1)
    B, nw, T = 16, 2, 128
    _, peq = _profiles(rng, [50] * B, nw)
    tg = np.full((B, T), SIGMA, np.int32)
    tg[:, :100] = rng.randint(0, SIGMA, (B, 100))
    got = tpar.sharded_sweep_dp(grid, peq, tg, hin0=1)
    want = jpar.sharded_sweep_dp(mesh, peq, tg, hin0=1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("want_hits", [False, True])
def test_sharded_reduce_dp_matches_jax(rng, want_hits):
    mesh, grid = _meshes(2, 4)
    B, nw, T = 16, 2, 160
    qlens = [40 + i for i in range(B)]
    _, peq = _profiles(rng, qlens, nw)
    targets = np.full((B, T), SIGMA, np.int32)
    lo = np.zeros(B, np.int64)
    hi = np.zeros(B, np.int64)
    for b in range(B):
        t = rng.randint(0, SIGMA, 100 + b)
        targets[b, :len(t)] = t
        lo[b] = nw * 32 - qlens[b]
        hi[b] = lo[b] + len(t)
    got = tpar.sharded_reduce_dp(grid, peq, targets, lo, hi, 0,
                                 want_hits=want_hits)
    want = jpar.sharded_reduce_dp(mesh, peq, targets, lo, hi, 0,
                                  want_hits=want_hits)
    assert (got[4] is None) == (not want_hits)
    for g, w in zip(got, want):
        if w is not None:
            _bits_equal(g, w)


@pytest.mark.parametrize("want_hits", [False, True])
def test_sharded_hw_locations_matches_jax(rng, want_hits):
    """Mixed w_lanes, planted matches, the halo word-aligned."""
    mesh, grid = _meshes(2, 4)
    B, nw = 8, 2
    qlens = [40 + 2 * i for i in range(B)]
    qs, peq = _profiles(rng, qlens, nw, null_row=True)
    w_lanes = np.array([nw * 32 - q for q in qlens], np.int32)
    t_ids = rng.randint(0, SIGMA, 1000).astype(np.int32)
    _plant(rng, t_ids, qs)
    w_max = int(w_lanes.max())
    halo = 2 * max(qlens) - 1
    halo += (-(halo + w_max)) % 32
    slices, _ = jpar.shard_target_slices(t_ids, SIGMA, 4, halo, w_max,
                                         c_multiple=32)
    args = (peq, slices, halo, w_max, len(t_ids))
    got = tpar.sharded_hw_locations(grid, *args, w_lanes=w_lanes,
                                    want_hits=want_hits)
    want = jpar.sharded_hw_locations(mesh, *args, w_lanes=w_lanes,
                                     want_hits=want_hits)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _bits_equal(g, w)
    with pytest.raises(ValueError, match="multiple of 32"):
        tpar.sharded_hw_locations(grid, peq, slices[:, :-1], halo, w_max,
                                  len(t_ids))
    with pytest.raises(ValueError, match="halo"):
        tpar.sharded_hw_locations(grid, peq, slices[:, 1:], halo - 1, w_max,
                                  len(t_ids))


def test_sharded_hw_search_matches_jax(rng):
    """best exactly; core scores equal wherever they are <= k_eff."""
    mesh, grid = _meshes(2, 4)
    B, qlen = 8, 48
    qs, peq = _profiles(rng, [qlen] * B, 2, null_row=True)
    w_pad = 64 - qlen
    halo = 2 * qlen - 1
    target = rng.randint(0, SIGMA, 701).astype(np.int32)
    target[300:300 + qlen] = qs[0]
    slices, _ = jpar.shard_target_slices(target, SIGMA, 4, halo, w_pad)
    best, cores = tpar.sharded_hw_search(grid, peq, slices, halo, w_pad, qlen)
    wbest, wcores = jpar.sharded_hw_search(mesh, peq, slices, halo, w_pad,
                                           qlen)
    np.testing.assert_array_equal(_np(best), np.asarray(wbest))
    cores, wcores = _np(cores), np.asarray(wcores)
    assert cores.shape == wcores.shape
    exact = wcores <= qlen
    np.testing.assert_array_equal(cores[exact], wcores[exact])
    assert int(best[0]) == 0


def test_sharded_nw_pipeline_matches_jax(rng):
    B, qlen, T = 4, 70, 333
    qs, peq = _profiles(rng, [qlen] * B, 3)
    target = rng.randint(0, SIGMA, T).astype(np.int32)
    mesh, grid = _meshes(2, 4)
    cores, C = tpar.sharded_nw_pipeline(grid, peq, target, qlen)
    wcores, wC = jpar.sharded_nw_pipeline(mesh, peq, target, qlen)
    assert C == wC
    np.testing.assert_array_equal(_np(cores), np.asarray(wcores))


@pytest.mark.parametrize("hin0", [0, 1])
def test_pipelined_sweep_summaries_matches_jax(hin0):
    rng = np.random.RandomState(4)
    qlens = [30, 32, 45, 64]
    nw = 2
    T = 530
    target = rng.randint(0, SIGMA, T).astype(np.int32)
    peq = np.stack([_profiles(rng, qlens, nw)[1] for _ in range(2)])
    lo = np.array([[nw * 32 - q for q in qlens]] * 2, np.int32)
    hi = lo + T
    mesh, grid = _meshes(1, 8)
    segs, _ = jpar.split_target_segments(target, SIGMA, 8, int(lo.max()))
    got = tpar.pipelined_sweep_summaries(grid, peq, segs, lo, hi, hin0=hin0)
    want = jpar.pipelined_sweep_summaries(mesh, peq, segs, lo, hi, hin0=hin0)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("hin0", [0, 1])
@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_reduce_pipeline_matches_jax(hin0, sp):
    """Windows ending mid-shard, minima straddling shard boundaries."""
    rng = np.random.RandomState(21 + sp)
    B, nw, qlen, T = 8, 2, 50, 700
    qs, peq = _profiles(rng, [qlen] * B, nw)
    t_ids = rng.randint(0, SIGMA, T).astype(np.int32)
    for b in range(0, B, 2):
        s = min(170 * (b // 2 + 1) - qlen // 2, T - qlen)
        t_ids[s:s + qlen] = qs[b]
    w = nw * 32 - qlen
    lo = np.full(B, w, np.int64)
    hi = np.array([w + T - 37 * b for b in range(B)], np.int64)
    mesh, grid = _meshes(8 // sp, sp)
    got = tpar.sharded_reduce_pipeline(grid, peq, t_ids, qlen, lo, hi,
                                       hin0=hin0)
    want = jpar.sharded_reduce_pipeline(mesh, peq, t_ids, qlen, lo, hi,
                                        hin0=hin0)
    for g, x in zip(got, want):
        _bits_equal(g, x)


# --------------------------------------------------------------------------
# align_batch(mesh=) and map_reads(mesh=)
# --------------------------------------------------------------------------


def _mutate(rng, s, rate=0.1):
    out = bytearray()
    for c in s:
        r = rng.rand()
        if r < rate * 0.4:
            continue
        out.append(rng.choice(list(b"ACGT")) if r < rate * 0.7 else c)
    return bytes(out)


@pytest.fixture(scope="module")
def workload():
    rng = np.random.RandomState(9)
    target = bytes(rng.choice(list(b"ACGT"), 700).tolist())
    reads = []
    for _ in range(12):
        start = rng.randint(0, 600)
        reads.append(_mutate(rng, target[start:start + 40 + rng.randint(20)]))
    reads.append(bytes(rng.choice(list(b"ACGT"), 50).tolist()))
    return reads, target


@pytest.mark.parametrize("task", ["distance", "locations", "path"])
def test_align_batch_mesh_hw_shared(workload, task):
    reads, target = workload
    mesh, grid = _meshes(2, 4)
    got = edlib_tpu_torch.align_batch(reads, target, mode="HW", task=task,
                                      mesh=grid)
    assert got == edlib_tpu.align_batch(reads, target, mode="HW", task=task,
                                        mesh=mesh)
    assert got == edlib_tpu_torch.align_batch(reads, target, mode="HW",
                                              task=task, device="cpu")


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_align_batch_mesh_dp(workload, monkeypatch, mode):
    rng = np.random.RandomState(3)
    reads, _ = workload
    targets = [bytes(rng.choice(list(b"ACGT"), 300).tolist())
               for _ in reads]
    mesh, grid = _meshes(4, 2)
    calls = []
    orig = tpar.dist.sharded_reduce_dp
    monkeypatch.setattr(tpar.dist, "sharded_reduce_dp",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    got = edlib_tpu_torch.align_batch(reads, targets, mode=mode,
                                      task="locations", mesh=grid)
    assert calls, "the data-parallel route did not run"
    assert got == edlib_tpu.align_batch(reads, targets, mode=mode,
                                        task="locations", mesh=mesh)
    assert got == edlib_tpu_torch.align_batch(reads, targets, mode=mode,
                                              task="locations", device="cpu")


def test_map_reads_mesh(workload):
    reads, target = workload
    mesh, grid = _meshes(2, 4)
    got = edlib_tpu_torch.map_reads(reads, target, mode="HW", mesh=grid)
    want = edlib_tpu.map_reads(reads, target, mode="HW", mesh=mesh)
    plain = edlib_tpu_torch.map_reads(reads, target, mode="HW", device="cpu")
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def test_map_reads_filter_over_grid_equals_no_grid(rng, monkeypatch):
    """The filtered body with the reads sharded over a CPU grid equals the
    same body on one device (the stragglers on the shared sweep)."""
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    monkeypatch.setenv("EDLIB_TPU_QFILTER_MAXC", "1")
    tb = rng.randint(0, SIGMA, 6000).astype(np.int32)
    reads = []
    for i in range(12):
        s = rng.randint(0, 5900)
        r = tb[s:s + 80].copy()
        muts = rng.rand(80) < 0.08
        r[muts] = rng.randint(0, SIGMA, muts.sum())
        reads.append(r)
    letters = np.frombuffer(b"ACGT", np.uint8)
    target = letters[tb].tobytes()
    # Reads with many passing windows each: stragglers under maxc = 1.
    read_b = [letters[r].tobytes() for r in reads] + [b"ACGT" * 20,
                                                      b"AAAA" * 20] * 2
    read_ids, t_ids, sigma, flat, t_key = tmap._prep(read_b, target)
    dev = torch.device("cpu")
    grid = tpar.make_alignment_mesh(devices=CPU8)
    shared = []
    orig = tmap._sweep_reads_shared
    monkeypatch.setattr(tmap, "_sweep_reads_shared",
                        lambda r, *a: shared.append(len(r)) or orig(r, *a))
    got = tmap._map_reads_filtered(read_ids, t_ids, t_key, sigma, -1, dev,
                                   flat, grid=grid)
    assert shared, "the grid's stragglers skipped the shared sweep"
    want = tmap._map_reads_filtered(read_ids, t_ids, t_key, sigma, -1, dev,
                                    flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
