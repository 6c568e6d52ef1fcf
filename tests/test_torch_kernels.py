"""The port's Myers kernels (edlib_tpu_torch/ops/cuda_kernel.py) against the
JAX package, on the CPU.

Here the wrappers run their plain PyTorch versions (CPU tensors); the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  Every output is an integer, so every comparison is exact
equality.  Inputs come from numpy with a fixed seed and go to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from edlib_tpu import encode as jenc
from edlib_tpu.ops import jax_engine
from edlib_tpu.ops import pallas_kernel as pk
from edlib_tpu_torch import convert
from edlib_tpu_torch import encode as tenc
from edlib_tpu_torch.ops import _build
from edlib_tpu_torch.ops import cuda_kernel as ck

BIG = 0x3FFFFFFF


def _reads(rng, B, qmax, sigma, qmin=1):
    q = rng.randint(0, sigma, (B, qmax)).astype(np.int32)
    qlens = rng.randint(qmin, qmax + 1, B).astype(np.int32)
    qlens[0] = qmax
    return q, qlens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.int32 \
        else np.asarray(x, np.uint32)


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


def _windows(rng, B, T):
    lo = rng.randint(0, T // 2, B).astype(np.int32)
    hi = (lo + rng.randint(1, T, B)).clip(max=T).astype(np.int32)
    hi[-1] = 0                                       # a pad lane: no columns
    return lo, hi


@pytest.mark.parametrize("qmax,sigma", [(20, 4), (64, 4), (90, 7), (33, 100)])
def test_build_peq_device_matches_jax(rng, qmax, sigma):
    nw = -(-qmax // 32)
    q, qlens = _reads(rng, 5, qmax, sigma)
    want = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    got = ck.build_peq_device(_t(q), _t(qlens), sigma, nw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got.numpy()), np.asarray(want))


@pytest.mark.parametrize("qlen,sigma,nw", [(0, 4, None), (31, 4, None),
                                           (64, 5, None), (40, 20, 3)])
def test_host_profile_words_match_jax(rng, qlen, sigma, nw):
    q = rng.randint(0, sigma, qlen).astype(np.uint8)
    eq = rng.rand(sigma, sigma) < 0.3
    eq |= np.eye(sigma, dtype=bool)
    assert tenc.num_words(qlen) == jenc.num_words(qlen)
    np.testing.assert_array_equal(tenc.build_peq_words(q, eq, n_words=nw),
                                  jenc.build_peq_words(q, eq, n_words=nw))


@pytest.mark.parametrize("qmax,sigma", [(40, 40), (100, 200)])
def test_bitplane_identity_operands_match_jax(rng, qmax, sigma):
    nw = -(-qmax // 32)
    q, qlens = _reads(rng, 4, qmax, sigma)
    wa, wp = pk.bitplane_identity_operands(jnp.asarray(q), jnp.asarray(qlens),
                                           sigma, nw)
    ga, gp = ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw)
    assert ck.bitplane_nb(sigma) == pk.bitplane_nb(sigma)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(_bits(gp.numpy()), np.asarray(wp))


@pytest.mark.parametrize("nw,sigma,hin0", [(1, 4, 0), (2, 4, 1), (3, 5, 0),
                                           (9, 4, 1)])
def test_reduce_lanes_plain_matches_sweep_scores(rng, nw, sigma, hin0):
    """K1's plain version == the JAX scan engine's score stream reduced with
    numpy, with lanes reaching their profile and target rows by index."""
    B, T = 7, 70
    q, qlens = _reads(rng, 3, nw * 32, sigma)
    peq = np.asarray(pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens),
                                         sigma, nw))
    rows = rng.randint(0, sigma + 1, (4, T)).astype(np.int32)
    prow = rng.randint(0, 3, B).astype(np.int32)
    trow = rng.randint(0, 4, B).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(
        jnp.asarray(peq[prow]), jnp.asarray(rows[trow]), hin0=hin0))
    want = _window_reduce(scores, lo, hi)
    before = ck.launch_counts()
    got = ck.reduce_lanes(convert.bit_words(peq), _t(rows), _t(lo), _t(hi),
                          _t(prow), _t(trow), hin0)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    assert ck.launch_counts() == before   # plain version: no launch


@pytest.mark.parametrize("sigma,nw,hin0", [(40, 1, 0), (100, 2, 1)])
def test_reduce_bitplane_plain_matches_sweep_scores(rng, sigma, nw, hin0):
    """K3's plain version (Eq rebuilt from query-id bit planes) == the JAX
    scan engine on the equivalent profiles; sigma is the wildcard."""
    B, T = 6, 60
    q, qlens = _reads(rng, B, nw * 32, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    scores = np.asarray(jax_engine.sweep_scores(peq, jnp.asarray(tg),
                                                hin0=hin0))
    want = _window_reduce(scores, lo, hi)
    got = ck.reduce_flat_device_bitplane(
        *ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw), _t(tg),
        _t(lo), _t(hi), hin0, sigma)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("hin0", [0, 1])
def test_sweep_shared_plain_matches_sweep_scores(rng, hin0):
    B, T, sigma, nw = 9, 80, 4, 2
    q, qlens = _reads(rng, B, 50, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    target = rng.randint(0, sigma + 1, T).astype(np.int32)
    scores = np.asarray(jax_engine.sweep_scores(
        peq, jnp.asarray(np.broadcast_to(target, (B, T))), hin0=hin0))
    col_lo, col_hi = 12, 70
    want = _window_reduce(scores, np.full(B, col_lo), np.full(B, col_hi))
    best, pos = ck.sweep_best_shared(convert.bit_words(np.asarray(peq)),
                                     _t(target), hin0, col_lo, col_hi)
    np.testing.assert_array_equal(best.numpy(), want[0])
    np.testing.assert_array_equal(pos.numpy(), want[1])


def test_reduce_flat_device_matches_pallas_interpret(rng):
    """K1 vs the TPU kernel itself (Pallas interpret mode), including a
    window reaching past T into the chunk filler."""
    B, T, sigma, nw = 8, 64, 4, 1
    q, qlens = _reads(rng, B, 30, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    hi[0] = 80                        # past T: scans the S1-1 filler
    want = pk.reduce_flat_device(peq, jnp.asarray(tg), jnp.asarray(lo),
                                 jnp.asarray(hi), hin0=0, chunk=32,
                                 interpret=True)
    got = ck.reduce_flat_device(convert.bit_words(np.asarray(peq)), _t(tg),
                                _t(lo), _t(hi), 0, chunk=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reduce_flat_device_bitplane_matches_pallas_interpret(rng):
    B, T, sigma, nw = 6, 64, 100, 1
    q, qlens = _reads(rng, B, 30, sigma)
    qa, pw = pk.bitplane_identity_operands(jnp.asarray(q), jnp.asarray(qlens),
                                           sigma, nw)
    tg = rng.randint(0, sigma + 1, (B, T)).astype(np.int32)
    lo, hi = _windows(rng, B, T)
    want = pk.reduce_flat_device_bitplane(
        qa, pw, jnp.asarray(tg), jnp.asarray(lo), jnp.asarray(hi), hin0=1,
        sigma=sigma, chunk=32, interpret=True)
    got = ck.reduce_flat_device_bitplane(
        *ck.bitplane_identity_operands(_t(q), _t(qlens), sigma, nw), _t(tg),
        _t(lo), _t(hi), 1, sigma, chunk=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sweep_best_shared_matches_pallas_interpret(rng):
    B, T, sigma, nw, chunk = 5, 64, 4, 1, 32
    q, qlens = _reads(rng, B, 25, sigma)
    peq = pk.build_peq_device(jnp.asarray(q), jnp.asarray(qlens), sigma, nw)
    peq_tiles = pk.pack_tiles_device(
        jnp.concatenate([peq, jnp.full((pk.B_TILE - B, sigma + 1, nw),
                                       0xFFFFFFFF, jnp.uint32)]))
    target = rng.randint(0, sigma + 1, T).astype(np.int32)
    chunks = jnp.asarray(target.reshape(T // chunk, 1, chunk))
    wb, wp = pk.sweep_best_pallas_shared(peq_tiles, chunks, hin0=0,
                                         col_lo=7, col_hi=60, chunk=chunk,
                                         interpret=True)
    got_b, got_p = ck.sweep_best_shared(
        convert.peq_from_tiles(np.asarray(peq_tiles))[:B].contiguous(),
        convert.target_from_chunks(np.asarray(chunks), T), 0, 7, 60)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(wb).reshape(-1)[:B])
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(wp).reshape(-1)[:B])


def test_wrappers_never_fall_back_off_the_cpu():
    """Operands on any device but the CPU take the kernel or raise; mixed
    devices and wrong dtypes are refused before any launch."""
    meta = dict(dtype=torch.int32, device="meta")
    lanes = [torch.zeros(4, **meta) for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.reduce_lanes(torch.zeros(2, 5, 1, **meta),
                        torch.zeros(2, 10, **meta), *lanes, 0)
    with pytest.raises(ValueError, match="several devices"):
        ck.sweep_shared(torch.zeros(5, 1, 4, dtype=torch.int32),
                        torch.zeros(10, **meta), 0, 0, 10)
    with pytest.raises(TypeError, match="int32"):
        ck.sweep_shared(torch.zeros(5, 1, 4, dtype=torch.int64),
                        torch.zeros(10, dtype=torch.int32), 0, 0, 10)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.hits_lanes(torch.zeros(2, 5, 1, **meta),
                      torch.zeros(2, 10, **meta), *lanes,
                      torch.zeros(4, **meta), 0)
    with pytest.raises(ValueError, match="best has 5 lanes"):
        ck.hits_lanes(torch.zeros(2, 5, 1, dtype=torch.int32),
                      torch.zeros(2, 10, dtype=torch.int32),
                      *[torch.zeros(4, dtype=torch.int32)] * 4,
                      torch.zeros(5, dtype=torch.int32), 0)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A host without the CUDA compiler cannot build the kernels: the build
    raises instead of leaving a library half made."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.hw, "_CUDA_HOME_DEFAULT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in compiler: writes the file named by -o and one log line;
    exits 2 on a command naming fail_on."""
    nvcc = tmp_path / "nvcc"
    fail = (f'case "$*" in *{fail_on}*) echo "error: {fail_on}"; exit 2;; '
            'esac\n') if fail_on else ""
    nvcc.write_text(
        "#!/bin/sh\n" + fail
        + 'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; '
        'done\necho "ptxas info : wrote $out"\n: > "$out"\n')
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One compile per source, then one link; the log keeps every step's
    output, no object file is left, and a second build reuses the library."""
    nvcc = _fake_nvcc(tmp_path)
    out_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out_dir)
    monkeypatch.setattr(_build.hw, "nvcc_path", lambda: nvcc)
    lib = _build.build()
    assert lib.exists() and lib.parent == out_dir
    log = lib.with_suffix(".log").read_text()
    assert log.count("ptxas info") == len(_build.SOURCES) + 1
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert _build.build() == lib


def test_build_reports_the_failing_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.hw, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, "wavefront.cu"))
    with pytest.raises(RuntimeError, match="on wavefront.cu"):
        _build.build()
    assert not list((tmp_path / "build").iterdir())
