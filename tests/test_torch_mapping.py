"""edlib_tpu_torch.map_reads against edlib_tpu.map_reads, on the CPU.

device="cpu" runs the port's plain PyTorch versions of its kernels; the JAX
package on this host answers from its reference engines.  Every route of
the port (SHW ladder, segmented, filter with both straggler fallbacks,
bit-plane verify, shared sweep) is forced here on small inputs made from a
seed, and every result must be equal, field for field.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import edlib_tpu
import edlib_tpu_torch
from edlib_tpu_torch import mapping as tmp
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import qfilter as tqf

REPO = Path(__file__).resolve().parents[1]


def _check(reads, target, mode="HW", ks=(-1,)):
    for k in ks:
        got = edlib_tpu_torch.map_reads(reads, target, mode=mode, k=k,
                                        device="cpu")
        want = edlib_tpu.map_reads(reads, target, mode=mode, k=k)
        assert got[0].dtype == np.int64 and got[1].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"k={k}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"k={k}")


def _target(rng, tlen, alphabet=b"ACGT"):
    return bytes(rng.choice(list(alphabet), tlen).tolist())


def _reads_from(rng, target, n, qlen, rate=0.06, alphabet=b"ACGT"):
    tb = np.frombuffer(target, np.uint8)
    reads = []
    for _ in range(n):
        s = rng.randint(0, len(tb) - qlen)
        r = tb[s:s + qlen].copy()
        muts = rng.rand(qlen) < rate
        r[muts] = rng.choice(list(alphabet), muts.sum())
        reads.append(r.tobytes())
    return reads


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("mode", ["HW", "SHW"])
def test_map_reads_matches_jax(rng, mode):
    """Mixed read lengths, k in {-1, 5}, a read of a symbol the target lacks
    (best == qlen at position -1)."""
    target = _target(rng, 700)
    reads = []
    for qlen in (40, 70, 100, 120) * 3:
        reads += _reads_from(rng, target, 1, qlen, rate=0.1)
    reads.append(b"Z" * 30)
    _check(reads, target, mode, ks=(-1, 5))


@pytest.mark.parametrize("mode", ["HW", "SHW"])
def test_map_reads_empty_read(rng, mode):
    """An empty read is (0, -1) for every k, as edlib_tpu.map_reads on its
    host route and edlib_tpu.align("", t) give it."""
    target = _target(rng, 300)
    reads = [b"", b"A", target[10:60], target[100:190]]
    ref = edlib_tpu.align(b"", target, mode=mode)
    assert (ref["editDistance"], ref["locations"][0][1]) == (0, -1)
    for k in (-1, 0, 5):
        got = edlib_tpu_torch.map_reads(reads, target, mode=mode, k=k,
                                        device="cpu")
        want = edlib_tpu.map_reads(reads, target, mode=mode, k=k)
        assert (got[0][0], got[1][0]) == (0, -1)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"k={k}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"k={k}")
    got = edlib_tpu_torch.map_reads([b"", b""], target, mode=mode,
                                    device="cpu")
    assert got[0].tolist() == [0, 0] and got[1].tolist() == [-1, -1]


def test_map_reads_edges():
    best, pos = edlib_tpu_torch.map_reads([], b"ACGT", device="cpu")
    assert best.shape == (0,) and pos.shape == (0,)
    for k in (-1, 1, 2):
        _check([b"AC", b"A"], b"", ks=(k,))
    _check([b"AC"], b"ACGT", mode="SHW")
    with pytest.raises(ValueError):
        edlib_tpu_torch.map_reads([b"AC"], b"ACGT", mode="NW", device="cpu")


def test_map_reads_without_a_card_raises():
    """device=None means the card: on a host without one that is an error,
    never a silent run of the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edlib_tpu_torch.map_reads([b"ACGT"], b"ACGTACGT")
    with pytest.raises(RuntimeError):
        edlib_tpu_torch.resolve_device("cuda")


def test_forced_filter_with_both_straggler_fallbacks(rng, monkeypatch):
    """maxc=1 starves the filter, so stragglers go to the segmented
    fallback (first _SEG_FB_B of them) and the rest to the shared sweep."""
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    monkeypatch.setenv("EDLIB_TPU_QFILTER_MAXC", "1")
    monkeypatch.setattr(tmp, "_SEG_FB_B", 2)
    fallback = _spy(monkeypatch, tmp, "_segmented_fallback")
    shared = _spy(monkeypatch, tmp, "_sweep_reads_shared")
    verify = _spy(monkeypatch, tqf, "filter_verify_batch")
    target = _target(rng, 6000)
    reads = _reads_from(rng, target, 6, 80, rate=0.08)
    reads += [b"ACGT" * 20, b"AAAA" * 20] * 2   # many passing windows each
    _check(reads, target)
    assert verify and fallback and shared


def test_filter_route_at_its_own_gates(rng, monkeypatch):
    """B >= 128 reads vs a 33 kbp target take the filter without any
    forcing, with the auto-tuner choosing (q, maxc)."""
    verify = _spy(monkeypatch, tqf, "filter_verify_batch")
    target = _target(rng, 33_000)
    reads = _reads_from(rng, target, 128, 60, rate=0.03)
    _check(reads, target, ks=(4,))
    assert verify


def test_big_alphabet_takes_the_bitplane_route(rng, monkeypatch):
    """sigma > 32 verifies (and falls back) with the bit-plane kernel, as
    the JAX package routes it."""
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    bitplane = _spy(monkeypatch, ck, "reduce_bitplane")
    lanes = _spy(monkeypatch, ck, "reduce_lanes")
    alphabet = bytes(range(1, 101))
    target = _target(rng, 5000, alphabet)
    reads = _reads_from(rng, target, 8, 60, rate=0.05, alphabet=alphabet)
    reads += [_target(rng, 60, alphabet) for _ in range(2)]
    _check(reads, target)
    assert bitplane and not lanes


def test_segmented_route_for_few_reads(rng, monkeypatch):
    """B <= 64 reads vs a target of 50 kbp or more are segmented."""
    segmented = _spy(monkeypatch, tmp, "_map_reads_segmented")
    target = _target(rng, 50_000)
    reads = _reads_from(rng, target, 3, 60) + [_target(rng, 45)]
    best, pos = edlib_tpu_torch.map_reads(reads, target, device="cpu")
    assert segmented
    for i, r in enumerate(reads):
        res = edlib_tpu.align(r, target, mode="HW")
        assert (best[i], pos[i]) == (res["editDistance"],
                                     res["locations"][0][1]), i


def test_shw_ladder(rng, monkeypatch):
    """Prefix-anchored reads resolve on the first rung; random reads climb
    the ladder; k semantics included."""
    ladder = _spy(monkeypatch, tmp, "_sweep_reads_shared")
    target = _target(rng, 1500)
    tb = np.frombuffer(target, np.uint8)
    reads = []
    for _ in range(5):
        r = tb[:70].copy()
        muts = rng.rand(70) < 0.06
        r[muts] = rng.choice(list(b"ACGT"), muts.sum())
        reads.append(r.tobytes())
    reads += [_target(rng, 300) for _ in range(3)]   # best > rung = 75
    _check(reads, target, "SHW", ks=(-1, 8, 0))
    assert len(ladder) > 3   # k=-1 climbed past the first rung


def test_target_caches_are_reused(rng, monkeypatch):
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    builds = _spy(monkeypatch, tqf, "build_target_index")
    tmp._INDEX_CACHE.clear()
    tmp._TMAP_CACHE.clear()
    target = _target(rng, 4000)
    _check(_reads_from(rng, target, 8, 80, rate=0.05), target)
    n_first = len(builds)
    assert n_first >= 1
    _check(_reads_from(rng, target, 8, 80, rate=0.05), target)
    assert len(builds) == n_first, "target index was rebuilt on call 2"
    assert len(tmp._TMAP_CACHE) == 1


def test_target_is_digested_once_per_call(rng, monkeypatch):
    """Every per-target cache is keyed by the one digest _prep takes, so a
    call through the filter and both straggler routes hashes the target
    once."""
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    monkeypatch.setenv("EDLIB_TPU_QFILTER_MAXC", "1")
    monkeypatch.setattr(tmp, "_SEG_FB_B", 1)
    digests = _spy(monkeypatch, tmp.hashlib, "blake2b")
    target = _target(rng, 3000)
    reads = _reads_from(rng, target, 3, 60) + [b"ACGT" * 15] * 2
    edlib_tpu_torch.map_reads(reads, target, device="cpu")
    assert len(digests) == 1


def test_port_imports_neither_jax_nor_edlib_tpu():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["edlib_tpu"] = None
        import edlib_tpu_torch
        best, pos = edlib_tpu_torch.map_reads(
            [b"ACGTAC", b"CCCC"], b"GGACGTACGG" * 4, device="cpu")
        print(best.tolist(), pos.tolist())
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[0, 3] [7, 3]"
