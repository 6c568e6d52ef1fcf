"""map_reads' q-gram filter on the port takes the reads up as uint8 symbols
with int32 lengths at every sigma (the JAX package's 2-bit pack for
sigma <= 4 loses on the H100's host link: ROADMAP divergence 6); its
answers at sigma 4 and 5 equal edlib_tpu.map_reads, reads of mixed lengths
and empty ones included."""

import numpy as np
import pytest

import edlib_tpu
import edlib_tpu_torch


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN"])
@pytest.mark.parametrize("lengths", [(61, 60, 58, 63), (120, 121, 117, 123)])
def test_map_reads_filter_matches_edlib_tpu(rng, monkeypatch, alphabet,
                                            lengths):
    monkeypatch.setenv("EDLIB_TPU_QFILTER", "1")
    t = bytes(rng.choice(list(alphabet), 5000).tolist())
    tb = np.frombuffer(t, np.uint8)
    reads = []
    for i in range(10):
        n = lengths[i % 4]
        s = rng.randint(0, len(tb) - n)
        r = tb[s:s + n].copy()
        muts = rng.rand(n) < 0.06
        r[muts] = rng.choice(list(alphabet), muts.sum())
        reads.append(r.tobytes())
    reads += [b"", bytes(rng.choice(list(alphabet), lengths[0]).tolist())]
    for k in (-1, 3):
        got = edlib_tpu_torch.map_reads(reads, t, k=k, device="cpu")
        want = edlib_tpu.map_reads(reads, t, k=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
