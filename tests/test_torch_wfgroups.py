"""The fixed-window wavefront's group schedule on the CPU.

myers_wavefront runs warp groups of 32 words linked by per-tile records in a
ring, in passes where a window outgrows one launch, and in HW from step 0
over column cores (ops/cuda_kernel.wavefront_groups_plain emulates it group
by group and tile by tile, with the ring's tags and back-pressure and the
blocks' task order).  The emulation is held against wavefront_plain and the
Pallas kernel in interpret mode (edlib_tpu.ops.wavefront._wavefront_call,
through convert.wavefront_state_from_jax): state for state and the stream.
The kernel follows the same schedule on the card, where chip_smoke.py holds
it against wavefront_plain.  Every output is an integer, so every comparison
is exact; inputs come from numpy with a fixed seed.
"""

import numpy as np
import pytest
import torch

from edlib_tpu.ops import wavefront as jwf
from edlib_tpu_torch import convert
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import wavefront as twf

CPU = torch.device("cpu")


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _operands(rng, n_words, t_scan):
    """Random scan symbols in [0, 5) and (5, n_words) profile words."""
    t = _t32(rng.randint(0, 5, t_scan))
    peq = convert.bit_words(rng.randint(0, 1 << 32, (5, n_words),
                                        dtype=np.uint64).astype(np.uint32))
    return t, peq


def _same(got, want):
    assert torch.equal(got[0], want[0])
    if want[1] is None:
        assert got[1] is None
    else:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("hin0,emit,cols,word0,chunk", [
    (0, True, None, 0, 32),          # HW stream
    (1, False, "real", 0, 32),       # SHW best over the real columns
    (1, True, (5, 60), 0, 8),        # a cut range, 40-step (ragged) segments
    (1, True, None, 2, 32),          # pinned window from word 2
    (0, False, (0, 90), 0, 8),       # HW tracked, ragged segments
])
def test_groups_match_plain_and_pallas_interpret(rng, hin0, emit, cols,
                                                 word0, chunk):
    """Three warp groups (69 words), two segments of _wavefront_call against
    the emulation (a ring of 2 tiles, blocks of 2 groups) and
    wavefront_plain from the same state."""
    q = rng.randint(0, 4, 69 * 32 - 11).astype(np.uint8)
    t = rng.randint(0, 4, 150).astype(np.uint8)
    per_seg = 5
    jw = jwf.Wavefront(chunk=chunk, interpret=True)
    peq, _, n_words, R, w_pad, t_scan = jw._prepare(q, t, 4)
    col_lo, col_hi = ((0, 0) if cols is None else (w_pad, w_pad + len(t))
                      if cols == "real" else cols)
    n_steps = 2 * per_seg * chunk
    t_ext = np.full(max(n_steps, t_scan), 4, np.int32)
    t_ext[:len(t)] = t
    t_port = _t32(t_ext)
    peq_port = convert.bit_words(peq.reshape(5, -1))
    targets = t_ext
    if word0:
        peq = np.zeros_like(peq.reshape(5, -1))
        peq[:, :-word0] = peq_port.numpy().view(np.uint32)[:, word0:]
        peq = peq.reshape(5, R, 128)
        targets = np.full_like(t_ext, 4)
        targets[word0:] = t_ext[:-word0]
    targets = targets[:n_steps].reshape(2 * per_seg, chunk, 1)
    state = jwf.Wavefront.initial_state(R)
    ours = convert.wavefront_state_from_jax(state)
    d0 = 0
    for seg in range(2):
        d = d0 + seg * per_seg * chunk
        _, state, stream = jwf._wavefront_call(
            np.array([d], np.int32), targets[seg * per_seg:
                                             (seg + 1) * per_seg],
            peq, state, R=R, sigma1=5, chunk=chunk, hin0=hin0,
            n_words=n_words, col_lo=col_lo, col_hi=col_hi, t_scan=t_scan,
            emit_stream=emit, word0=word0, interpret=True)
        args = (t_port, peq_port, ours, d, per_seg * chunk, n_words, t_scan,
                hin0, col_lo, col_hi, word0, emit)
        got = ck.wavefront_groups_plain(*args, ring=2, block_groups=2)
        _same(got, ck.wavefront_plain(*args))
        ours = got[0]
        assert torch.equal(ours, convert.wavefront_state_from_jax(state))
        if emit:
            tiles = np.asarray(stream).reshape(per_seg, R * 128)
            want = tiles[:, :chunk][:, ::-1].reshape(-1)
            np.testing.assert_array_equal(got[1].numpy(), want)


@pytest.mark.parametrize("hin0,emit,cols,word0,segs,kw", [
    (1, True, (0, 0), 0, ((0, 97), (97, 301)), dict(ring=1)),
    (0, True, (40, 250), 0, ((13, 77), (90, 250)), dict(ring=2,
                                                        block_groups=2,
                                                        blocks=2)),
    (1, False, (3, 500), 30, ((131, 64), (195, 333)), dict(block_groups=1)),
    (0, True, (0, 400), 0, ((0, 129), (129, 200)), dict(pass_groups=2,
                                                        ring=3)),
    (1, True, (0, 0), 150, ((150, 45), (195, 260)), dict(ring=2)),
])
def test_groups_schedule_variants(rng, hin0, emit, cols, word0, segs, kw):
    """Ragged segment starts and lengths, a ring shallower than the
    segment (1-3 tiles), blocks of one or two groups with two resident,
    passes of two groups, word0 > 0 (a window whose bottom slots are past
    the query) and a tracked range cut by a segment: the emulation equals
    wavefront_plain segment for segment."""
    n_words, ns, t_scan = 150, 256, 420
    t, peq = _operands(rng, n_words, t_scan)
    got = want = twf.initial_state(ns, CPU)
    for d, n in segs:
        args = (t, peq, got, d, n, n_words, t_scan, hin0, *cols, word0, emit)
        got_out = ck.wavefront_groups_plain(*args, **kw)
        want_out = ck.wavefront_plain(t, peq, want, *args[3:])
        _same(got_out, want_out)
        got, want = got_out[0], want_out[0]


@pytest.mark.parametrize("n_words,t_scan,core,n_steps,cols", [
    (3, 600, 100, None, (20, 590)),     # halos reach column 0 (192 > 100)
    (3, 600, 40, 350, (0, 0)),          # a run cut before its end
    (40, 2600, 900, None, (64, 2500)),  # two groups a core, fresh cores
    (40, 2600, 700, 1900, (100, 1800)),
])
def test_groups_hw_cores(rng, n_words, t_scan, core, n_steps, cols):
    """HW from step 0 over forced column cores (the first from the loaded
    initial state, the others fresh a halo of 64 * n_words columns before
    their own), with the stream and the bottom word's tracked (min, first
    argmin): every word's state, the stream and the key equal
    wavefront_plain's, whether the run ends or is cut."""
    ns = 128
    t, peq = _operands(rng, n_words, t_scan)
    steps = t_scan + n_words - 1 if n_steps is None else n_steps
    state = twf.initial_state(ns, CPU)
    args = (t, peq, state, 0, steps, n_words, t_scan, 0, *cols, 0, True)
    plan = ck.wavefront_form(ns, n_words, t_scan, 0, 0, 0, core)
    assert plan["cores"] == -(-t_scan // core) > 2
    _same(ck.wavefront_groups_plain(*args, core=core, ring=4),
          ck.wavefront_plain(*args))


def test_wavefront_core_rule():
    """Cores only for HW from step 0 with word0 = 0, at least a halo long,
    enough of them for _WF_FILL_WARPS warps; a forced core wins."""
    halo = ck.split_halo(313)
    assert ck.wavefront_core(384, 313, 10**6, 0, 0, 0) == halo
    assert ck.wavefront_core(384, 313, 10**6, 0, 1, 0) == 10**6
    assert ck.wavefront_core(384, 313, 10**6, 5, 0, 0) == 10**6
    assert ck.wavefront_core(384, 313, 10**6, 0, 0, 2) == 10**6
    assert ck.wavefront_core(384, 313, 10**6, 0, 0, 0, core=77) == 77
    assert ck.wavefront_core(128, 4, 10**7, 0, 0, 0) == -(-10**7 // 1056)
    form = ck.wavefront_form(384, 313, 10**6, 0, 0, 0)
    assert form == dict(cores=-(-10**6 // halo), core=halo, groups=10)
    assert ck.wavefront_form(4096, 3125, 10**5, 0, 1, 0)["cores"] == 1


def test_groups_schedule_needs_a_cores_blocks_resident(rng):
    """One resident block of one group and a ring of one tile: the first
    group fills its ring and waits for a reader that never starts, which
    the emulation reports (the kernel's launch refuses such a plan)."""
    t, peq = _operands(rng, 100, 300)
    state = twf.initial_state(128, CPU)
    with pytest.raises(RuntimeError, match="deadlocks"):
        ck.wavefront_groups_plain(t, peq, state, 0, 300, 100, 300, 1, 0, 0,
                                  0, False, ring=1, block_groups=1, blocks=1)


def test_hw_sweep_is_one_call_and_nw_runs_segments(rng, monkeypatch):
    """Wavefront runs HW as one call from step 0 (the kernel's cores cut
    it) and SHW/NW in segments of seg_chunks * chunk steps."""
    calls = []
    wf_call = ck.wavefront

    def spy(*a, **kw):
        calls.append(a[3:5])
        return wf_call(*a, **kw)

    monkeypatch.setattr(ck, "wavefront", spy)
    q = rng.randint(0, 4, 70).astype(np.uint8)
    t = rng.randint(0, 4, 300).astype(np.uint8)
    wf = twf.Wavefront(chunk=32, seg_chunks=2, device="cpu")
    hw = wf.semiglobal_scores(q, t, 4, mode_is_hw=True)
    assert calls == [(0, 300 + 96 - 70 + 2)]
    calls.clear()
    shw = wf.semiglobal_scores(q, t, 4, mode_is_hw=False)
    assert [c[1] for c in calls] == [64] * 5 + [328 - 5 * 64]
    assert hw.shape == shw.shape == (300,)
