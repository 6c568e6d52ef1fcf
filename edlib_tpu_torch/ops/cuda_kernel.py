"""Myers bit-vector sweeps with in-sweep reduction: CUDA kernels and their
plain PyTorch versions.

Port of the parts of edlib_tpu/ops/pallas_kernel.py on the read-mapping path.
Three kernels, in csrc/myers.cu (its header says what bounds them):

  reduce_lanes     per-lane target rows, Eq from each lane's query profile
                   (pallas_kernel._reduce_kernel, per-lane form);
  reduce_bitplane  the same with Eq rebuilt from query-id bit planes
                   (the kernel's bit-plane form, alphabets past 32);
  sweep_shared     every lane against ONE target (_shared_kernel).

Each wrapper checks its operands, runs the plain version when they lie on
the CPU, and otherwise launches its kernel on the current stream, raises on
a CUDA error, and counts the launch (launch_counts()).  A CUDA tensor never
falls back to the plain version.

Layouts follow the JAX package's flat wrappers, (B, S1, NW) profiles and
(B, T) targets, without its (8, 128) lane tiles.  Bit words travel as int32
tensors holding the uint32 bit patterns (torch has no uint32 arithmetic on
the CPU); the kernels read them as uint32.  In the plain versions int32 add
and << wrap like uint32, and the logical >> 31 is written (x >> 31) & 1.

Lane indices (prow, trow) name each lane's profile row and target row, so a
caller verifying maxc candidate windows per read, or fanning a read over
target segments, never materialises the repeated profiles or targets.
"""

from __future__ import annotations

import torch

from edlib_tpu_torch.encode import WORD_SIZE
from edlib_tpu_torch.ops import _build

_BIG = 0x3FFFFFFF          # best of a lane that saw no column (pallas _BIG)
_I32 = torch.int32
# Kernel launches per wrapper, counted where each wrapper launches its kernel.
_LAUNCHES = {"reduce_lanes": 0, "reduce_bitplane": 0, "sweep_shared": 0}


# ---------------------------------------------------------------------------
# Operand builders (plain PyTorch on whichever device the inputs are on).
# ---------------------------------------------------------------------------


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool (..., n*32) -> int32 (..., n): bit i of word g = mask[32g + i]."""
    shape = mask.shape[:-1] + (mask.shape[-1] // WORD_SIZE, WORD_SIZE)
    shifts = torch.arange(WORD_SIZE, dtype=_I32, device=mask.device)
    return (mask.reshape(shape).to(_I32) << shifts).sum(-1, dtype=_I32)


def build_peq_device(q_ids: torch.Tensor, qlens: torch.Tensor, sigma: int,
                     n_words: int) -> torch.Tensor:
    """Query profiles, (B, sigma+1, n_words) int32 bit words.

    q_ids: (B, Qmax) symbol ids in [0, sigma) (entries past qlens are
    ignored).  Row sigma is the wildcard (all ones); rows past each qlen
    match every symbol.  Counterpart of pallas_kernel.build_peq_device, built
    by scatter: O(B * Qmax) memory instead of O(B * S1 * NW * 32)."""
    B, qmax = q_ids.shape
    dev = q_ids.device
    s1 = sigma + 1
    rows = torch.arange(qmax, dtype=torch.int64, device=dev)
    valid = rows[None, :] < qlens.to(torch.int64)[:, None]
    sym = torch.where(valid, q_ids.to(torch.int64), 0)
    flat = ((torch.arange(B, dtype=torch.int64, device=dev)[:, None] * s1
             + sym) * n_words + rows[None, :] // WORD_SIZE)
    bit = torch.ones(1, dtype=_I32, device=dev) << (rows % WORD_SIZE).to(_I32)
    vals = torch.where(valid, bit[None, :], 0)
    peq = torch.zeros(B * s1 * n_words, dtype=_I32, device=dev)
    peq.scatter_add_(0, flat.reshape(-1), vals.reshape(-1))
    peq = peq.view(B, s1, n_words)
    all_rows = torch.arange(n_words * WORD_SIZE, device=dev)
    pad = _pack_bits(all_rows[None, :] >= qlens.to(torch.int64)[:, None])
    peq |= pad[:, None, :]
    peq[:, sigma, :] = -1
    return peq


def bitplane_nb(sigma: int) -> int:
    """Bit planes per alternative: enough for symbols [0, sigma] plus a
    sentinel id (1<<nb)-1 > sigma that matches no target symbol."""
    return (sigma + 1).bit_length()


def bitplane_identity_operands(q_arr: torch.Tensor, qlens: torch.Tensor,
                               sigma: int, n_words: int):
    """(q_alts int32 (B, 1, NW*32), pad_words int32 (B, NW)) for identity
    equality: the reads with the sentinel in every pad slot, and the packed
    bits of rows past each qlen (pallas_kernel.bitplane_identity_operands)."""
    B, qmax = q_arr.shape
    dev = q_arr.device
    R = n_words * WORD_SIZE
    sent = (1 << bitplane_nb(sigma)) - 1
    pad = (torch.arange(R, device=dev)[None, :]
           >= qlens.to(torch.int64)[:, None])
    qa = torch.full((B, R), sent, dtype=_I32, device=dev)
    qa[:, :qmax] = q_arr.to(_I32)
    q_alts = torch.where(pad, sent, qa)[:, None, :]
    return q_alts, _pack_bits(pad)


def bitplane_planes(q_alts: torch.Tensor, nb: int) -> torch.Tensor:
    """int32 (B, E*nb*NW): plane (e, b) word w holds bit b of the ids of
    query rows 32w..32w+31 of alternative e (the kernel's operand)."""
    B, E, R = q_alts.shape
    shifts = torch.arange(nb, dtype=_I32, device=q_alts.device)
    bits = ((q_alts[:, :, None, :] >> shifts[None, None, :, None]) & 1) > 0
    return _pack_bits(bits).reshape(B, E * nb * (R // WORD_SIZE))


# ---------------------------------------------------------------------------
# Plain versions: lanes vectorised, a Python loop over columns.
# ---------------------------------------------------------------------------


def _advance_word(pv, mv, eq, hneg, hpos):
    """Myers block update on int32 bit words (pallas_kernel._advance_word)."""
    xv = eq | mv
    eq = eq | hneg
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    out_pos = (ph >> 31) & 1
    out_neg = (mh >> 31) & 1
    ph = (ph << 1) | hpos
    mh = (mh << 1) | hneg
    return mh | ~(xv | ph), ph & xv, out_neg, out_pos


def _sweep_plain(eq_at, n_cols: int, n_words: int, lo, hi, hin0: int):
    """Advance every lane over columns [0, min(max hi, n_cols)); eq_at(c)
    returns the column's Eq words, a list of NW int32 (B,) tensors.
    Returns (best, pfirst, plast, last) with the kernels' semantics."""
    B = lo.shape[0]
    dev = lo.device
    pv = [torch.full((B,), -1, dtype=_I32, device=dev)] * n_words
    mv = [torch.zeros(B, dtype=_I32, device=dev)] * n_words
    score = torch.full((B,), n_words * WORD_SIZE, dtype=_I32, device=dev)
    best = torch.full((B,), _BIG, dtype=_I32, device=dev)
    pfirst = torch.full((B,), -1, dtype=_I32, device=dev)
    plast = pfirst.clone()
    last = best.clone()
    zero = torch.zeros(B, dtype=_I32, device=dev)
    hpos0 = torch.full((B,), hin0, dtype=_I32, device=dev)
    end = min(n_cols, int(hi.max())) if B else 0
    for c in range(end):
        eqs = eq_at(c)
        hneg, hpos = zero, hpos0
        for w in range(n_words):
            pv[w], mv[w], hneg, hpos = _advance_word(pv[w], mv[w], eqs[w],
                                                     hneg, hpos)
        score = score + hpos - hneg
        in_win = (lo <= c) & (hi > c)
        upd = (score < best) & in_win
        pfirst = torch.where(upd, c, pfirst)
        plast = torch.where((score <= best) & in_win, c, plast)
        best = torch.where(upd, score, best)
        last = torch.where(hi - 1 == c, score, last)
    return best, pfirst, plast, last


def reduce_lanes_plain(peq, targets, lo, hi, prow, trow, hin0: int):
    """Plain version of reduce_lanes (same operands and outputs)."""
    n_words = peq.shape[2]
    n_cols = targets.shape[1]
    end = min(n_cols, int(hi.max())) if lo.shape[0] else 0
    prof = peq[prow.long()]                               # (B, S1, NW)
    tg = targets[trow.long(), :end]                       # (B, end)
    lanes = torch.arange(lo.shape[0], device=lo.device)

    def eq_at(c):
        words = prof[lanes, tg[:, c].long()]              # (B, NW)
        return [words[:, w] for w in range(n_words)]

    return _sweep_plain(eq_at, n_cols, n_words, lo, hi, hin0)


def reduce_bitplane_plain(planes, pad, targets, lo, hi, prow, trow,
                          hin0: int, nb: int, n_alts: int, wildcard: int):
    """Plain version of reduce_bitplane (same operands and outputs)."""
    n_words = pad.shape[1]
    n_cols = targets.shape[1]
    end = min(n_cols, int(hi.max())) if lo.shape[0] else 0
    pl = planes[prow.long()]                              # (B, E*nb*NW)
    pd = pad[prow.long()]                                 # (B, NW)
    tg = targets[trow.long(), :end]

    def eq_at(c):
        sym = tg[:, c]
        tb = [-((sym >> b) & 1) for b in range(nb)]
        wild = torch.where(sym == wildcard, -1, 0).to(_I32)
        words = []
        for w in range(n_words):
            acc = pd[:, w] | wild
            for e in range(n_alts):
                base = e * nb * n_words + w
                x = pl[:, base] ^ tb[0]
                for b in range(1, nb):
                    x = x | (pl[:, base + b * n_words] ^ tb[b])
                acc = acc | ~x
            words.append(acc)
        return words

    return _sweep_plain(eq_at, n_cols, n_words, lo, hi, hin0)


def sweep_shared_plain(peq_t, target, hin0: int, col_lo: int, col_hi: int):
    """Plain version of sweep_shared (same operands and outputs)."""
    n_words, B = peq_t.shape[1], peq_t.shape[2]
    dev = peq_t.device
    lo = torch.full((B,), col_lo, dtype=_I32, device=dev)
    hi = torch.full((B,), col_hi, dtype=_I32, device=dev)
    syms = target.tolist()

    def eq_at(c):
        words = peq_t[syms[c]]                            # (NW, B)
        return [words[w] for w in range(n_words)]

    best, pfirst, _, _ = _sweep_plain(eq_at, target.shape[0], n_words, lo,
                                      hi, hin0)
    return best, pfirst


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _on_cuda(name: str, *tensors) -> bool:
    """False for CPU operands (plain version), True for CUDA operands
    (kernel); raises for mixed devices or any other device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def _check(name: str, t: torch.Tensor, what: str, ndim: int) -> None:
    if t.dtype != _I32:
        raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_lanes(name: str, *vecs) -> int:
    n = vecs[0].shape[0]
    for v, what in zip(vecs, ("lo", "hi", "prow", "trow")):
        _check(name, v, what, 1)
        if v.shape[0] != n:
            raise ValueError(f"{name}: {what} has {v.shape[0]} lanes, "
                             f"expected {n}")
    return n


def _lane_outputs(n: int, dev):
    return [torch.empty(n, dtype=_I32, device=dev) for _ in range(4)]


def _scratch(n_words: int, n_lanes: int, dev) -> torch.Tensor:
    """State buffer of the generic (more than 8 words) kernel path."""
    size = 2 * n_words * n_lanes if n_words > 8 else 1
    return torch.empty(size, dtype=_I32, device=dev)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def reduce_lanes(peq, targets, lo, hi, prow, trow, hin0: int):
    """Per-lane Myers sweep with in-sweep reduction (kernel K1).

    peq: int32 (R_p, S1, NW) profile bit words; targets: int32 (R_t, T)
    symbols in [0, S1); lo, hi, prow, trow: int32 (B,).  Lane i sweeps
    target row trow[i] with profile row prow[i] over scan columns
    [0, min(hi[i], T)) and returns, over columns [lo[i], hi[i]):
    best, pfirst, plast (int32 (B,)) and last, the score at hi[i]-1.
    hin0: 0 for HW (free leading gap), 1 for SHW/NW."""
    name = "reduce_lanes"
    _check(name, peq, "peq", 3)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, lo, hi, prow, trow)
    if not _on_cuda(name, peq, targets, lo, hi, prow, trow):
        return reduce_lanes_plain(peq, targets, lo, hi, prow, trow, hin0)
    s1, nw = peq.shape[1], peq.shape[2]
    dev = peq.device
    out = _lane_outputs(n, dev)
    if n == 0:
        return tuple(out)
    scratch = _scratch(nw, n, dev)
    lib = _build.load()
    err = lib.myers_reduce_lanes(
        dev.index, peq.data_ptr(), s1, nw, targets.data_ptr(),
        targets.shape[1], lo.data_ptr(), hi.data_ptr(), prow.data_ptr(),
        trow.data_ptr(), n, int(hin0), *(o.data_ptr() for o in out),
        scratch.data_ptr(), _stream(dev))
    _build.check(lib, err, name)
    _LAUNCHES["reduce_lanes"] += 1
    return tuple(out)


def reduce_bitplane(planes, pad, targets, lo, hi, prow, trow, hin0: int,
                    nb: int, n_alts: int, wildcard: int):
    """reduce_lanes with Eq rebuilt per column from query-id bit planes
    (kernel K3): planes int32 (R_p, n_alts*nb*NW) from bitplane_planes,
    pad int32 (R_p, NW) rows matching every symbol, wildcard the target
    symbol matching every row.  Other operands and outputs as reduce_lanes.
    """
    name = "reduce_bitplane"
    _check(name, planes, "planes", 2)
    _check(name, pad, "pad", 2)
    _check(name, targets, "targets", 2)
    n = _check_lanes(name, lo, hi, prow, trow)
    nw = pad.shape[1]
    if planes.shape[1] != n_alts * nb * nw or planes.shape[0] != pad.shape[0]:
        raise ValueError(f"{name}: planes {tuple(planes.shape)} do not match "
                         f"pad {tuple(pad.shape)} with n_alts={n_alts}, "
                         f"nb={nb}")
    if not 1 <= nb <= 9:
        raise ValueError(f"{name}: nb={nb} outside [1, 9]")
    if not _on_cuda(name, planes, pad, targets, lo, hi, prow, trow):
        return reduce_bitplane_plain(planes, pad, targets, lo, hi, prow,
                                     trow, hin0, nb, n_alts, wildcard)
    dev = planes.device
    out = _lane_outputs(n, dev)
    if n == 0:
        return tuple(out)
    scratch = _scratch(nw, n, dev)
    lib = _build.load()
    err = lib.myers_reduce_bitplane(
        dev.index, planes.data_ptr(), pad.data_ptr(), nw, nb, n_alts,
        wildcard, targets.data_ptr(), targets.shape[1], lo.data_ptr(),
        hi.data_ptr(), prow.data_ptr(), trow.data_ptr(), n, int(hin0),
        *(o.data_ptr() for o in out), scratch.data_ptr(), _stream(dev))
    _build.check(lib, err, name)
    _LAUNCHES["reduce_bitplane"] += 1
    return tuple(out)


def sweep_shared(peq_t, target, hin0: int, col_lo: int, col_hi: int):
    """Every lane against one target (kernel K2).

    peq_t: int32 (S1, NW, B) profile bit words, lane-minor so a warp reads
    consecutive words; target: int32 (n_cols,) symbols in [0, S1).
    Returns (best, pos) int32 (B,): the minimal score over scan columns
    [col_lo, col_hi) and the first column reaching it."""
    name = "sweep_shared"
    _check(name, peq_t, "peq_t", 3)
    _check(name, target, "target", 1)
    if not _on_cuda(name, peq_t, target):
        return sweep_shared_plain(peq_t, target, hin0, col_lo, col_hi)
    nw, n = peq_t.shape[1], peq_t.shape[2]
    dev = peq_t.device
    best, pos = _lane_outputs(n, dev)[:2]
    if n == 0:
        return best, pos
    scratch = _scratch(nw, n, dev)
    lib = _build.load()
    err = lib.myers_sweep_shared(
        dev.index, peq_t.data_ptr(), nw, n, target.data_ptr(),
        target.shape[0], int(hin0), int(col_lo), int(col_hi),
        best.data_ptr(), pos.data_ptr(), scratch.data_ptr(), _stream(dev))
    _build.check(lib, err, name)
    _LAUNCHES["sweep_shared"] += 1
    return best, pos


KERNELS = (reduce_lanes, reduce_bitplane, sweep_shared)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The JAX package's flat signatures (one profile row and one target row per
# lane), for callers and tests that hold per-lane operands.
# ---------------------------------------------------------------------------


def _identity_rows(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=dev)


def _pad_cols(targets: torch.Tensor, fill: int, chunk: int):
    """Targets padded with ``fill`` to the JAX wrappers' chunk grain, so a
    window reaching past T scans the same filler columns there and here."""
    T = targets.shape[1]
    Tp = -(-T // chunk) * chunk
    if Tp == T:
        return targets
    pad = targets.new_full((targets.shape[0], Tp - T), fill)
    return torch.cat([targets, pad], 1)


def reduce_flat_device(peq, targets, lo, hi, hin0: int, chunk: int = 256):
    """pallas_kernel.reduce_flat_device: peq (B, S1, NW), targets (B, T),
    lo/hi (B,) -> (best, pfirst, plast, last) (B,) int32."""
    rows = _identity_rows(lo.shape[0], lo.device)
    return reduce_lanes(peq, _pad_cols(targets, peq.shape[1] - 1, chunk), lo,
                        hi, rows, rows, hin0)


def reduce_flat_device_bitplane(q_alts, pad_words, targets, lo, hi,
                                hin0: int, sigma: int, chunk: int = 256):
    """pallas_kernel.reduce_flat_device_bitplane: q_alts int32 (B, E, R)
    alternative ids per query row (sentinel where none), pad_words (B, NW),
    targets (B, T) in [0, sigma] with sigma the wildcard."""
    nb = bitplane_nb(sigma)
    rows = _identity_rows(lo.shape[0], lo.device)
    return reduce_bitplane(bitplane_planes(q_alts, nb), pad_words,
                           _pad_cols(targets, sigma, chunk), lo, hi, rows, rows,
                           hin0, nb, q_alts.shape[1], sigma)


def sweep_best_shared(peq, target, hin0: int, col_lo: int, col_hi: int):
    """pallas_kernel.sweep_best_pallas_shared on flat operands: peq
    (B, S1, NW), target (n_cols,) -> (best, pos) (B,) int32, pos a scan
    column (-1 when no column of the window was seen)."""
    return sweep_shared(peq.permute(1, 2, 0).contiguous(), target, hin0,
                        col_lo, col_hi)
