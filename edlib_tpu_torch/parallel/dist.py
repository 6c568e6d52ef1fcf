"""Sharded alignment on a grid of devices: the port of
edlib_tpu/parallel/dist.py.

The JAX package shards over a ``jax.sharding.Mesh`` with ``shard_map`` and
merges with collectives.  The port is one process over a DeviceGrid, a
(dp, sp) array of torch devices (a device may repeat: a grid of one card
four times runs the shards in turn on the same kernels):

* dp (data parallel): the batch is split over the grid's rows (or, where
  the JAX function shards over every axis, over all its devices); pairs are
  independent, nothing is merged.
* sp (sequence parallel): one long shared target is cut over the grid's
  columns.  HW (infix) search gives each shard a slice with a left halo of
  (Q_max + k_eff - 1) columns, filled with a NULL symbol before the target
  start (shard_target_slices); every core score <= k_eff is then exact, and
  the shards' minima are merged.  Prefix-anchored sweeps (SHW, NW) hand the
  carried (Pv, Mv, score) from shard to shard instead (the pipelines).

A shard's operands go to its device with ``.to(device)``; each shard runs
the port's kernels (ops/cuda_kernel.py) on a CUDA device and their plain
versions on the CPU.  The merges are elementwise minima and maxima over the
shards' results, gathered on the grid's first device, where the JAX package
uses ``lax.pmin`` / ``lax.pmax``.  Its ``ppermute`` hand-off, in which every
shard sweeps in every round and only round r's shard is kept, becomes one
sweep of shard r in round r from the carry of round r-1, copied to shard
r's device: the same results, sp times fewer sweeps.

Alphabet convention for the sharded HW sweeps: Peq carries sigma real rows,
row sigma = WILDCARD (all ones, for the W-extension), row sigma+1 = NULL
(all zeros, for the halo before the target start).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.utils import hw

_BIG = 0x3FFFFFFF
_I32 = torch.int32


class DeviceGrid:
    """A (dp, sp) grid of torch devices, the port's counterpart of the
    alignment mesh: ``devices`` a numpy object array, ``axis_names``
    ("dp", "sp"), ``shape`` {"dp": dp, "sp": sp}."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a DeviceGrid is a non-empty (dp, sp) array")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device that holds merged and gathered results."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"DeviceGrid(dp={self.devices.shape[0]}, "
                f"sp={self.devices.shape[1]}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_alignment_mesh(n_devices: Optional[int] = None,
                        dp: Optional[int] = None,
                        sp: Optional[int] = None,
                        devices=None) -> DeviceGrid:
    """A (dp, sp) DeviceGrid over the first n_devices of ``devices``
    (default: every CUDA device; torch devices or strings, and a device may
    repeat).  Factorisation as edlib_tpu.parallel.make_alignment_mesh: by
    default sp gets the larger factor (long targets are the scarcer
    resource; the batch is easy to grow)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "edlib_tpu_torch: no CUDA device is available; pass devices= "
                "(e.g. ['cpu'] * 8) to build a grid of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [hw.resolve_device(d) for d in devices]
    n = n_devices if n_devices is not None else len(devices)
    if dp is None and sp is None:
        dp = 1
        while dp * dp * 4 <= n:
            dp *= 2
        sp = n // dp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n or not 1 <= n <= len(devices):
        raise ValueError(f"dp*sp must equal the device count ({dp}*{sp} != "
                         f"{n}) and n_devices lie in [1, {len(devices)}]")
    grid = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // sp, i % sp] = d
    return DeviceGrid(grid)


def check_grid(mesh) -> DeviceGrid:
    """mesh, if it is a DeviceGrid; TypeError otherwise."""
    if not isinstance(mesh, DeviceGrid):
        raise TypeError("edlib_tpu_torch: mesh= takes a DeviceGrid from "
                        "edlib_tpu_torch.parallel.make_alignment_mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def _resolve_engine(mesh: DeviceGrid, engine: str) -> str:
    """The grid's device type, "cuda" (the kernels) or "cpu" (their plain
    versions).  engine= is the JAX package's: "auto", "xla" and "pallas"
    follow the grid's devices; its Pallas interpreter ("interpret") has no
    counterpart, and a grid mixing device types has no single engine."""
    check_grid(mesh)
    if engine not in ("auto", "xla", "pallas", "interpret"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(auto | xla | pallas | interpret)")
    if engine == "interpret":
        raise ValueError("engine='interpret' is the JAX package's Pallas "
                         "interpreter; a CPU grid runs the kernels' plain "
                         "versions")
    types = {d.type for d in mesh.devices.flat}
    if len(types) != 1:
        raise ValueError(f"a grid mixing device types {sorted(types)} has "
                         "no single engine")
    return types.pop()


def _i32(a, dev) -> torch.Tensor:
    """numpy (uint32 bit words or integers) or a tensor -> a contiguous
    int32 tensor on dev holding the same values (bit words: same bits)."""
    if isinstance(a, torch.Tensor):
        t = a if a.dtype == _I32 else a.to(_I32)
    else:
        arr = np.asarray(a)
        arr = arr.view(np.int32) if arr.dtype == np.uint32 else \
            arr.astype(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dev).contiguous()


def _splits(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous [a, b) ranges cutting n rows into `parts` shards, as a
    batch axis is sharded (the last shards may be shorter or empty)."""
    size = -(-n // parts) if parts else 0
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


def _gather(parts, dev) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts])


def over_devices(mesh: DeviceGrid, n: int):
    """(device, [a, b)) per shard of n batch rows split over every device
    of the grid (the JAX package's P(axes)); empty shards left out."""
    devs = list(mesh.devices.flat)
    return [(d, ab) for d, ab in zip(devs, _splits(n, len(devs)))
            if ab[0] < ab[1]]


def _over_rows(mesh: DeviceGrid, n: int):
    """(dp row, [a, b)) per shard of n batch rows split over the grid's dp
    rows (P("dp")), each swept by that row's devices; empty shards left
    out."""
    dp = mesh.devices.shape[0]
    return [(i, ab) for i, ab in enumerate(_splits(n, dp)) if ab[0] < ab[1]]


def sharded_sweep_dp(mesh: DeviceGrid, peq, targets, hin0: int
                     ) -> torch.Tensor:
    """Data-parallel batched score streams, the batch over every device.

    peq (B, S1, NW) uint32 bit words, targets (B, T) int32.  Returns int32
    (B, T) on the grid's first device (sweep_scores on each shard)."""
    _resolve_engine(mesh, "auto")
    outs = [ck.sweep_flat_device(_i32(peq[a:b], dev),
                                 _i32(targets[a:b], dev), hin0)
            for dev, (a, b) in over_devices(mesh, len(peq))]
    return _gather(outs, mesh.first)


def shard_target_slices(target_ids: np.ndarray, sigma: int, n_shards: int,
                        halo: int, w_pad: int, c_multiple: int = 1
                        ) -> Tuple[np.ndarray, int]:
    """Cut a shared target into halo-extended shard slices (host-side).

    Returns (slices int32 (n_shards, halo + C + w_pad), C) where C is the
    core width.  Layout per shard d:
      [ halo cols: target[d*C-halo : d*C] (NULL-filled before col 0) |
        core cols: target[d*C : (d+1)*C] |
        w_pad cols: target continues (drain room for per-lane wildcard
        pads W < w_pad); WILDCARD-filled only past the true target end ]
    """
    T = len(target_ids)
    C = -(-T // n_shards)
    C = -(-C // c_multiple) * c_multiple
    null_sym = sigma + 1
    wild_sym = sigma
    L = halo + C + w_pad
    padded = np.concatenate([
        np.full(halo, null_sym, dtype=np.int32),
        np.asarray(target_ids, dtype=np.int32),
        np.full(n_shards * C - T + w_pad, wild_sym, dtype=np.int32),
    ])
    slices = np.empty((n_shards, L), dtype=np.int32)
    for d in range(n_shards):
        slices[d] = padded[d * C:d * C + L]
    return slices, C


def _hit_slice(words: torch.Tensor, off: int, n_words: int) -> torch.Tensor:
    """n_words packed hit words starting at bit `off` of each row of words
    int32 (B, G): bit j of output word g is input bit off + 32g + j."""
    q, r = divmod(off, 32)
    pad = words.new_zeros((words.shape[0], 1))
    w = torch.cat([words, pad], 1)
    low = w[:, q:q + n_words]
    if r == 0:
        return low.contiguous()
    high = w[:, q + 1:q + 1 + n_words]
    return ((low >> r) & ((1 << (32 - r)) - 1)) | (high << (32 - r))


def sharded_hw_locations(mesh: DeviceGrid, peq, slices: np.ndarray,
                         halo: int, w_pad: int, tlen: int,
                         w_lanes: Optional[np.ndarray] = None,
                         want_hits: bool = True, engine: str = "auto"):
    """HW search with the location merge over the grid.

    peq:     uint32 (B, S2, NW), rows sigma = wildcard, sigma+1 = null.
    slices:  int32 (D_sp, L) from shard_target_slices; core width C = L -
             halo - w_pad must be a multiple of 32 when want_hits.
    tlen:    true target length (core columns past it are masked out).
    w_lanes: int32 (B,) per-lane wildcard pads for mixed-length batches
             (w_pad must be their max); omitted = uniform w_pad.

    Returns (best, pos_first, pos_last) int32 (B,) and hits uint32 bit
    words as int32 (B, D_sp*C//32) | None, on the grid's first device.
    Each sp shard of each dp row runs the shared-row reduce (and, with the
    merged best, the hit mask) on its halo slice; best and the positions
    are merged as pmin / pmax over sp.  Hit bit j of word g of lane b is end
    position 32g + j + (w_pad - w_lanes[b]).  Exact for any k: halo = qlen +
    k_eff - 1 with k_eff >= qlen makes every minimal score exact."""
    D, L = slices.shape
    C = L - halo - w_pad
    B = peq.shape[0]
    _resolve_engine(mesh, engine)
    if want_hits and C % 32:
        raise ValueError("core width must be a multiple of 32 for hits")
    if want_hits and engine != "xla" and (halo + w_pad) % 32:
        raise ValueError("halo + w_pad must be a multiple of 32 for the "
                         "kernel engine's hit bitmasks (round the halo up "
                         "— a larger halo is still exact)")
    if D != mesh.shape["sp"]:
        raise ValueError(f"{D} slices for a grid of sp={mesh.shape['sp']}")
    if w_lanes is None:
        w_lanes = np.full(B, w_pad, np.int32)
    delta = (w_pad - np.asarray(w_lanes)).astype(np.int32)   # (B,) >= 0
    null_sym = peq.shape[1] - 1
    first = mesh.first
    rows = []       # per dp row: (a, b, its sp shards, their reductions)
    for i, (a, b) in _over_rows(mesh, B):
        shards = []     # (device, peq, slice, lo, hi, base) per sp shard
        for d in range(D):
            dev = mesh.devices[i, d]
            dl = torch.from_numpy(delta[a:b]).to(dev)
            lo = torch.full((b - a,), halo + w_pad, dtype=_I32, device=dev)
            hi = lo + (tlen - d * C - dl).clamp(0, C)
            base = d * C - (halo + w_pad) + dl            # gpos = col + base
            shards.append((dev, _i32(peq[a:b], dev),
                           _i32(slices[d], dev), lo, hi, base))
        outs = [ck.reduce_flat_device_shared(p, s, lo, hi, 0, null_sym)
                for dev, p, s, lo, hi, _ in shards]
        rows.append((a, b, shards, outs))
    bests, firsts, lasts, hit_rows = [], [], [], []
    for a, b, shards, outs in rows:
        best_s = torch.stack([o[0].to(first) for o in outs])   # (D, Bl)
        best = best_s.amin(0)
        at = best_s == best
        pf = torch.stack([o[1].to(first) + s[5].to(first)
                          for o, s in zip(outs, shards)])
        pl_ = torch.stack([o[2].to(first) + s[5].to(first)
                           for o, s in zip(outs, shards)])
        found_f = at & (torch.stack([o[1].to(first) for o in outs]) >= 0)
        found_l = at & (torch.stack([o[2].to(first) for o in outs]) >= 0)
        bests.append(best)
        firsts.append(torch.where(found_f, pf, _BIG).amin(0))
        lasts.append(torch.where(found_l, pl_, -1).amax(0))
        if want_hits:
            masks = [ck.hits_flat_device_shared(p, s, lo, hi, best.to(dev),
                                                0, null_sym)
                     for dev, p, s, lo, hi, _ in shards]
            hit_rows.append(torch.cat([_hit_slice(m, halo + w_pad, C // 32)
                                       .to(first) for m in masks], 1))
    out = (torch.cat(bests), torch.cat(firsts), torch.cat(lasts))
    return out + (torch.cat(hit_rows) if want_hits else None,)


def sharded_reduce_dp(mesh: DeviceGrid, peq, targets, lo, hi, hin0: int,
                      want_hits: bool = False, engine: str = "auto"):
    """Data-parallel batched sweep with the reduction on each device, the
    batch over every device of the grid (pairs are independent: nothing is
    merged).

    peq (B, S1, NW) uint32, targets (B, T) int32, lo/hi (B,) scan-column
    windows.  Returns (best, pos_first, pos_last, last_score) int32 (B,)
    and, when want_hits, the packed mask int32 (B, ceil(T/32)) of window
    columns with score == best (bit j of word g = scan column 32g + j), else
    None; on the grid's first device.  Each shard runs reduce_lanes (and
    hits_lanes)."""
    _resolve_engine(mesh, engine)
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    outs = [ck.reduce_flat_device(
        _i32(peq[a:b], dev), _i32(targets[a:b], dev), _i32(lo[a:b], dev),
        _i32(hi[a:b], dev), hin0, want_hits=want_hits)
        for dev, (a, b) in over_devices(mesh, len(peq))]
    n_out = 5 if want_hits else 4
    got = tuple(_gather([o[j] for o in outs], mesh.first)
                for j in range(n_out))
    return got if want_hits else got + (None,)


def sharded_hw_search(mesh: DeviceGrid, peq, slices: np.ndarray, halo: int,
                      w_pad: int, qlen: int):
    """HW search of a batch of queries against an sp-sharded shared target.

    peq: uint32 (B, S2, NW), rows sigma = wildcard, sigma+1 = null; slices:
    int32 (D_sp, L) from shard_target_slices.  Returns (best (B,) int32, the
    minimum over every shard's core columns; core_scores (D_sp, B, C) int32,
    core column j of shard d holding the stream at scan column halo + w_pad
    + j of its slice), on the grid's first device.  Scores above the halo
    budget may differ from a full-target sweep; values <= k_eff (halo =
    qlen + k_eff - 1) are exact."""
    del qlen
    _resolve_engine(mesh, "auto")
    D = slices.shape[0]
    skip = halo + w_pad
    first = mesh.first
    cores = [[] for _ in range(D)]
    for i, (a, b) in _over_rows(mesh, peq.shape[0]):
        for d in range(D):
            dev = mesh.devices[i, d]
            n = b - a
            stream = ck.sweep_scores(
                _i32(peq[a:b], dev), _i32(slices[d][None], dev),
                torch.arange(n, dtype=_I32, device=dev),
                torch.zeros(n, dtype=_I32, device=dev), 0)
            cores[d].append(stream[:, skip:])
    core = torch.stack([_gather(c, first) for c in cores])   # (D, B, C)
    return core.amin((0, 2)), core


def _fresh_carry(n: int, nw: int, dev):
    return (torch.full((n, nw), -1, dtype=_I32, device=dev),
            torch.zeros((n, nw), dtype=_I32, device=dev),
            torch.full((n,), nw * 32, dtype=_I32, device=dev))


def _scan_slices(target_ids, sigma: int, n_shards: int, t_scan: int):
    """The wildcard-extended scan target cut into n_shards plain segments
    of C = ceil(t_scan / n_shards) columns: (slices (n_shards, C), C)."""
    T = len(target_ids)
    C = -(-t_scan // n_shards)
    padded = np.full(n_shards * C, sigma, dtype=np.int32)
    padded[:T] = target_ids
    return padded.reshape(n_shards, C), C


def merge_segments(reds, width: int, hi):
    """The running reduction over a chain of segments of `width` columns
    from each segment's (best, pfirst, plast, last) in its own columns: best
    the minimum, the first and last positions (global: + j * width for
    segment j) where it is reached, last from the segment holding column
    hi-1; _BIG / -1 / _BIG where no column of the window was seen (the JAX
    pipelines' defaults)."""
    best_s = torch.stack([r[0] for r in reds])
    best = best_s.amin(0)
    at = best_s == best
    pf = torch.stack([torch.where(at[j] & (r[1] >= 0), r[1] + j * width,
                                  _BIG) for j, r in enumerate(reds)])
    pl_ = torch.stack([torch.where(at[j] & (r[2] >= 0), r[2] + j * width,
                                   -1) for j, r in enumerate(reds)])
    last = torch.full_like(best, _BIG)
    for j, r in enumerate(reds):
        has = (hi > j * width) & (hi <= (j + 1) * width)
        last = torch.where(has, r[3], last)
    return best, pf.amin(0), pl_.amax(0), last


def sharded_reduce_pipeline(mesh: DeviceGrid, peq, target_ids: np.ndarray,
                            qlen: int, lo, hi, hin0: int = 1,
                            engine: str = "auto", chunk: int = 256):
    """Sequential multi-shard reduce: one long scan streamed through the sp
    shards of each dp row, the (Pv, Mv, score) carry copied from shard to
    shard, each round reduced in place (reduce_resume), so only O(B) leaves
    the grid.

    peq (B, S1, NW) uint32 with the wildcard row at sigma; target_ids (T,)
    int32; lo/hi (B,) GLOBAL scan-column windows (per-lane wildcard pads W
    .. W + tlen, as the single-device reduce takes them).  Returns (best,
    pos_first, pos_last, last_score) int32 (B,) in global scan-column space
    on the grid's first device: equal to one reduce of the whole scan.
    The scan is cut into sp segments of ceil((T + w_pad) / sp) columns, each
    swept exactly (the resumable kernel has no chunk grain, so chunk, the
    TPU kernel's, changes nothing)."""
    del chunk
    _resolve_engine(mesh, engine)
    sp = mesh.shape["sp"]
    B, S1, NW = peq.shape
    w_pad = NW * 32 - qlen
    slices, C = _scan_slices(target_ids, S1 - 1, sp, len(target_ids) + w_pad)
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    first = mesh.first
    outs = []
    for i, (a, b) in _over_rows(mesh, B):
        carry = _fresh_carry(b - a, NW, mesh.devices[i, 0])
        reds = []
        for r in range(sp):
            dev = mesh.devices[i, r]
            lo_r = np.clip(lo[a:b] - r * C, 0, C)
            hi_r = np.clip(hi[a:b] - r * C, 0, C)
            out = ck.reduce_resumable_flat_device(
                _i32(peq[a:b], dev), _i32(slices[r], dev), _i32(lo_r, dev),
                _i32(hi_r, dev), *(c.to(dev) for c in carry), hin0)
            reds.append(tuple(o.to(first) for o in out[:4]))
            carry = out[4:]
        outs.append(merge_segments(reds, C, _i32(hi[a:b], first)))
    return tuple(_gather([o[j] for o in outs], first) for j in range(4))


def sharded_nw_pipeline(mesh: DeviceGrid, peq, target_ids: np.ndarray,
                        qlen: int, hin0: int = 1):
    """Sequential (Pv, Mv, score) carry through the sp shards: one long NW
    target streamed through the grid, shard r swept in round r from the
    carry of round r-1 (sweep_scores_resume); the batch over the dp rows.

    peq: uint32 (B, S1, NW) with the wildcard row at sigma; target_ids (T,)
    int32, padded here to sp*C with wildcards so the padded-bottom stream
    covers the NW corner.  Returns (core_scores (sp, B, C) int32 on the
    grid's first device, scan column s*C + j; C).  The NW distance of lane
    b is at scan column tlen + w_pad - 1."""
    sp = mesh.shape["sp"]
    _resolve_engine(mesh, "auto")
    B, S1, NW = peq.shape
    w_pad = NW * 32 - qlen
    slices, C = _scan_slices(target_ids, S1 - 1, sp, len(target_ids) + w_pad)
    first = mesh.first
    cores = [[] for _ in range(sp)]
    for i, (a, b) in _over_rows(mesh, B):
        n = b - a
        carry = _fresh_carry(n, NW, mesh.devices[i, 0])
        for r in range(sp):
            dev = mesh.devices[i, r]
            scores, *carry = ck.sweep_scores_resume(
                _i32(peq[a:b], dev), _i32(slices[r][None], dev),
                torch.arange(n, dtype=_I32, device=dev),
                torch.zeros(n, dtype=_I32, device=dev),
                *(c.to(dev) for c in carry), hin0)
            cores[r].append(scores)
    return torch.stack([_gather(c, first) for c in cores]), C
