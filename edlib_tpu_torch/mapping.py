"""map_reads on the card: best hit of many reads against one shared target.

PyTorch port of edlib_tpu/mapping.py.  Returns per read (best edit distance,
end position of the first best hit); the reduction happens in the kernels,
so only O(B) values come back to the host.

Routing, in the JAX package's order (as it routes with a device forced):

1. SHW: prefix slices with a doubling ladder (spans start at column 0).
2. HW, B <= 64 and tlen >= 50,000: the target is segmented across lanes.
3. HW: the exact q-gram filter (ops/qfilter.py), when its gates pass:
   filter and verify, then a segmented full-target sweep for the first
   _SEG_FB_B stragglers, then the shared sweep for any past those.
4. Everything else: the shared-target sweep.

Under mesh= (a parallel.DeviceGrid), HW takes, as the JAX package under
its mesh: on an all-CUDA grid the filter first, the reads sharded over every
device of the grid and the target index on each (no merges), the stragglers
on the shared sweep (no segmented fallback); then, or on a CPU grid at once,
the sequence-parallel sweep (halo slices of the target over "sp", the
minima merged; _map_reads_sharded).  SHW ignores the grid.  The port never
builds a grid by itself (EDLIB_TPU_AUTO_MESH is not read).

Every route is exact; only speed differs.  An empty read is (0, -1) before
any routing (0 passes every k).  EDLIB_TPU_QFILTER ("0" off, "1" forced on)
and EDLIB_TPU_QFILTER_MAXC (candidate budget, skips the auto-tuner) mean
what they mean to the JAX package.
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops import qfilter as qf
from edlib_tpu_torch.ops import segmented as seg
from edlib_tpu_torch.types import AlignMode
from edlib_tpu_torch.utils import hw

_SEG_FB_B = 64             # stragglers given the segmented fallback
_CHUNK = 256               # the JAX package's scan grain (verify rows)


def _first_appearance_map(arr: np.ndarray, glob_idx: np.ndarray,
                          seen: int) -> int:
    """Extend glob_idx with arr's unmapped byte values in first-appearance
    order (chunked: genomic alphabets close after the first chunk).
    Returns the new count of mapped values."""
    n_vals = int((np.bincount(arr, minlength=256)
                  [np.nonzero(glob_idx < 0)[0]] > 0).sum()) + seen
    for ofs in range(0, len(arr), 1 << 16):
        chunk = arr[ofs:ofs + (1 << 16)]
        vals, first = np.unique(chunk, return_index=True)
        for v in vals[np.argsort(first)]:
            if glob_idx[v] < 0:
                glob_idx[v] = seen
                seen += 1
        if seen == n_vals:
            break
    return seen


_TMAP_CACHE: dict = {}
_TMAP_CACHE_MAX = 8


def _prep(reads: Sequence[bytes], target: bytes):
    """Alphabet transform in the reference's first-appearance order (target
    first, then reads in call order).  Returns (read_ids list, t_ids, sigma,
    flat, t_key) with flat = (ids_2d, qlen) when every read has one nonzero
    length, else None, and t_key the target's content digest.  t_ids depend
    on the target alone (reads only ever extend the map), so t_key keys the
    transform here and every per-target cache below."""
    t_arr = np.frombuffer(target, dtype=np.uint8)
    t_key = hashlib.blake2b(target, digest_size=16).digest()
    hit = _TMAP_CACHE.pop(t_key, None)
    if hit is None:
        glob_idx = np.full(256, -1, dtype=np.int32)
        seen = _first_appearance_map(t_arr, glob_idx, 0)
        t_ids = glob_idx[t_arr].astype(np.int32)
        hit = (glob_idx, seen, t_ids)
    _TMAP_CACHE[t_key] = hit
    while len(_TMAP_CACHE) > _TMAP_CACHE_MAX:
        _TMAP_CACHE.pop(next(iter(_TMAP_CACHE)))
    glob_idx0, seen0, t_ids = hit

    lens = [len(r) for r in reads]
    cat = (np.frombuffer(b"".join(reads), dtype=np.uint8)
           if reads else np.empty(0, np.uint8))
    if (glob_idx0[cat] < 0).any():
        glob_idx = glob_idx0.copy()
        seen = _first_appearance_map(cat, glob_idx, seen0)
    else:
        glob_idx, seen = glob_idx0, seen0
    ids = glob_idx[cat].astype(np.int32)
    flat = None
    if reads and lens.count(lens[0]) == len(lens) and lens[0] > 0:
        ids2d = ids.reshape(len(reads), lens[0])
        read_ids = list(ids2d)
        flat = (ids2d, lens[0])
    else:
        read_ids = (np.split(ids, np.cumsum(lens)[:-1]) if reads else [])
    return read_ids, t_ids, seen, flat, t_key


def map_reads(reads: Sequence, target, mode="HW", k: int = -1, device=None,
              mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Best-hit mapping of reads against one shared target.

    Returns (best int64 (B,), end_pos int64 (B,)): best = minimal edit
    distance of the read vs any target window (HW) or prefix (SHW); end_pos
    = smallest end position reaching it.  best > k (when k >= 0) is
    reported as -1 with end_pos -1.

    device: None (the card, or with a mesh the grid's first device) or a
    torch device; without a card None raises RuntimeError.  device="cpu"
    runs the plain PyTorch versions of the kernels (slow; for tests).
    mesh: a parallel.DeviceGrid to shard HW mapping over (see the module
    docstring)."""
    grid = None
    if mesh is not None:
        from edlib_tpu_torch.parallel.dist import check_grid
        grid = check_grid(mesh)
    dev = (grid.first if grid is not None and device is None
           else hw.resolve_device(device))
    mode = AlignMode.parse(mode)
    if mode == AlignMode.NW:
        raise ValueError("map_reads is for semiglobal modes (HW/SHW)")
    if isinstance(target, str):
        target = target.encode()
    reads_b = [r.encode() if isinstance(r, str) else bytes(r) for r in reads]
    read_ids, t_ids, sigma, flat, t_key = _prep(reads_b, bytes(target))
    B = len(reads_b)
    best = np.full(B, -1, dtype=np.int64)
    pos = np.full(B, -1, dtype=np.int64)
    if B == 0 or len(t_ids) == 0:
        if B and len(t_ids) == 0:
            # Empty target: best = read length at position -1 (edlib's
            # empty-sequence convention).
            for i, r in enumerate(read_ids):
                if k < 0 or len(r) <= k:
                    best[i] = len(r)
        return best, pos

    qlens = np.fromiter((len(r) for r in read_ids), np.int64, B)
    live = np.nonzero(qlens)[0]
    # An empty read aligns at cost 0 before any routing: (0, -1), within
    # every k.
    best[qlens == 0] = 0
    if len(live) == 0:
        return best, pos
    if len(live) < B:
        read_ids = [read_ids[i] for i in live]
    if mode == AlignMode.SHW:
        raw = _map_reads_shw_pruned(read_ids, t_ids, t_key, sigma, k, dev)
    elif grid is not None:
        from edlib_tpu_torch.parallel import dist
        raw = None
        if dist._resolve_engine(grid, "auto") == "cuda":
            raw = _map_reads_filtered(read_ids, t_ids, t_key, sigma, k, dev,
                                      flat, grid=grid)
        if raw is None:
            raw = _map_reads_sharded(read_ids, t_ids, sigma, grid)
    elif len(live) <= 64 and len(t_ids) >= 50_000:
        # Few reads vs a huge target: segment the target across lanes.
        raw = _map_reads_segmented(read_ids, t_ids, sigma, dev)
    else:
        raw = _map_reads_filtered(read_ids, t_ids, t_key, sigma, k, dev,
                                  flat)
        if raw is None:
            raw = _sweep_reads_shared(read_ids, t_ids, t_key, sigma, 0, dev)
    best[live], pos[live] = finish(raw[0], raw[1], qlens[live], k)
    return best, pos


def _map_reads_sharded(read_ids, t_ids, sigma, grid):
    """dp x sp sharded HW best hits (edlib_tpu/mapping.py:234-267): halo
    slices of the target over "sp", the reads over "dp", (best, first
    position) merged over the grid (parallel/dist.sharded_hw_locations)."""
    from edlib_tpu_torch.parallel import dist

    dev = grid.first
    qlens_np = np.fromiter((len(r) for r in read_ids), np.int32,
                           len(read_ids))
    qmax = int(qlens_np.max())
    nw = encode.num_words(qmax)
    w_max = nw * 32 - int(qlens_np.min())
    halo = 2 * qmax - 1
    q_np, _ = _reads_array(read_ids, None, qmax)
    peq = ck.build_peq_device(torch.from_numpy(q_np).to(dev),
                              torch.from_numpy(qlens_np).to(dev), sigma, nw)
    null = torch.zeros((len(read_ids), 1, nw), dtype=torch.int32, device=dev)
    slices, _ = dist.shard_target_slices(np.asarray(t_ids), sigma,
                                         grid.shape["sp"], halo, w_max,
                                         c_multiple=32)
    b_, pf, _, _ = dist.sharded_hw_locations(
        grid, torch.cat([peq, null], 1), slices, halo, w_max, len(t_ids),
        w_lanes=nw * 32 - qlens_np, want_hits=False)
    return (b_.cpu().numpy().astype(np.int64),
            pf.cpu().numpy().astype(np.int64))


def finish(raw_best, raw_pos, qlens: np.ndarray, k: int):
    """map_reads' post-pass over raw (best, pos): the -1 end-location
    candidate (score exactly qlen; edlib's 64-bit padding emulation) sorts
    before any real position, then best > k becomes (-1, -1)."""
    b = np.asarray(raw_best, dtype=np.int64)
    p = np.asarray(raw_pos, dtype=np.int64)
    cap = (qlens % 64 != 0) & (qlens <= b)
    b = np.where(cap, qlens, b)
    p = np.where(cap, -1, p)
    ok = (b <= k) if k >= 0 else np.ones(len(b), bool)
    return np.where(ok, b, -1), np.where(ok, p, -1)


def _map_reads_shw_pruned(read_ids, t_ids, t_key, sigma, k, dev):
    """SHW best hits via prefix-slice sweeps.  A best b <= r has every end
    of score <= b inside the first qmax + r columns (the score at prefix
    end e is >= e + 1 - qlen), so one slice sweep resolves every read with
    best <= r, first position included.  With a user k one r = k pass is
    complete; with k < 0 unresolved reads climb r x4 until the slice covers
    the target (the reference's dynamic-k pattern, edlib.cpp:199-217)."""
    B = len(read_ids)
    tlen = len(t_ids)
    qmax = max(len(r) for r in read_ids)
    rung = k if k >= 0 else max(64, qmax // 4)
    best = np.full(B, -1, np.int64)
    pos = np.full(B, -1, np.int64)
    todo = np.arange(B)
    while len(todo):
        P = min(qmax + rung, tlen)
        b_s, p_s = _sweep_reads_shared([read_ids[i] for i in todo],
                                       t_ids[:P], (t_key, P), sigma, 1, dev)
        if P >= tlen or k >= 0:
            best[todo], pos[todo] = b_s, p_s
            break
        resolved = b_s <= rung
        best[todo[resolved]] = b_s[resolved]
        pos[todo[resolved]] = p_s[resolved]
        todo = todo[~resolved]
        rung *= 4
    return best, pos


def _map_reads_segmented(read_ids, t_ids, sigma, dev):
    """HW best hits for few reads vs one long target (ops/segmented.py)."""
    return seg.hw_best_segmented(read_ids, t_ids, sigma, dev)


def _reads_array(read_ids, flat, qmax: int):
    """(uint8 (B, qmax) read ids, int32 (B,) lengths) on the host."""
    B = len(read_ids)
    if flat is not None:
        ids2d, qlen0 = flat
        return (np.ascontiguousarray(ids2d, dtype=np.uint8),
                np.full(B, qlen0, np.int32))
    q_arr = np.zeros((B, qmax), np.uint8)
    qlens = np.zeros(B, np.int32)
    for i, r in enumerate(read_ids):
        q_arr[i, :len(r)] = r
        qlens[i] = len(r)
    return q_arr, qlens


def _map_reads_filtered(read_ids, t_ids, t_key, sigma, k, dev, flat=None,
                        grid=None):
    """q-gram filter + windowed verification, then the straggler fallbacks
    (see the module docstring); None when the filter does not apply
    (size, geometry, vocabulary, or the tuner rejects the target).  grid:
    the reads sharded over every device of a DeviceGrid, the target index
    on each device, nothing merged (edlib_tpu/mapping.py:827-851); the
    stragglers then all take the shared sweep."""
    flag = os.environ.get("EDLIB_TPU_QFILTER", "")
    if flag == "0":
        return None
    B = len(read_ids)
    tlen = len(t_ids)
    if flag != "1" and (B < 128 or tlen < 32768):
        return None  # filter overhead beats the plain sweep only at size
    qmax = max(len(r) for r in read_ids)
    qmin = min(len(r) for r in read_ids)
    # k < 0: filter at a rung that resolves typical mapping reads; the
    # rest (best above the rung) fall back to full-target sweeps.
    rung = k if k >= 0 else max(8, qmax // 10)
    geom = qf.window_geometry(tlen, qmax, rung)
    if geom is None:
        return None
    L, stride, n_win = geom
    # The JAX package's presence-table budget, kept so both packages pick
    # the same (q, maxc).
    vocab_cap = (6 << 30) // (2 * (n_win + B)) - 1
    n_words = encode.num_words(qmax)
    Lv = qf.verify_cols(L, n_words, _CHUNK)
    env_maxc = os.environ.get("EDLIB_TPU_QFILTER_MAXC")
    q = qf.choose_q(sigma, qmin, rung, L, max_vocab=vocab_cap,
                    bump=env_maxc is not None)
    if q is None:
        return None
    if env_maxc is not None:
        maxc = min(int(env_maxc), n_win)
        win_pres, win_syms = _target_index_cached(t_ids, t_key, sigma, q, L,
                                                  stride, n_win, Lv, dev)
    else:
        tuned = _auto_tune_cached(t_ids, t_key, sigma, q, rung, qmin, L,
                                  stride, n_win, Lv, vocab_cap, dev)
        if tuned is None:
            return None
        q, maxc, win_pres, win_syms = tuned

    q_np, qlens_np = _reads_array(read_ids, flat, qmax)
    q_arr = torch.from_numpy(q_np).to(dev)
    qlens = torch.from_numpy(qlens_np).to(dev)
    if grid is not None:
        gb, gp, resolved = _filter_over_grid(
            grid, q_np, qlens_np, t_ids, t_key, sigma, q, L, stride, n_win,
            Lv, tlen, rung, maxc, n_words, dev)
    else:
        gb, gp, resolved = qf.filter_verify_batch(
            q_arr, qlens, win_pres, win_syms, sigma=sigma, q=q, L=L,
            stride=stride, tlen=tlen, k=rung, maxc=maxc, nw=n_words)
    # resolved & gb > rung == k proves best > k (the post-pass reports -1);
    # with no user cap every such read needs its true best.
    need = ~resolved if k >= 0 else (~resolved) | (gb > rung)
    idxs = torch.nonzero(need).flatten()
    FB = min(_SEG_FB_B, B) if grid is None else 0
    gb = gb.cpu().numpy().astype(np.int64)
    gp = gp.cpu().numpy().astype(np.int64)
    granted, rest = idxs[:FB], idxs[FB:].cpu().numpy()
    if len(granted):
        fb_b, fb_p = _segmented_fallback(
            q_arr[granted], qlens[granted], t_ids, t_key, sigma, qmax, qmin,
            n_words, FB, dev)
        g = granted.cpu().numpy()
        gb[g] = fb_b.cpu().numpy()
        gp[g] = fb_p.cpu().numpy()
    if len(rest):
        # More stragglers than the segmented fallback takes: the shared
        # sweep, whose padded target is cached too.
        gb[rest], gp[rest] = _sweep_reads_shared(
            [read_ids[i] for i in rest], t_ids, t_key, sigma, 0, dev)
    return gb, gp


def _filter_over_grid(grid, q_np, qlens_np, t_ids, t_key, sigma, q, L,
                      stride, n_win, Lv, tlen, rung, maxc, n_words, dev):
    """The filter and verification with the reads sharded over every
    device of the grid and the target index cached on each; (best, pos,
    resolved) gathered on dev.  Reads are independent: nothing is merged."""
    from edlib_tpu_torch.parallel.dist import over_devices

    parts = []
    for shard_dev, (a, b) in over_devices(grid, len(q_np)):
        win_pres, win_syms = _target_index_cached(
            t_ids, t_key, sigma, q, L, stride, n_win, Lv, shard_dev)
        parts.append(qf.filter_verify_batch(
            torch.from_numpy(q_np[a:b]).to(shard_dev),
            torch.from_numpy(qlens_np[a:b]).to(shard_dev), win_pres,
            win_syms, sigma=sigma, q=q, L=L, stride=stride, tlen=tlen,
            k=rung, maxc=maxc, nw=n_words))
    return tuple(torch.cat([p[j].to(dev) for p in parts]) for j in range(3))


def _segmented_fallback(q_arr, qlens, t_ids, t_key, sigma, qmax, qmin,
                        n_words, FB, dev):
    """(best, pos) int32 of stragglers vs the full target via segments, in
    the geometry the JAX package's fused program fixes for FB stragglers
    (so the padded target is reused across calls)."""
    w_max = n_words * 32 - qmin
    halo = 2 * qmax - 1
    n_seg, core = seg.plan_segments(len(t_ids), halo, w_max,
                                    max_lanes=max(1, 4096 // FB))
    padded = _seg_padded_cached(t_ids, t_key, sigma, halo, n_seg, core, w_max,
                                dev)
    rows = seg.segment_rows(padded, n_seg, core, halo + core + w_max)
    return seg.best_over_segments(
        q_arr, qlens, rows, sigma=sigma, n_words=n_words, halo=halo,
        core=core, tlen=len(t_ids), bitplane=sigma > 32)


# Device-resident per-target state, keyed by t_key (the key that names t_ids:
# _prep's content digest, with the length for a prefix), the geometry and the
# device; least recently used entries leave first.
_INDEX_CACHE: dict = {}
_INDEX_CACHE_MAX = 8


def _cached(key, build):
    hit = _INDEX_CACHE.pop(key, None)
    if hit is None:
        hit = build()
    _INDEX_CACHE[key] = hit
    while len(_INDEX_CACHE) > _INDEX_CACHE_MAX:
        _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
    return hit


def _target_tensor(t_ids, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t_ids, np.int32)).to(dev)


def _seg_padded_cached(t_ids, t_key, sigma, halo, n_seg, core, w_max, dev):
    """The segmented sweep's padded target (NULL halo, wildcard tail)."""
    key = (t_key, "segfb", sigma, halo, n_seg, core, w_max, str(dev))
    return _cached(key, lambda: seg.padded_target(
        _target_tensor(t_ids, dev), sigma, halo, n_seg, core, w_max))


def _auto_tune_cached(t_ids, t_key, sigma, q0, rung, qmin, L, stride, n_win,
                      Lv, vocab_cap, dev):
    """Cached qf.auto_tune verdict for one target, geometry and vocabulary
    budget: (q, maxc, win_pres, win_syms), or None when the filter cannot
    bound the target's shared-gram tail (route to the full sweep)."""
    t_np = np.ascontiguousarray(np.asarray(t_ids, np.int32))
    key = (t_key, "tune", sigma, q0, rung, qmin, L, stride, n_win, Lv,
           vocab_cap, str(dev))

    def tune():
        q, maxc, _, _, _ = qf.auto_tune(
            t_np, sigma, q0, rung, qmin, L, stride, n_win, Lv,
            index_builder=lambda qq: _target_index_cached(
                t_np, t_key, sigma, qq, L, stride, n_win, Lv, dev),
            max_vocab=vocab_cap, device=dev)
        return q, maxc

    q, maxc = _cached(key, tune)
    if q is None:
        return None
    win_pres, win_syms = _target_index_cached(t_np, t_key, sigma, q, L,
                                              stride, n_win, Lv, dev)
    return q, maxc, win_pres, win_syms


def _target_index_cached(t_ids, t_key, sigma, q, L, stride, n_win, Lv, dev):
    """Per-target q-gram index (qf.build_target_index) on the device,
    cached across calls: real mapping streams many read batches against
    one reference."""
    key = (t_key, sigma, q, L, stride, n_win, Lv, str(dev))
    return _cached(key, lambda: qf.build_target_index(
        _target_tensor(t_ids, dev), sigma, q, L, stride, n_win, Lv))


def _target_chunks_cached(t_ids, t_key, sigma, w, chunk, dev):
    """The shared sweep's target, wildcard-padded to a whole number of
    chunks past tlen + w columns, on the device."""
    tlen = len(t_ids)
    n_cols = -(-(tlen + w) // chunk) * chunk

    def build():
        tg = torch.full((n_cols,), sigma, dtype=torch.int32, device=dev)
        tg[:tlen] = _target_tensor(t_ids, dev)
        return tg

    return _cached((t_key, "chunks", sigma, w, chunk, str(dev)),
                   build)


def _sweep_reads_shared(read_ids, t_ids, t_key, sigma, hin0, dev):
    """Full shared-target sweep: (best, pos) int64 (B,).  Reads are grouped
    by their wildcard pad W = NW*32 - qlen, since one launch reduces one
    column window [W, W + tlen)."""
    B = len(read_ids)
    qmax = max(len(r) for r in read_ids)
    n_words = encode.num_words(qmax)
    tlen = len(t_ids)
    groups: dict = {}
    for i, r in enumerate(read_ids):
        groups.setdefault(n_words * 32 - len(r), []).append(i)
    best = np.empty(B, np.int64)
    pos = np.empty(B, np.int64)
    for w, idxs in groups.items():
        target = _target_chunks_cached(t_ids, t_key, sigma, w, _CHUNK, dev)
        q_np, qlens_np = _reads_array([read_ids[i] for i in idxs], None, qmax)
        peq = ck.build_peq_device(torch.from_numpy(q_np).to(dev),
                                  torch.from_numpy(qlens_np).to(dev), sigma,
                                  n_words)
        b, p = ck.sweep_shared(peq.permute(1, 2, 0).contiguous(), target,
                               hin0, w, w + tlen)
        best[idxs] = b.cpu().numpy()
        pos[idxs] = p.cpu().numpy() - w
    return best, pos
