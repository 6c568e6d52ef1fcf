"""Segmented HW search: few reads vs one very long target (PyTorch port of
edlib_tpu/ops/segmented.py; the exactness argument is that module's).

HW restarts free at every column, so the target is cut into overlapping
segments, each with a left halo of 2*qmax - 1 columns (NULL before the
target start) and a wildcard tail; every segment's core scores are exact
wherever <= qlen, and the HW best is always <= qlen, so the per-segment
(best, first position) merge equals the full sweep's.

Each (read, segment) pair is one lane of the per-lane reduce kernel; the
lanes name their profile row and their segment row by index, so neither the
profiles nor the segments are repeated in memory.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode
from edlib_tpu_torch.ops import cuda_kernel as ck

_BIG = 1 << 30
_I32 = torch.int32


def plan_segments(tlen: int, halo: int, w_pad: int,
                  max_lanes: int = 1024) -> Tuple[int, int]:
    """(n_segments, core_len): enough segments to fill lanes without letting
    halo overhead dominate (halo work <= ~50% of core work)."""
    if tlen <= 0:
        return 1, 1
    min_core = max(32, halo // 2)
    n = max(1, min(max_lanes, math.ceil(tlen / min_core)))
    core = math.ceil(tlen / n)
    n = math.ceil(tlen / core)
    return n, core


def padded_target(t_ids: torch.Tensor, sigma: int, halo: int, n_seg: int,
                  core: int, w_pad: int) -> torch.Tensor:
    """int32 (halo + n_seg*core + w_pad,): NULL (sigma+1) halo, the target,
    then wildcards (sigma)."""
    tlen = t_ids.shape[0]
    dev = t_ids.device
    return torch.cat([
        torch.full((halo,), sigma + 1, dtype=_I32, device=dev),
        t_ids.to(_I32),
        torch.full((n_seg * core - tlen + w_pad,), sigma, dtype=_I32,
                   device=dev)])


def segment_rows(padded: torch.Tensor, n_seg: int, core: int,
                 seg_len: int) -> torch.Tensor:
    """int32 (n_seg, seg_len): row s = padded[s*core : s*core + seg_len]."""
    return padded.unfold(0, seg_len, core)[:n_seg].contiguous()


def best_over_segments(q_arr: torch.Tensor, qlens: torch.Tensor,
                       rows: torch.Tensor, *, sigma: int, n_words: int,
                       halo: int, core: int, tlen: int, bitplane: bool):
    """(best, first best end position) int32 (B,) of each read over every
    segment row (one lane per read and segment).

    q_arr: (B, qmax) read ids; qlens: int32 (B,); rows from segment_rows.
    bitplane: verify with reduce_bitplane (identity equality; the NULL
    symbol sigma+1 matches no read symbol and is not the wildcard), else
    with reduce_lanes on profiles carrying an all-zero NULL row."""
    B = q_arr.shape[0]
    n_seg = rows.shape[0]
    dev = q_arr.device
    seg = torch.arange(n_seg, dtype=_I32, device=dev)
    seg_cols = (tlen - core * seg).clamp(max=core)
    w = n_words * 32 - qlens.to(_I32)                     # (B,)
    lo = (halo + w)[:, None].expand(B, n_seg)
    hi = (lo + seg_cols[None, :]).reshape(-1).contiguous()
    lo = lo.reshape(-1).contiguous()
    prow = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(n_seg)
    trow = seg.repeat(B)
    if bitplane:
        nb = ck.bitplane_nb(sigma)
        q_alts, pad_words = ck.bitplane_identity_operands(q_arr, qlens, sigma,
                                                          n_words)
        best, pf, _, _ = ck.reduce_bitplane(
            ck.bitplane_planes(q_alts, nb), pad_words, rows, lo, hi, prow,
            trow, 0, nb, 1, sigma)
    else:
        peq = ck.build_peq_device(q_arr, qlens, sigma, n_words)
        peq = torch.cat([peq, peq.new_zeros((B, 1, n_words))], 1)
        best, pf, _, _ = ck.reduce_lanes(peq.contiguous(), rows, lo, hi,
                                         prow, trow, 0)
    best = best.view(B, n_seg)
    bmin = best.min(1).values
    gpos = core * seg[None, :] + pf.view(B, n_seg) - halo - w[:, None]
    pmin = torch.where(best == bmin[:, None], gpos, _BIG).min(1).values
    return bmin, pmin


def hw_best_segmented(read_ids, t_ids: np.ndarray, sigma: int,
                      device: torch.device, max_lanes: int = 4096):
    """Per-read (best int64 (B,), first best end position int64 (B,)) for
    few reads vs one long target, reduced on the device."""
    B = len(read_ids)
    tlen = len(t_ids)
    qmax = max(len(r) for r in read_ids)
    qmin = min(len(r) for r in read_ids)
    n_words = encode.num_words(qmax)
    w_max = n_words * 32 - qmin
    halo = 2 * qmax - 1
    n_seg, core = plan_segments(tlen, halo, w_max,
                                max_lanes=max(1, max_lanes // B))
    padded = padded_target(torch.from_numpy(np.asarray(t_ids, np.int32)).to(
        device), sigma, halo, n_seg, core, w_max)
    rows = segment_rows(padded, n_seg, core, halo + core + w_max)
    q_arr = np.zeros((B, qmax), np.uint8)
    for i, r in enumerate(read_ids):
        q_arr[i, :len(r)] = r
    qlens = torch.tensor([len(r) for r in read_ids], dtype=_I32,
                         device=device)
    best, pos = best_over_segments(
        torch.from_numpy(q_arr).to(device), qlens, rows, sigma=sigma,
        n_words=n_words, halo=halo, core=core, tlen=tlen, bitplane=False)
    return (best.cpu().numpy().astype(np.int64),
            pos.cpu().numpy().astype(np.int64))
