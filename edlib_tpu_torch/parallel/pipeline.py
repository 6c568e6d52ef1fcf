"""Sequential (Pv, Mv, score) carry hand-off across "sp" shards: the port
of edlib_tpu/parallel/pipeline.py.

SHW and NW sweeps are prefix-anchored: their DP state at a column depends on
the whole target prefix, so a target cut over the shards is swept through
them, shard d taking the carried state (Pv, Mv, bottom score) from shard d-1
(the reference's targetStopPosition resume, edlib.cpp:896-908).  Micro-
batches pipeline through the shards: at step s shard d sweeps micro-batch
s - d, so after M + D - 1 steps every micro-batch has crossed every segment.
Each (micro-batch, segment) is one resumable reduce (reduce_resume) from the
carry, and the per-segment reductions (best, first and last minimal
position, final-column score) are merged across segments, which gives what
the JAX pipeline's carried running reduction gives.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.parallel.dist import (DeviceGrid, _fresh_carry, _i32,
                                           _over_rows, _resolve_engine,
                                           merge_segments)


def split_target_segments(target_ids: np.ndarray, sigma: int, n_shards: int,
                          w_max: int) -> Tuple[np.ndarray, int]:
    """Plain (halo-free) split of the wildcard-extended scan target.

    Returns (segments int32 (n_shards, Lseg), Lseg) where the concatenation
    is target + wildcard fill; Lseg covers T + w_max so every lane's final
    column (w_lane + T - 1) lands inside the last shard for w_max < Lseg.
    """
    T = len(target_ids)
    Lseg = -(-(T + w_max) // n_shards)
    scan = np.full(n_shards * Lseg, sigma, dtype=np.int32)
    scan[:T] = target_ids
    return scan.reshape(n_shards, Lseg), Lseg


def pipelined_sweep_summaries(mesh: DeviceGrid, peq: np.ndarray,
                              segments: np.ndarray, lo: np.ndarray,
                              hi: np.ndarray, hin0: int) -> np.ndarray:
    """Pipelined batched sweep of M micro-batches over an sp-sharded target.

    peq:      uint32 (M, mb, S2, NW): micro-batches of query profiles, each
              split over the grid's dp rows.
    segments: int32 (D_sp, Lseg) from split_target_segments.
    lo/hi:    int32 (M, mb) per-lane scan-column windows [lo, hi): lo =
              W_lane, hi = W_lane + tlen (hi <= D_sp * Lseg).
    hin0:     1 for SHW/NW, 0 for HW.

    Returns int32 (M, mb, 4): [best, pos_first, pos_last, last_score] per
    lane, positions in scan-column space (caller subtracts W); a lane that
    saw no window column keeps the JAX pipeline's (_BIG, _BIG, -1, _BIG).
    """
    _resolve_engine(mesh, "auto")
    M, mb, _, NW = peq.shape
    D, Lseg = segments.shape
    if D != mesh.shape["sp"]:
        raise ValueError(f"{D} segments for a grid of sp={mesh.shape['sp']}")
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    first = mesh.first
    shards = dict(_over_rows(mesh, mb))    # dp row -> its lanes [a, b)
    carry = {}      # (m, dp row) -> the carry after the last segment swept
    reds = {}       # (m, dp row) -> per-segment reductions
    for step in range(M + D - 1):
        for d in range(D):
            m = step - d
            if not 0 <= m < M:
                continue
            for i, (a, b) in shards.items():
                dev = mesh.devices[i, d]
                state = carry[m, i] if d else _fresh_carry(b - a, NW, dev)
                out = ck.reduce_resumable_flat_device(
                    _i32(peq[m, a:b], dev), _i32(segments[d], dev),
                    _i32(np.clip(lo[m, a:b] - d * Lseg, 0, Lseg), dev),
                    _i32(np.clip(hi[m, a:b] - d * Lseg, 0, Lseg), dev),
                    *(c.to(dev) for c in state), hin0)
                carry[m, i] = out[4:]
                reds.setdefault((m, i), []).append(
                    tuple(o.to(first) for o in out[:4]))
    result = np.zeros((M, mb, 4), np.int32)
    for (m, i), per_seg in reds.items():
        a, b = shards[i]
        merged = merge_segments(per_seg, Lseg, _i32(hi[m, a:b], first))
        for j, x in enumerate(merged):
            result[m, a:b, j] = x.cpu().numpy()
    return result
