"""One bucket's sweeps on the card: the port's PallasSweeper.

Counterpart of PallasSweeper's full sweep, two-phase, banded and adaptive
methods (edlib_tpu/ops/pallas_kernel.py:2286-2512) on flat tensors.  A bucket is its
query profiles (B, S1, NW) and its targets: one row per lane, or, when
shared, ONE target row that every lane reads (trow = 0).  So the TPU
kernels' shared forms are the per-lane kernels here, with one target row.
Lane vectors go in as numpy; reductions come back as numpy int64 in
scan-column space, hit masks as per-lane sorted scan columns decoded on the
device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from edlib_tpu_torch.encode import WORD_SIZE
from edlib_tpu_torch.ops import cuda_kernel as ck
from edlib_tpu_torch.ops.cuda_kernel import adaptive_classes

__all__ = ["Sweeper", "adaptive_classes", "decode_hit_words"]


def decode_hit_words(words: torch.Tensor) -> List[np.ndarray]:
    """Per-row sorted positions of packed hit words int32 (B, G): bit j of
    word g is position 32g + j.  The bits are found on the words' device;
    only the positions come to the host."""
    B = words.shape[0]
    nz = torch.nonzero(words)                              # (n, 2), row-major
    vals = words[nz[:, 0], nz[:, 1]]
    shifts = torch.arange(WORD_SIZE, dtype=torch.int32, device=words.device)
    bit_i, bit_b = torch.nonzero((vals[:, None] >> shifts) & 1,
                                 as_tuple=True)
    lane = nz[bit_i, 0]
    cols = (nz[bit_i, 1] * WORD_SIZE + bit_b).cpu().numpy().astype(np.int64)
    counts = torch.bincount(lane, minlength=B).cpu().numpy()
    return np.split(cols, np.cumsum(counts)[:-1])


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


class Sweeper:
    """Packs one bucket for the kernels and runs them on `device`."""

    def __init__(self, device, chunk: int = 256):
        self.device = device
        self.chunk = chunk
        self._pack_cache = None

    def _packed(self, peq, targets, hi, shared: bool):
        """(peq, targets (R, T), prow, trow, n_chunks) on the device, cached
        by input OBJECT IDENTITY so k-ladders and reduce-then-hits pairs
        pack once.  Contract: callers keep peq/targets alive for the
        sweeper's lifetime (per-bucket sweepers do) — a freed-and-reused id
        would alias the cache.

        peq: int32 tensor (B, S1, NW).  targets: numpy int32 (B, T), or,
        when shared, 1-D (T,), padded here with the wildcard S1-1 out to
        every lane's window end.  n_chunks counts the chunks of the JAX
        package's padded scan, which its band schedule spans."""
        key = (id(peq), id(targets))
        if self._pack_cache is not None and self._pack_cache[0] == key:
            return self._pack_cache[1]
        dev = self.device
        B = peq.shape[0]
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        if shared:
            t = np.asarray(targets, np.int32)
            tg = np.full(max(len(t), int(np.max(hi, initial=0))),
                         peq.shape[1] - 1, np.int32)
            tg[:len(t)] = t
            tg = tg[None]
            trow = torch.zeros(B, dtype=torch.int32, device=dev)
        else:
            tg = np.ascontiguousarray(targets, np.int32)
            trow = rows
        tg = torch.from_numpy(tg).to(dev)
        packed = (peq.to(dev), tg, rows, trow,
                  -(-tg.shape[1] // self.chunk))
        self._pack_cache = (key, packed)
        return packed

    def _lanes(self, *vals):
        return [torch.from_numpy(np.asarray(v, np.int64).astype(np.int32))
                .to(self.device) for v in vals]

    def _band(self, n_words: int, n_chunks: int, d_lo: int, d_hi: int):
        woff, n_win = ck.nw_band_schedule(n_words, n_chunks, self.chunk,
                                          d_lo, d_hi)
        return torch.from_numpy(woff).to(self.device), n_win

    def sweep(self, peq, targets, hin0: int) -> torch.Tensor:
        """Full score streams (PallasSweeper.sweep): peq int32 tensor
        (B, S1, NW) of any S1, targets numpy int32 (B, T) one row per lane
        -> int32 (B, T) on the device, every column's padded bottom cell
        (a lane-minor view of the stream kernel's output)."""
        tg = torch.from_numpy(np.ascontiguousarray(targets, np.int32)).to(
            self.device)
        return ck.sweep_flat_device(peq.to(self.device), tg, hin0)

    def reduce(self, peq, targets, lo, hi, hin0: int, shared: bool = False):
        """Phase 1: (best, pos_first, pos_last, last_score), each (B,)
        int64 in scan-column space (caller shifts by per-lane W)."""
        peq, tg, prow, trow, _ = self._packed(peq, targets, hi, shared)
        lo_t, hi_t = self._lanes(lo, hi)
        return tuple(_np64(o) for o in ck.reduce_lanes(
            peq, tg, lo_t, hi_t, prow, trow, hin0))

    def hits(self, peq, targets, lo, hi, best, hin0: int,
             shared: bool = False) -> List[np.ndarray]:
        """Phase 2: per-lane sorted scan columns where score == best."""
        peq, tg, prow, trow, _ = self._packed(peq, targets, hi, shared)
        lo_t, hi_t, best_t = self._lanes(lo, hi, best)
        return decode_hit_words(ck.hits_lanes(peq, tg, lo_t, hi_t, prow,
                                              trow, best_t, hin0))

    def reduce_nw_banded(self, peq, targets, hi, d_lo: int, d_hi: int,
                         shared: bool = False) -> np.ndarray:
        """Banded NW distances (B,) int64 for live scan diagonals
        [d_lo, d_hi]; a lane whose distance is past the band's k gets some
        value above k (caller filters and retries)."""
        peq, tg, prow, trow, n_chunks = self._packed(peq, targets, hi,
                                                     shared)
        woff, n_win = self._band(peq.shape[2], n_chunks, d_lo, d_hi)
        (hi_t,) = self._lanes(hi)
        return _np64(ck.nw_banded(peq, tg, woff, hi_t, prow, trow, n_win,
                                  self.chunk))

    def reduce_shw_banded(self, peq, targets, lo, hi, k: int,
                          shared: bool = False):
        """Banded SHW reduce: (best, pos_first, pos_last) each (B,) int64,
        exact for lanes whose true best <= k.  The band is lane-independent:
        every SHW cell of value <= k lies on scan diagonals in [-k, k]."""
        peq, tg, prow, trow, n_chunks = self._packed(peq, targets, hi,
                                                     shared)
        woff, n_win = self._band(peq.shape[2], n_chunks, -k, k)
        lo_t, hi_t = self._lanes(lo, hi)
        return tuple(_np64(o) for o in ck.shw_banded(
            peq, tg, woff, lo_t, hi_t, prow, trow, n_win, self.chunk))

    def hits_shw_banded(self, peq, targets, lo, hi, best, k: int,
                        shared: bool = False) -> List[np.ndarray]:
        """Banded phase 2: per-lane sorted scan columns with score == best
        (exact for lanes whose best <= k)."""
        peq, tg, prow, trow, n_chunks = self._packed(peq, targets, hi,
                                                     shared)
        woff, n_win = self._band(peq.shape[2], n_chunks, -k, k)
        lo_t, hi_t, best_t = self._lanes(lo, hi, best)
        return decode_hit_words(ck.shw_banded_hits(
            peq, tg, woff, lo_t, hi_t, prow, trow, best_t, n_win,
            self.chunk))

    def reduce_hw_adaptive(self, peq, targets, lo, hi, k: int, hin0: int = 0,
                           group: int = 8, strong_every: int = 64,
                           shared: bool = False):
        """Value-adaptive banded semiglobal reduce: (best, pos_first,
        pos_last) each (B,) int64 in scan-column space
        (PallasSweeper.reduce_hw_adaptive).  Exact for lanes whose true best
        is <= k; others get some value above k (the caller ladders k).  Each
        1,024 lanes share one band, the bucket padded to whole tiles as the
        TPU kernel pads it; k < 0 is taken as 0."""
        peq, tg, prow, trow, _ = self._packed(peq, targets, hi, shared)
        lo_t, hi_t = self._lanes(lo, hi)
        return tuple(_np64(o) for o in ck.hw_adaptive_padded(
            peq, tg, lo_t, hi_t, prow, trow, max(0, int(k)), hin0, group,
            strong_every))
