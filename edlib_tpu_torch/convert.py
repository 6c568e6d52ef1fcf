"""Carry the JAX package's per-target state and operands into the port.

The system has no weights: its state is the per-target q-gram index and the
query profiles.  These helpers take the JAX package's arrays as numpy (bit
words as uint32, presence tables as bf16 or any 0/1 dtype) and return the
port's tensors: bit words as int32 holding the same bit patterns, presence
as 0/1 float32, symbols as int32.
"""

from __future__ import annotations

import numpy as np
import torch


def bit_words(a) -> torch.Tensor:
    """uint32 bit words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def index_from_jax(win_pres, win_syms, device=None):
    """(win_pres float32 (n_win, vocab), win_syms int32 (n_win, Lv)) from
    qfilter.build_target_index's (bf16, int32) arrays."""
    pres = np.asarray(win_pres).astype(np.float32)
    syms = np.array(win_syms, dtype=np.int32)
    return (torch.from_numpy(pres).to(device),
            torch.from_numpy(syms).to(device))


def peq_from_tiles(tiles, device=None) -> torch.Tensor:
    """Kernel-tiled profiles uint32 (n_tiles, S1, NW, 8, 128) -> int32
    (n_tiles * 1024, S1, NW), lane b = tile b // 1024, sublane
    (b % 1024) // 128, lane b % 128."""
    t = np.asarray(tiles, dtype=np.uint32)
    n_tiles, s1, nw = t.shape[:3]
    flat = np.transpose(t, (0, 3, 4, 1, 2)).reshape(n_tiles * 1024, s1, nw)
    return bit_words(flat).to(device)


def target_from_chunks(chunks, length: int, device=None) -> torch.Tensor:
    """Shared target int32 (n_chunks, 1, chunk) -> int32 (length,)."""
    flat = np.array(chunks, dtype=np.int32).reshape(-1)[:length]
    return torch.from_numpy(flat.copy()).to(device)
