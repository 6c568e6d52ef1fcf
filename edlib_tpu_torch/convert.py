"""Carry the JAX package's per-target state and operands into the port.

The system has no weights: its state is the per-target q-gram index, the
query profiles, a long pair's wavefront state between segments, and a
resumable sweep's carried (Pv, Mv, score).  These helpers take the JAX
package's arrays as numpy (bit words as uint32, presence tables as bf16 or
any 0/1 dtype) and return the port's tensors: bit words as int32 holding the
same bit patterns, presence as 0/1 float32, symbols as int32.  The
*_from_tiles helpers undo the TPU kernels' (8, 128) lane tiling, so their
raw outputs compare with the port's flat ones; grid_from_mesh gives a test's
device mesh its DeviceGrid.
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


def lanes_from_tiles(tiles, n_lanes=None, device=None) -> torch.Tensor:
    """Per-lane kernel outputs (n_tiles, 8, 128) -> int32 (n_lanes,), lane
    b = tile b // 1024, sublane (b % 1024) // 128, lane b % 128."""
    flat = np.asarray(tiles).reshape(-1)[:n_lanes]
    return torch.from_numpy(flat.astype(np.int32)).to(device)


def hit_words_from_tiles(tiles, n_lanes=None, device=None) -> torch.Tensor:
    """Packed hit masks uint32 (n_tiles, n_chunks, G, 8, 128) -> int32
    (n_lanes, n_chunks * G) holding the same bits: word j*G + g of a lane
    is chunk j's group g."""
    t = np.asarray(tiles, dtype=np.uint32)
    n_tiles, n_chunks, G = t.shape[:3]
    flat = np.transpose(t, (0, 3, 4, 1, 2)).reshape(n_tiles * 1024,
                                                    n_chunks * G)
    return bit_words(flat[:n_lanes]).to(device)


def wavefront_state_from_jax(state, device=None) -> torch.Tensor:
    """The JAX wavefront kernels' state, uint32 (8, R, 128) or the banded
    kernel's (8 + S1, R, 128), -> the port's int32 (7, R * 128) [Pv, Mv,
    hneg, hpos, score, runmin, runpos]: the symbol plane (2) and the banded
    Peq window (8:) are dropped, since the port's kernels read the target
    and the profile themselves."""
    s = np.asarray(state, dtype=np.uint32)
    planes = s[[0, 1, 3, 4, 5, 6, 7]].reshape(7, -1)
    return bit_words(planes).to(device)


def wavefront_state_to_jax(state, symwin=None, peq_window=None) -> np.ndarray:
    """The port's wavefront state (7, NS) -> the JAX kernels' uint32
    (8, NS // 128, 128), or with peq_window (S1, NS) the banded kernel's
    (8 + S1, NS // 128, 128).  symwin (NS,): slot s's current symbol, the
    target at the word's column (0 where none); the port does not keep it."""
    s = np.asarray(torch.as_tensor(state).cpu(), dtype=np.int32)
    s = s.view(np.uint32)
    ns = s.shape[1]
    sym = (np.zeros(ns, np.uint32) if symwin is None
           else np.asarray(symwin, np.int32).view(np.uint32))
    planes = [s[0], s[1], sym, *s[2:]]
    if peq_window is not None:
        planes += list(np.asarray(peq_window, np.uint32))
    return np.stack(planes).reshape(len(planes), ns // 128, 128)


def grid_from_mesh(mesh, devices):
    """A DeviceGrid of the same (dp, sp) shape as the JAX package's
    alignment mesh, over `devices` (torch devices or strings, e.g.
    ["cpu"] * 8): the port's counterpart for a test's mesh."""
    from edlib_tpu_torch.parallel import make_alignment_mesh
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    return make_alignment_mesh(shape["dp"] * shape["sp"], dp=shape["dp"],
                               sp=shape["sp"], devices=devices)


def carry_from_jax(state, layout: str = "xla", device=None):
    """A resumable sweep's state from the JAX package -> the port's (pv
    int32 (B, NW), mv int32 (B, NW), score int32 (B,)).  layout "xla":
    (Pv, Mv) uint32 (NW, B), as jax_engine.initial_state and
    sweep_scores_resumable hold them; "kernel": (B, NW), as
    pallas_kernel.reduce_resumable_flat_device does."""
    pv, mv, score = (np.asarray(x) for x in state)
    if layout == "xla":
        pv, mv = pv.T, mv.T
    elif layout != "kernel":
        raise ValueError(f"unknown layout {layout!r} (xla | kernel)")
    return (bit_words(np.ascontiguousarray(pv)).to(device),
            bit_words(np.ascontiguousarray(mv)).to(device),
            torch.from_numpy(np.array(score, dtype=np.int32)).to(device))


def carry_to_jax(state, layout: str = "xla"):
    """The port's (pv, mv, score) -> the JAX package's (Pv uint32, Mv
    uint32, score int32) numpy arrays in `layout` (see carry_from_jax)."""
    pv, mv, score = (np.asarray(torch.as_tensor(x).cpu()) for x in state)
    pv, mv = pv.view(np.uint32), mv.view(np.uint32)
    if layout == "xla":
        pv, mv = pv.T, mv.T
    elif layout != "kernel":
        raise ValueError(f"unknown layout {layout!r} (xla | kernel)")
    return (np.ascontiguousarray(pv), np.ascontiguousarray(mv),
            score.astype(np.int32))
