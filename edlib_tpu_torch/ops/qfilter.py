"""Exact q-gram prefilter for batched HW read mapping (PyTorch port of
edlib_tpu/ops/qfilter.py; the soundness argument is in that module's
docstring and holds here unchanged).

Candidate windows are those whose distinct shared-gram count C[b, w] reaches
tau_b = D_b - k*q; only they are verified by the Myers reduce kernels, and a
read with more than maxc passing windows is reported unresolved so the caller
falls back to a full sweep.  Results are exact.

Exact arithmetic: presence tables are 0/1 float32 and the candidate counts a
float32 matmul, exact for every count below 2^24 (a bf16 x bf16 product in
torch returns bf16, exact only to 256, so the port keeps float32).  Which
window wins a tie in the top-maxc pick is unobservable: when more than maxc
windows pass, the read is unresolved.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from edlib_tpu_torch.ops import cuda_kernel as ck

MAX_VOCAB = 1 << 16      # sigma**q cap: presence table width
_BIG = 1 << 30
_MAXC_LADDER = (4, 8, 16, 32, 64)


def choose_q(sigma: int, qlen_min: int, k: int, L: int,
             n_sigma_noise: float = 6.0,
             max_vocab: Optional[int] = None,
             bump: bool = True) -> Optional[int]:
    """Smallest q whose filter is sound (tau >= 1 at the worst case) AND
    effective (tau clears the random-window shared-gram count by
    n_sigma_noise standard deviations), or None; bump=True adds one order
    of q when that stays sound and within max_vocab."""
    if sigma < 2 or qlen_min < 2 or k < 0:
        return None
    cap = MAX_VOCAB if max_vocab is None else min(MAX_VOCAB, max_vocab)
    chosen = None
    for q in range(2, 17):
        vocab = sigma ** q
        if vocab > cap:
            return None
        m_eff = qlen_min - q + 1
        if m_eff < 1:
            continue
        tau = m_eff - k * q
        if tau < 1:
            continue
        p = 1.0 - (1.0 - 1.0 / vocab) ** max(1, L - q + 1)
        mu = m_eff * p
        sd = math.sqrt(max(1e-9, m_eff * p * (1.0 - p)))
        if tau > mu + n_sigma_noise * sd:
            chosen = q
            break
    if chosen is None or not bump:
        return chosen
    q2 = chosen + 1
    if (sigma ** q2 <= cap and qlen_min - q2 + 1 >= 1
            and (qlen_min - q2 + 1) - k * q2 >= 1):
        return q2
    return chosen


def window_geometry(tlen: int, qmax: int, k: int,
                    L: Optional[int] = None) -> Optional[Tuple[int, int, int]]:
    """(L, stride, n_win) covering every possible <=k alignment span, or
    None when the target is too short for windowed filtering to help."""
    P = qmax + k
    if L is None:
        L = max(256, -(-2 * P // 128) * 128)
    stride = L - P + 1
    if stride < 1 or tlen <= L:
        return None
    n_win = (tlen - L + stride - 1) // stride + 1
    if n_win < 4:
        return None
    return L, stride, n_win


def verify_cols(L: int, nw: int, chunk: int = 256) -> int:
    """Scan width of one verification lane (window + wildcard extension,
    rounded to the JAX package's chunk grain so both index the same rows)."""
    return -(-(L + nw * 32) // chunk) * chunk


def _gram_ids(ids: torch.Tensor, q: int, sigma: int) -> torch.Tensor:
    """Rolling gram ids: out[..., i] = sum_j clamp(ids[..., i+j]) * sigma^j
    for i in [0, N-q].  Out-of-alphabet symbols clamp (sound: presence only
    grows)."""
    n = ids.shape[-1]
    c = ids.to(torch.int32).clamp(0, sigma - 1)
    out = torch.zeros(ids.shape[:-1] + (n - q + 1,), dtype=torch.int32,
                      device=ids.device)
    for j in range(q):
        out += c[..., j:n - q + 1 + j] * (sigma ** j)
    return out


def window_presence(t_ids: torch.Tensor, sigma: int, q: int, L: int,
                    stride: int, n_win: int) -> torch.Tensor:
    """float32 (n_win, sigma**q) 0/1 gram presence of the target's length-L
    windows at the given stride (windows past the end read clamped grams)."""
    tlen = t_ids.shape[0]
    dev = t_ids.device
    gids = _gram_ids(t_ids, q, sigma)
    starts = torch.arange(n_win, dtype=torch.int64, device=dev) * stride
    span = L - q + 1
    idx = (starts[:, None] + torch.arange(span, device=dev)[None, :]).clamp(
        0, tlen - q)
    pres = torch.zeros((n_win, sigma ** q), dtype=torch.float32, device=dev)
    return pres.scatter_(1, gids[idx].long(), 1.0)


def read_gram_presence(q_ids: torch.Tensor, qlens: torch.Tensor, sigma: int,
                       q: int):
    """(float32 (B, sigma**q) 0/1 gram presence per read, int32 (B,)
    distinct-gram counts D_b); grams crossing a read's qlen are dropped."""
    vocab = sigma ** q
    B, qmax = q_ids.shape
    m = qmax - q + 1
    gids = _gram_ids(q_ids, q, sigma)
    valid = (torch.arange(m, device=q_ids.device)[None, :]
             <= (qlens.to(torch.int64) - q)[:, None])
    gids = torch.where(valid, gids, vocab)                # trash column
    pres = torch.zeros((B, vocab + 1), dtype=torch.float32,
                       device=q_ids.device)
    pres.scatter_(1, gids.long(), 1.0)
    pres = pres[:, :vocab]
    return pres, pres.sum(1).to(torch.int32)


def candidate_counts(read_pres: torch.Tensor,
                     win_pres: torch.Tensor) -> torch.Tensor:
    """float32 (B, n_win) distinct shared-gram counts, one matmul of 0/1
    float32 operands (exact: every count is an integer below 2^24)."""
    return read_pres @ win_pres.T


def build_target_index(t_ids: torch.Tensor, sigma: int, q: int, L: int,
                       stride: int, n_win: int, Lv: int):
    """Per-target index, built once and reused across read batches:
      win_pres float32 (n_win, sigma**q) — window gram-presence bitmap;
      win_syms int32 (n_win, Lv) — each window's verification target row
        (window slice; the wildcard sigma past tlen)."""
    tlen = t_ids.shape[0]
    dev = t_ids.device
    t32 = t_ids.to(torch.int32)
    win_pres = window_presence(t32, sigma, q, L, stride, n_win)
    base = (torch.arange(n_win, dtype=torch.int64, device=dev)[:, None]
            * stride + torch.arange(Lv, device=dev)[None, :])
    win_syms = torch.where(base < tlen, t32[base.clamp(0, tlen - 1)], sigma)
    return win_pres, win_syms.to(torch.int32).contiguous()


def _top_candidates(Cm: torch.Tensor, maxc: int):
    """Top-maxc (value, window) per row; slots past n_win are padded with
    value -2 (never a candidate)."""
    B, n_win = Cm.shape
    kk = min(maxc, n_win)
    vals, idx = torch.topk(Cm, kk, dim=1)
    if kk < maxc:
        vals = torch.cat([vals, vals.new_full((B, maxc - kk), -2.0)], 1)
        idx = torch.cat([idx, idx.new_zeros((B, maxc - kk))], 1)
    return vals, idx.to(torch.int32)


def filter_verify_batch(q_arr, qlens, win_pres, win_syms, *, sigma: int,
                        q: int, L: int, stride: int, tlen: int, k: int,
                        maxc: int, nw: int):
    """Filter + verify one read batch against a prebuilt target index.

    q_arr: (B, qmax) read symbol ids (uint8 or int32); qlens: int32 (B,).
    Returns (all on the operands' device)
      gbest int32 (B,) — exact best HW score when the read resolved and
        gbest <= k; > k (up to _BIG) proves best > k;
      gpos int32 (B,) — first best end position (target coordinates);
      resolved bool (B,) — False when more than maxc windows passed.
    Verification runs reduce_lanes (sigma <= 32) or reduce_bitplane
    (sigma > 32), as the JAX package routes it, one lane per (read,
    candidate) with the read's profile and the window's row by index."""
    qa = q_arr.to(torch.int32)
    qlens = qlens.to(torch.int32)
    B = qa.shape[0]
    dev = qa.device
    read_pres, distinct = read_gram_presence(qa, qlens, sigma, q)
    C = candidate_counts(read_pres, win_pres)             # (B, n_win)
    del read_pres
    tau = (distinct - k * q).to(torch.float32)
    passing = C >= tau[:, None]
    n_pass = passing.sum(1)
    vals, widx = _top_candidates(torch.where(passing, C, -1.0), maxc)
    del C, passing
    valid = vals >= 0.0
    starts = widx * stride                                # (B, maxc)
    W = nw * 32 - qlens                                   # (B,)
    l_eff = (tlen - starts).clamp(max=L)
    lo = W[:, None].expand(B, maxc).reshape(-1).contiguous()
    # Padded and failing candidates get an empty window: no columns run.
    hi = torch.where(valid, W[:, None] + l_eff, 0).to(torch.int32).reshape(-1)
    prow = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        maxc)
    trow = widx.reshape(-1).contiguous()
    if sigma > 32:
        nb = ck.bitplane_nb(sigma)
        q_alts, pad_words = ck.bitplane_identity_operands(qa, qlens, sigma,
                                                          nw)
        best_c, pf_c, _, _ = ck.reduce_bitplane(
            ck.bitplane_planes(q_alts, nb), pad_words, win_syms, lo, hi,
            prow, trow, 0, nb, 1, sigma)
    else:
        peq = ck.build_peq_device(qa, qlens, sigma, nw)
        best_c, pf_c, _, _ = ck.reduce_lanes(peq, win_syms, lo, hi, prow,
                                             trow, 0)
    best_c = torch.where(valid, best_c.view(B, maxc), _BIG)
    gbest = best_c.min(1).values
    gpos_c = starts + pf_c.view(B, maxc) - W[:, None]
    gpos = torch.where(best_c == gbest[:, None], gpos_c, _BIG).min(1).values
    return gbest.to(torch.int32), gpos.to(torch.int32), n_pass <= maxc


def sample_pass_counts(q_arr, qlens, win_pres, sigma: int, q: int,
                       k: int) -> torch.Tensor:
    """Per-read passing-window counts — the filter's own first stage."""
    pres, distinct = read_gram_presence(q_arr.to(torch.int32), qlens, sigma,
                                        q)
    C = candidate_counts(pres, win_pres)
    tau = (distinct - k * q).to(torch.float32)
    return (C >= tau[:, None]).sum(1)


def auto_tune(t_np, sigma: int, q0: int, k: int, qlen_min: int, L: int,
              stride: int, n_win: int, Lv: int, index_builder,
              n_samples: int = 128, max_vocab: Optional[int] = None,
              device=None):
    """(q, maxc, win_pres, win_syms, pred_resolved) derived from the target
    index itself, or (None, 0, None, None, 0.0) when no sound q bounds the
    shared-gram tail (repeat-rich targets: the full sweep is the honest
    route).  Probe reads sampled from the target with k substitutions each
    run the filter's first stage; the p99 pass count picks maxc from the
    ladder, q escalates while the tail stays unbounded (the JAX package's
    auto_tune, same probes from the same seed, so the same verdict).

    index_builder(q) -> (win_pres, win_syms) builds or returns the cached
    index for q; device is where the probes run (the index's device)."""
    if len(t_np) <= qlen_min:
        return None, 0, None, None, 0.0   # no full-length probe fits
    cap = MAX_VOCAB if max_vocab is None else min(MAX_VOCAB, max_vocab)
    rng = np.random.RandomState(12345)
    starts = rng.randint(0, max(1, len(t_np) - qlen_min), n_samples)
    probes = np.stack([t_np[s:s + qlen_min] for s in starts]).astype(
        np.int32)
    if k > 0 and sigma > 1:
        rows = np.arange(n_samples)[:, None]
        pos = rng.randint(0, qlen_min, (n_samples, k))
        delta = rng.randint(1, sigma, (n_samples, k)).astype(np.int32)
        probes[rows, pos] = (probes[rows, pos] + delta) % sigma
    probes_t = torch.from_numpy(probes).to(device)
    qlens = torch.full((n_samples,), qlen_min, dtype=torch.int32,
                       device=device)
    q_try = q0
    last_resort = None
    while True:
        win_pres, win_syms = index_builder(q_try)
        n_pass = sample_pass_counts(probes_t, qlens, win_pres, sigma, q_try,
                                    k).cpu().numpy()
        p99 = int(np.percentile(n_pass, 99))
        for maxc in _MAXC_LADDER[:-1]:
            if p99 + 5 <= maxc:
                pred = float((n_pass <= maxc).mean())
                return q_try, maxc, win_pres, win_syms, pred
        pred64 = float((n_pass <= _MAXC_LADDER[-1]).mean())
        if pred64 >= 0.9 and last_resort is None:
            last_resort = (q_try, _MAXC_LADDER[-1], win_pres, win_syms,
                           pred64)
        if int(np.median(n_pass)) > max(_MAXC_LADDER[-1], n_win // 8):
            break   # exact repeats share every gram at any q
        q2 = q_try + 1
        m_eff2 = qlen_min - q2 + 1
        if sigma ** q2 > cap or m_eff2 < 1 or m_eff2 - k * q2 < 1:
            break
        q_try = q2
    if last_resort is not None:
        return last_resort
    return None, 0, None, None, 0.0


def filter_verify_map(q_arr, qlens, t_ids, *, sigma: int, q: int, L: int,
                      stride: int, n_win: int, k: int, maxc: int, nw: int):
    """One-shot convenience: build the target index, then filter + verify
    (callers mapping many batches against one target build the index once
    with build_target_index)."""
    Lv = verify_cols(L, nw)
    win_pres, win_syms = build_target_index(t_ids, sigma, q, L, stride,
                                            n_win, Lv)
    return filter_verify_batch(
        q_arr, qlens, win_pres, win_syms, sigma=sigma, q=q, L=L,
        stride=stride, tlen=t_ids.shape[0], k=k, maxc=maxc, nw=nw)
