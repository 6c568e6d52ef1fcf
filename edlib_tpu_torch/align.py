"""align and align_batch on the card (the entry points of edlib_tpu/align.py).

Signature and result-dict parity with the reference Python binding
(edlib.pyx:56-155): {editDistance, alphabetLength, locations: [(start|None,
end)], cigar}.  Both entry points run the batched device path
(batch.align_batch_device); align is a batch of one, except for huge NW
pairs (at least EDLIB_TPU_WAVEFRONT_MIN_CELLS effective DP cells, 8e9 by
default), whose distance comes from the banded wavefront that spreads the
pair over the whole card (ops/wavefront.py).  Tasks "distance",
"locations" and "path" (the extended CIGAR of the first location pair) in
every mode, at every alphabet size and length the reference takes: buckets
past the per-lane kernels' alphabet cap or routing budget (dense
equalities past 63 symbols, queries past 65,536 bp) take the bit-plane,
eq-stream or score-stream kernels, as edlib_tpu routes them.
align_batch's ``backend="host"`` aligns pair by pair on edlib_tpu.align's
host route: the native C++ engine (native_loader.py) for distance and
locations in one call, or for task "path" its banded sweeps, start
re-runs and reconstruction (align_host); and ``mesh=`` (a
parallel.DeviceGrid) shards the sweeps over a grid of devices as edlib_tpu
shards them over its mesh.

One reference quirk is emulated exactly: edlib can report end location -1
(query aligned entirely before the target, edlib.cpp:237-249).  With 64-bit
words that candidate exists iff Q % 64 != 0, and its score is exactly Q (it
survives filtering only when the overall best equals Q).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from edlib_tpu_torch import encode, native_loader
from edlib_tpu_torch.types import (STATUS_OK, AlignMode, AlignResult,
                                   AlignTask)
from edlib_tpu_torch.utils import hw

_INF = float("inf")

# Huge NW pairs take the banded wavefront from this many effective DP cells
# (edlib_tpu/align.py:127-146: its attached-chip floor; the card is
# attached, so no dispatch-RTT scaling).  EDLIB_TPU_WAVEFRONT_MIN_CELLS
# overrides; _WAVEFRONT_MIN_CELLS is also the tests' monkeypatch point.
_env_wf = os.environ.get("EDLIB_TPU_WAVEFRONT_MIN_CELLS")
_WAVEFRONT_MIN_CELLS = int(_env_wf) if _env_wf else None
_WAVEFRONT_FLOOR_CELLS = 8_000_000_000


def _wavefront_gate() -> int:
    return (_WAVEFRONT_MIN_CELLS if _WAVEFRONT_MIN_CELLS is not None
            else _WAVEFRONT_FLOOR_CELLS)


def _nw_effective_cells(q_ids, t_ids, eq, k_eff,
                        d_ub: Optional[int] = None) -> int:
    """Similarity-aware DP cost of an NW pair (edlib_tpu/align.py:184-205):
    a banded engine visits ~2*(d+1)*max_len cells, d bounded by the O(n)
    substitution bound and a finite k; never more than qlen*tlen."""
    qlen, tlen = len(q_ids), len(t_ids)
    if d_ub is None:
        d_ub = encode.nw_upper_bound(q_ids, t_ids, eq)
    if not (k_eff is _INF or k_eff >= (1 << 40)):
        d_ub = min(d_ub, int(k_eff) + 1)
    return min(qlen * tlen, 2 * (d_ub + 1) * max(qlen, tlen))


def _nw_wavefront_run(q_ids, t_ids, eq, k_eff, device) -> int:
    """One NW distance on the banded wavefront (-1 above k_eff)."""
    from edlib_tpu_torch.ops.wavefront import BandedWavefront
    k = -1 if (k_eff is _INF or k_eff >= (1 << 40)) else int(k_eff)
    return BandedWavefront(device=device).nw_distance(
        q_ids, t_ids, eq.shape[0], k=k, eq=eq)


def _align_huge_nw(qb: bytes, tb: bytes, eq_pairs, task: AlignTask, k: int,
                   device) -> Optional[dict]:
    """align's result for an NW pair past the wavefront gate, else None
    (the pair goes to the batch of one).  The distance comes from the
    banded wavefront, the end is tlen-1, the start 0, and the path is
    obtain_alignment's (edlib_tpu/align.py:459-489), also for task "path",
    where the JAX package keeps the distance on its native engine."""
    if not qb or not tb or len(qb) * len(tb) < _wavefront_gate():
        return None
    q_ids, t_ids, alphabet = encode.transform_sequences(qb, tb)
    eq = encode.build_equality_matrix(alphabet, eq_pairs)
    k_eff = _INF if k < 0 else k
    if _nw_effective_cells(q_ids, t_ids, eq, k_eff) < _wavefront_gate():
        return None
    dev = hw.resolve_device(device)
    res = AlignResult(status=STATUS_OK, alphabet_length=len(alphabet))
    d = _nw_wavefront_run(q_ids, t_ids, eq, k_eff, dev)
    if d < 0:
        return res.to_dict()
    res.edit_distance = d
    res.end_locations = np.array([len(t_ids) - 1], np.int64)
    res.num_locations = 1
    if task in (AlignTask.LOC, AlignTask.PATH):
        res.start_locations = np.zeros(1, np.int64)
    if task == AlignTask.PATH:
        from edlib_tpu_torch.path.hirschberg import obtain_alignment
        res.alignment = obtain_alignment(q_ids, t_ids, eq, d, device=dev)
        res.alignment_length = len(res.alignment)
    return res.to_dict()


def _neg1_candidate_exists(qlen: int) -> bool:
    """edlib-64 parity: the -1 end-location candidate (score == Q) exists iff
    the reference's last 64-bit block has padding (Q % 64 != 0)."""
    return qlen % 64 != 0


def _filter_locations(col_scores: np.ndarray, qlen: int, k_eff: float
                      ) -> Tuple[int, List[int]]:
    """All minimal end positions from per-column bottom-row scores
    (myersCalcEditDistanceSemiGlobal's record/clear/tighten,
    edlib.cpp:657-693, on a full sweep)."""
    candidates_scores = [int(col_scores.min())] if col_scores.size else []
    best = min(candidates_scores) if candidates_scores else _INF
    if _neg1_candidate_exists(qlen):
        best = min(best, qlen)
    if best > k_eff or best is _INF:
        return -1, []
    positions: List[int] = []
    if _neg1_candidate_exists(qlen) and qlen == best:
        positions.append(-1)
    positions.extend(int(p) for p in np.nonzero(col_scores == best)[0])
    return int(best), positions


def _native_ctx(q_ids, t_ids, eq):
    """(peq64, t_ext, w64) for the native 64-bit engines, or None."""
    sigma = eq.shape[0]
    if sigma > 255 or not native_loader.available():
        return None
    qlen = len(q_ids)
    nw64 = encode.num_words(qlen, 64)
    w64 = nw64 * 64 - qlen
    peq64 = native_loader.build_peq64_native(q_ids, eq)
    t_ext = np.concatenate([np.asarray(t_ids, np.uint8),
                            np.full(w64, sigma, np.uint8)])
    return peq64, t_ext, w64


def _semiglobal_best_positions(q_ids, t_ids, eq, mode, k_eff
                               ) -> Tuple[int, List[int]]:
    """Best score and all minimal end positions of an HW/SHW pair on the
    host (edlib_tpu/align.py:87-116): the native banded search, the
    reference's dynamic-k doubling in C for unbounded k; else the host
    big-int engine's full stream."""
    mode = AlignMode.parse(mode)
    qlen = len(q_ids)
    hin0 = 0 if mode == AlignMode.HW else 1
    ctx = _native_ctx(q_ids, t_ids, eq)
    if ctx is not None:
        peq64, t_ext, w64 = ctx
        k = -1 if (k_eff is _INF or k_eff >= (1 << 40)) else int(k_eff)
        best, positions = native_loader.semiglobal_best_native(
            peq64, t_ext, w64, qlen, len(t_ids), hin0, k)
        if best < 0:
            return -1, []
        return best, [int(p) for p in positions]
    from edlib_tpu_torch.ops import host as host_engine
    peq = encode.build_peq_bigint(q_ids, eq)
    scores = host_engine.semiglobal_scores(peq, t_ids, qlen, mode.name)
    return _filter_locations(scores, qlen, k_eff)


def _nw_score_host(q_ids, t_ids, eq, k_eff) -> int:
    """NW distance on the host, -1 above k_eff (edlib_tpu/align.py:378-400):
    the native banded sweep, with the k doubling ladder from 64 for
    unbounded k, capped at the substitution bound; else the big-int
    engine.  The JAX package's race against its device (_nw_race) is not
    ported."""
    qlen, tlen = len(q_ids), len(t_ids)
    ctx = _native_ctx(q_ids, t_ids, eq)
    if ctx is not None:
        peq64 = ctx[0]
        bound = max(1, min(max(qlen, tlen),
                           encode.nw_upper_bound(q_ids, t_ids, eq)))
        if k_eff is _INF or k_eff >= (1 << 40):
            k = 64
            while True:
                d = native_loader.nw_distance_banded_native(
                    peq64, t_ids, qlen, min(k, bound))
                if d >= 0 or k >= bound:
                    return d    # at the bound the band always answers
                k *= 2
        return native_loader.nw_distance_banded_native(
            peq64, t_ids, qlen, int(min(k_eff, bound)))
    from edlib_tpu_torch.ops import host as host_engine
    state, _ = host_engine.nw_run(encode.build_peq_bigint(q_ids, eq), t_ids,
                                  qlen)
    score = int(state.score)
    return score if score <= k_eff else -1


def _hw_start_locations(q_ids, t_ids, eq, edit_distance: int,
                        end_locations) -> List[int]:
    """HW start locations: the last minimal reversed-SHW position before
    each end (edlib.cpp:230-266), over the last Q + d target symbols."""
    qlen = len(q_ids)
    rq = q_ids[::-1].copy()
    starts = []
    for e in end_locations:
        if e == -1:
            starts.append(0)    # open edge case, edlib.cpp:237-249
            continue
        lim = qlen + edit_distance
        rt_prefix = t_ids[max(0, e + 1 - lim):e + 1][::-1].copy()
        _, positions = _semiglobal_best_positions(rq, rt_prefix, eq,
                                                  AlignMode.SHW,
                                                  edit_distance)
        starts.append(e - positions[-1])
    return starts


def _align_ids_host(q_ids, t_ids, eq, k: int, mode: AlignMode,
                    task: AlignTask, alphabet_length: int) -> AlignResult:
    """edlib_tpu.align.align_ids on the host engines, for non-empty
    sequences: distance and ends, start locations, then the alignment of
    the first location pair (edlib.cpp:274-289)."""
    res = AlignResult(status=STATUS_OK, alphabet_length=alphabet_length)
    k_eff = _INF if k < 0 else k
    if mode == AlignMode.NW:
        d = _nw_score_host(q_ids, t_ids, eq, k_eff)
        if d >= 0:
            res.edit_distance = d
            res.end_locations = np.array([len(t_ids) - 1], np.int64)
            res.num_locations = 1
    else:
        best, positions = _semiglobal_best_positions(q_ids, t_ids, eq, mode,
                                                     k_eff)
        res.edit_distance = best
        if best >= 0:
            res.end_locations = np.array(positions, np.int64)
            res.num_locations = len(positions)
    if res.edit_distance < 0:
        return res
    if task in (AlignTask.LOC, AlignTask.PATH):
        if mode == AlignMode.HW:
            res.start_locations = np.array(_hw_start_locations(
                q_ids, t_ids, eq, res.edit_distance, res.end_locations),
                np.int64)
        else:
            res.start_locations = np.zeros(res.num_locations, np.int64)
    if task == AlignTask.PATH:
        from edlib_tpu_torch.path.hirschberg import obtain_alignment
        start0 = int(res.start_locations[0])
        end0 = int(res.end_locations[0])
        res.alignment = obtain_alignment(q_ids, t_ids[start0:end0 + 1], eq,
                                         res.edit_distance)
        res.alignment_length = len(res.alignment)
    return res


def _align_native(qb: bytes, tb: bytes, eq_pairs, mode: AlignMode,
                  task: AlignTask, k: int) -> Optional[dict]:
    """One pair on edlib_tpu.align's host route (edlib_tpu/align.py:
    520-572), or None where the port keeps its own route: an empty
    sequence, an NW pair past the wavefront gate, or no native library.
    Distance and locations come from one call of the CPython extension
    (or, where only the ctypes library loaded, from the host engines, which
    run on it); task "path" from the host engines and obtain_alignment."""
    if not qb or not tb or not native_loader.available():
        return None
    if mode == AlignMode.NW and len(qb) * len(tb) >= _wavefront_gate():
        return None
    ext = native_loader.get_ext() if task != AlignTask.PATH else None
    if ext is not None:
        eq_a = eq_b = None
        if eq_pairs:
            eq_a = bytes(p[0] for p in eq_pairs)
            eq_b = bytes(p[1] for p in eq_pairs)
        out = ext.align(qb, tb, int(mode), int(task == AlignTask.LOC),
                        int(k), eq_a, eq_b)
        if out is not None:
            dist, alpha, ends, starts = out
            return {"editDistance": dist, "alphabetLength": alpha,
                    "locations": ([(None, e) for e in ends]
                                  if starts is None
                                  else list(zip(starts, ends))),
                    "cigar": None}
    q_ids, t_ids, alphabet = encode.transform_sequences(qb, tb)
    eq = encode.build_equality_matrix(alphabet, eq_pairs)
    return _align_ids_host(q_ids, t_ids, eq, k, mode, task,
                           len(alphabet)).to_dict()


def align_host(query, target, mode="NW", task="distance", k=-1,
               additionalEqualities=None) -> dict:
    """One pair on the host, as edlib_tpu.align runs it without a device:
    the native engine where it is loaded and the pair is not empty or an
    NW pair past the wavefront gate, else align(..., device="cpu")."""
    if k is None:
        k = -1
    qb, tb, eq_pairs = encode.map_to_bytes(query, target,
                                           additionalEqualities)
    got = _align_native(qb, tb, eq_pairs, AlignMode.parse(mode),
                        AlignTask.parse(task), k)
    if got is not None:
        return got
    return align(qb, tb, mode=mode, task=task, k=k,
                 additionalEqualities=eq_pairs, device="cpu")


def _threads_allowed() -> bool:
    """EDLIB_TPU_THREADS "0" or "1" turns the host pools off, as in the
    JAX package (and the native recursion's forks, which read it too)."""
    return os.environ.get("EDLIB_TPU_THREADS", "") not in ("0", "1")


def _host_pool_map(fn, items):
    """fn over items on a thread pool (the native engine releases the
    interpreter lock), each worker's PATH recursion sequential."""
    from concurrent.futures import ThreadPoolExecutor

    from edlib_tpu_torch.path.hirschberg import PATH_POOL_CTX

    def one(item):
        PATH_POOL_CTX.sequential = True
        return fn(item)

    with ThreadPoolExecutor(
            max_workers=min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(one, items))


def align_batch(queries, targets, mode="NW", task="distance", k=-1,
                additionalEqualities=None, backend: str = "auto", mesh=None,
                device=None) -> List[dict]:
    """Batched alignment on the card, equal to edlib_tpu.align_batch.

    queries/targets: sequences of str/bytes; pair i aligns queries[i] vs
    targets[i] (a single target is broadcast to all queries, and the
    sweeps then read that one target).  task="path" reconstructs each
    window on the card (the column-capture kernel) or, past the device
    route's size bounds, on the host.

    backend: "auto" and "jax" run the batched device path on `device`;
    "host" aligns pair by pair with align_host (the native engine, as
    edlib_tpu's host route), PATH batches of at least 4 pairs pooled over
    the host's cores.  With mesh given, backend is ignored, as in the JAX
    package.

    mesh: a parallel.DeviceGrid: shared-target HW buckets go
    sequence-parallel over its "sp" axis with halo slices, every other
    bucket data-parallel over the whole grid, the locations merged on its
    first device (parallel/dist.py); results equal the unsharded path's.

    device: None (the card, or with a mesh the grid's first device; raises
    RuntimeError without a card) or a torch device; "cpu" runs the kernels'
    plain PyTorch versions."""
    grid = None
    if mesh is not None:
        from edlib_tpu_torch.parallel.dist import check_grid
        grid = check_grid(mesh)
        dev = grid.first if device is None else hw.resolve_device(device)
    elif backend == "host":
        dev = torch.device("cpu")
    else:
        dev = hw.resolve_device(device)
    if isinstance(targets, (str, bytes, bytearray)):
        targets = [targets] * len(queries)
    if len(queries) != len(targets):
        raise ValueError("queries and targets must have equal length")
    if backend == "host" and grid is None:
        pairs = list(zip(queries, targets))

        def one(qt):
            return align_host(qt[0], qt[1], mode=mode, task=task, k=k,
                              additionalEqualities=additionalEqualities)

        # PATH pairs are independent and long enough to pay for the pool
        # (edlib_tpu/align.py:618-637).
        if (AlignTask.parse(task) == AlignTask.PATH and len(pairs) >= 4
                and native_loader.available() and _threads_allowed()):
            return _host_pool_map(one, pairs)
        return [one(qt) for qt in pairs]
    from edlib_tpu_torch.batch import align_batch_device
    return align_batch_device(queries, targets, mode=mode, task=task, k=k,
                              additionalEqualities=additionalEqualities,
                              device=dev, mesh=grid)


def align(query, target, mode="NW", task="distance", k=-1,
          additionalEqualities=None, device=None) -> dict:
    """Align query with target using edit distance, as edlib_tpu.align: a
    device batch of one pair, or for NW pairs past the wavefront gate the
    banded wavefront (inputs of any hashable alphabet are mapped to bytes
    first, edlib.pyx:22-53)."""
    qb, tb, eq_pairs = encode.map_to_bytes(query, target,
                                           additionalEqualities)
    if AlignMode.parse(mode) == AlignMode.NW:
        got = _align_huge_nw(qb, tb, eq_pairs, AlignTask.parse(task),
                             -1 if k is None else k, device)
        if got is not None:
            return got
    return align_batch([qb], [tb], mode=mode, task=task, k=k,
                       additionalEqualities=eq_pairs, device=device)[0]
