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
align_batch's ``backend="host"`` aligns pair by pair with ``align(...,
device="cpu")``, and ``mesh=`` (a parallel.DeviceGrid) shards the sweeps
over a grid of devices as edlib_tpu shards them over its mesh.

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

from edlib_tpu_torch import encode
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
    "host" aligns pair by pair with align(..., device="cpu"), the port's
    stand-in for the JAX package's native host engines.  With mesh given,
    backend is ignored, as in the JAX package.

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
        return [align(q, t, mode=mode, task=task, k=k,
                      additionalEqualities=additionalEqualities, device=dev)
                for q, t in zip(queries, targets)]
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
