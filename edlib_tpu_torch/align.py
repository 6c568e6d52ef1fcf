"""align and align_batch on the card (the entry points of edlib_tpu/align.py).

Signature and result-dict parity with the reference Python binding
(edlib.pyx:56-155): {editDistance, alphabetLength, locations: [(start|None,
end)], cigar}.  Both entry points run the batched device path
(batch.align_batch_device); align is a batch of one.  Tasks "distance",
"locations" and "path" (the extended CIGAR of the first location pair) in
every mode; the ``mesh=`` sharding of edlib_tpu.align_batch is not ported
yet and raises NotImplementedError.

One reference quirk is emulated exactly: edlib can report end location -1
(query aligned entirely before the target, edlib.cpp:237-249).  With 64-bit
words that candidate exists iff Q % 64 != 0, and its score is exactly Q (it
survives filtering only when the overall best equals Q).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from edlib_tpu_torch import encode
from edlib_tpu_torch.utils import hw

_INF = float("inf")


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
                additionalEqualities=None, device=None, mesh=None
                ) -> List[dict]:
    """Batched alignment on the card, equal to edlib_tpu.align_batch.

    queries/targets: sequences of str/bytes; pair i aligns queries[i] vs
    targets[i] (a single target is broadcast to all queries, and the
    sweeps then read that one target).  task="path" reconstructs each
    window on the card (the column-capture kernel) or, past the device
    route's size bounds, on the host.  device: None (the card; raises
    RuntimeError without one) or a torch device; "cpu" runs the kernels'
    plain PyTorch versions."""
    if mesh is not None:
        raise NotImplementedError(
            "edlib_tpu_torch: align_batch(mesh=...) is not ported yet "
            "(ROADMAP Queue A 13)")
    dev = hw.resolve_device(device)
    if isinstance(targets, (str, bytes, bytearray)):
        targets = [targets] * len(queries)
    if len(queries) != len(targets):
        raise ValueError("queries and targets must have equal length")
    from edlib_tpu_torch.batch import align_batch_device
    return align_batch_device(queries, targets, mode=mode, task=task, k=k,
                              additionalEqualities=additionalEqualities,
                              device=dev)


def align(query, target, mode="NW", task="distance", k=-1,
          additionalEqualities=None, device=None) -> dict:
    """Align query with target using edit distance, as edlib_tpu.align: a
    device batch of one pair (inputs of any hashable alphabet are mapped to
    bytes first, edlib.pyx:22-53)."""
    qb, tb, eq_pairs = encode.map_to_bytes(query, target,
                                           additionalEqualities)
    return align_batch([qb], [tb], mode=mode, task=task, k=k,
                       additionalEqualities=eq_pairs, device=device)[0]
