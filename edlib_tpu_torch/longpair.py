"""Long single-pair alignment on the card (the port of edlib_tpu/longpair.py).

``nw_distance_long``, ``shw_best_long`` and ``semiglobal_locations_long``
answer for ONE (possibly multi-Mbp) pair with the wavefront kernels, which
spread the pair over the whole card (ops/wavefront.py).  Results equal
edlib's, including the -1-above-k convention when k >= 0.

backend: "auto" and "wavefront" run the wavefront on ``device`` (the card,
or with device="cpu" the kernels' plain PyTorch versions); "native" runs the
port's host big-int engine (ops/host.py), which takes the place of the JAX
package's native C++ engine.
"""

from __future__ import annotations

import numpy as np

from edlib_tpu_torch import encode
from edlib_tpu_torch.utils import hw

_BACKENDS = ("auto", "wavefront", "native")


def _prep(query, target, backend: str, device):
    """(q_ids, t_ids, sigma, torch device) after the alphabet transform."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    dev = hw.resolve_device(device)
    qb = query.encode() if isinstance(query, str) else bytes(query)
    tb = target.encode() if isinstance(target, str) else bytes(target)
    q_ids, t_ids, alphabet = encode.transform_sequences(qb, tb)
    return q_ids, t_ids, len(alphabet), dev


def _host_semiglobal(q_ids, t_ids, sigma: int, mode: str, k: int):
    """(best, all minimal end positions) on the host engine."""
    from edlib_tpu_torch.align import _filter_locations
    from edlib_tpu_torch.ops import host
    peq = encode.build_peq_bigint(q_ids, np.eye(sigma, dtype=bool))
    scores = host.semiglobal_scores(peq, t_ids, len(q_ids), mode)
    return _filter_locations(scores, len(q_ids), float("inf") if k < 0 else k)


def nw_distance_long(query, target, k: int = -1, backend: str = "auto",
                     device=None) -> int:
    """NW edit distance of one long pair; -1 when k >= 0 and the distance
    exceeds k.  The banded wavefront with a dynamic-k ladder capped at the
    substitution bound."""
    q_ids, t_ids, sigma, dev = _prep(query, target, backend, device)
    qlen, tlen = len(q_ids), len(t_ids)
    if qlen == 0 or tlen == 0:
        d = max(qlen, tlen)
        return d if k < 0 or d <= k else -1
    if backend == "native":
        from edlib_tpu_torch.ops import host
        peq = encode.build_peq_bigint(q_ids, np.eye(sigma, dtype=bool))
        d = int(host.nw_run(peq, t_ids, qlen)[0].score)
        return d if k < 0 or d <= k else -1
    from edlib_tpu_torch.ops.wavefront import BandedWavefront
    return BandedWavefront(device=dev).nw_distance(q_ids, t_ids, sigma, k=k)


def shw_best_long(query, target, k: int = -1, backend: str = "auto",
                  device=None):
    """SHW (prefix) best score and FIRST best end location of one long
    pair: ``(editDistance, endLocation)``; ``(-1, -1)`` when k >= 0 and the
    best exceeds k.  The first location is the head of edlib's endLocations
    list, including its -1 "query ends before the target" padding artifact
    (edlib.cpp:550-704; align._filter_locations)."""
    q_ids, t_ids, sigma, dev = _prep(query, target, backend, device)
    qlen, tlen = len(q_ids), len(t_ids)
    if qlen == 0 or tlen == 0:
        # edlib's empty-sequence early return (edlib.cpp:166-184).
        return (qlen, -1) if k < 0 or qlen <= k else (-1, -1)
    if backend == "native":
        best, positions = _host_semiglobal(q_ids, t_ids, sigma, "SHW", k)
        return (best, positions[0]) if best >= 0 else (-1, -1)
    from edlib_tpu_torch.ops.wavefront import BandedWavefront
    best, pos = BandedWavefront(device=dev).shw_best(q_ids, t_ids, sigma, k=k)
    if best < 0:
        return (-1, -1)
    if best == qlen and qlen % 64 != 0:
        return best, -1   # the 64-bit padding artifact precedes column 0
    return best, pos


def semiglobal_locations_long(query, target, mode: str = "HW", k: int = -1,
                              backend: str = "auto", device=None):
    """ALL minimal end locations of one long semiglobal pair:
    ``(editDistance, [endLocations])`` in edlib's order (edlib.cpp:657-693),
    ``(-1, [])`` above k.  SHW takes the banded full-stream search; HW (no
    static band: a free start at every column) the unbanded stream-emitting
    wavefront, filtered on the host."""
    q_ids, t_ids, sigma, dev = _prep(query, target, backend, device)
    qlen, tlen = len(q_ids), len(t_ids)
    if qlen == 0 or tlen == 0:
        # edlib's empty-sequence early return (edlib.cpp:166-184).
        return (qlen, [-1]) if k < 0 or qlen <= k else (-1, [])
    mode = mode.upper()
    if mode not in ("HW", "SHW"):
        raise ValueError("mode must be HW or SHW")
    if backend == "native":
        return _host_semiglobal(q_ids, t_ids, sigma, mode, k)
    from edlib_tpu_torch.ops.wavefront import BandedWavefront, Wavefront
    if mode == "SHW":
        return BandedWavefront(device=dev).shw_locations(q_ids, t_ids, sigma,
                                                         k=k)
    from edlib_tpu_torch.align import _filter_locations
    scores = Wavefront(device=dev).semiglobal_scores(q_ids, t_ids, sigma,
                                                     mode_is_hw=True)
    return _filter_locations(scores, qlen, float("inf") if k < 0 else k)
