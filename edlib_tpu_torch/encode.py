"""Word geometry and host-side query profiles (C5, edlib.cpp:358-384).

Bit-parallel words are 32 bits wide, as in the JAX package, so word counts,
wildcard padding and every scan-column offset agree between the two.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

WORD_SIZE = 32


def ceil_div(x: int, y: int) -> int:
    return -(-x // y)


def num_words(query_length: int, word_size: int = WORD_SIZE) -> int:
    return max(1, ceil_div(query_length, word_size))


def build_peq_words(q_ids: np.ndarray, eq: np.ndarray,
                    word_size: int = WORD_SIZE,
                    n_words: Optional[int] = None) -> np.ndarray:
    """Query profile as packed words: uint32[(sigma+1), n_words].

    Bit i of word b for symbol s is 1 iff query cell b*word_size+i matches s,
    where cells >= len(query) are wildcard (always 1) — the virtual padding of
    buildPeq (edlib.cpp:358-384).  Row sigma is the explicit wildcard symbol
    (all ones).
    """
    qlen = len(q_ids)
    sigma = eq.shape[0]
    nw = n_words if n_words is not None else num_words(qlen, word_size)
    total = nw * word_size
    match = np.ones((sigma + 1, total), dtype=bool)
    if qlen:
        match[:sigma, :qlen] = eq[:, q_ids]
    bits = match.reshape(sigma + 1, nw, word_size).astype(np.uint64)
    shifts = np.arange(word_size, dtype=np.uint64)
    peq = (bits << shifts).sum(axis=2, dtype=np.uint64)
    return peq.astype(np.uint32) if word_size == 32 else peq
