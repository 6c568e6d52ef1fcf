"""Sequence encoding: alphabet discovery, equality extension, query profiles.

Host-side numpy, copied from the JAX package (C3 alphabet transform,
edlib.cpp:1417-1462; C4 equalities, edlib.cpp:63-94; C5 query profile,
edlib.cpp:358-384, as packed words and as big-ints for the host engine).  Bit-parallel words are 32 bits wide, as in the JAX
package, so word counts, wildcard padding and every scan-column offset agree
between the two.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

WORD_SIZE = 32
MAX_ALPHABET = 256


class NeedsAlphabetMapping(Exception):
    pass


def _map_ascii(seq) -> bytes:
    """Fast path: bytes, or str that is pure ASCII (edlib.pyx:11-19)."""
    if isinstance(seq, bytes):
        return seq
    if isinstance(seq, bytearray):
        return bytes(seq)
    if isinstance(seq, str):
        b = seq.encode("utf-8")
        if len(b) == len(seq):
            return b
    raise NeedsAlphabetMapping()


def map_to_bytes(query, target, additional_equalities):
    """Map hashable inputs to byte strings (edlib.pyx:22-53).

    Accepts str/bytes or any iterable of hashables; if the combined alphabet
    exceeds 256 symbols raises ValueError.  Returns (query_bytes,
    target_bytes, equalities as list of (byte,byte) int pairs or None).
    """
    try:
        qb = _map_ascii(query)
        tb = _map_ascii(target)
        eqs = None
        if additional_equalities is not None:
            eqs = []
            for a, b in additional_equalities:
                eqs.append((_eq_symbol_to_byte(a), _eq_symbol_to_byte(b)))
        return qb, tb, eqs
    except NeedsAlphabetMapping:
        pass
    alphabet = set(query).union(set(target))
    if len(alphabet) > MAX_ALPHABET:
        raise ValueError(
            "query and target combined have more than 256 unique values, "
            "this is not supported.")
    mapping = {c: idx for idx, c in enumerate(alphabet)}
    qb = bytes(mapping[c] for c in query)
    tb = bytes(mapping[c] for c in target)
    eqs = None
    if additional_equalities is not None:
        eqs = [(mapping[a], mapping[b]) for a, b in additional_equalities
               if a in mapping and b in mapping]
    return qb, tb, eqs


def _eq_symbol_to_byte(x) -> int:
    """First utf-8 byte of an equality-pair element (edlib.pyx:120-121)."""
    if isinstance(x, int):
        return x & 0xFF
    if isinstance(x, (bytes, bytearray)):
        return x[0]
    return bytearray(str(x).encode("utf-8"))[0]


def transform_sequences(query: bytes, target: bytes
                        ) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Discover the alphabet and remap chars to ordinals 0..sigma-1, in
    first-appearance order, query first (transformSequences,
    edlib.cpp:1417-1462).  Returns (query_ids uint8, target_ids uint8,
    alphabet bytes where alphabet[i] is the original char with ordinal i).
    """
    q = np.frombuffer(query, dtype=np.uint8)
    t = np.frombuffer(target, dtype=np.uint8)
    letter_idx = np.full(MAX_ALPHABET, -1, dtype=np.int16)
    alphabet = bytearray()
    for seq in (q, t):
        vals, idx = np.unique(seq, return_index=True)
        for i in np.argsort(idx):
            c = int(vals[i])
            if letter_idx[c] < 0:
                letter_idx[c] = len(alphabet)
                alphabet.append(c)
    q_ids = letter_idx[q].astype(np.uint8) if len(q) else np.zeros(0, np.uint8)
    t_ids = letter_idx[t].astype(np.uint8) if len(t) else np.zeros(0, np.uint8)
    return q_ids, t_ids, bytes(alphabet)


def build_equality_matrix(alphabet: bytes,
                          additional_equalities: Optional[
                              Sequence[Tuple[int, int]]]) -> np.ndarray:
    """sigma x sigma bool matrix: identity + symmetric extra pairs, given as
    original byte values (pairs whose chars are absent are ignored;
    EqualityDefinition, edlib.cpp:63-94)."""
    sigma = len(alphabet)
    eq = np.eye(sigma, dtype=bool)
    if additional_equalities:
        pos = {c: i for i, c in enumerate(alphabet)}
        for a, b in additional_equalities:
            ia, ib = pos.get(a), pos.get(b)
            if ia is not None and ib is not None:
                eq[ia, ib] = eq[ib, ia] = True
    return eq


def nw_upper_bound(q_ids, t_ids, eq=None) -> int:
    """Substitution-only NW bound: d_NW <= hamming(prefixes) + |len diff|.
    Caps the k-doubling ladders (the run at the cap always succeeds).  eq:
    optional sigma x sigma bool matrix (equalities count as matches)."""
    m = min(len(q_ids), len(t_ids))
    if eq is None:
        mism = int(np.count_nonzero(
            np.asarray(q_ids[:m]) != np.asarray(t_ids[:m])))
    else:
        mism = int(np.count_nonzero(
            ~eq[np.asarray(q_ids[:m], np.intp),
                np.asarray(t_ids[:m], np.intp)]))
    return abs(len(q_ids) - len(t_ids)) + mism


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


def build_peq_bigint(q_ids: np.ndarray, eq: np.ndarray) -> List[int]:
    """Query profile as Python big-ints, one per symbol plus the wildcard
    row: bit i == query cell i, exactly len(query) bits, no padding (the
    host big-int engine, ops/host.py, needs none)."""
    qlen = len(q_ids)
    sigma = eq.shape[0]
    out = []
    for s in range(sigma):
        if qlen:
            bits = np.packbits(eq[s, q_ids], bitorder="little").tobytes()
            out.append(int.from_bytes(bits, "little"))
        else:
            out.append(0)
    out.append((1 << qlen) - 1)  # wildcard row
    return out
