"""The general generator: genomes, read batches and mutated pairs from a seed.

Every input of every cell is made here, on the host with numpy's PCG64
generator seeded by ``--seed``, so one seed gives the same inputs on any
machine (the CPU tests see exactly what the card is given).  A
configuration's file says what to make (``kind``: ``genome`` or ``pair``)
and a traffic mix's file how to draw from it; neither holds code.

Sequences are bytes over "ACGT"; codes are uint8 0..3 in that order.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one purpose of one run: the seed and a
    stream tag, so adding a stream later leaves the others unchanged."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def to_bytes(codes: np.ndarray) -> bytes:
    return BASES[codes].tobytes()


def substitute(rng, codes: np.ndarray, pos: np.ndarray) -> None:
    """Replace codes[pos] by another base, in place (never the same)."""
    codes[pos] = (codes[pos] + rng.integers(1, 4, len(pos))) % 4


class Genome(NamedTuple):
    codes: np.ndarray        # uint8 (length,)
    repeat_spans: np.ndarray  # int64 (n, 2): [start, end) of every copy


def make_genome(cfg: dict, seed: int) -> Genome:
    """A random genome of cfg["length"] bases with the configuration's
    repeat families planted in it: each family one random segment, copied
    into its own slot of the genome and then diverged by substitutions at
    cfg["repeat_divergence"].  The sequence comes from the seed; the
    places of the copies from cfg["repeat_layout_seed"], the same in every
    run, as a genome's repeats keep their places: where they fall decides
    how many candidates a read in them passes, and so how much work the
    port's filter tuner plans for (its probe reads sit at fixed places)."""
    rng = rng_for(seed, 1)
    layout = np.random.default_rng(int(cfg.get("repeat_layout_seed", 0)))
    n = int(cfg["length"])
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    fams = [(int(f["length"]), int(f["copies"])) for f in cfg["repeats"]]
    n_copies = sum(c for _, c in fams)
    spans = np.zeros((n_copies, 2), np.int64)
    if n_copies:
        # One copy a slot of n // n_copies bases, at an offset in it, the
        # families dealt to slots in a shuffled order: no two overlap.
        slot = n // n_copies
        order = layout.permutation(n_copies)
        div = float(cfg["repeat_divergence"])
        i = 0
        for length, copies in fams:
            if length > slot:
                raise ValueError("repeat longer than its slot")
            unit = rng.integers(0, 4, length, dtype=np.uint8)
            for _ in range(copies):
                start = order[i] * slot + int(layout.integers(
                    0, slot - length + 1))
                copy = unit.copy()
                substitute(rng, copy, rng.choice(length, int(round(
                    div * length)), replace=False))
                codes[start:start + length] = copy
                spans[i] = (start, start + length)
                i += 1
    return Genome(codes, spans[np.argsort(spans[:, 0])])


class ReadBatch(NamedTuple):
    reads: List[bytes]
    codes: np.ndarray     # uint8 (B, read_len)
    origin: np.ndarray    # int64 (B,): first genome base, -1 for random
    is_random: np.ndarray  # bool (B,)


def edit_plan(rng, n: int, n_edits: int, mix) -> np.ndarray:
    """int8 (n, n_edits) edit types per read: 0 substitution, 1 insertion
    (a base in the read only), 2 deletion (a genome base the read skips),
    drawn with the probabilities mix = (sub, ins, del)."""
    p = np.asarray(mix, np.float64)
    return rng.choice(3, size=(n, n_edits), p=p / p.sum()).astype(np.int8)


def make_reads(genome: Genome, traffic: dict, seed: int,
               batch: int) -> ReadBatch:
    """One batch of traffic["reads_per_call"] reads of exactly
    traffic["read_len"] bases.  round(random_share * B) of them, at random
    indices, are random sequence; the others start at a uniform genome
    position and carry exactly round(edit_rate * read_len) edits of the
    mix's types at distinct alignment columns."""
    rng = rng_for(seed, 2, batch)
    B = int(traffic["reads_per_call"])
    m = int(traffic["read_len"])
    n_edits = int(round(float(traffic["edit_rate"]) * m))
    mix = (traffic["edit_mix"]["sub"], traffic["edit_mix"]["ins"],
           traffic["edit_mix"]["del"])
    g = genome.codes
    is_random = np.zeros(B, bool)
    is_random[rng.permutation(B)[:int(round(float(traffic["random_share"])
                                            * B))]] = True

    kinds = edit_plan(rng, B, n_edits, mix)
    n_ins = (kinds == 1).sum(1)
    n_del = (kinds == 2).sum(1)
    n_cols = m + n_del                   # alignment columns of each read
    src_len = m - n_ins + n_del          # genome bases each read covers
    width = m + n_edits
    # Distinct edit columns: the first n_edits of a random order of each
    # read's own columns.
    keys = rng.random((B, width))
    keys[np.arange(width)[None, :] >= n_cols[:, None]] = 2.0
    cols = np.argsort(keys, axis=1)[:, :n_edits]
    col_kind = np.full((B, width), -1, np.int8)       # -1: a match column
    np.put_along_axis(col_kind, cols, kinds, axis=1)
    col_kind[np.arange(width)[None, :] >= n_cols[:, None]] = 3   # past the end
    takes_src = (col_kind == -1) | (col_kind == 0) | (col_kind == 2)
    gives_read = (col_kind == -1) | (col_kind == 0) | (col_kind == 1)
    src_idx = np.cumsum(takes_src, axis=1) - 1
    read_idx = np.cumsum(gives_read, axis=1) - 1

    origin = rng.integers(0, len(g) - src_len.max(), B).astype(np.int64)
    base = g[np.clip(origin[:, None] + src_idx, 0, len(g) - 1)]
    sub = col_kind == 0
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ins = col_kind == 1
    base[ins] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    codes = np.zeros((B, m), np.uint8)
    rows = np.nonzero(gives_read)
    codes[rows[0], read_idx[rows]] = base[rows]

    codes[is_random] = rng.integers(0, 4, (int(is_random.sum()), m),
                                    dtype=np.uint8)
    origin[is_random] = -1
    buf = to_bytes(codes)
    reads = [buf[i * m:(i + 1) * m] for i in range(B)]
    return ReadBatch(reads, codes, origin, is_random)


class Pair(NamedTuple):
    query: bytes
    target: bytes
    q_codes: np.ndarray
    t_codes: np.ndarray
    n_edits: int


def make_pair(cfg: dict, seed: int, index: int) -> Pair:
    """A random target of cfg["length"] bases and its mutated copy: exactly
    round(edit_rate * length * share) substitutions, insertions and
    deletions of each kind, at distinct target positions (insertions
    before theirs)."""
    rng = rng_for(seed, 3, index)
    n = int(cfg["length"])
    t = rng.integers(0, 4, n, dtype=np.uint8)
    mix = cfg["edit_mix"]
    total = float(cfg["edit_rate"]) * n
    n_sub, n_ins, n_del = (int(round(total * mix[k] / sum(mix.values())))
                           for k in ("sub", "ins", "del"))
    pos = rng.choice(n, n_sub + n_del, replace=False)
    q = t.copy()
    substitute(rng, q, pos[:n_sub])
    keep = np.ones(n, bool)
    keep[pos[n_sub:]] = False
    ins_at = np.sort(rng.choice(n, n_ins, replace=False))
    # Insert before target position ins_at, counted in the kept bases.
    where = np.cumsum(keep)[ins_at] - keep[ins_at]
    q = np.insert(q[keep], where, rng.integers(0, 4, n_ins, dtype=np.uint8))
    return Pair(to_bytes(q), to_bytes(t), q, t, n_sub + n_ins + n_del)
