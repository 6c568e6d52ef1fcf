"""Entry ``map_reads``: a batch of reads against one genome, best hit each.

The program is ``edlib_tpu_torch.map_reads(reads, genome, mode, k)``, one
call a batch.  Inputs: the configuration's genome (``gen.make_genome``) and
traffic["batches"] read batches (``gen.make_reads``), made at set-up and
cycled through by the window.

The check compares (best, end) of a sample of each batch's reads, drawn from
the seed, in every call the window made on that batch, with the plain
reference (reference/hw_map.py).  The sample holds the first and the last
random reads by index and reads from the genome's repeats besides reads
drawn at random: the port sends the stragglers of a batch (reads the filter
leaves unresolved or proves above its rung, which random reads always are)
in index order to the segmented fallback, 64 of them, and the rest to the
shared sweep, so the first random reads take the fallback, the last ones the
shared sweep, and the others mostly the filter and its verification.
"""

from __future__ import annotations

import numpy as np

from benchmark import gen
from benchmark.reference import hw_map

# Mismatching (call, read) answers allowed: the answers are exact integers.
MISMATCH_LIMIT = 0
# The control's tiles: the genome swept in 4,096-column pieces, no halo.
CONTROL_TILE = 4096


def sample(batch: gen.ReadBatch, genome: gen.Genome, spec: dict, seed: int,
           index: int) -> np.ndarray:
    """Sorted read indices of one batch to compare (see the module)."""
    rng = gen.rng_for(seed, 4, index)
    B = len(batch.reads)
    rand = np.nonzero(batch.is_random)[0]
    spans = genome.repeat_spans
    m = batch.codes.shape[1]
    o = batch.origin
    j = np.searchsorted(spans[:, 0], o + m, side="left") - 1
    in_rep = (np.nonzero((o >= 0) & (j >= 0)
                         & (spans[np.clip(j, 0, None), 1] > o))[0]
              if len(spans) else j[:0])
    picked = set(rand[:spec["first_random"]].tolist())
    picked |= set(rand[::-1][:spec["last_random"]].tolist())
    if len(in_rep):
        picked |= set(rng.choice(in_rep, min(len(in_rep), spec["in_repeats"]),
                                 replace=False).tolist())
    rest = np.setdiff1d(np.arange(B), np.fromiter(picked, np.int64))
    n_more = max(0, min(spec["per_batch"] - len(picked), len(rest)))
    picked |= set(rng.choice(rest, n_more, replace=False).tolist())
    return np.array(sorted(picked), np.int64)


class MapReads:
    unit = "reads"      # what a call attempts, counted by work()

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import edlib_tpu_torch
        self.port = edlib_tpu_torch
        self.device = device
        self.seed = seed
        self.traffic = traffic
        self.genome = gen.make_genome(cfg, seed)
        self.target = gen.to_bytes(self.genome.codes)
        self.batches = [gen.make_reads(self.genome, traffic, seed, b)
                        for b in range(int(traffic["batches"]))]
        self.n_inputs = len(self.batches)

    def call(self, i: int):
        b = self.batches[i % self.n_inputs]
        return self.port.map_reads(b.reads, self.target,
                                   mode=self.traffic["mode"],
                                   k=int(self.traffic["k"]),
                                   device=self.device)

    def shape(self, i: int) -> tuple:
        return self.batches[i % self.n_inputs].codes.shape

    def work(self, i: int) -> dict:
        return {"reads": len(self.batches[i % self.n_inputs].reads)}

    def check(self, answers, device, control: bool = False) -> dict:
        """{name: (value, limit, sense)} over the window's answers [(i,
        answer)], sense "<=" or ">=" the limit.  control: the reference's
        tiled control (reference/hw_map.py) answers in the program's place,
        once a batch."""
        k = int(self.traffic["k"])
        bad = compared = 0
        for b, batch in enumerate(self.batches):
            calls = [a for i, a in answers if i % self.n_inputs == b]
            if not (calls or control):
                continue
            idx = sample(batch, self.genome, self.traffic["sample"],
                         self.seed, b)
            codes = batch.codes[idx]
            want = hw_map.above_k(*hw_map.best_ends(
                codes, self.genome.codes, device), k)
            got = [(np.asarray(best)[idx], np.asarray(pos)[idx])
                   for best, pos in calls]
            if control:
                got = [hw_map.above_k(*hw_map.best_ends(
                    codes, self.genome.codes, device, tile=CONTROL_TILE), k)]
            for best, pos in got:
                bad += int(((best != want[0]) | (pos != want[1])).sum())
                compared += len(idx)
        return {"mismatched_reads": (bad, MISMATCH_LIMIT, "<="),
                "compared_reads": (compared, 1, ">=")}


def make(cfg, traffic, seed, device):
    return MapReads(cfg, traffic, seed, device)
