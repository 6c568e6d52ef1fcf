"""Entry ``nw_distance_long``: one long pair a call, its NW edit distance.

The program is ``edlib_tpu_torch.nw_distance_long(query, target, k)``.
Inputs: traffic["pairs"] pairs of the configuration (``gen.make_pair``),
made at set-up and cycled through by the window.

The check compares every answer of the window with the plain reference
(reference/nw_wfa.py) of its pair: the distance, or -1 above k.
"""

from __future__ import annotations

import numpy as np

from benchmark import gen
from benchmark.reference import nw_wfa

# Largest |answer - reference| allowed: the answers are exact integers.
GAP_LIMIT = 0
# The control's band: diagonals within 32 of the pair's length difference,
# the band of the k ladder's first rung (k = 64), taken as the answer.
CONTROL_BAND = 32


class NwDistanceLong:
    unit = "pairs"      # what a call attempts, counted by work()

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import edlib_tpu_torch
        self.port = edlib_tpu_torch
        self.device = device
        self.k = int(traffic["k"])
        self.pairs = [gen.make_pair(cfg, seed, p)
                      for p in range(int(traffic["pairs"]))]
        self.n_inputs = len(self.pairs)

    def call(self, i: int):
        p = self.pairs[i % self.n_inputs]
        return self.port.nw_distance_long(p.query, p.target, k=self.k,
                                          device=self.device)

    def shape(self, i: int) -> tuple:
        p = self.pairs[i % self.n_inputs]
        return len(p.query), len(p.target)

    def work(self, i: int) -> dict:
        p = self.pairs[i % self.n_inputs]
        return {"pairs": 1, "cells": len(p.query) * len(p.target)}

    def reference(self, device, band=None) -> list:
        """The reference's answer for every pair (with band: the banded
        control's)."""
        by_len = {}
        for j, p in enumerate(self.pairs):
            by_len.setdefault((len(p.q_codes), len(p.t_codes)), []).append(j)
        out = [None] * self.n_inputs
        for idx in by_len.values():
            got = nw_wfa.distances(np.stack([self.pairs[j].q_codes
                                             for j in idx]),
                                   np.stack([self.pairs[j].t_codes
                                             for j in idx]),
                                   device, k=self.k, band=band)
            for j, d in zip(idx, got):
                out[j] = d
        return out

    def check(self, answers, device, control: bool = False) -> dict:
        """{name: (value, limit, sense)} over the window's answers [(i,
        answer)], sense "<=" or ">=" the limit.  control: the reference's
        banded control answers in the program's place, once a pair."""
        want = self.reference(device)
        if control:
            answers = list(enumerate(self.reference(device, CONTROL_BAND)))
        gap = max((abs(int(a) - want[i % self.n_inputs]) for i, a in answers),
                  default=0)
        return {"distance_gap": (gap, GAP_LIMIT, "<="),
                "compared_pairs": (len(answers), 1, ">=")}


def make(cfg, traffic, seed, device):
    return NwDistanceLong(cfg, traffic, seed, device)
