"""Public API types (edlib.h:30-218), as the JAX package defines them."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

# Status codes (edlib.h:30-31).
STATUS_OK = 0
STATUS_ERROR = 1


# Edit operations (edlib.h:84-87).
EDOP_MATCH = 0     # match
EDOP_INSERT = 1    # insertion to target == deletion from query
EDOP_DELETE = 2    # deletion from target == insertion to query
EDOP_MISMATCH = 3  # mismatch


class AlignMode(enum.IntEnum):
    """How gaps before/after the query are treated.

      NW  — global: full query vs full target.
      SHW — prefix: gap after query end is free (query vs target prefix).
      HW  — infix: gaps before query start and after query end are free
            (query vs any target substring; read mapping).
    """

    NW = 0
    SHW = 1
    HW = 2

    @classmethod
    def parse(cls, value) -> "AlignMode":
        if isinstance(value, AlignMode):
            return value
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError:
                raise ValueError(f"Unknown alignment mode: {value!r}") from None
        return cls(value)


class AlignTask(enum.IntEnum):
    """What to compute (edlib.h:67-71): less work is faster."""

    DISTANCE = 0  # edit distance + end locations
    LOC = 1       # + start locations
    PATH = 2      # + alignment path

    @classmethod
    def parse(cls, value) -> "AlignTask":
        if isinstance(value, AlignTask):
            return value
        if isinstance(value, str):
            v = value.lower()
            if v == "distance":
                return cls.DISTANCE
            if v == "locations":
                return cls.LOC
            if v == "path":
                return cls.PATH
            raise ValueError(f"Unknown alignment task: {value!r}")
        return cls(value)


class CigarFormat(enum.IntEnum):
    """CIGAR output format (edlib.h:78-81)."""

    STANDARD = 0  # M / I / D
    EXTENDED = 1  # = / I / D / X


@dataclass(frozen=True)
class AlignConfig:
    """Alignment configuration (edlib.h:100-140).

    k: non-negative => edit distance searched only up to k (result -1 beyond);
       negative => unbounded (auto-adjust, edlib.cpp:199-217).
    additional_equalities: extra symmetric symbol equivalences, as pairs of
       single characters / bytes / hashables (edlib.h:126-139).
    """

    k: int = -1
    mode: AlignMode = AlignMode.NW
    task: AlignTask = AlignTask.DISTANCE
    additional_equalities: Optional[Sequence[Tuple]] = None


def new_align_config(k: int = -1,
                     mode=AlignMode.NW,
                     task=AlignTask.DISTANCE,
                     additional_equalities=None) -> AlignConfig:
    """Parity helper for edlibNewAlignConfig (edlib.cpp:1465-1475)."""
    return AlignConfig(k=k, mode=AlignMode.parse(mode),
                       task=AlignTask.parse(task),
                       additional_equalities=additional_equalities)


def default_align_config() -> AlignConfig:
    """Defaults per edlibDefaultAlignConfig (edlib.cpp:1477-1479)."""
    return AlignConfig()


@dataclass
class AlignResult:
    """Alignment result (edlib.h:162-218).

    edit_distance: -1 if k was non-negative and the distance exceeds k.
    end_locations: 0-based positions in target where optimal alignments end
        (None if distance > k).  May contain -1 (query entirely before
        target; see edlib.cpp:237-249).
    start_locations: positions where the optimal alignments start; computed
        only for task LOC/PATH.
    alignment: np.uint8 array of EDOP_* codes, for the FIRST location pair
        only (edlib.cpp:274-289); None unless task == PATH.
    alphabet_length: number of distinct symbols in query+target.
    """

    status: int = STATUS_OK
    edit_distance: int = -1
    end_locations: Optional[np.ndarray] = None
    start_locations: Optional[np.ndarray] = None
    num_locations: int = 0
    alignment: Optional[np.ndarray] = None
    alignment_length: int = 0
    alphabet_length: int = 0

    def to_dict(self) -> dict:
        """Python-binding-shaped dict (edlib.pyx:136-155)."""
        from edlib_tpu_torch.cigar import alignment_to_cigar

        locations = []
        for i in range(self.num_locations):
            start = (int(self.start_locations[i])
                     if self.start_locations is not None else None)
            end = (int(self.end_locations[i])
                   if self.end_locations is not None else None)
            locations.append((start, end))
        cigar = None
        if self.alignment is not None:
            cigar = alignment_to_cigar(self.alignment, CigarFormat.EXTENDED)
        return {
            "editDistance": int(self.edit_distance),
            "alphabetLength": int(self.alphabet_length),
            "locations": locations,
            "cigar": cigar,
        }
