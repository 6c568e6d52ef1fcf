"""Alignment modes (edlib.h:36-62), as the JAX package defines them."""

from __future__ import annotations

import enum


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
