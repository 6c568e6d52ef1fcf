"""Device helpers and profiling of the port."""

from edlib_tpu_torch.utils.profiling import (Span, child, count, counter,
                                             enable, gcups, reset, span, take)

__all__ = ["Span", "child", "count", "counter", "enable", "gcups", "reset",
           "span", "take"]
