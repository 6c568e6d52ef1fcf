"""Device helpers and profiling of the port."""

from edlib_tpu_torch.utils.profiling import Timer, gcups, trace

__all__ = ["Timer", "gcups", "trace"]
