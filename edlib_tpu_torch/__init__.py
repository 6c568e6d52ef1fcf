"""edlib_tpu_torch — the read-mapping path of edlib_tpu on PyTorch and CUDA.

Entry point: ``map_reads(reads, target, mode="HW", k=-1, device=None)``,
field for field the results of ``edlib_tpu.map_reads`` for HW and SHW.  It
runs on the card (hand-written CUDA kernels in ``ops/csrc``, built with nvcc
at first use) unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.  The package imports torch, numpy and the
standard library only.
"""

from edlib_tpu_torch.mapping import map_reads
from edlib_tpu_torch.types import AlignMode
from edlib_tpu_torch.utils.hw import (card_name_and_power, nvcc_path,
                                      resolve_device)

__all__ = ["map_reads", "AlignMode", "resolve_device", "card_name_and_power",
           "nvcc_path"]
