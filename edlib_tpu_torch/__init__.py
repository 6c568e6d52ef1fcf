"""edlib_tpu_torch — edlib_tpu on PyTorch and CUDA.

Entry points, field for field the results of their ``edlib_tpu``
namesakes:

* ``map_reads(reads, target, mode="HW", k=-1, device=None, mesh=None)``:
  best hit of many reads against one target, HW and SHW;
* ``align_batch(queries, targets, mode="NW", task="distance", k=-1,
  additionalEqualities=None, backend="auto", mesh=None, device=None)`` and ``align(query, target,
  ...)``: edlib's alignment, NW/SHW/HW, tasks "distance", "locations" and
  "path" (the CIGAR), any alphabet and length (dense equalities and
  queries past 65,536 bp take the eq-stream or score-stream kernels); NW
  pairs past 8e9 effective DP cells take the banded wavefront, and
  Hirschberg nodes past 1e10 cells their half-sweeps on the card;
  ``backend="host"`` aligns pair by pair with ``align(..., device="cpu")``,
  and ``mesh=`` (a ``parallel.DeviceGrid``) shards the batch over a grid of
  cards (``map_reads`` takes ``mesh=`` too);
* ``edlib_tpu_torch.parallel``: the sharded API of ``edlib_tpu.parallel``
  on a grid of devices (``make_alignment_mesh``, the sharded reduces,
  sweeps and carry pipelines);
* ``nw_distance_long(query, target, k=-1, backend="auto", device=None)``,
  ``shw_best_long(...)`` and ``semiglobal_locations_long(query, target,
  mode="HW", k=-1, backend="auto", device=None)``: one long pair spread
  over the whole card by the wavefront kernels;
* ``getNiceAlignment(result, query, target)``, ``alignment_to_cigar`` and
  ``cigar_to_alignment``: the CIGAR helpers of the reference binding.

They run on the card (hand-written CUDA kernels in ``ops/csrc``, built with
nvcc at first use) unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.  The package imports torch, numpy and the
standard library only.
"""

from edlib_tpu_torch.align import align, align_batch
from edlib_tpu_torch.cigar import alignment_to_cigar, cigar_to_alignment
from edlib_tpu_torch.longpair import (nw_distance_long,
                                      semiglobal_locations_long,
                                      shw_best_long)
from edlib_tpu_torch.mapping import map_reads
from edlib_tpu_torch.nice import getNiceAlignment
from edlib_tpu_torch.types import (EDOP_DELETE, EDOP_INSERT, EDOP_MATCH,
                                   EDOP_MISMATCH, STATUS_ERROR, STATUS_OK,
                                   AlignConfig, AlignMode, AlignResult,
                                   AlignTask, CigarFormat,
                                   default_align_config, new_align_config)
from edlib_tpu_torch.utils.hw import (card_name_and_power, nvcc_path,
                                      resolve_device)

__version__ = "0.1.0"

__all__ = ["align", "align_batch", "map_reads", "nw_distance_long",
           "shw_best_long", "semiglobal_locations_long", "getNiceAlignment",
           "alignment_to_cigar", "cigar_to_alignment", "AlignMode",
           "AlignTask", "CigarFormat", "AlignConfig", "AlignResult",
           "new_align_config", "default_align_config", "EDOP_MATCH",
           "EDOP_INSERT", "EDOP_DELETE", "EDOP_MISMATCH", "STATUS_OK",
           "STATUS_ERROR", "resolve_device", "card_name_and_power",
           "nvcc_path"]
