"""Drop-in replacement for the reference ``edlib`` Python module, on the
port (edlib_tpu/edlib_compat.py):

    import edlib_tpu_torch.edlib_compat as edlib
    edlib.align("ACT", "CGACTGAC", mode="HW", task="path")
    edlib.getNiceAlignment(result, query, target)

The reference binding's two public functions, signatures and result dicts
(bindings/python/edlib.pyx:56-238); align runs on the card unless given
device="cpu".
"""

from edlib_tpu_torch.align import align
from edlib_tpu_torch.nice import getNiceAlignment

__all__ = ["align", "getNiceAlignment"]
