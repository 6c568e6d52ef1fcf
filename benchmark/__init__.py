"""The benchmark of edlib_tpu_torch (see run.py)."""
