"""The card the port runs on: device choice, identity and the CUDA compiler.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means CUDA, and without a card that is an error, never a silent fall back to
the plain PyTorch versions (only ``device="cpu"`` runs those).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

_CUDA_HOME_DEFAULT = "/usr/local/cuda"


def resolve_device(device=None) -> torch.device:
    """torch.device for ``device`` (None -> "cuda"); raises RuntimeError when
    CUDA is asked for and no card is present, ValueError for any device type
    other than cuda or cpu."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "edlib_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"edlib_tpu_torch: unsupported device {dev}")
    return dev


def card_name_and_power() -> str:
    """The card's name and power limit exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card), e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def nvcc_path() -> str:
    """Path of the CUDA compiler: nvcc on PATH, else $CUDA_HOME/bin/nvcc,
    else /usr/local/cuda/bin/nvcc."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or _CUDA_HOME_DEFAULT
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("edlib_tpu_torch: nvcc not found (PATH, $CUDA_HOME, "
                       f"{_CUDA_HOME_DEFAULT}); the CUDA kernels cannot be built")
