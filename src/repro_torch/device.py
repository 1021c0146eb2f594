"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card: the port runs on CUDA unless the caller
    asks for the CPU.  Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and the host has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain versions")
    return dev
