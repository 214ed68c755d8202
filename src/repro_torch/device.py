"""Where the port runs: on the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises when no GPU is present (pass
    ``device="cpu"`` to run the plain versions on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
