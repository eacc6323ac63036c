"""Device resolution for the port's entry points.

Everything runs on the CUDA card unless the caller asks for the CPU. With no
card and no explicit CPU request the entry points raise: they never carry on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises when there is none);
    ``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` / a ``torch.device`` → checked and
    returned."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
