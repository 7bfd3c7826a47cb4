"""The explicit device every entry point takes."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a concrete torch.device. A CUDA device on a machine
    with no card raises here, so a default call never drops to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev
