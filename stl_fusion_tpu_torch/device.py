"""The port's one device rule.

Entry points run on the CUDA device. The CPU is used only when the caller
asks for it with ``device="cpu"`` (the tests do): a missing card raises
instead of silently falling back, so a run can never report CPU work as
device work.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device is visible); an
    explicit device is taken as given, and ``cuda`` is checked too."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d
