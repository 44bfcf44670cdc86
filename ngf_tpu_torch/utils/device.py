"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``'cuda'`` (the default of every entry point) or ``'cpu'``.

    Asking for CUDA on a machine without a card raises instead of running on
    the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu / device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
