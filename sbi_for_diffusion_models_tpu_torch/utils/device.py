"""The port's default device.

The port's entry points run on the CUDA card unless the caller names
another device: ``default_device()`` is what they take when ``device`` is
None. It never returns the CPU; a caller who wants the CPU says so
(``device="cpu"``), as the CPU tests do. Functions that receive tensors
follow the tensors' device instead.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises ``RuntimeError`` when there is no
    CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or ``default_device()`` when None."""
    return torch.device(device) if device is not None else default_device()
