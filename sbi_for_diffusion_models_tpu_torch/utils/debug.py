"""Numerical-safety debugging hooks (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/utils/debug.py``:

* ``nan_guard()`` raises ``FloatingPointError`` at the first NaN produced
  inside the block. The JAX package turns on ``jax_debug_nans``; PyTorch has
  no such switch (``torch.autograd.detect_anomaly`` checks the backward
  only), so the block runs under a ``TorchDispatchMode`` that checks every
  floating-point output of every operation, the backward's included. Each
  check reads a flag back from the device: a debugging tool, which no path
  of the port enters by default.
* ``assert_finite`` is the host-side finiteness check with a named error.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["nan_guard", "assert_finite"]


class _NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the operation whose output holds
    a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise at the first NaN produced by any operation inside the block."""
    with _NaNCheck():
        yield


def assert_finite(name: str, *arrays) -> None:
    """Host-side finiteness assertion with a useful error message (arrays
    may be tensors on any device, or anything numpy takes)."""
    for i, a in enumerate(arrays):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise FloatingPointError(f"{name}: array {i} has {bad}/{a.size} non-finite values")
