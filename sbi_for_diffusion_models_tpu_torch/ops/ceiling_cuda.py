"""Kernel K4: the issue-ceiling microkernel as a hand-written CUDA kernel.

Counterpart of the Pallas kernel in ``benchmarks/roofline.py`` (``kernel``,
built by ``vpu_ceiling``); the kernel is ``csrc/issue_ceiling.cu``. Every
element of ``x`` runs a serial chain of ``K`` operations, ``K // 8`` turns of
an 8-operation body of one of two kinds:

* ``"fma"``: ``x = x * c + d`` eight times, c = float32(1.0000001),
  d = float32(1e-7);
* ``"transcendental"``: exp(x * 1e-3), log(x + 1.5), sqrt(x * x + 0.25),
  sin(x), x * 1.0001 + 1e-6, max(x, -10), min(x, 10), x + 1e-6.

``ceiling_chain`` launches the kernel for a CUDA tensor and runs the plain
version, ``ceiling_plain``, for a CPU tensor. The kernel issues one FMA per
step of the fma chain, which rounds once where the plain version rounds the
product and the sum separately: the two drift by up to an ulp and a half a
step, so the checks hold both to ``ceiling_plain`` run in float64, with a
tolerance that grows with ``K`` (``fma_tolerance``), and the kernel to
``ceiling_plain(..., fused=True)``, which rounds once a step as it does,
within ``FUSED_ULPS`` float32 ulps. ``roofline.py`` times
the kernel at two chain lengths to measure the card's achievable issue rate.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda import CudaKernel, check_cuda_tensor, stream_handle

__all__ = ["ceiling_chain", "ceiling_plain", "fma_tolerance", "KINDS", "FUSED_ULPS", "K4"]

KINDS = ("fma", "transcendental")
FUSED_ULPS = 4  # the kernel's fma chain against ceiling_plain(fused=True); one turn moves a value by about 21

K4 = CudaKernel(
    "issue_ceiling",
    "issue_ceiling.cu",
    "sdm_issue_ceiling",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def _f32(v: float) -> float:
    """The float32 nearest to ``v``, as a Python float: the chains' constants
    are float32 values in every precision the plain version runs in."""
    return float(np.float32(v))


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: expected one of {KINDS}")


def ceiling_plain(x: torch.Tensor, K: int, kind: str, fused: bool = False) -> torch.Tensor:
    """The chain in plain PyTorch: a Python loop of ``K // 8`` turns of the
    same eight tensor operations, in ``x``'s dtype (float64 gives the
    reference the float32 results are held to).

    ``fused`` (fma kind, float32 ``x``) rounds each step once, as the
    kernel's FMA does: the product of two float32 values is exact in
    float64, the sum is formed there and rounded to float32. Up to the rare
    double rounding of that sum it is the kernel's value bit for bit, so it
    tells a chain that is a single turn short or long."""
    _check_kind(kind)
    if fused and (kind != "fma" or x.dtype != torch.float32):
        raise ValueError("fused=True is the float32 fma chain's single rounding: kind 'fma', float32 x")
    for _ in range(int(K) // 8):
        if kind == "fma":
            c, d = _f32(1.0000001), _f32(1e-7)
            for _ in range(8):
                x = (x.double() * c + d).float() if fused else x * c + d
        else:
            x = torch.exp(x * _f32(1e-3))
            x = torch.log(x + 1.5)
            x = torch.sqrt(x * x + 0.25)
            x = torch.sin(x)
            x = x * _f32(1.0001) + _f32(1e-6)
            x = torch.clamp(x, min=-10.0)
            x = torch.clamp(x, max=10.0)
            x = x + _f32(1e-6)
    return x


def fma_tolerance(K: int, scale, roundings: int = 1):
    """Tolerance of a float32 fma chain of ``K`` steps against its float64
    evaluation, for values of magnitude ``scale`` (a number or a tensor):
    K x roundings x 2^-24 x scale x (1 + 2^-23)^K. Each rounding is off by
    at most half an ulp, 2^-24 of the value; the kernel's FMA rounds once a
    step, the plain version twice (the product, then the sum). The value
    moves so slowly that a step's rounding repeats for many steps, so the
    errors add up linearly, each carried on by the chain's multiplier
    1 + 2^-23 (the last factor, 1.0001 at K = 1,024). A step moves the value
    by 2^-23 x (value + 0.84), three to five times the kernel's tolerance,
    so a chain that was cut short or not run fails."""
    return int(K) * int(roundings) * 2.0**-24 * (1.0 + 2.0**-23) ** int(K) * scale


def ceiling_chain(x: torch.Tensor, K: int, kind: str) -> torch.Tensor:
    """x (any shape, float32) -> the same shape after ``K // 8`` turns of
    ``kind``'s 8-operation body on every element."""
    _check_kind(kind)
    turns = int(K) // 8
    if turns < 0 or turns > 2**31 - 1:
        raise ValueError(f"K={K} gives {turns} turns, outside [0, 2^31)")
    if not x.is_cuda:
        return ceiling_plain(x, K, kind)
    check_cuda_tensor("x", x, tuple(x.shape))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    K4(x.data_ptr(), out.data_ptr(), x.numel(), turns, KINDS.index(kind), stream_handle(x.device))
    return out
