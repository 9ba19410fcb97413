"""The u-space density kernel pair: ``potentials.tempered_value_and_grad``'s
bijector, prior and tempering in two launches around the potential call.

A port-only pair (``csrc/udensity.cu``: ``density_pre_kernel``,
``density_post_kernel``), with no Pallas counterpart: XLA fuses the density
into the JAX sampler's program. In the port the density ran as some 80
eager operations a call on (C, D) tensors (``Bijector.forward_and_grads``,
``MultipleIndependent.log_prob_and_grad``, the tempering sum and the chain
rule), each a launch of about a microsecond on the card behind tens of
microseconds of host dispatch, at every leaf, start and extra move of the
sampler.

``DensityTables`` reads the prior and the bijector once into tables: each
dimension's support and constants, and the prior's groups in the order
``MultipleIndependent`` sums them. The priors and the bijector give their
own rows (``kernel_groups``, ``kernel_family``, ``kernel_constants`` and
``Bijector.kernel_table`` in ``distributions.py``, beside the closed forms
they mirror). Every prior the port builds is a ``Uniform``, ``Normal``,
``Beta`` or ``LogNormal``, alone or inside a ``MultipleIndependent``; any
other prior, or D >= ``MAX_D``, raises.
``UDensity`` binds the tables to the card: ``pre(u, need_grad)`` launches
``density_pre`` and returns theta (a fresh tensor, for the potential),
keeping log prior + log det and, with the gradient, dtheta, dlog_det and the
prior's gradient in scratch it reuses; ``post(ll, g_ll, beta, need_grad)``
launches ``density_post`` and returns ``(value, grad or None)``, fresh
tensors. Both follow the plain composition's float32 arithmetic bit for bit.
Each launch adds one to the recorder's ``launch.density``
(``utils.metrics``). The plain version is
``potentials._tempered_vg_plain``; ``tempered_value_and_grad`` takes the
pair for CUDA tensors and the plain version otherwise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import metrics
from ._cuda import CudaKernel

__all__ = ["DensityTables", "UDensity", "DENSITY_PRE", "DENSITY_POST", "MAX_D", "UNARY_FUNCTIONS", "unary"]

MAX_D = 128  # csrc/udensity.cu's per-thread column arrays
K_STRIDE = 7  # constants a column: the bijector's lo, span, log span, then four of the prior family's
# The one-input functions of sdm_density_unary, in its order.
UNARY_FUNCTIONS = ("sigmoid", "exp", "log", "log1p", "logsigmoid", "clamp", "clamp_min")


class _Tables(ctypes.Structure):
    """``SdmDensityTables`` of ``csrc/udensity.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("code", "family", "k", "group_start", "order")] + [
        (name, ctypes.c_int) for name in ("D", "G", "zero_start")]


_P, _I = ctypes.c_void_p, ctypes.c_int
DENSITY_PRE = CudaKernel("density_pre", "udensity.cu", "sdm_density_pre", [_P] * 7 + [_I, _I, _P])
DENSITY_POST = CudaKernel("density_post", "udensity.cu", "sdm_density_post",
                          [_P] * 4 + [ctypes.c_float] + [_P] * 5 + [_I, _I, _I, _P])


class DensityTables:
    """The host tables of ``csrc/udensity.cu`` for ``prior`` and the
    bijector ``bij`` (a ``distributions.Bijector``): per dimension its
    support code, prior family and constants; the prior's groups, each its
    columns in the order of its own (C, width) tensor, summed in the order
    ``MultipleIndependent`` sums them (``zero_start``: from 0.0, as its
    sum starts). Raises for a prior of another kind and for D >= MAX_D."""

    def __init__(self, prior, bij):
        D = int(bij.dim)
        if not 1 <= D < MAX_D:
            raise ValueError(f"the density kernel takes 1 <= D < {MAX_D} dimensions, got D = {D}")
        groups, from_zero = prior.kernel_groups()
        for dist, _ in groups:
            if not hasattr(dist, "kernel_constants"):
                raise ValueError(f"the density kernel takes Uniform, Normal, Beta and LogNormal priors (alone or in a "
                                 f"MultipleIndependent), got {type(dist).__name__}")
        if sum(len(span) for _, span in groups) != D:
            raise ValueError(f"the prior has {sum(len(s) for _, s in groups)} dimensions, the bijector {D}")
        self.D, self.G, self.zero_start = D, len(groups), int(from_zero)
        self.code, bij_k = bij.kernel_table()
        self.family = [0] * D
        k = np.zeros((D, K_STRIDE), np.float32)
        k[:, :3] = bij_k
        self.group_start, self.order = [0], []
        for dist, span in groups:
            for d, consts in zip(span, dist.kernel_constants()):
                self.family[d] = dist.kernel_family
                k[d, 3:] = consts
            self.order.extend(span)
            self.group_start.append(len(self.order))
        self.k = k

    def ints(self) -> np.ndarray:
        """code, family, group_start and order, one int32 array."""
        return np.asarray(self.code + self.family + self.group_start + self.order, np.int32)


class UDensity:
    """The kernel pair for one prior, bijector and temperature, its tables
    uploaded to each card once. One call of the density is ``pre`` then
    ``post``, with the potential between them."""

    def __init__(self, prior, bij, temperature: float = 1.0):
        self.tables = DensityTables(prior, bij)
        # beta / T as PyTorch's CUDA division by a CPU scalar computes it: beta times float32(1) / float32(T).
        self.inv_t = float(np.float32(1.0) / np.float32(temperature))
        self._on: dict = {}  # device -> (ctypes tables, the tensors they point into)
        # [dtheta (C, D) | dlog_det (C, D) | g_lp (C, D) | lp + log_det (C,)] of the call in flight, reused
        # call to call; C its rows.
        self._scratch, self._C = None, 0
        self._stream = None

    def _device_tables(self, device) -> _Tables:
        entry = self._on.get(device)
        if entry is None:
            t = self.tables
            ints = torch.from_numpy(t.ints()).to(device)
            k = torch.from_numpy(t.k).to(device)
            D, G = t.D, t.G
            ptr = ints.data_ptr()
            entry = self._on[device] = (_Tables(code=ptr, family=ptr + 4 * D, k=k.data_ptr(),
                                                group_start=ptr + 8 * D, order=ptr + 4 * (2 * D + G + 1),
                                                D=D, G=G, zero_start=t.zero_start), (ints, k))
        return entry[0]

    def pre(self, u: torch.Tensor, need_grad: bool) -> torch.Tensor:
        """theta = bij.forward(u) for u (C, D) float32 on a card; keeps the
        rest of the density's terms for ``post``."""
        C, D = u.shape
        if D != self.tables.D or u.dtype != torch.float32:
            raise ValueError(f"u must be (C, {self.tables.D}) float32, got {tuple(u.shape)} {u.dtype}")
        u = u.contiguous()
        tables = self._device_tables(u.device)
        if self._C != C or self._scratch.device != u.device:
            self._scratch = torch.empty((C * (3 * D + 1),), dtype=torch.float32, device=u.device)
            self._C = C
        self._stream = ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream)
        theta = torch.empty_like(u)
        base = self._scratch.data_ptr()
        if metrics.RECORDING:
            metrics.count("launch.density")
        DENSITY_PRE(ctypes.byref(tables), u.data_ptr(), theta.data_ptr(), base + 4 * 3 * D * C, base,
                    base + 4 * D * C, base + 4 * 2 * D * C, C, int(need_grad), self._stream)
        return theta

    def post(self, ll: torch.Tensor, g_ll, beta: torch.Tensor, need_grad: bool):
        """``(value (C,), grad (C, D) or None)`` of the density whose ``pre``
        came last, from the potential's ``ll`` (C,), ``g_ll`` (C, D) and the
        rows' inverse temperatures ``beta`` (C,)."""
        C, D, dev = self._C, self.tables.D, self._scratch.device
        ll, beta = ll.contiguous(), beta.contiguous()
        given = [("ll", ll, (C,)), ("beta", beta, (C,))]
        value, grad = torch.empty_like(ll), None
        if need_grad:
            g_ll = g_ll.contiguous()
            given.append(("g_ll", g_ll, (C, D)))
            grad = torch.empty_like(g_ll)
        for name, t, shape in given:
            if t.shape != shape or t.dtype != torch.float32 or t.device != dev:
                raise ValueError(f"{name} must be {shape} float32 on {dev}, got {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}")
        base = self._scratch.data_ptr()
        if metrics.RECORDING:
            metrics.count("launch.density")
        DENSITY_POST(base + 4 * 3 * D * C, ll.data_ptr(), g_ll.data_ptr() if need_grad else None, beta.data_ptr(),
                     self.inv_t, base + 4 * 2 * D * C, base, base + 4 * D * C, value.data_ptr(),
                     grad.data_ptr() if need_grad else None, C, D, int(need_grad), self._stream)
        return value, grad


def unary(fn: str, first: int, n: int, device) -> tuple:
    """``(x, y)``: the n float32 values with bit patterns ``first``,
    ``first + 1``, ... (mod 2^32) and ``csrc/udensity.cu``'s ``fn`` (one of
    UNARY_FUNCTIONS) of each, as the kernel pair computes it; for tests."""
    lib = DENSITY_PRE.library.load()
    f = lib.sdm_density_unary
    f.argtypes, f.restype = [_I, ctypes.c_uint, ctypes.c_longlong, _P, _P, _P], _I
    x = torch.empty((n,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    err = f(UNARY_FUNCTIONS.index(fn), first & 0xFFFFFFFF, n, x.data_ptr(), y.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"density_unary: kernel launch failed: cudaError {err} "
                           f"({lib.sdm_error_string(err).decode()})")
    return x, y
