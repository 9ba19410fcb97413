"""The NUTS leaf kernel: one leaf of ``inference/nuts._build_subtree`` in one launch.

A port-only kernel (``csrc/nuts_leaf.cu``, ``nuts_leaf_kernel``), with no
Pallas counterpart: the JAX package compiles the whole tree building into
one XLA program. In the port the leaf body ran as some 45 to 50 eager
operations a leaf on (C, D) tensors, each a launch of microseconds on the
card behind tens of microseconds of host dispatch. The kernel runs that
body after the leaf's potential call, in the plain path's float32
arithmetic and order, and updates the subtree's state in place; it also
computes the next leaf's half step and position and writes ``any(live)``
into the sampler's pinned flag byte, so that a leaf launches ``torch.rand``,
this kernel and its potential, and nothing else.

``LeafKernel`` binds one subtree's state tensors (the dict
``_build_subtree`` keeps) to the kernel; ``leaf(...)`` launches a leaf's
body. The half step before a subtree's first leaf is the plain path's two
``torch.addcmul`` calls, the first into ``LeafKernel.p_half``. Each leaf
launch adds one to the recorder's ``launch.leaf`` (``utils.metrics``). The
plain version is ``inference/nuts._leaf_plain``; ``_build_subtree`` takes
the kernel for CUDA tensors and the plain version otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import metrics
from ._cuda import CudaKernel, check_cuda_tensor, stream_handle

__all__ = ["LeafKernel", "LEAF"]


class _LeafState(ctypes.Structure):
    """``SdmNutsLeafState`` of ``csrc/nuts_leaf.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "edge", "prop", "rho", "log_w", "sum_accept", "n_leaves", "turning", "diverging", "live", "r_ckpts",
        "rsum_ckpts", "p_half", "half_e", "e_im", "inv_mass", "H0", "flag", "any_live")] + [
        ("C", ctypes.c_int), ("D", ctypes.c_int), ("S", ctypes.c_int)]


_P = ctypes.c_void_p
LEAF = CudaKernel("nuts_leaf", "nuts_leaf.cu", "sdm_nuts_leaf", [_P] * 6 + [ctypes.c_int] * 4 + [_P])


def _device_pointer(host: torch.Tensor) -> int:
    """The device's address of the pinned host tensor ``host``."""
    lib = LEAF.library.load()
    fn = lib.sdm_host_device_pointer
    fn.argtypes, fn.restype = [_P, ctypes.POINTER(_P)], ctypes.c_int
    out = _P()
    err = fn(host.data_ptr(), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"nuts_leaf: no device address for the pinned flag: cudaError {err} "
                           f"({lib.sdm_error_string(err).decode()})")
    return out.value


class LeafKernel:
    """One subtree's state ``s`` (``edge`` (C, 3D+1), ``prop`` (C, 2D+1),
    ``rho`` (C, D), ``log_w``, ``sum_accept`` (C,) float32, ``n_leaves``
    (C,) int64, ``turning``, ``diverging``, ``live`` (C,) bool, ``r_ckpts``,
    ``rsum_ckpts`` (C, S, D)), all contiguous on one card, which the kernel
    updates in place; ``half_e`` (C, 1) or (C,), ``e_im``, ``inv_mass`` (C,
    D), ``H0`` (C,); ``flag_host`` the sampler's two pinned flag bytes
    (``_LaggedAny.host``)."""

    def __init__(self, s: dict, half_e, e_im, inv_mass, H0, flag_host: torch.Tensor):
        C, E = s["edge"].shape
        D = (E - 1) // 3
        S = s["r_ckpts"].shape[1]
        f32 = dict(edge=(C, E), prop=(C, 2 * D + 1), rho=(C, D), log_w=(C,), sum_accept=(C,), r_ckpts=(C, S, D),
                   rsum_ckpts=(C, S, D))
        for name, shape in f32.items():
            check_cuda_tensor(name, s[name], shape)
        check_cuda_tensor("n_leaves", s["n_leaves"], (C,), torch.int64)
        for name in ("turning", "diverging", "live"):
            check_cuda_tensor(name, s[name], (C,), torch.bool)
        half_e = half_e.reshape(C).contiguous()
        e_im, inv_mass, H0 = e_im.contiguous(), inv_mass.contiguous(), H0.contiguous()
        for name, t, shape in (("half_e", half_e, (C,)), ("e_im", e_im, (C, D)), ("inv_mass", inv_mass, (C, D)),
                               ("H0", H0, (C,))):
            check_cuda_tensor(name, t, shape)
        if not (flag_host.is_pinned() and flag_host.dtype == torch.bool and flag_host.numel() == 2):
            raise ValueError("flag_host must be two pinned bools")
        self.C, self.D, self.device = C, D, s["edge"].device
        self.p_half = torch.empty((C, D), dtype=torch.float32, device=self.device)
        # The blocks' or of live and their count, which the kernel leaves at 0 after each launch.
        any_live = torch.zeros((2,), dtype=torch.int32, device=self.device)
        # The kernel reads these through raw pointers: keep them alive with it.
        self._keep = (s, half_e, e_im, inv_mass, H0, flag_host, any_live)
        ptr = {name: s[name].data_ptr() for name in (*f32, "n_leaves", "turning", "diverging", "live")}
        self.state = _LeafState(**ptr, p_half=self.p_half.data_ptr(), half_e=half_e.data_ptr(),
                                e_im=e_im.data_ptr(), inv_mass=inv_mass.data_ptr(), H0=H0.data_ptr(),
                                flag=_device_pointer(flag_host), any_live=any_live.data_ptr(), C=C, D=D, S=S)
        self.stream = stream_handle(self.device)
        self._state = ctypes.byref(self.state)

    def leaf(self, u_new, logp_new, g_new, uni, slots: tuple, flag_slot: int) -> torch.Tensor:
        """A leaf's body at positions ``u_new`` after its potential call
        (``logp_new`` (C,), ``g_new`` (C, D)) with the leaf's uniforms ``uni``
        (C,). ``slots`` = (store_slot, idx_min, idx_max): the checkpoint slot
        of an even leaf (else -1), the slots of an odd leaf's U-turn test
        (else -1, -1); ``any(live)`` goes to byte ``flag_slot`` of the flag.
        Returns the next leaf's position (C, D)."""
        C, D = self.C, self.D
        logp_new, g_new = logp_new.contiguous(), g_new.contiguous()
        check_cuda_tensor("u_new", u_new, (C, D))
        check_cuda_tensor("logp_new", logp_new, (C,))
        check_cuda_tensor("g_new", g_new, (C, D))
        check_cuda_tensor("uni", uni, (C,))
        if metrics.RECORDING:
            metrics.count("launch.leaf")
        u_next = torch.empty((C, D), dtype=torch.float32, device=self.device)
        LEAF(self._state, u_new.data_ptr(), logp_new.data_ptr(), g_new.data_ptr(), uni.data_ptr(),
             u_next.data_ptr(), *slots, flag_slot, self.stream)
        return u_next
