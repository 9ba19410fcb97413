"""Kernels K2/K3 and K2p/K3p: the fused MNLE log-prob forward and backward.

Counterpart of ``sbi_for_diffusion_models_tpu/ops/mnle_pallas.py``. Per row
(one trial under one theta) the whole network runs in one kernel: the
categorical MLP and its log-softmax, the flow trunk, one head matmul to all
spline parameters (plus the affine (mu, log sigma) pair), the conditional
affine layer, the RQ spline chain and the normal base, with the censored
mask. K2 (``csrc/mnle_logprob.cu``, ``mnle_logprob_fwd_kernel``) returns the
row log-probs; K3 (``mnle_logprob_bwd_kernel``) recomputes the forward,
returns the same values (the same bits as K2's) and the cotangent-weighted
gradients w.r.t. the standardized RT ``t`` and the context ``ctx``, never
w.r.t. the weights (training keeps the plain autodiff path).
``FusedRowsLogProb`` binds them as a ``torch.autograd.Function``;
``make_fused_logprob`` wraps the outer transforms around it, as the JAX
``make_fused_logprob`` does.

Beside the kernels stand their plain versions: ``rows_logp_plain`` (the
counterpart of the JAX ``_rows_logp``) and ``rows_logp_vjp_plain``
(``torch.autograd.grad`` of it). The wrappers ``rows_logp`` (K2),
``rows_logp_and_vjp`` (K3: value and gradients) and ``rows_logp_vjp`` (K3,
gradients only) launch the kernels for CUDA tensors and take the plain
versions for CPU tensors only. A caller that needs a value and its gradient
calls ``rows_logp_and_vjp``: one launch. Each wrapper call adds one to its
kernel's counter of the recorder (``launch.k2``, ``launch.k3``;
``utils.metrics``), whichever route it takes.

The pulse-grid representation (absolute anchor) has its own pair, K2p
(``csrc/mnle_pulse.cu``, ``mnle_pulse_fwd_kernel``) and K3p
(``mnle_pulse_bwd_kernel``), the counterparts of the same Pallas kernels run
with the JAX row function ``_rows_logp_pulse``: the rows carry the phase
phi, the flow-head features kf and the slot index kv, and K3p returns the
values and the gradients w.r.t. phi, ctx and kf. Their plain versions are
``rows_logp_pulse_plain`` and ``rows_logp_pulse_vjp_plain``, their wrappers
``rows_logp_pulse``, ``rows_logp_pulse_and_vjp`` and
``rows_logp_pulse_vjp``, their ``autograd.Function``
``FusedPulseRowsLogProb``, their counters ``launch.k2p`` and ``launch.k3p``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..nets.spline import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    num_circular_spline_params,
    num_spline_params,
    rq_spline_circular,
    rq_spline_forward,
)
from ..utils import metrics
from ._cuda import CudaKernel, check_cuda_tensor, stream_handle

__all__ = [
    "pack_mnle_weights",
    "MNLEWeights",
    "rows_logp_plain",
    "rows_logp_vjp_plain",
    "rows_logp",
    "rows_logp_and_vjp",
    "rows_logp_vjp",
    "FusedRowsLogProb",
    "rows_logp_pulse_plain",
    "rows_logp_pulse_vjp_plain",
    "rows_logp_pulse",
    "rows_logp_pulse_and_vjp",
    "rows_logp_pulse_vjp",
    "FusedPulseRowsLogProb",
    "make_fused_logprob",
    "K2",
    "K3",
    "K2P",
    "K3P",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
MAX_LAYERS = 4  # trunk_depth + 1, bounded by the C struct
MAX_TRANSFORMS = 16  # transforms in a spline chain, as the kernels check it


class _Params(ctypes.Structure):
    """Mirror of ``MnleParams`` in ``csrc/mnle_common.cuh``."""

    _fields_ = [
        ("cat_w", ctypes.c_void_p * MAX_LAYERS),
        ("cat_wt", ctypes.c_void_p * MAX_LAYERS),
        ("cat_b", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_w", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_wt", ctypes.c_void_p * MAX_LAYERS),
        ("trunk_b", ctypes.c_void_p * MAX_LAYERS),
        ("head_w", ctypes.c_void_p),
        ("head_wt", ctypes.c_void_p),
        ("head_b", ctypes.c_void_p),
        ("D", ctypes.c_int),
        ("C", ctypes.c_int),
        ("H", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("T", ctypes.c_int),
        ("K", ctypes.c_int),
        ("HO", ctypes.c_int),
        ("cond_affine", ctypes.c_int),
        ("censored_col", ctypes.c_int),
        ("tail_bound", ctypes.c_float),
        ("min_w", ctypes.c_float),
        ("min_h", ctypes.c_float),
        ("min_d", ctypes.c_float),
        ("scale_w", ctypes.c_float),
        ("scale_h", ctypes.c_float),
        ("slot_w", ctypes.c_void_p),
        ("slot_wt", ctypes.c_void_p),
        ("slot_b", ctypes.c_void_p),
        ("NS", ctypes.c_int),
        ("F", ctypes.c_int),
        ("head_ld", ctypes.c_int),
        ("head_t_ld", ctypes.c_int),
    ]


_ARGS_FWD = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
_ARGS_BWD = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
K2 = CudaKernel("mnle_logprob_fwd", "mnle_logprob.cu", "sdm_mnle_logprob_fwd", _ARGS_FWD)
K3 = CudaKernel("mnle_logprob_bwd", "mnle_logprob.cu", "sdm_mnle_logprob_bwd", _ARGS_BWD)
_ARGS_PULSE_FWD = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
_ARGS_PULSE_BWD = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
K2P = CudaKernel("mnle_pulse_fwd", "mnle_pulse.cu", "sdm_mnle_pulse_fwd", _ARGS_PULSE_FWD)
K3P = CudaKernel("mnle_pulse_bwd", "mnle_pulse.cu", "sdm_mnle_pulse_bwd", _ARGS_PULSE_BWD)


@dataclass
class MNLEWeights:
    """The estimator's weights in the kernels' layout.

    ``cat`` and ``trunk`` hold one (W (in, out), b (out,)) pair per layer,
    ``slot`` (pulse rep) the slot head's pair (H, NS), ``head_w``
    (H [+ F], T*S [+2]) and ``head_b`` the concatenated spline heads (and
    the affine head last, when cond_affine) — the JAX ``pack_mnle_weights``
    order. ``*_t`` are (out, in) copies read by the backward kernels, so
    their transposed products read weights coalesced; K2p and K3p read the
    head and its transpose from ``padded_head``.
    """

    cat: list
    trunk: list
    head_w: torch.Tensor
    head_b: torch.Tensor
    n_layers: int
    num_transforms: int
    num_bins: int
    tail_bound: float
    censored_col: Optional[int]
    cond_affine: bool
    slot: Optional[tuple] = None
    _struct: Optional[_Params] = None
    _keep: Optional[list] = None

    @property
    def pulse(self) -> bool:
        """Whether these are the weights of the pulse rep (K2p/K3p)."""
        return self.slot is not None

    @property
    def num_features(self) -> int:
        """F: the flow-head features appended to the trunk output."""
        return self.head_w.shape[0] - self.trunk[-1][0].shape[1]

    def astype(self, dtype) -> "MNLEWeights":
        """The same weights in another dtype (a float64 reference for the
        plain versions; the kernels take float32 only)."""
        return dataclasses.replace(
            self,
            cat=[(W.to(dtype), b.to(dtype)) for W, b in self.cat],
            trunk=[(W.to(dtype), b.to(dtype)) for W, b in self.trunk],
            head_w=self.head_w.to(dtype),
            head_b=self.head_b.to(dtype),
            slot=None if self.slot is None else tuple(a.to(dtype) for a in self.slot),
            _struct=None,
            _keep=None,
        )

    def as_list(self) -> list:
        """Flat list in the JAX ``pack_mnle_weights`` order (biases 1-D)."""
        out = []
        for W, b in self.cat + self.trunk + ([self.slot] if self.pulse else []):
            out += [W, b]
        return out + [self.head_w, self.head_b]

    def padded_head(self) -> tuple:
        """K2p's and K3p's copies of the head weights: head_w (H + F, HO) and its
        transpose (HO, H + F), each with zero columns appended up to a
        multiple of 4 floats (16 bytes), so the tile product stages every
        row by 16-byte copies. The padding is never read into an output."""

        def pad(a):
            cols = -(-a.shape[1] // 4) * 4
            out = a.new_zeros((a.shape[0], cols))
            out[:, : a.shape[1]] = a
            return out

        return pad(self.head_w), pad(self.head_w.t())

    def struct(self) -> _Params:
        """The ctypes struct of device pointers (built once; the tensors it
        points into are kept alive by this object)."""
        if self._struct is None:
            if not self.head_w.is_cuda:
                raise ValueError("kernel weights must be CUDA tensors")
            keep = []
            p = _Params()
            for name, layers in (("cat", self.cat), ("trunk", self.trunk)):
                for i, (W, b) in enumerate(layers):
                    Wc, Wt, bc = W.contiguous(), W.t().contiguous(), b.contiguous()
                    keep += [Wc, Wt, bc]
                    getattr(p, f"{name}_w")[i] = Wc.data_ptr()
                    getattr(p, f"{name}_wt")[i] = Wt.data_ptr()
                    getattr(p, f"{name}_b")[i] = bc.data_ptr()
            # The pulse rep's head and its transpose are padded (16-byte rows), the others' kept as they are.
            hw, hwt = self.padded_head() if self.pulse else (self.head_w.contiguous(), self.head_w.t().contiguous())
            hb = self.head_b.contiguous()
            keep += [hw, hwt, hb]
            p.head_w, p.head_wt, p.head_b = hw.data_ptr(), hwt.data_ptr(), hb.data_ptr()
            p.head_ld, p.head_t_ld = hw.shape[1], hwt.shape[1]
            if self.pulse:
                sw, swt, sb = self.slot[0].contiguous(), self.slot[0].t().contiguous(), self.slot[1].contiguous()
                keep += [sw, swt, sb]
                p.slot_w, p.slot_wt, p.slot_b = sw.data_ptr(), swt.data_ptr(), sb.data_ptr()
                p.NS = self.slot[0].shape[1]
            p.F = self.num_features
            p.D = self.cat[0][0].shape[0]
            p.C = self.cat[-1][0].shape[1]
            p.H = self.trunk[-1][0].shape[1]
            p.n_layers = self.n_layers
            p.T = self.num_transforms
            p.K = self.num_bins
            p.HO = self.head_w.shape[1]
            p.cond_affine = int(self.cond_affine)
            p.censored_col = -1 if self.censored_col is None else int(self.censored_col)
            p.tail_bound = self.tail_bound
            p.min_w, p.min_h, p.min_d = DEFAULT_MIN_BIN_WIDTH, DEFAULT_MIN_BIN_HEIGHT, DEFAULT_MIN_DERIVATIVE
            p.scale_w = 1.0 - DEFAULT_MIN_BIN_WIDTH * self.num_bins
            p.scale_h = 1.0 - DEFAULT_MIN_BIN_HEIGHT * self.num_bins
            self._struct, self._keep = p, keep
        return self._struct


def pack_mnle_weights(estimator) -> MNLEWeights:
    """The estimator's layers as (in, out) matrices for the row function
    and the kernels (counterpart of the JAX ``pack_mnle_weights``)."""
    cfg = estimator.cfg
    net = estimator.net
    n_layers = cfg.trunk_depth + 1
    if n_layers > MAX_LAYERS:
        raise ValueError(f"trunk_depth={cfg.trunk_depth} > {MAX_LAYERS - 1} is not supported by the kernels")
    if cfg.num_transforms > MAX_TRANSFORMS:
        raise ValueError(f"num_transforms={cfg.num_transforms} > {MAX_TRANSFORMS} is not supported by the kernels")

    def pair(lin):
        return lin.weight.detach().t().contiguous(), lin.bias.detach().contiguous()

    heads = list(net.spline_heads) + ([net.affine_head] if net.affine_head is not None else [])
    return MNLEWeights(
        cat=[pair(lin) for lin in net.cat_net.layers],
        trunk=[pair(lin) for lin in net.flow_trunk.layers],
        head_w=torch.cat([h.weight.detach().t() for h in heads], dim=1).contiguous(),
        head_b=torch.cat([h.bias.detach() for h in heads]).contiguous(),
        n_layers=n_layers,
        num_transforms=cfg.num_transforms,
        num_bins=cfg.num_bins,
        tail_bound=float(cfg.tail_bound),
        censored_col=cfg.censored_category if cfg.censor_rt else None,
        cond_affine=bool(net.affine_head is not None),
        slot=pair(net.pulse_slot_head) if net.pulse_slot_head is not None else None,
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _shared_heads(oh, ctx, w: MNLEWeights):
    """Categorical log-prob and flow-trunk embedding of the rows, shared by
    both representations (the JAX ``_shared_heads``)."""
    h = ctx
    for W, b in w.cat[:-1]:
        h = F.relu(h @ W + b)
    logits = F.log_softmax(h @ w.cat[-1][0] + w.cat[-1][1], dim=-1)
    f = torch.cat([ctx, oh], dim=-1)
    for W, b in w.trunk:
        f = F.relu(f @ W + b)
    return (logits * oh).sum(-1), f


def _censor(cat_lp, rt_term, oh, w: MNLEWeights):
    """cat_lp + (1 - onehot[censored]) rt_term; rows where that factor is 0
    take 0 instead of the product, so a non-finite term there never turns
    into NaN."""
    if w.censored_col is None:
        return cat_lp + rt_term
    keep = 1.0 - oh[:, w.censored_col]
    return cat_lp + torch.where(keep > 0, keep * rt_term, torch.zeros_like(rt_term))


def rows_logp_plain(t, oh, ctx, w: MNLEWeights):
    """Per-row MNLE log p on standardized inputs (plain PyTorch).

    t: (N,), oh: (N, C), ctx: (N, D). Censored rows (when the estimator
    censors) keep only the categorical term: the flow term is multiplied by
    (1 - onehot[censored]) as in the JAX row function, and rows where that
    factor is 0 take 0 instead of the product.
    """
    cat_lp, f = _shared_heads(oh, ctx, w)
    sp = f @ w.head_w + w.head_b
    S = num_spline_params(w.num_bins)
    T = w.num_transforms
    z = t
    log_det = torch.zeros_like(t)
    if w.cond_affine:
        mu = sp[:, T * S]
        ls = torch.clamp(sp[:, T * S + 1], -7.0, 7.0)
        z = (z - mu) * torch.exp(-ls)
        log_det = log_det - ls
    for i in range(T):
        z, ld = rq_spline_forward(z, sp[:, i * S : (i + 1) * S], num_bins=w.num_bins, tail_bound=w.tail_bound)
        log_det = log_det + ld
    return _censor(cat_lp, log_det + (-_LOG_SQRT_2PI - 0.5 * z * z), oh, w)


def rows_logp_vjp_plain(t, oh, ctx, w: MNLEWeights, g):
    """(dt, dctx): the cotangent ``g`` pulled back through
    ``rows_logp_plain`` by autograd (the plain version of K3)."""
    with torch.enable_grad():
        t_ = t.detach().requires_grad_(True)
        ctx_ = ctx.detach().requires_grad_(True)
        out = rows_logp_plain(t_, oh.detach(), ctx_, w)
        dt, dctx = torch.autograd.grad(out, (t_, ctx_), grad_outputs=g)
    return dt, dctx


def rows_logp_pulse_plain(phi, oh, ctx, kf, kv, w: MNLEWeights):
    """Per-row log p of the pulse rep (absolute anchor) on standardized
    inputs (plain PyTorch; the JAX ``_rows_logp_pulse``).

    phi: (N,) within-slot phase, oh: (N, C), ctx: (N, D), kf: (N, F)
    flow-head features, kv: (N,) slot index as a float. The slot head's
    log-softmax is picked where the slot equals int(kv) (0 outside the
    slots); the phase runs through the circular splines to a uniform base.
    The outer -log Delta is added by the caller."""
    cat_lp, emb = _shared_heads(oh, ctx, w)
    slot_logits = F.log_softmax(emb @ w.slot[0] + w.slot[1], dim=-1)
    iota = torch.arange(slot_logits.shape[-1], device=kv.device)
    pick = iota == kv.to(torch.int64)[:, None]
    slot_lp = torch.where(pick, slot_logits, torch.zeros_like(slot_logits)).sum(-1)
    sp = torch.cat([emb, kf], dim=-1) @ w.head_w + w.head_b
    S = num_circular_spline_params(w.num_bins)
    z = phi
    log_det = torch.zeros_like(phi)
    for i in range(w.num_transforms):
        z, ld = rq_spline_circular(z, sp[:, i * S : (i + 1) * S], num_bins=w.num_bins)
        log_det = log_det + ld
    return _censor(cat_lp, slot_lp + log_det, oh, w)


def rows_logp_pulse_vjp_plain(phi, oh, ctx, kf, kv, w: MNLEWeights, g):
    """(dphi, dctx, dkf): the cotangent ``g`` pulled back through
    ``rows_logp_pulse_plain`` by autograd (the plain version of K3p)."""
    with torch.enable_grad():
        diff = [a.detach().requires_grad_(True) for a in (phi, ctx, kf)]
        out = rows_logp_pulse_plain(diff[0], oh.detach(), diff[1], diff[2], kv.detach(), w)
        return torch.autograd.grad(out, diff, grad_outputs=g)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_rows(t, oh, ctx, w: MNLEWeights):
    N = t.shape[0]
    p = w.struct()
    if p.K > 32:
        raise ValueError(f"the fused kernels hold one spline bin per lane of a warp: num_bins={p.K} > 32")
    check_cuda_tensor("t", t, (N,))
    check_cuda_tensor("onehot", oh, (N, p.C))
    check_cuda_tensor("ctx", ctx, (N, p.D))
    if not (t.device == oh.device == ctx.device == w.head_w.device):
        raise ValueError("rows and weights must be on one device")
    return N, p


def rows_logp(t, oh, ctx, w: MNLEWeights):
    """K2 for CUDA tensors, ``rows_logp_plain`` for CPU tensors."""
    if metrics.RECORDING:
        metrics.count("launch.k2")
    if not t.is_cuda:
        return rows_logp_plain(t, oh, ctx, w)
    N, p = _check_rows(t, oh, ctx, w)
    out = torch.empty((N,), dtype=torch.float32, device=t.device)
    K2(ctypes.byref(p), t.data_ptr(), oh.data_ptr(), ctx.data_ptr(), out.data_ptr(), N,
       stream_handle(t.device))
    return out


def rows_logp_and_vjp(t, oh, ctx, w: MNLEWeights, g):
    """(value (N,), dt (N,), dctx (N, D)): K3 alone for CUDA tensors (its
    value has K2's bits), ``rows_logp_plain`` and ``rows_logp_vjp_plain``
    for CPU tensors."""
    if metrics.RECORDING:
        metrics.count("launch.k3")
    if not t.is_cuda:
        return (rows_logp_plain(t, oh, ctx, w), *rows_logp_vjp_plain(t, oh, ctx, w, g))
    N, p = _check_rows(t, oh, ctx, w)
    check_cuda_tensor("g", g, (N,))
    out = torch.empty((N,), dtype=torch.float32, device=t.device)
    dt = torch.empty((N,), dtype=torch.float32, device=t.device)
    dctx = torch.empty((N, p.D), dtype=torch.float32, device=t.device)
    K3(ctypes.byref(p), t.data_ptr(), oh.data_ptr(), ctx.data_ptr(), g.data_ptr(), out.data_ptr(),
       dt.data_ptr(), dctx.data_ptr(), N, stream_handle(t.device))
    return out, dt, dctx


def rows_logp_vjp(t, oh, ctx, w: MNLEWeights, g):
    """(dt, dctx): K3 for CUDA tensors, ``rows_logp_vjp_plain`` for CPU
    tensors."""
    if not t.is_cuda:
        if metrics.RECORDING:
            metrics.count("launch.k3")
        return rows_logp_vjp_plain(t, oh, ctx, w, g)
    return rows_logp_and_vjp(t, oh, ctx, w, g)[1:]


class FusedRowsLogProb(torch.autograd.Function):
    """Row log-probs with K2 forward and K3 recompute-VJP backward
    (gradients for ``t`` and ``ctx`` only)."""

    @staticmethod
    def forward(ctx_, t, oh, ctx, weights: MNLEWeights):
        t, oh, ctx = t.contiguous(), oh.contiguous(), ctx.contiguous()
        ctx_.save_for_backward(t, oh, ctx)
        ctx_.weights = weights
        return rows_logp(t, oh, ctx, weights)

    @staticmethod
    def backward(ctx_, g):
        t, oh, ctx = ctx_.saved_tensors
        dt, dctx = rows_logp_vjp(t, oh, ctx, ctx_.weights, g.contiguous())
        return dt, None, dctx, None


def _check_pulse_rows(phi, oh, ctx, kf, kv, w: MNLEWeights):
    if not w.pulse:
        raise ValueError("K2p/K3p need the weights of a pulse-rep estimator")
    N, p = _check_rows(phi, oh, ctx, w)
    check_cuda_tensor("kf", kf, (N, p.F))
    check_cuda_tensor("kv", kv, (N,))
    if not (kf.device == kv.device == phi.device):
        raise ValueError("rows and weights must be on one device")
    return N, p


def rows_logp_pulse(phi, oh, ctx, kf, kv, w: MNLEWeights):
    """K2p for CUDA tensors, ``rows_logp_pulse_plain`` for CPU tensors."""
    if metrics.RECORDING:
        metrics.count("launch.k2p")
    if not phi.is_cuda:
        return rows_logp_pulse_plain(phi, oh, ctx, kf, kv, w)
    N, p = _check_pulse_rows(phi, oh, ctx, kf, kv, w)
    out = torch.empty((N,), dtype=torch.float32, device=phi.device)
    K2P(ctypes.byref(p), phi.data_ptr(), oh.data_ptr(), ctx.data_ptr(), kf.data_ptr(), kv.data_ptr(),
        out.data_ptr(), N, stream_handle(phi.device))
    return out


def rows_logp_pulse_and_vjp(phi, oh, ctx, kf, kv, w: MNLEWeights, g):
    """(value (N,), dphi (N,), dctx (N, D), dkf (N, F)): K3p alone for CUDA
    tensors (its value has K2p's bits), ``rows_logp_pulse_plain`` and
    ``rows_logp_pulse_vjp_plain`` for CPU tensors."""
    if metrics.RECORDING:
        metrics.count("launch.k3p")
    if not phi.is_cuda:
        return (rows_logp_pulse_plain(phi, oh, ctx, kf, kv, w), *rows_logp_pulse_vjp_plain(phi, oh, ctx, kf, kv, w, g))
    N, p = _check_pulse_rows(phi, oh, ctx, kf, kv, w)
    check_cuda_tensor("g", g, (N,))
    out = torch.empty((N,), dtype=torch.float32, device=phi.device)
    dphi = torch.empty((N,), dtype=torch.float32, device=phi.device)
    dctx = torch.empty((N, p.D), dtype=torch.float32, device=phi.device)
    dkf = torch.empty((N, p.F), dtype=torch.float32, device=phi.device)
    K3P(ctypes.byref(p), phi.data_ptr(), oh.data_ptr(), ctx.data_ptr(), kf.data_ptr(), kv.data_ptr(),
        g.data_ptr(), out.data_ptr(), dphi.data_ptr(), dctx.data_ptr(), dkf.data_ptr(), N,
        stream_handle(phi.device))
    return out, dphi, dctx, dkf


def rows_logp_pulse_vjp(phi, oh, ctx, kf, kv, w: MNLEWeights, g):
    """(dphi (N,), dctx (N, D), dkf (N, F)): K3p for CUDA tensors,
    ``rows_logp_pulse_vjp_plain`` for CPU tensors."""
    if not phi.is_cuda:
        if metrics.RECORDING:
            metrics.count("launch.k3p")
        return rows_logp_pulse_vjp_plain(phi, oh, ctx, kf, kv, w, g)
    return rows_logp_pulse_and_vjp(phi, oh, ctx, kf, kv, w, g)[1:]


class FusedPulseRowsLogProb(torch.autograd.Function):
    """Pulse-rep row log-probs with K2p forward and K3p recompute-VJP
    backward (gradients for ``phi``, ``ctx`` and ``kf`` only)."""

    @staticmethod
    def forward(ctx_, phi, oh, ctx, kf, kv, weights: MNLEWeights):
        rows = tuple(a.contiguous() for a in (phi, oh, ctx, kf, kv))
        ctx_.save_for_backward(*rows)
        ctx_.weights = weights
        return rows_logp_pulse(*rows, weights)

    @staticmethod
    def backward(ctx_, g):
        dphi, dctx, dkf = rows_logp_pulse_vjp(*ctx_.saved_tensors, ctx_.weights, g.contiguous())
        return dphi, None, dctx, dkf, None, None


def make_fused_logprob(estimator):
    """``fn(x, condition) -> log p(x | condition)`` through K2/K3 (K2p/K3p
    for the pulse rep), the same function as ``estimator.log_prob_fn`` (the
    outer transforms run in PyTorch around the kernels). The weights are
    packed once, here, on the estimator's device: the function is tied to
    the estimator's current weights and differentiates w.r.t. its inputs.
    The kernels read the context ``net.make_context`` gives (the pulse
    embedding runs in PyTorch before them, as in the JAX package), and the
    tail sharpening is part of ``standardize``'s t and log-det. The pulse
    rep's tnd anchor has no fused path and raises, as in the JAX package."""
    cfg = estimator.cfg
    if cfg.rt_rep == "pulse" and not cfg.circular:
        raise ValueError(
            "fused kernel supports rt_rep='pulse' only with grid_anchor='absolute' "
            "(the tnd anchor stays on the plain path)"
        )
    weights = pack_mnle_weights(estimator)

    def pulse_log_prob(x, condition, batch_shape):
        phi, onehot, c, kf, kv, ds, _ = estimator.standardize_pulse(x, condition)
        c = estimator.net.make_context(c, condition)
        n = math.prod(batch_shape)
        lp = FusedPulseRowsLogProb.apply(
            phi.reshape(n), onehot.reshape(n, cfg.num_categories), c.reshape(n, c.shape[-1]),
            kf.reshape(n, kf.shape[-1]), kv.reshape(n), weights,
        )
        return lp.reshape(batch_shape) + ds

    def log_prob(x, condition):
        batch_shape = torch.broadcast_shapes(x.shape[:-1], condition.shape[:-1])
        x = x.expand(batch_shape + x.shape[-1:])
        condition = condition.expand(batch_shape + condition.shape[-1:])
        if cfg.rt_rep == "pulse":
            return pulse_log_prob(x, condition, batch_shape)
        t, onehot, c, log_det, barrier, choice = estimator.standardize(x, condition)
        c = estimator.net.make_context(c, condition)
        log_det = log_det + barrier
        if cfg.censor_rt:
            log_det = torch.where(choice == cfg.censored_category, torch.zeros_like(log_det), log_det)
        n = math.prod(batch_shape)
        lp = FusedRowsLogProb.apply(
            t.reshape(n), onehot.reshape(n, cfg.num_categories), c.reshape(n, c.shape[-1]), weights
        )
        return lp.reshape(batch_shape) + log_det

    log_prob.weights = weights
    return log_prob
