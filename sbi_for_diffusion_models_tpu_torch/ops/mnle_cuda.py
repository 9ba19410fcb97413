"""Kernels K2 and K3: the fused MNLE log-prob forward and its backward.

Counterpart of ``sbi_for_diffusion_models_tpu/ops/mnle_pallas.py``. Per row
(one trial under one theta) the whole network runs in one kernel: the
categorical MLP and its log-softmax, the flow trunk, one head matmul to all
spline parameters (plus the affine (mu, log sigma) pair), the conditional
affine layer, the RQ spline chain and the normal base, with the censored
mask. K2 (``csrc/mnle_logprob.cu``, ``mnle_logprob_fwd_kernel``) returns the
row log-probs; K3 (``mnle_logprob_bwd_kernel``) recomputes the forward and
returns the cotangent-weighted gradients w.r.t. the standardized RT ``t``
and the context ``ctx``, never w.r.t. the weights (training keeps the plain
autodiff path). ``FusedRowsLogProb`` binds them as a
``torch.autograd.Function``; ``make_fused_logprob`` wraps the outer
transforms around it, as the JAX ``make_fused_logprob`` does.

Beside the kernels stand their plain versions: ``rows_logp_plain`` (the
counterpart of the JAX ``_rows_logp``) and ``rows_logp_vjp_plain``
(``torch.autograd.grad`` of it). The wrappers ``rows_logp`` and
``rows_logp_vjp`` launch the kernels for CUDA tensors and take the plain
versions for CPU tensors only.
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
    num_spline_params,
    rq_spline_forward,
)
from ._cuda import CudaKernel, check_cuda_tensor, stream_handle

__all__ = [
    "pack_mnle_weights",
    "MNLEWeights",
    "rows_logp_plain",
    "rows_logp_vjp_plain",
    "rows_logp",
    "rows_logp_vjp",
    "FusedRowsLogProb",
    "make_fused_logprob",
    "K2",
    "K3",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
MAX_LAYERS = 4  # trunk_depth + 1, bounded by the C struct
MAX_TRANSFORMS = 16  # per-row z stack of the backward kernel


class _Params(ctypes.Structure):
    """Mirror of ``MnleParams`` in ``csrc/mnle_logprob.cu``."""

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
    ]


_ARGS_FWD = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
_ARGS_BWD = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
K2 = CudaKernel("mnle_logprob_fwd", "mnle_logprob.cu", "sdm_mnle_logprob_fwd", _ARGS_FWD)
K3 = CudaKernel("mnle_logprob_bwd", "mnle_logprob.cu", "sdm_mnle_logprob_bwd", _ARGS_BWD)


@dataclass
class MNLEWeights:
    """The estimator's weights in the kernels' layout.

    ``cat`` and ``trunk`` hold one (W (in, out), b (out,)) pair per layer,
    ``head_w`` (H, T*S [+2]) and ``head_b`` the concatenated spline heads
    (and the affine head last, when cond_affine) — the JAX
    ``pack_mnle_weights`` order. ``*_t`` are (out, in) copies read by the
    backward kernel, so its transposed products read weights coalesced.
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
    _struct: Optional[_Params] = None
    _keep: Optional[list] = None

    def astype(self, dtype) -> "MNLEWeights":
        """The same weights in another dtype (a float64 reference for the
        plain versions; the kernels take float32 only)."""
        return dataclasses.replace(
            self,
            cat=[(W.to(dtype), b.to(dtype)) for W, b in self.cat],
            trunk=[(W.to(dtype), b.to(dtype)) for W, b in self.trunk],
            head_w=self.head_w.to(dtype),
            head_b=self.head_b.to(dtype),
            _struct=None,
            _keep=None,
        )

    def as_list(self) -> list:
        """Flat list in the JAX ``pack_mnle_weights`` order (biases 1-D)."""
        out = []
        for W, b in self.cat + self.trunk:
            out += [W, b]
        return out + [self.head_w, self.head_b]

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
            hw, hwt, hb = self.head_w.contiguous(), self.head_w.t().contiguous(), self.head_b.contiguous()
            keep += [hw, hwt, hb]
            p.head_w, p.head_wt, p.head_b = hw.data_ptr(), hwt.data_ptr(), hb.data_ptr()
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
        cond_affine=bool(cfg.cond_affine),
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def rows_logp_plain(t, oh, ctx, w: MNLEWeights):
    """Per-row MNLE log p on standardized inputs (plain PyTorch).

    t: (N,), oh: (N, C), ctx: (N, D). Censored rows (when the estimator
    censors) keep only the categorical term: the flow term is multiplied by
    (1 - onehot[censored]) as in the JAX row function, and rows where that
    factor is 0 take 0 instead of the product, so a non-finite flow term
    there never turns into NaN.
    """
    h = ctx
    for W, b in w.cat[:-1]:
        h = F.relu(h @ W + b)
    logits = F.log_softmax(h @ w.cat[-1][0] + w.cat[-1][1], dim=-1)
    cat_lp = (logits * oh).sum(-1)
    f = torch.cat([ctx, oh], dim=-1)
    for W, b in w.trunk:
        f = F.relu(f @ W + b)
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
    flow = log_det + (-_LOG_SQRT_2PI - 0.5 * z * z)
    if w.censored_col is None:
        return cat_lp + flow
    keep = 1.0 - oh[:, w.censored_col]
    return cat_lp + torch.where(keep > 0, keep * flow, torch.zeros_like(flow))


def rows_logp_vjp_plain(t, oh, ctx, w: MNLEWeights, g):
    """(dt, dctx): the cotangent ``g`` pulled back through
    ``rows_logp_plain`` by autograd (the plain version of K3)."""
    with torch.enable_grad():
        t_ = t.detach().requires_grad_(True)
        ctx_ = ctx.detach().requires_grad_(True)
        out = rows_logp_plain(t_, oh.detach(), ctx_, w)
        dt, dctx = torch.autograd.grad(out, (t_, ctx_), grad_outputs=g)
    return dt, dctx


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_rows(t, oh, ctx, w: MNLEWeights):
    N = t.shape[0]
    p = w.struct()
    check_cuda_tensor("t", t, (N,))
    check_cuda_tensor("onehot", oh, (N, p.C))
    check_cuda_tensor("ctx", ctx, (N, p.D))
    if not (t.device == oh.device == ctx.device == w.head_w.device):
        raise ValueError("rows and weights must be on one device")
    return N, p


def rows_logp(t, oh, ctx, w: MNLEWeights):
    """K2 for CUDA tensors, ``rows_logp_plain`` for CPU tensors."""
    if not t.is_cuda:
        return rows_logp_plain(t, oh, ctx, w)
    N, p = _check_rows(t, oh, ctx, w)
    out = torch.empty((N,), dtype=torch.float32, device=t.device)
    K2(ctypes.byref(p), t.data_ptr(), oh.data_ptr(), ctx.data_ptr(), out.data_ptr(), N,
       stream_handle(t.device))
    return out


def rows_logp_vjp(t, oh, ctx, w: MNLEWeights, g):
    """K3 for CUDA tensors, ``rows_logp_vjp_plain`` for CPU tensors."""
    if not t.is_cuda:
        return rows_logp_vjp_plain(t, oh, ctx, w, g)
    N, p = _check_rows(t, oh, ctx, w)
    check_cuda_tensor("g", g, (N,))
    dt = torch.empty((N,), dtype=torch.float32, device=t.device)
    dctx = torch.empty((N, p.D), dtype=torch.float32, device=t.device)
    K3(ctypes.byref(p), t.data_ptr(), oh.data_ptr(), ctx.data_ptr(), g.data_ptr(),
       dt.data_ptr(), dctx.data_ptr(), N, stream_handle(t.device))
    return dt, dctx


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


def make_fused_logprob(estimator):
    """``fn(x, condition) -> log p(x | condition)`` through K2/K3, the same
    function as ``estimator.log_prob_fn`` (the outer transforms run in
    PyTorch around the kernels). The weights are packed once, here, on the
    estimator's device: the function is tied to the estimator's current
    weights and differentiates w.r.t. its inputs."""
    cfg = estimator.cfg
    weights = pack_mnle_weights(estimator)

    def log_prob(x, condition):
        batch_shape = torch.broadcast_shapes(x.shape[:-1], condition.shape[:-1])
        x = x.expand(batch_shape + x.shape[-1:])
        condition = condition.expand(batch_shape + condition.shape[-1:])
        t, onehot, c, log_det, barrier, choice = estimator.standardize(x, condition)
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
