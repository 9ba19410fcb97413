"""Rational-quadratic spline transforms (Durkan et al. 2019), in PyTorch.

Counterpart of ``sbi_for_diffusion_models_tpu/nets/spline.py``
(``_prepare_knots``, ``rq_spline_forward``, ``rq_spline_inverse``): monotone
RQ splines on [-B, B] with linear (identity) tails, written for the last
axis being the parameter axis and broadcasting over leading axes. The
parameters are unconstrained network outputs; widths and heights go through
softmax, inner derivatives through softplus.

The circular spline (``_prepare_circular_knots``, ``rq_spline_circular``)
maps the phase circle [0, 1) to itself: a monotone RQ spline with f(0) = 0,
f(1) = 1 and one derivative shared across the wrap (d_K = d_0), composed
with a learned rotation. The pulse-grid RT representation flows its
within-slot phase through a chain of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "num_spline_params",
    "rq_spline_forward",
    "rq_spline_inverse",
    "num_circular_spline_params",
    "rq_spline_circular",
    "clip",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def num_spline_params(num_bins: int) -> int:
    """Unconstrained params per transformed scalar: K widths + K heights +
    (K - 1) inner derivatives."""
    return 3 * num_bins - 1


def _prepare_knots(params: torch.Tensor, num_bins: int, tail_bound: float):
    """Raw params (..., 3K-1) -> (x_knots, y_knots, derivs), each (..., K+1),
    with the end knots pinned to +-tail_bound and the boundary derivatives
    pinned to 1 (linear tails)."""
    K = num_bins
    widths = DEFAULT_MIN_BIN_WIDTH + (1.0 - DEFAULT_MIN_BIN_WIDTH * K) * torch.softmax(params[..., :K], -1)
    heights = DEFAULT_MIN_BIN_HEIGHT + (1.0 - DEFAULT_MIN_BIN_HEIGHT * K) * torch.softmax(params[..., K : 2 * K], -1)
    total = 2.0 * tail_bound
    cum_w = torch.cumsum(widths, -1) * total
    cum_h = torch.cumsum(heights, -1) * total
    lo = torch.full_like(cum_w[..., :1], -tail_bound)
    hi = torch.full_like(cum_w[..., :1], tail_bound)
    # End knots pinned exactly (cumsum rounding can drift the last one).
    x_knots = torch.cat([lo, cum_w[..., : K - 1] - tail_bound, hi], -1)
    y_knots = torch.cat([lo, cum_h[..., : K - 1] - tail_bound, hi], -1)
    d_inner = DEFAULT_MIN_DERIVATIVE + F.softplus(params[..., 2 * K :])
    ones = torch.ones_like(d_inner[..., :1])
    derivs = torch.cat([ones, d_inner, ones], -1)
    return x_knots, y_knots, derivs


def _searchsorted(knots: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Bin k with knots[k] <= z < knots[k+1]; z == knots[j+1] goes to bin
    j+1 and the top edge to bin K-1."""
    return torch.clamp((z[..., None] >= knots[..., 1:]).sum(-1), 0, knots.shape[-1] - 2)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, -1, idx[..., None])[..., 0]


def rq_spline_forward(x, params, *, num_bins: int, tail_bound: float):
    """y = f(x) and log|dy/dx|, each shaped like x (params (..., 3K-1))."""
    return _rq_spline(x, params, num_bins, tail_bound, inverse=False)


def rq_spline_inverse(y, params, *, num_bins: int, tail_bound: float):
    """x = f^{-1}(y) and log|dx/dy| of the inverse map."""
    return _rq_spline(y, params, num_bins, tail_bound, inverse=True)


def _rq_spline(inputs, params, num_bins, tail_bound, *, inverse: bool):
    x_knots, y_knots, derivs = _prepare_knots(params, num_bins, tail_bound)
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    z = torch.clamp(inputs, -tail_bound, tail_bound)
    k = _searchsorted(y_knots if inverse else x_knots, z)
    x_k, x_k1 = _take(x_knots, k), _take(x_knots, k + 1)
    y_k, y_k1 = _take(y_knots, k), _take(y_knots, k + 1)
    d_k, d_k1 = _take(derivs, k), _take(derivs, k + 1)
    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w
    if not inverse:
        xi = (z - x_k) / w
        xi1m = 1.0 - xi
        num = h * (s * xi**2 + d_k * xi * xi1m)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        out = y_k + num / den
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        log_det = torch.log(deriv_num) - 2.0 * torch.log(den)
    else:
        dy = z - y_k
        a = h * (s - d_k) + dy * (d_k1 + d_k - 2.0 * s)
        b = h * d_k - dy * (d_k1 + d_k - 2.0 * s)
        c = -s * dy
        disc = torch.clamp(b**2 - 4.0 * a * c, min=0.0)
        xi = torch.clamp(2.0 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
        out = x_k + xi * w
        xi1m = 1.0 - xi
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        log_det = 2.0 * torch.log(den) - torch.log(deriv_num)
    out = torch.where(inside, out, inputs)
    log_det = torch.where(inside, log_det, torch.zeros_like(log_det))
    return out, log_det


# ---------------------------------------------------------------------------
# Circular RQ spline on [0, 1) (phase variables)
# ---------------------------------------------------------------------------
def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient rule: the gradient passes inside
    (lo, hi), is 0 outside and is halved where x equals a bound (the rule of
    ``maximum``/``minimum`` in both frameworks; ``torch.clamp`` passes all of
    it there)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def num_circular_spline_params(num_bins: int) -> int:
    """K widths + K heights + K derivatives (wrap-shared) + 1 rotation."""
    return 3 * num_bins + 1


def _prepare_circular_knots(params: torch.Tensor, num_bins: int):
    """Raw params (..., 3K+1) -> (x_knots, y_knots, derivs) each (..., K+1)
    and the rotation (...,). Knots are [0, cumsum(w)[:K-1], 1] with the end
    pinned; derivs = [d_0, .., d_{K-1}, d_0]; rot = sigmoid(rot_raw)."""
    K = num_bins
    widths = DEFAULT_MIN_BIN_WIDTH + (1.0 - DEFAULT_MIN_BIN_WIDTH * K) * torch.softmax(params[..., :K], -1)
    heights = DEFAULT_MIN_BIN_HEIGHT + (1.0 - DEFAULT_MIN_BIN_HEIGHT * K) * torch.softmax(params[..., K : 2 * K], -1)
    cum_w = torch.cumsum(widths, -1)
    cum_h = torch.cumsum(heights, -1)
    zeros = torch.zeros_like(cum_w[..., :1])
    ones = torch.ones_like(cum_w[..., :1])
    x_knots = torch.cat([zeros, cum_w[..., : K - 1], ones], -1)
    y_knots = torch.cat([zeros, cum_h[..., : K - 1], ones], -1)
    d_inner = DEFAULT_MIN_DERIVATIVE + F.softplus(params[..., 2 * K : 3 * K])
    derivs = torch.cat([d_inner, d_inner[..., :1]], -1)
    return x_knots, y_knots, derivs, torch.sigmoid(params[..., 3 * K])


def rq_spline_circular(phi, params, *, num_bins: int, inverse: bool = False):
    """Circular RQ spline on [0, 1): phi -> (out, log_det), shaped like phi.

    Forward (normalizing): out = f(clip((phi - rot) mod 1, 0, 1 - 1e-6)).
    Inverse (generative): out = (f^{-1}(clip(phi, 0, 1 - 1e-6)) + rot) mod 1.
    The mod has floor semantics (``torch.remainder``, as ``%`` in JAX): its
    result lies in [0, 1) and its gradient is 1 w.r.t. phi and -1 w.r.t. rot.
    """
    x_knots, y_knots, derivs, rot = _prepare_circular_knots(params, num_bins)
    if inverse:
        z = clip(phi, 0.0, 1.0 - 1e-6)
    else:
        z = clip(torch.remainder(phi - rot, 1.0), 0.0, 1.0 - 1e-6)
    k = _searchsorted(y_knots if inverse else x_knots, z)
    x_k, x_k1 = _take(x_knots, k), _take(x_knots, k + 1)
    y_k, y_k1 = _take(y_knots, k), _take(y_knots, k + 1)
    d_k, d_k1 = _take(derivs, k), _take(derivs, k + 1)
    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w
    if not inverse:
        xi = clip((z - x_k) / w, 0.0, 1.0)
        xi1m = 1.0 - xi
        num = h * (s * xi**2 + d_k * xi * xi1m)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        return y_k + num / den, torch.log(deriv_num) - 2.0 * torch.log(den)
    dy = z - y_k
    a = h * (s - d_k) + dy * (d_k1 + d_k - 2.0 * s)
    b = h * d_k - dy * (d_k1 + d_k - 2.0 * s)
    c = -s * dy
    disc = torch.clamp(b**2 - 4.0 * a * c, min=0.0)
    xi = clip(2.0 * c / (-b - torch.sqrt(disc)), 0.0, 1.0)
    xi1m = 1.0 - xi
    den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
    deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
    return torch.remainder(x_k + xi * w + rot, 1.0), 2.0 * torch.log(den) - torch.log(deriv_num)
