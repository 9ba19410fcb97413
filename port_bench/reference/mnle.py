"""Plain MNLE likelihood, written from the saved ``.npz`` and the model's equations.

This is the benchmark's yardstick for the sampler cells. It reads the
weights and the standardization statistics of a saved estimator with NumPy
and evaluates, in any floating type, what the port's potential evaluates at
every sampler call:

    ll(theta) = sum_t log p(x_t | [theta, s_t]),

the mixed likelihood of Boelts et al. (2022): a categorical head
p(choice | c) and, on the trials that are not censored, a conditional flow
over the reaction time. Two RT representations are written out, the ones
the benchmark's configurations run:

* ``shifted_log``: t = (log(rt - t_nd) - x_mean) / x_std, an optional
  conditional location-scale layer, ``num_transforms`` rational-quadratic
  splines on [-B, B] with identity tails (Durkan et al. 2019) and a
  standard-normal base; the change of variables -log(rt - t_nd) - log x_std
  and a linear barrier below the onset (gap < 1e-6).
* ``pulse`` with the absolute anchor: the slot k = floor(rt / Delta) from a
  categorical slot head and the phase within the slot from a chain of
  circular rational-quadratic splines (uniform base), whose heads also read
  [k_norm, sin, cos] of t_nd's grid phase; the change of variables -log Delta.

It imports nothing of the port and nothing of JAX. Gradients are taken by
autograd, in the type the caller asks for (float64 for the yardstick,
float32 with TF32 products for the control).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Model", "load_npz", "log_prob", "log_lik", "log_lik_and_grad"]

_KEY = re.compile(r"\['([^']*)'\]")
_MIN_W = _MIN_H = _MIN_D = 1e-3
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass
class Model:
    """A saved estimator: ``cfg`` its ``mnle_config``, each layer a pair
    (W (in, out), b (out,)) as the ``.npz`` stores it, and the statistics."""

    cfg: dict
    cat: list
    trunk: list
    heads: list
    affine: tuple | None
    slot: tuple | None
    cond_mean: torch.Tensor
    cond_std: torch.Tensor
    x_mean: torch.Tensor
    x_std: torch.Tensor

    def to(self, dtype, device=None) -> "Model":
        def cv(a):
            return None if a is None else a.to(dtype=dtype, device=device)

        def pair(p):
            return None if p is None else (cv(p[0]), cv(p[1]))

        return Model(self.cfg, [pair(p) for p in self.cat], [pair(p) for p in self.trunk],
                     [pair(p) for p in self.heads], pair(self.affine), pair(self.slot),
                     cv(self.cond_mean), cv(self.cond_std), cv(self.x_mean), cv(self.x_std))


def load_npz(path, dtype=torch.float64, device="cpu") -> Model:
    """The estimator saved at ``path`` (``param:['a']['b']['kernel']`` leaves,
    ``stat:*`` arrays, the ``__meta__`` JSON)."""
    with np.load(path, allow_pickle=False) as data:
        cfg = json.loads(str(data["__meta__"]))["mnle_config"]
        tree: dict = {}
        for name in data.files:
            if name.startswith("param:"):
                parts = _KEY.findall(name[len("param:"):])
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = torch.from_numpy(np.asarray(data[name], np.float32).copy())
        stats = {k: torch.from_numpy(np.asarray(data[f"stat:{k}"], np.float32).copy())
                 for k in ("cond_mean", "cond_std", "x_mean", "x_std")}

    def pair(leaf):
        return leaf["kernel"], leaf["bias"]

    def mlp(name):
        return [pair(tree[name][f"Dense_{i}"]) for i in range(len(tree[name]))]

    model = Model(
        cfg=cfg,
        cat=mlp("cat_net"),
        trunk=mlp("flow_trunk"),
        heads=[pair(tree[f"spline_head_{i}"]) for i in range(cfg["num_transforms"])],
        affine=pair(tree["affine_head"]) if "affine_head" in tree else None,
        slot=pair(tree["pulse_slot_head"]) if "pulse_slot_head" in tree else None,
        **stats,
    )
    if "pulse_embed" in tree or cfg.get("tail_sharp_k", 0.0) > 0:
        raise NotImplementedError("the reference has no pulse embedding and no tail sharpening")
    if cfg["rt_rep"] not in ("shifted_log", "pulse") or (cfg["rt_rep"] == "pulse" and cfg["grid_anchor"] != "absolute"):
        raise NotImplementedError(f"rt_rep {cfg['rt_rep']!r} is not written out here")
    return model.to(dtype, device)


def _dense(h, layer):
    return h @ layer[0] + layer[1]


def _mlp(h, layers):
    """ReLU after every layer but the last."""
    for layer in layers[:-1]:
        h = torch.relu(_dense(h, layer))
    return _dense(h, layers[-1])


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _bin(knots, z):
    """The bin k with knots[k] <= z < knots[k+1] (the top edge in the last bin)."""
    return torch.clamp((z[..., None] >= knots[..., 1:-1]).sum(-1), max=knots.shape[-1] - 2)


def _pick(a, k):
    return torch.gather(a, -1, k[..., None])[..., 0]


def _rq(z, xk, yk, dk):
    """The rational-quadratic map of z inside its bin and its log-derivative."""
    k = _bin(xk, z)
    x0, x1, y0, y1 = _pick(xk, k), _pick(xk, k + 1), _pick(yk, k), _pick(yk, k + 1)
    d0, d1 = _pick(dk, k), _pick(dk, k + 1)
    w, h = x1 - x0, y1 - y0
    s = h / w
    xi = torch.clamp((z - x0) / w, 0.0, 1.0)
    om = 1.0 - xi
    den = s + (d1 + d0 - 2.0 * s) * xi * om
    out = y0 + h * (s * xi * xi + d0 * xi * om) / den
    ld = torch.log(s * s * (d1 * xi * xi + 2.0 * s * xi * om + d0 * om * om)) - 2.0 * torch.log(den)
    return out, ld


def _spline(z, p, K: int, B: float):
    """Monotone RQ spline on [-B, B], identity outside: (f(z), log f'(z))."""
    w = _MIN_W + (1.0 - _MIN_W * K) * torch.softmax(p[..., :K], -1)
    h = _MIN_H + (1.0 - _MIN_H * K) * torch.softmax(p[..., K:2 * K], -1)
    edge = torch.full_like(w[..., :1], B)
    xk = torch.cat([-edge, torch.cumsum(w, -1)[..., :K - 1] * 2.0 * B - B, edge], -1)
    yk = torch.cat([-edge, torch.cumsum(h, -1)[..., :K - 1] * 2.0 * B - B, edge], -1)
    one = torch.ones_like(w[..., :1])
    dk = torch.cat([one, _MIN_D + _softplus(p[..., 2 * K:]), one], -1)
    inside = (z >= -B) & (z <= B)
    out, ld = _rq(torch.clamp(z, -B, B), xk, yk, dk)
    return torch.where(inside, out, z), torch.where(inside, ld, torch.zeros_like(ld))


def _circular_spline(phi, p, K: int):
    """Circular RQ spline of the phase: rotate by sigmoid(p[3K]) mod 1, then a
    monotone RQ map of [0, 1) onto itself whose end derivatives are shared."""
    w = _MIN_W + (1.0 - _MIN_W * K) * torch.softmax(p[..., :K], -1)
    h = _MIN_H + (1.0 - _MIN_H * K) * torch.softmax(p[..., K:2 * K], -1)
    zero, one = torch.zeros_like(w[..., :1]), torch.ones_like(w[..., :1])
    xk = torch.cat([zero, torch.cumsum(w, -1)[..., :K - 1], one], -1)
    yk = torch.cat([zero, torch.cumsum(h, -1)[..., :K - 1], one], -1)
    d = _MIN_D + _softplus(p[..., 2 * K:3 * K])
    dk = torch.cat([d, d[..., :1]], -1)
    z = torch.clamp(torch.remainder(phi - torch.sigmoid(p[..., 3 * K]), 1.0), 0.0, 1.0 - 1e-6)
    return _rq(z, xk, yk, dk)


def _condition(m: Model, cond):
    c = cond
    log_dims = list(m.cfg.get("log_condition_dims") or ())
    if log_dims:
        mask = torch.zeros(cond.shape[-1], dtype=torch.bool, device=cond.device)
        mask[log_dims] = True
        c = torch.where(mask, torch.log(torch.clamp(cond, min=1e-37)), cond)
    if m.cfg["z_score_theta"]:
        c = (c - m.cond_mean) / m.cond_std
    return c


def _slot_split(m: Model, rt):
    """(slot k, phase phi) of the pulse grid, worked out in the observation's
    own float32 (so the slot of a trial never depends on the type the rest
    runs in), then cast to the model's type."""
    delta = np.float32(m.cfg["pulse_interval"])
    u = torch.clamp(rt.to(torch.float32), min=float(np.float32(m.cfg["euler_dt"]))) / float(delta)
    k = torch.clamp(torch.floor(u).to(torch.int64), 0, m.cfg["num_pulse_slots"] - 1)
    phi = torch.clamp(u - k.to(torch.float32), 1e-6, 1.0 - 1e-6)
    return k, phi.to(m.cond_mean.dtype)


def log_prob(m: Model, x, cond):
    """log p(x | cond) of rows: x (n, 2) = (rt, choice), cond (n, condition_dim)
    the raw condition [theta, pulses]. Returns (n,)."""
    cfg = m.cfg
    rt, choice = x[:, 0], x[:, 1].round().to(torch.int64)
    c = _condition(m, cond)
    onehot = F.one_hot(choice, cfg["num_categories"]).to(c.dtype)
    cat_lp = _pick(torch.log_softmax(_mlp(c, m.cat), -1), choice)
    emb = torch.relu(_mlp(torch.cat([c, onehot], -1), m.trunk))
    K, tnd = cfg["num_bins"], cond[:, cfg["tnd_index"]]
    if cfg["rt_rep"] == "pulse":
        k, phi = _slot_split(m, rt)
        slot_lp = _pick(torch.log_softmax(_dense(emb, m.slot), -1), k)
        ang = 2.0 * math.pi * torch.remainder(tnd / cfg["pulse_interval"], 1.0)
        feat = torch.stack([(k.to(c.dtype) + 0.5) / cfg["num_pulse_slots"], torch.sin(ang), torch.cos(ang)], -1)
        he = torch.cat([emb, feat], -1)
        z, flow_lp = phi, torch.zeros_like(phi)
        for head in m.heads:
            z, ld = _circular_spline(z, _dense(he, head), K)
            flow_lp = flow_lp + ld
        rt_term = slot_lp + flow_lp - math.log(cfg["pulse_interval"])
    else:
        # The onset gap rt - t_nd is taken where the float32 observation and
        # parameter meet, in float32, as the model's float32 program takes
        # it: near the floor (1e-6 s) a gap rounded otherwise lands on the
        # other side of the floor, where the derivative is the barrier's.
        gap = (rt.to(torch.float32) - tnd.to(torch.float32)).to(rt.dtype)
        t_raw = torch.log(torch.clamp(gap, min=1e-6))
        change = -t_raw - 50.0 * torch.relu(1e-6 - gap)
        z = t_raw
        if cfg["z_score_x"]:
            z = (t_raw - m.x_mean) / m.x_std
            change = change - torch.log(m.x_std)
        flow_lp = torch.zeros_like(z)
        if m.affine is not None:
            a = _dense(emb, m.affine)
            ls = torch.clamp(a[:, 1], -7.0, 7.0)
            z = (z - a[:, 0]) * torch.exp(-ls)
            flow_lp = flow_lp - ls
        for head in m.heads:
            z, ld = _spline(z, _dense(emb, head), K, float(cfg["tail_bound"]))
            flow_lp = flow_lp + ld
        rt_term = -_LOG_SQRT_2PI - 0.5 * z * z + flow_lp + change
    if cfg["censor_rt"]:
        rt_term = torch.where(choice == cfg["censored_category"], torch.zeros_like(rt_term), rt_term)
    return cat_lp + rt_term


def log_lik(m: Model, x, stim, theta):
    """Summed log-likelihood of N parameter rows: theta (N, D), x (N, T, 2) and
    stim (N, T, P) each row's session. Returns (N,)."""
    N, T = x.shape[:2]
    cond = torch.cat([theta[:, None, :].expand(N, T, theta.shape[-1]), stim], -1)
    return log_prob(m, x.reshape(N * T, 2), cond.reshape(N * T, -1)).reshape(N, T).sum(-1)


def log_lik_and_grad(m: Model, x, stim, theta, need_grad: bool = True, block: int = 256):
    """(ll (N,), d ll / d theta (N, D) or None) in the model's type, in blocks
    of ``block`` parameter rows so that a large call fits."""
    dtype = m.cond_mean.dtype
    lls, grads = [], []
    for lo in range(0, theta.shape[0], block):
        th = theta[lo:lo + block].to(dtype).detach().requires_grad_(need_grad)
        with torch.set_grad_enabled(need_grad):
            ll = log_lik(m, x[lo:lo + block].to(dtype), stim[lo:lo + block].to(dtype), th)
            if need_grad:
                grads.append(torch.autograd.grad(ll.sum(), th)[0])
        lls.append(ll.detach())
    return torch.cat(lls), (torch.cat(grads) if need_grad else None)
