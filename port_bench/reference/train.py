"""Plain MNLE training steps: the yardstick of the training cell.

Given the benchmark's initial weights, the whole training set (for the
standardization statistics) and the batches of the first optimizer steps,
it works out what those steps should give: each step's loss
-mean log p(x | z), the first step's gradient after clipping to a global
norm of 5, and the weights after the steps, under Adam (b1 0.9, b2 0.999,
eps 1e-8) at the cosine schedule lr(step) = lr0 ((1 - 0.02) (1 + cos(pi
min(step, T) / T)) / 2 + 0.02). The log-probability is the plain
``reference.mnle.log_prob``; it imports nothing of the port and nothing of
JAX.
"""

from __future__ import annotations

import math

import torch

from . import mnle as ref

__all__ = ["statistics", "schedule_steps", "steps"]

_ALPHA = 0.02


def statistics(cfg: dict, z, x):
    """Population mean and standard deviation (floored at 1e-6) of the
    condition after its log dims, and of log(rt - t_nd) over the trials that
    are not censored."""
    c = z
    if cfg.get("log_condition_dims"):
        mask = torch.zeros(z.shape[-1], dtype=torch.bool, device=z.device)
        mask[list(cfg["log_condition_dims"])] = True
        c = torch.where(mask, torch.log(torch.clamp(z, min=1e-37)), z)
    cond_mean = c.mean(0)
    cond_std = c.std(0, unbiased=False).clamp(min=1e-6)
    t = torch.log(torch.clamp(x[:, 0] - z[:, cfg["tnd_index"]], min=1e-6))
    keep = x[:, 1] != cfg["censored_category"]
    x_mean = t[keep].mean()
    x_std = torch.sqrt(((t[keep] - x_mean) ** 2).mean()).clamp(min=1e-6)
    return cond_mean, cond_std, x_mean, x_std


def schedule_steps(n: int, validation_fraction: float, batch: int, max_epochs: int) -> int:
    """T of the cosine schedule: optimizer steps an epoch times the epochs."""
    n_val = max(int(n * validation_fraction), 1) if n > 10 else 0
    n_tr = n - n_val
    return max(n_tr // min(batch, n_tr), 1) * max_epochs


def _model(cfg: dict, leaves: dict, stats) -> ref.Model:
    def mlp(name):
        count = sum(1 for k in leaves if k.startswith(name + "/") and k.endswith("/kernel"))
        return [(leaves[f"{name}/Dense_{i}/kernel"], leaves[f"{name}/Dense_{i}/bias"]) for i in range(count)]

    heads = [(leaves[f"spline_head_{i}/kernel"], leaves[f"spline_head_{i}/bias"])
             for i in range(cfg["num_transforms"])]
    affine = (leaves["affine_head/kernel"], leaves["affine_head/bias"]) if "affine_head/kernel" in leaves else None
    return ref.Model(cfg, mlp("cat_net"), mlp("flow_trunk"), heads, affine, None, *stats)


def steps(cfg: dict, leaves: dict, z, x, batches, *, lr0: float, total_steps: int, max_norm: float = 5.0) -> dict:
    """Run len(batches) optimizer steps from ``leaves`` (name -> tensor, in the
    type to compute in). Returns the losses, each step's clipped gradient
    (``grads``; ``grad1`` the first's) and the weights after the last step,
    each leaf by name."""
    dtype = next(iter(leaves.values())).dtype
    stats = statistics(cfg, z.to(dtype), x.to(dtype))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, clipped = [], []
    for step, (xb, zb) in enumerate(batches):
        model = _model(cfg, params, stats)
        loss = -ref.log_prob(model, xb.to(dtype), zb.to(dtype)).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if norm >= max_norm:
            grads = {k: g / norm * max_norm for k, g in grads.items()}
        clipped.append({k: g.detach() for k, g in grads.items()})
        losses.append(float(loss.detach()))
        t = min(step, total_steps)
        lr = lr0 * ((1.0 - _ALPHA) * 0.5 * (1.0 + math.cos(math.pi * t / total_steps)) + _ALPHA)
        with torch.no_grad():
            for k, p in params.items():
                m[k] = b1 * m[k] + (1.0 - b1) * grads[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * grads[k] ** 2
                m_hat = m[k] / (1.0 - b1 ** (step + 1))
                v_hat = v2[k] / (1.0 - b2 ** (step + 1))
                p -= lr * m_hat / (torch.sqrt(v_hat) + eps)
    return {"losses": losses, "grad1": clipped[0], "grads": clipped,
            "weights": {k: p.detach() for k, p in params.items()}}
