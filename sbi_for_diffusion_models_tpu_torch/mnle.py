"""MNLE training, persistence and MCMC inference (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/mnle.py``. Ported:
``train_mnle`` (Adam under global-norm clipping with a cosine schedule,
index-only validation split, early stopping on the validation loss),
``save_model`` and ``load_model`` (the JAX ``.npz`` layout:
``param:<keystr>`` leaves, ``stat:*`` arrays and the ``__meta__`` JSON,
written and read with numpy alone, so a model saved by either package loads
in the other) and ``run_inference_mcmc``, for the log, shifted-log and
pulse-grid RT representations. Training differentiates the plain
``MNLE.log_prob_fn`` with autograd: the fused kernels K2/K3 return input
gradients only and serve inference. Training checkpoints, ensembles and SBC
are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .distributions import Distribution, mcmc_transform
from .inference.mcmc import MCMCPosterior, compose_moves, make_dim_slice, make_grid_hop
from .nets.mnle_net import (
    MNLE,
    MNLEConfig,
    build_mnle,
    mnle_from_flax_params,
    mnle_to_flax_params,
    pulse_grid_split,
    shifted_rt_transform,
    transform_condition,
)
from .potentials import ConditionedMNLELogLikelihood, ThetaOnlyPosteriorPotential
from .run_config import RunConfig
from .utils.device import resolve_device
from .utils.rng import as_seed, child_seed, make_generator

__all__ = ["train_mnle", "train_step", "TrainState", "save_model", "load_model", "build_mnle", "run_inference_mcmc"]

_DEFAULT_MODEL_FILENAME = "mnle_rt_choice_model.npz"
_KEY_PART = re.compile(r"\['([^']*)'\]")
_STATS = ("cond_mean", "cond_std", "x_mean", "x_std")
_VALIDATION_CHUNK = 65_536  # rows per forward pass of the validation loss
_SCHEDULE_ALPHA = 0.02  # the cosine schedule ends at this share of the initial learning rate


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
class TrainState:
    """The optimizer state of ``train_step``: Adam (b1 0.9, b2 0.999, eps
    1e-8 added to the root of the bias-corrected second moment) on gradients
    clipped to a global norm of ``max_norm``, at the learning rate
    ``lr_at(step)`` = init x ((1 - alpha) x (1 + cos(pi min(step, T) / T)) / 2
    + alpha), alpha = 0.02: what ``optax.chain(clip_by_global_norm(5.0),
    adam(cosine_decay_schedule(init, T, alpha=0.02)))`` computes.

    Adam's arithmetic is ``torch.optim.Adam``'s, with its defaults
    (``foreach`` on the card, the per-tensor loop on the CPU, never
    ``fused``): the same element-wise formula either way. The clip and the
    schedule are written out here because PyTorch's own differ
    (``clip_grad_norm_`` scales by max_norm / (norm + 1e-6);
    ``CosineAnnealingLR`` is a recursion)."""

    def __init__(self, params, learning_rate: float, decay_steps: int, *, max_norm: float = 5.0):
        self.params = [p for p in params]
        self.learning_rate = float(learning_rate)
        self.decay_steps = max(int(decay_steps), 1)
        self.max_norm = float(max_norm)
        self.adam = torch.optim.Adam(self.params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def lr_at(self, step: int) -> float:
        t = min(int(step), self.decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / self.decay_steps))
        return self.learning_rate * ((1.0 - _SCHEDULE_ALPHA) * cosine + _SCHEDULE_ALPHA)

    def clip_gradients_(self) -> None:
        """optax's ``clip_by_global_norm`` on the parameters' ``.grad``, in
        place: unchanged while the global norm is below ``max_norm``, else
        (g / norm) x max_norm. Decided on the device, without a read-back."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        below = norm < self.max_norm
        divisor = torch.where(below, torch.ones_like(norm), norm)
        factor = torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.max_norm))
        for g in grads:
            g.div_(divisor).mul_(factor)

    def apply(self, step: int) -> None:
        """One update from the gradients in ``.grad``: clip, set the
        learning rate of ``step`` (0 for the first update), Adam."""
        self.clip_gradients_()
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(step)
        self.adam.step()


def train_step(estimator: MNLE, state: TrainState, xb: torch.Tensor, zb: torch.Tensor, step: int) -> torch.Tensor:
    """One optimizer step on the batch (xb, zb): the loss -mean(log p(xb |
    zb)) through the plain ``log_prob_fn``, its gradients w.r.t. the weights
    by autograd, and ``state.apply(step)``. Returns the loss before the
    update (a 0-dim tensor, not read back)."""
    state.adam.zero_grad(set_to_none=True)
    loss = -estimator.log_prob_fn(estimator.net, xb, zb).mean()
    loss.backward()
    state.apply(step)
    return loss.detach()


def _validation_loss(estimator: MNLE, x, z, idx) -> float:
    """-mean(log p) over the rows ``idx``, gathered in chunks to bound memory."""
    total = x.new_zeros(())
    with torch.no_grad():
        for rows in idx.split(_VALIDATION_CHUNK):
            total = total + estimator.log_prob_fn(estimator.net, x[rows], z[rows]).sum()
    return float(-total / idx.numel())


def _mnle_config(cfg: RunConfig, condition_dim: int, num_categories: int, pulse_dim: int) -> MNLEConfig:
    return MNLEConfig(
        condition_dim=condition_dim,
        num_categories=num_categories,
        hidden_features=cfg.MNLE_HIDDEN_FEATURES,
        num_transforms=cfg.MNLE_NUM_TRANSFORMS,
        num_bins=cfg.MNLE_NUM_BINS,
        tail_bound=cfg.MNLE_TAIL_BOUND,
        log_transform_x=cfg.SBI_LOG_TRANSFORM_X,
        z_score_theta=True,
        z_score_x=cfg.Z_SCORE_X not in (None, "none"),
        trunk_depth=cfg.MNLE_TRUNK_DEPTH,
        pulse_dim=pulse_dim,
        embed_dim=cfg.MNLE_EMBED_DIM if pulse_dim > 0 else 0,
        embed_depth=cfg.MNLE_EMBED_DEPTH,
        embed_mode=cfg.MNLE_EMBED_MODE,
        censor_rt=cfg.MNLE_CENSOR_RT,
        rt_rep=cfg.MNLE_RT_REP,
        grid_anchor=cfg.MNLE_GRID_ANCHOR,
        log_condition_dims=cfg.MNLE_LOG_THETA_DIMS,
        tail_sharp_k=cfg.MNLE_TAIL_SHARP_K,
        tail_sharp_c=cfg.MNLE_TAIL_SHARP_C,
        cond_affine=cfg.MNLE_COND_AFFINE,
    )


def _standardization_stats(mcfg: MNLEConfig, z, x):
    """(cond_mean, cond_std, x_mean, x_std): "independent" z-scoring stats of
    the transformed condition and of the flow's own coordinate (per
    ``rt_rep``; over the rows that are not censored when ``censor_rt``).
    Population standard deviations, floored at 1e-6."""
    z_cond = transform_condition(mcfg, z)
    cond_mean = z_cond.mean(0)
    cond_std = z_cond.std(0, unbiased=False).clamp(min=1e-6)
    rt = x[:, 0]
    if mcfg.rt_rep == "pulse":
        _, _, t, _, _ = pulse_grid_split(mcfg, rt, z[:, mcfg.tnd_index])
    elif mcfg.rt_rep == "shifted_log":
        t, _, _ = shifted_rt_transform(mcfg, rt, z)
    else:
        t = torch.log(rt.clamp(min=1e-37)) if mcfg.log_transform_x else rt
    if mcfg.censor_rt:
        # The flow only ever sees the rows that are not censored.
        m = (x[:, 1] != mcfg.censored_category).to(t.dtype)
        denom = m.sum().clamp(min=1.0)
        x_mean = (t * m).sum() / denom
        x_std = torch.sqrt((m * (t - x_mean) ** 2).sum() / denom).clamp(min=1e-6)
    else:
        x_mean = t.mean()
        x_std = t.std(unbiased=False).clamp(min=1e-6)
    return cond_mean, cond_std, x_mean, x_std


def train_mnle(
    cfg: RunConfig,
    proposal_z,
    z_train,
    x_train,
    device=None,
    *,
    seed=0,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
) -> MNLE:
    """Train the MNLE on pre-simulated (z, x) pairs; returns the estimator
    with the best validation loss, its weights not requiring gradients.

    Runs on ``device`` (default: the device of tensor inputs, the CUDA card
    for other input). ``proposal_z`` gives the theta/pulse split of the
    condition (its ``theta_dim``); training itself needs only (z, x). The
    training arrays stay whole on the device: the validation split is a
    split of row indices, and every batch is gathered by index.

    Random streams (``utils/rng.child_seed`` of ``seed``): tag 0 the weights,
    tag 1 the validation split, tag 100 + epoch that epoch's batch order.
    ``train_meta`` carries the JAX package's four entries and, beside them,
    the per-epoch ``train_losses`` and ``val_losses``, ``steps_per_epoch`` and
    ``step_ms`` (mean wall milliseconds per optimizer step, epoch by epoch
    read-back included, validation excluded).
    """
    if cfg.Z_SCORE_X not in (None, "none", "independent", "structured"):
        raise ValueError(
            f"Z_SCORE_X={cfg.Z_SCORE_X!r} not supported: expected None, "
            "'none', 'independent', or 'structured'"
        )
    if cfg.LOG_RT_MANUALLY and cfg.SBI_LOG_TRANSFORM_X:
        raise ValueError(
            "LOG_RT_MANUALLY and SBI_LOG_TRANSFORM_X are mutually exclusive: "
            "both would log-transform the RT column twice."
        )
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "train_mnle(checkpoint_dir=...) is not ported to PyTorch yet (it needs "
            "utils/checkpoint.py; see ROADMAP.md, Queue 1)"
        )
    if device is None and isinstance(z_train, torch.Tensor):
        device = z_train.device
    device = resolve_device(device)
    z = torch.as_tensor(z_train, dtype=torch.float32).to(device)
    x = torch.as_tensor(x_train, dtype=torch.float32).to(device)
    n = x.shape[0]
    seed = as_seed(seed)

    observed_max = int(x[:, 1].max())
    if cfg.MNLE_NUM_CATEGORIES > 0:
        num_categories = cfg.MNLE_NUM_CATEGORIES
        if observed_max >= num_categories:
            raise ValueError(
                f"MNLE_NUM_CATEGORIES={num_categories} but training data contains category {observed_max}"
            )
    else:
        # Inferred from the data, floored at 3: {0, 1, censored}.
        num_categories = max(observed_max + 1, 3)
    theta_dim = getattr(proposal_z, "theta_dim", None)
    want_pulse_block = cfg.MNLE_EMBED_DIM > 0 or cfg.MNLE_EMBED_MODE == "append"
    pulse_dim = int(z.shape[1]) - int(theta_dim) if want_pulse_block and theta_dim is not None else 0
    if cfg.MNLE_RT_REP == "pulse":
        warnings.warn(
            "MNLE_RT_REP='pulse' is statistically UNCALIBRATED: all "
            "measured 96-dataset SBC runs failed rank uniformity "
            "(artifacts/calibration_pulseabs_*_96). Use the default "
            "rt_rep='log' (with MNLE_CENSOR_RT=True) for inference you "
            "intend to trust.",
            stacklevel=2,
        )
    mcfg = _mnle_config(cfg, int(z.shape[1]), num_categories, pulse_dim)
    if any(d >= z.shape[1] for d in mcfg.log_condition_dims):
        raise ValueError(
            f"MNLE_LOG_THETA_DIMS={mcfg.log_condition_dims} outside the "
            f"condition block (condition_dim={z.shape[1]})"
        )
    if mcfg.cond_affine and mcfg.rt_rep == "pulse":
        raise ValueError(
            "MNLE_COND_AFFINE has no effect with MNLE_RT_REP='pulse' (the "
            "slot/phase factorization has no continuous spline chain to "
            "precondition); disable one of the two"
        )
    mcfg.check_ported()
    if mcfg.rt_rep in ("pulse", "shifted_log"):
        theta_dim_stats = theta_dim if theta_dim is not None else 5
        if mcfg.tnd_index >= theta_dim_stats:
            raise ValueError(f"tnd_index={mcfg.tnd_index} outside theta block (theta_dim={theta_dim_stats})")

    cond_mean, cond_std, x_mean, x_std = _standardization_stats(mcfg, z, x)
    estimator = build_mnle(
        make_generator(child_seed(seed, 0), device), mcfg,
        cond_mean=cond_mean, cond_std=cond_std, x_mean=x_mean, x_std=x_std, device=device,
    )
    net = estimator.net

    n_val = max(int(n * cfg.TRAIN_VALIDATION_FRACTION), 1) if n > 10 else 0
    perm = torch.randperm(n, generator=make_generator(child_seed(seed, 1), device), device=device)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    n_tr = int(n - n_val)
    batch_size = min(int(cfg.TRAIN_BATCH_SIZE), n_tr)
    n_batches = max(n_tr // batch_size, 1)
    state = TrainState(net.parameters(), cfg.TRAIN_LEARNING_RATE, n_batches * cfg.TRAIN_MAX_EPOCHS)

    train_t0 = time.time()
    # PyTorch updates the weights in place, so the best ones are a copy.
    best_weights = copy.deepcopy(net.state_dict())
    best_val = np.inf
    epochs_since_best = 0
    epochs_run = 0
    step = 0
    step_seconds = 0.0
    train_losses, val_losses = [], []
    # The JAX net's products run at full float32 precision; keep TF32 off
    # here whatever the caller's global setting.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for epoch in range(cfg.TRAIN_MAX_EPOCHS):
            epochs_run = epoch + 1
            t0 = time.perf_counter()
            order = torch.randperm(n_tr, generator=make_generator(child_seed(seed, 100 + epoch), device),
                                   device=device)
            batches = tr_idx[order[: n_batches * batch_size]].reshape(n_batches, batch_size)
            losses = []
            for idx in batches:
                losses.append(train_step(estimator, state, x[idx], z[idx], step))
                step += 1
            tr_loss = float(torch.stack(losses).mean())
            step_seconds += time.perf_counter() - t0
            vl = _validation_loss(estimator, x, z, val_idx) if n_val > 0 else tr_loss
            train_losses.append(tr_loss)
            val_losses.append(vl)
            if vl < best_val - 1e-5:
                best_val = vl
                best_weights = copy.deepcopy(net.state_dict())
                epochs_since_best = 0
            else:
                epochs_since_best += 1
            if verbose and epoch % 10 == 0:
                print(f"[train_mnle] epoch {epoch}: train={tr_loss:.4f} val={vl:.4f}")
            if epochs_since_best >= cfg.TRAIN_STOP_AFTER_EPOCHS:
                if verbose:
                    print(f"[train_mnle] converged at epoch {epoch} (best val {best_val:.4f})")
                break
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    net.load_state_dict(best_weights)
    net.requires_grad_(False)
    estimator.train_meta = {
        "num_train": int(n),
        "epochs_run": int(epochs_run),
        "best_val_loss": float(best_val) if np.isfinite(best_val) else None,
        "train_wall_s": round(time.time() - train_t0, 1),
        "train_losses": train_losses,
        "val_losses": val_losses,
        "steps_per_epoch": int(n_batches),
        "step_ms": step_seconds * 1e3 / step if step else None,
    }
    return estimator


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------
def _model_dir() -> Path:
    return Path(os.environ.get("MODEL_DIR", Path.home() / "models"))


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of arrays -> ``['a']['b']['kernel']`` keyed leaves, in
    sorted order (what ``jax.tree_util.keystr`` gives each leaf's path)."""
    out = {}
    for name in sorted(tree):
        key = f"{prefix}['{name}']"
        if isinstance(tree[name], dict):
            out.update(_flatten(tree[name], key))
        else:
            out[key] = tree[name]
    return out


def save_model(estimator: MNLE, cfg: Optional[RunConfig] = None, filename: str = _DEFAULT_MODEL_FILENAME) -> Path:
    """Save the estimator's weights, stats and configs to
    ``$MODEL_DIR/filename`` (default ``~/models``; the directory is made),
    in the JAX ``save_model``'s ``.npz`` layout: the JAX ``load_model``
    reads it, and the same weights give the same ``param_fingerprint`` (the
    first 16 hex digits of the SHA-256 of the sorted parameter leaves'
    bytes)."""
    path = _model_dir() / filename
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = {"param:" + k: v for k, v in _flatten(mnle_to_flax_params(estimator)).items()}
    for name in _STATS:
        leaves[f"stat:{name}"] = getattr(estimator, name).detach().cpu().numpy()
    fp = hashlib.sha256()
    for name in sorted(k for k in leaves if k.startswith("param:")):
        fp.update(leaves[name].tobytes())
    meta = {
        "mnle_config": dataclasses.asdict(estimator.cfg),
        "run_config": dataclasses.asdict(cfg) if cfg is not None else None,
        "train_meta": estimator.train_meta,
        "param_fingerprint": fp.hexdigest()[:16],
    }
    np.savez(path, __meta__=json.dumps(meta), **leaves)
    print(f"[save_model] wrote {path}")
    return path


def _unflatten(data) -> dict:
    """``param:['a']['b']['kernel']`` leaves -> nested dicts of arrays."""
    tree: dict = {}
    for name in data.files:
        if not name.startswith("param:"):
            continue
        parts = _KEY_PART.findall(name[len("param:") :])
        if not parts:
            raise ValueError(f"unrecognized parameter key {name!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[name])
    return tree


def load_model(filename: str = _DEFAULT_MODEL_FILENAME, *, device=None) -> MNLE:
    """Load an estimator saved by either package's ``save_model`` from
    ``$MODEL_DIR/filename`` (default ``~/models``) onto ``device`` (default:
    the CUDA card; pass ``device="cpu"`` for the CPU)."""
    path = _model_dir() / filename
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        cfg = MNLEConfig(**meta["mnle_config"])
        params = _unflatten(data)
        stats = {k: np.asarray(data[f"stat:{k}"]) for k in _STATS}
    return mnle_from_flax_params(
        cfg, params, stats["cond_mean"], stats["cond_std"], stats["x_mean"], stats["x_std"],
        train_meta=meta.get("train_meta"), device=device,
    )


def run_inference_mcmc(
    cfg: RunConfig,
    prior_theta: Distribution,
    density_estimator: MNLE,
    x_o,
    pulses_o,
    device=None,
    *,
    seed: int = 0,
    verbose: bool = True,
    return_info: bool = False,
):
    """Posterior samples over theta given an observed session:
    (POSTERIOR_SAMPLES, theta_dim) on ``device`` (default: the estimator's).
    With ``return_info=True`` also the sampler's info dict (per-chain accept
    probabilities, tree sizes and divergences of every rung, step sizes,
    swap acceptance) with the cold chains' ``diagnostics`` (ESS, R-hat).

    The potential is log prior(theta) + sum_i log p(x_i | theta, s_i) / T,
    sampled in the unconstrained space of ``mcmc_transform(prior)`` by
    many-chain NUTS (with parallel tempering, the pulse-grid hop and the
    t_nd slice move as ``cfg`` selects).
    """
    device = torch.device(device) if device is not None else density_estimator.device
    density_estimator.to(device)
    x_o = torch.as_tensor(x_o, dtype=torch.float32).to(device)
    pulses_o = torch.as_tensor(pulses_o, dtype=torch.float32).to(device)
    likelihood = ConditionedMNLELogLikelihood(
        density_estimator, pulses_o, logprob_kernel=cfg.MNLE_LOGPROB_KERNEL
    )
    potential = ThetaOnlyPosteriorPotential(
        prior=prior_theta, likelihood=likelihood, x_o=x_o, temperature=cfg.TEMPERATURE
    )
    bij = mcmc_transform(prior_theta)
    mode_hop = None
    if cfg.MCMC_GRID_HOP:
        from .constants import PULSE_INTERVAL

        # t_nd (theta[4]) is identifiable only up to pulse-grid aliasing.
        mode_hop = make_grid_hop(bij, index=4, delta=PULSE_INTERVAL)
    if cfg.MCMC_TAU_SLICE:
        # Within-basin t_nd mixer; hop first (cross-mode), then slice.
        mode_hop = compose_moves(mode_hop, make_dim_slice(4, width=cfg.MCMC_TAU_SLICE_WIDTH))
    posterior = MCMCPosterior(
        potential_fn=potential,
        proposal=prior_theta,
        theta_transform=bij,
        method=cfg.MCMC_METHOD,
        num_chains=cfg.NUM_CHAINS,
        warmup_steps=cfg.WARMUP_STEPS,
        thin=cfg.MCMC_THIN,
        max_tree_depth=cfg.MCMC_MAX_TREE_DEPTH,
        target_accept=cfg.MCMC_TARGET_ACCEPT,
        verbose=verbose,
        mode_hop=mode_hop,
        auto_fallback=cfg.MCMC_AUTO_FALLBACK,
        pt_replicas=cfg.MCMC_PT_REPLICAS,
        pt_beta_min=cfg.MCMC_PT_BETA_MIN,
        pt_swap_every=cfg.MCMC_PT_SWAP_EVERY,
        device=device,
    )
    samples = posterior.sample((cfg.POSTERIOR_SAMPLES,), x=x_o, seed=seed)
    if return_info:
        return samples, dict(posterior.last_info, diagnostics=posterior._last_diagnostics)
    return samples
