"""MNLE training, persistence and MCMC inference (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/mnle.py``. Ported:
``train_mnle`` (Adam under global-norm clipping with a cosine schedule,
index-only validation split, early stopping on the validation loss),
``save_model`` and ``load_model`` (the JAX ``.npz`` layout:
``param:<keystr>`` leaves, ``stat:*`` arrays and the ``__meta__`` JSON,
written and read with numpy alone, so a model saved by either package loads
in the other), ``run_inference_mcmc`` and simulation-based calibration
(``run_sbc``: datasets folded into the chain axis, the mixing gate and its
escalating remediation, atomic partials, and the sampler's segment
checkpoints under ``nuts_ckpt/``, from which a cut run resumes), for the
log, shifted-log and pulse-grid RT representations (with the left-tail
sharpening and the pulse embedding). Training differentiates the plain
``MNLE.log_prob_fn`` with autograd: the fused kernels K2/K3 return input
gradients only and serve inference; it checkpoints and resumes with
``checkpoint_dir``. ``MNLEEnsemble`` / ``load_ensemble``: a uniform mixture of
saved estimators, served by the same potentials, samplers and SBC.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import time
import warnings
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .distributions import Distribution, mcmc_transform
from .inference.mcmc import MCMCPosterior, compose_moves, make_dim_slice, make_grid_hop
from .inference.nuts import ReplicaExchange, geometric_ladder, run_nuts
from .inference.slice import run_slice
from .models.rt_choice_model import (
    generate_pulse_matrix,
    n_pulses_max_from_schedule,
    pack_x_rt_choice,
    pulse_schedule,
    rt_choice_model_simulator_torch,
    simulate_session_data_rt_choice,
)
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
from .potentials import (
    ConditionedMNLELogLikelihood,
    ThetaOnlyPosteriorPotential,
    mixture_log_prob,
    tempered_value_and_grad,
)
from .run_config import RunConfig
from .utils import metrics
from .utils.checkpoint import restore_train_state, save_train_state
from .utils.device import resolve_device
from .utils.rng import as_seed, child_seed, make_generator

__all__ = [
    "train_mnle", "train_step", "TrainState", "save_model", "load_model", "build_mnle", "run_inference_mcmc", "run_sbc",
    "MNLEEnsemble", "load_ensemble",
]

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
    span = metrics.begin("train.step") if metrics.RECORDING else -1
    state.adam.zero_grad(set_to_none=True)
    phase = metrics.begin("train.forward") if metrics.RECORDING else -1
    loss = -estimator.log_prob_fn(estimator.net, xb, zb).mean()
    if phase >= 0:
        metrics.end(phase)
    phase = metrics.begin("train.backward") if metrics.RECORDING else -1
    loss.backward()
    if phase >= 0:
        metrics.end(phase)
    phase = metrics.begin("train.optimizer") if metrics.RECORDING else -1
    state.apply(step)
    if phase >= 0:
        metrics.end(phase)
    if span >= 0:
        metrics.end(span)
    return loss.detach()


def _validation_loss(estimator: MNLE, x, z, idx) -> float:
    """-mean(log p) over the rows ``idx``, gathered in chunks to bound memory."""
    span = metrics.begin("train.validation") if metrics.RECORDING else -1
    total = x.new_zeros(())
    with torch.no_grad():
        for rows in idx.split(_VALIDATION_CHUNK):
            total = total + estimator.log_prob_fn(estimator.net, x[rows], z[rows]).sum()
    out = float(-total / idx.numel())
    if span >= 0:
        metrics.end(span)
    return out


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


def _flow_coordinate(mcfg: MNLEConfig, z, x):
    """The flow's own coordinate of the pairs, before z-scoring (per
    ``rt_rep``)."""
    rt = x[:, 0]
    if mcfg.rt_rep == "pulse":
        return pulse_grid_split(mcfg, rt, z[:, mcfg.tnd_index])[2]
    if mcfg.rt_rep == "shifted_log":
        return shifted_rt_transform(mcfg, rt, z)[0]
    return torch.log(rt.clamp(min=1e-37)) if mcfg.log_transform_x else rt


def _standardization_stats(mcfg: MNLEConfig, z, x):
    """(cond_mean, cond_std, x_mean, x_std): "independent" z-scoring stats of
    the transformed condition and of the flow's own coordinate (per
    ``rt_rep``; over the rows that are not censored when ``censor_rt``).
    Population standard deviations, floored at 1e-6."""
    z_cond = transform_condition(mcfg, z)
    cond_mean = z_cond.mean(0)
    cond_std = z_cond.std(0, unbiased=False).clamp(min=1e-6)
    t = _flow_coordinate(mcfg, z, x)
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


def _auto_tail_sharp_c(mcfg: MNLEConfig, z, x, x_mean, x_std) -> float:
    """The tail sharpening's automatic threshold (``MNLE_TAIL_SHARP_C=None``):
    c = (q - x_mean) / x_std - 0.25, q the 0.001 quantile of the flow
    coordinate over the rows that are not censored, so the suppression
    starts just below the training data's left edge in standardized units.
    Computed as the JAX package does, by ``np.quantile`` (linear
    interpolation) on one host copy: ``torch.quantile`` refuses inputs above
    2^24 elements."""
    t_np = _flow_coordinate(mcfg, z, x).cpu().numpy()
    if mcfg.censor_rt:
        t_np = t_np[x[:, 1].cpu().numpy() != mcfg.censored_category]
    return float((np.quantile(t_np, 1e-3) - float(x_mean)) / float(x_std) - 0.25)


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
    read-back included, validation excluded), each of the epochs this call
    ran.

    ``MNLE_TAIL_SHARP_C=None`` (with ``MNLE_TAIL_SHARP_K > 0``) resolves the
    threshold from the training data (``_auto_tail_sharp_c``); the estimator's
    config, and so the saved one, holds the resolved value.

    ``checkpoint_dir``: the weights, Adam's state and the optimizer step are
    saved there every ``checkpoint_every`` epochs (``utils/checkpoint.py``),
    and a call with the same config and directory resumes after the newest
    checkpoint, as the JAX package does: at the learning rate and on the
    batches an uninterrupted run has there, with the best weights and the
    patience count starting afresh from the restored weights. A checkpoint
    written under another config raises ``ValueError``.
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
    if device is None and isinstance(z_train, torch.Tensor):
        device = z_train.device
    device = resolve_device(device)
    z = torch.as_tensor(z_train, dtype=torch.float32).to(device)
    x = torch.as_tensor(x_train, dtype=torch.float32).to(device)
    n = x.shape[0]
    seed = as_seed(seed)
    if metrics.RECORDING:
        metrics.new_run()

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
    mcfg.validate()
    if mcfg.rt_rep in ("pulse", "shifted_log"):
        theta_dim_stats = theta_dim if theta_dim is not None else 5
        if mcfg.tnd_index >= theta_dim_stats:
            raise ValueError(f"tnd_index={mcfg.tnd_index} outside theta block (theta_dim={theta_dim_stats})")

    cond_mean, cond_std, x_mean, x_std = _standardization_stats(mcfg, z, x)
    if mcfg.tail_sharp_k > 0 and mcfg.tail_sharp_c is None:
        mcfg = dataclasses.replace(mcfg, tail_sharp_c=_auto_tail_sharp_c(mcfg, z, x, x_mean, x_std))
        if verbose:
            print(f"[train_mnle] tail_sharp_c auto -> {mcfg.tail_sharp_c:.3f} "
                  f"(q0.001 of standardized training t - 0.25)")
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
    start_epoch = step = 0
    if checkpoint_dir is not None:
        restored = restore_train_state(checkpoint_dir, {"params": net.state_dict()}, cfg=cfg)
        if restored is not None:
            net.load_state_dict(restored["params"])
            state.adam.load_state_dict(restored["opt_state"]["adam"])
            step = int(restored["opt_state"]["step"])
            start_epoch = int(restored["meta"]["step"]) + 1
            if verbose:
                print(f"[train_mnle] resumed from epoch {start_epoch - 1}")
    # PyTorch updates the weights in place, so the best ones are a copy.
    best_weights = copy.deepcopy(net.state_dict())
    best_val = np.inf
    epochs_since_best = 0
    epochs_run = 0
    step_seconds = 0.0
    train_losses, val_losses = [], []
    # The JAX net's products run at full float32 precision; keep TF32 off
    # here whatever the caller's global setting.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for epoch in range(start_epoch, cfg.TRAIN_MAX_EPOCHS):
            epochs_run += 1
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
            if checkpoint_dir is not None and (epoch + 1) % checkpoint_every == 0:
                save_train_state(checkpoint_dir, epoch, net.state_dict(),
                                 {"adam": state.adam.state_dict(), "step": step}, seed, cfg=cfg)
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
        "step_ms": step_seconds * 1e3 / (epochs_run * n_batches) if epochs_run else None,
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


class MNLEEnsemble:
    """Uniform mixture of K independently trained MNLEs: log p(x | c) =
    logsumexp_k log p_k(x | c) - log K, row by row.

    The surface the potentials, samplers and SBC read from an ``MNLE``
    (``dispatch_log_prob``, ``log_prob_fn``, ``params``, ``sample_fn``,
    ``cfg``, ``train_meta``, ``device``, ``to``); each member keeps its own
    standardization stats. ``params`` is one tuple of the members'
    networks, made once, so the fused path's stale-weights guard (``params
    is not est.params``) holds for ensembles too."""

    def __init__(self, members):
        members = tuple(members)
        if not members:
            raise ValueError("MNLEEnsemble needs at least one member")
        c0 = members[0].cfg
        for m in members[1:]:
            if m.cfg != c0:
                raise ValueError(f"ensemble members must share one MNLEConfig (got {m.cfg} vs {c0})")
        self.members = members
        self.params = tuple(m.params for m in members)
        self.cfg = c0
        metas = [m.train_meta or {} for m in members]
        self.train_meta = {
            "ensemble_size": len(members),
            "num_train": sum(t.get("num_train") or 0 for t in metas) or None,
            "num_train_per_member": [t.get("num_train") for t in metas],
            "best_val_loss": [t.get("best_val_loss") for t in metas],
        }

    def __len__(self) -> int:
        return len(self.members)

    @property
    def device(self) -> torch.device:
        return self.members[0].device

    def to(self, device) -> "MNLEEnsemble":
        """Move every member to ``device`` (in place)."""
        for m in self.members:
            m.to(device)
        return self

    def log_prob_fn(self, params, x, condition):
        lps = torch.stack([m.log_prob_fn(p, x, condition) for m, p in zip(self.members, params)])
        return torch.logsumexp(lps, dim=0) - math.log(len(self.members))

    def log_prob(self, x, condition):
        return self.log_prob_fn(self.params, x, condition)

    def dispatch_log_prob(self, kernel: str = "auto"):
        """The mixture of the members' ``dispatch_log_prob(kernel)``."""
        return mixture_log_prob([m.dispatch_log_prob(kernel) for m in self.members])

    def sample_fn(self, params, generator, condition):
        """Mixture draw: a member picked uniformly per condition row, then
        that member's draw. ``generator`` (or a seed for one) draws the
        picks, then each member's draws in turn."""
        gen = generator if isinstance(generator, torch.Generator) else make_generator(generator, condition.device)
        flat = condition.reshape(-1, condition.shape[-1])
        pick = torch.randint(len(self.members), (flat.shape[0],), generator=gen, device=flat.device)
        draws = torch.stack([m.sample_fn(p, gen, flat) for m, p in zip(self.members, params)])  # (K, rows, 2)
        out = torch.gather(draws, 0, pick[None, :, None].expand(1, flat.shape[0], 2))[0]
        return out.reshape(*condition.shape[:-1], 2)

    def sample(self, generator, condition):
        condition = torch.as_tensor(condition, dtype=torch.float32).to(self.device)
        return self.sample_fn(self.params, generator, condition)


def load_ensemble(filenames, *, device=None) -> MNLEEnsemble:
    """An ``MNLEEnsemble`` of saved members (a list of ``save_model``
    filenames under ``$MODEL_DIR``, or one comma-separated string of them),
    each loaded by ``load_model`` onto ``device`` (default: the CUDA card)."""
    if isinstance(filenames, str):
        filenames = [f for f in filenames.split(",") if f]
    return MNLEEnsemble([load_model(f, device=device) for f in filenames])


def _mode_hop(cfg: RunConfig, bij):
    """The extra move after every transition that ``cfg`` selects: the
    pulse-grid hop of t_nd (theta[4], identifiable only up to pulse-grid
    aliasing), then the within-basin t_nd slice; None for neither."""
    mode_hop = None
    if cfg.MCMC_GRID_HOP:
        from .constants import PULSE_INTERVAL

        mode_hop = make_grid_hop(bij, index=4, delta=PULSE_INTERVAL)
    if cfg.MCMC_TAU_SLICE:
        # Hop first (cross-mode), then slice.
        mode_hop = compose_moves(mode_hop, make_dim_slice(4, width=cfg.MCMC_TAU_SLICE_WIDTH))
    return mode_hop


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
    swap acceptance) with the cold chains' ``diagnostics`` (ESS, R-hat;
    None unless ``verbose``, as in the JAX package).

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
        mode_hop=_mode_hop(cfg, bij),
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


# ---------------------------------------------------------------------------
# Simulation-based calibration
# ---------------------------------------------------------------------------
def _compute_ranks(samples: np.ndarray, theta_true: np.ndarray) -> np.ndarray:
    """Per-dimension rank of theta_true among posterior samples."""
    return (np.asarray(samples) < np.asarray(theta_true).reshape(1, -1)).sum(axis=0)


def _plot_sbc_rank_histograms(ranks: np.ndarray, num_samples: int, outdir: Path, param_names=None):
    """Per-parameter rank histograms (``sbc_rank_histograms.png``) and the
    ECDF-difference companion (``sbc_ecdf.png``). Returns the histograms'
    path, or None where matplotlib does not import (each plot then prints
    one line naming the file it did not write)."""
    from .analysis import _pyplot, sbc_ecdf_plot

    ranks = np.asarray(ranks)
    d = ranks.shape[1]
    if param_names is None:
        param_names = [f"theta_{i}" for i in range(d)]
    path = Path(outdir) / "sbc_rank_histograms.png"
    plt = _pyplot(path, "run_sbc")
    if plt is not None:
        fig, axes = plt.subplots(1, d, figsize=(3 * d, 3))
        if d == 1:
            axes = [axes]
        n_bins = min(20, max(ranks.shape[0] // 2, 5))
        expected = ranks.shape[0] / n_bins
        for i, ax in enumerate(axes):
            ax.hist(ranks[:, i], bins=n_bins, range=(0, num_samples), color="#4477aa")
            ax.axhline(expected, color="k", ls="--", lw=1)
            ax.set_title(param_names[i])
            ax.set_xlabel("rank")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        print(f"[run_sbc] wrote {path}")
    # High-power companion diagnostic: histograms hide small systematic bias.
    sbc_ecdf_plot(ranks, num_samples, Path(outdir) / "sbc_ecdf.png", param_names)
    return path if plt is not None else None


def _pooled(cold: np.ndarray, post_samples: int) -> np.ndarray:
    """Cold draws (..., C, S, dim) -> chains interleaved (..., C*S, dim) ->
    the first ``post_samples``: draw k of chain c is row k*C + c."""
    C, S, dim = cold.shape[-3:]
    return cold.swapaxes(-3, -2).reshape(*cold.shape[:-3], C * S, dim)[..., :post_samples, :]


def _min_rt_tau_init(init_theta: torch.Tensor, x_g: torch.Tensor, reps: int, log_rt: bool,
                     generator: torch.Generator) -> torch.Tensor:
    """``init_theta`` (Gl*reps, 5) with its t_nd column replaced by
    clip(u * min_rt, 1e-3, 0.98), u ~ U(0.05, 0.95) and min_rt the smallest
    RT of the row's session in ``x_g`` (Gl, T, 2) (exp'd first under
    ``log_rt``). t_nd < min(rt) by construction (rt = t_nd + hit_step * dt),
    so hard-onset posteriors sit just below min(rt), and prior draws often
    start chains in a far basin. Where the chains start does not change the
    stationary distribution."""
    rt = x_g[..., 0]
    if log_rt:
        rt = torch.exp(rt)
    min_rt = rt.min(-1).values.repeat_interleave(reps)
    u01 = 0.05 + 0.9 * torch.rand(min_rt.shape, generator=generator, device=min_rt.device)
    out = init_theta.clone()
    out[:, 4] = torch.clamp(u01 * min_rt, 1e-3, 0.98)
    return out


def _fold_density(cfg: RunConfig, prior_theta: Distribution, bij, est: MNLE, x_g, s_g):
    """The density of the SBC fold, whose chain rows carry ``data`` =
    (sessions (N,), beta (N,)): each row's dataset among the group's
    sessions ``x_g`` (Gl, T, 2), ``s_g`` (Gl, T, P), and its inverse
    temperature. Returns ``(logp, ll, vg)``: ``logp(u, data)`` = log
    prior(theta) + log_det(u) + beta * ll(u, data) and ``ll(u, data)`` the
    untempered summed log-likelihood / ``cfg.TEMPERATURE`` (what beta
    multiplies, for the replica exchange), theta = bij.forward(u); ``vg(u,
    data, need_grad=True)`` the same density with its gradient in closed
    form (one K3/K3p launch a gradient call, one K2/K2p a value-only call),
    or None where the likelihood has no closed form (the sampler then
    differentiates ``logp`` by autograd). The theta-free session terms are
    made once, for the group's Gl sessions."""
    temperature = float(cfg.TEMPERATURE)
    lik = ConditionedMNLELogLikelihood(est, s_g, logprob_kernel=cfg.MNLE_LOGPROB_KERNEL)

    def ll(u, data):
        theta = bij.forward(u)
        if lik.closed_form_grad:
            return lik.log_lik_and_grad(x_g, theta, False, sessions=data[0])[0] / temperature
        return lik.log_lik_fn(est.params, x_g, theta, sessions=data[0]) / temperature

    def logp(u, data):
        theta = bij.forward(u)
        return prior_theta.log_prob(theta) + bij.forward_log_det(u) + data[1] * ll(u, data)

    if not (lik.closed_form_grad and getattr(prior_theta, "has_closed_form_grad", lambda: False)()):
        return logp, ll, None
    vg_t = tempered_value_and_grad(prior_theta, bij, lik, temperature)

    def vg(u, data, need_grad: bool = True):
        return vg_t(u, x_g, data[1], need_grad, sessions=data[0])

    return logp, ll, vg


def _sbc_launch(cfg: RunConfig, prior_theta: Distribution, est: MNLE, x_g, s_g, seed_init: int, seed_run: int,
                warmup: int, ladder, per_chain: int, mode_hop, tau_init: bool = False,
                checkpoint_dir: Optional[str] = None, mesh=None) -> tuple:
    """One sampler launch over the Gl sessions (x_g, s_g) x C chains x R
    replicas, the rows dataset-major, then chain, then replica (cold rung
    first), the chains started from prior draws of ``seed_init`` (with
    ``tau_init`` the t_nd column from ``_min_rt_tau_init``); NUTS keeps its
    segment checkpoints in ``checkpoint_dir`` (the slice sampler has none).
    With ``mesh`` the rows are split over its (first) axis
    (``parallel.mesh.sharded_run_nuts``; padded by whole replica groups, by
    wrap-around, so that every rank holds whole groups, the padding dropped
    after) and every rank returns the whole launch's results.
    Returns (cold draws (Gl, C, per_chain, dim) as numpy, per-dataset cold
    divergence counts or None, mean accept, total divergences or None, swap
    acceptance or None, batched potential calls)."""
    device = x_g.device
    C = cfg.NUM_CHAINS
    R = len(ladder)
    Gl = x_g.shape[0]
    bij = mcmc_transform(prior_theta)
    init_theta = prior_theta.sample(make_generator(seed_init, device), (Gl * C * R,)).to(torch.float32)
    if tau_init and init_theta.shape[-1] == 5:
        init_theta = _min_rt_tau_init(init_theta, x_g, C * R, cfg.LOG_RT_MANUALLY,
                                      make_generator(child_seed(seed_init, 1), device))
    init_u = bij.inverse(init_theta)
    sessions = torch.arange(Gl, device=device).repeat_interleave(C * R)
    betas = torch.as_tensor(np.asarray(ladder, np.float32), device=device).repeat(Gl * C)
    data = (sessions, betas)
    logp, ll, vg = _fold_density(cfg, prior_theta, bij, est, x_g, s_g)
    if mesh is not None:
        from .parallel.mesh import _sharded_run, sharded_run_nuts

        axis = mesh.mesh_dim_names[0]
        slice_fn = partial(_sharded_run, run_slice, mesh=mesh, axis_name=axis)
        nuts_fn = partial(sharded_run_nuts, mesh=mesh, axis_name=axis)
    else:
        slice_fn, nuts_fn = run_slice, run_nuts
    if cfg.MCMC_METHOD in ("slice", "slice_np_vectorized"):
        samples_u, info = slice_fn(seed_run, logp, init_u, num_warmup=warmup, num_samples=per_chain,
                                   thin=cfg.MCMC_THIN, data=data, mode_hop=mode_hop, value_and_grad_fn=vg)
    else:
        exchange = None
        if R > 1:
            exchange = ReplicaExchange(n_replicas=R, betas=betas, ll_fn=ll, swap_every=cfg.MCMC_PT_SWAP_EVERY)
        samples_u, info = nuts_fn(
            seed_run, logp, init_u, num_warmup=warmup, num_samples=per_chain,
            max_depth=cfg.MCMC_MAX_TREE_DEPTH, target_accept=cfg.MCMC_TARGET_ACCEPT, thin=cfg.MCMC_THIN,
            data=data, mode_hop=mode_hop, exchange=exchange, value_and_grad_fn=vg, checkpoint_dir=checkpoint_dir,
        )
    theta_s = bij.forward(samples_u)  # (Gl*C*R, S, dim)
    # Keep only the cold (beta = 1) rung of each replica group.
    theta_cold = theta_s.reshape(Gl, C, R, per_chain, -1)[:, :, 0].cpu().numpy()
    # Per-dataset divergence counts over the cold chains (NUTS only): a
    # pooled count hides which datasets pile mass against a wall.
    div_cold, div_total = None, None
    if "diverging" in info:
        div = info["diverging"]
        div_cold = div.reshape(Gl, C, R, -1)[:, :, 0].sum((1, 2)).cpu().numpy()
        div_total = int(div.sum())
    return (theta_cold, div_cold, float(info["accept_prob"].mean()), div_total, info.get("swap_accept"),
            info["potential_calls"])


def _run_sbc_batched(
    cfg: RunConfig,
    prior_theta: Distribution,
    density_estimator: MNLE,
    num_datasets: int,
    post_samples: int,
    outdir: Path,
    seed: int,
    verbose: bool,
    device: torch.device,
    group_size: int = 8,
    mesh=None,
) -> dict:
    """Every SBC dataset x chain x replica folded into the chain axis of one
    sampler run, ``group_size`` datasets at a time.

    One simulator call (K1) makes every session. Each group's datasets x
    chains x replicas run as one batch of chains whose rows each carry their
    dataset's session (``data`` = (session index, beta)), so every potential
    call is one launch over all of the group's rows: K3 (K3p) for a
    gradient, K2 (K2p) for a value. The final group is padded by
    wrap-around, and the padded rows enter no statistic.

    Random streams: ``child_seed(seed, tag)`` with the JAX package's
    ``fold_in`` tags: 0 theta_true, 1 the stimuli, 2 the simulator's noise,
    300 + g and 400 + g group g's starts and sampler, 7000 + 131 rnd + rg
    and 7100 + 131 rnd + rg remediation round rnd's group rg. The streams
    differ from JAX's, so results agree in distribution only.

    Resume: each NUTS launch keeps its segment checkpoints in
    ``outdir/nuts_ckpt/group_{g}`` (remediation: ``remed_{rnd}_{rg}``), under
    ``nuts_ckpt/run_id.txt``, a hash of the seed and (D, C, WARMUP_STEPS,
    draws a chain, T, R); a ``nuts_ckpt/`` of another run id is removed
    first. So the same call again, in the same ``outdir``, replays the
    finished groups from their checkpoints without a potential call and
    resumes a cut group at its last segment, to the same ranks.

    With ``mesh`` (``parallel.mesh.default_mesh``; every rank calls with the
    same arguments) each launch's rows are split over the mesh's ranks
    (``_sbc_launch``) and gathered before the mixing gate, the ranks and the
    files, so every rank takes the same decisions and returns the same
    result. Each rank simulates every session (K1, the same bits). The run id
    includes the number of ranks; rank 0 alone clears another run's
    ``nuts_ckpt/`` (the ranks wait for it), each rank keeps its segments in
    ``<group>/rank_{r}``, and rank 0 alone prints and writes ``outdir``'s
    files.
    """
    from .analysis import sbc_uniformity_stats
    from .inference.diagnostics import effective_sample_size, split_r_hat

    D, C, T = num_datasets, cfg.NUM_CHAINS, cfg.NUM_TRIALS_OBS
    est = density_estimator
    bij = mcmc_transform(prior_theta)

    theta_true = prior_theta.sample(make_generator(child_seed(seed, 0), device), (D,))
    n_max, spp = pulse_schedule()
    P = n_pulses_max_from_schedule(n_max, spp)
    pulses = generate_pulse_matrix(make_generator(child_seed(seed, 1), device), D * T, P, p_success=cfg.P_SUCCESS)
    x = rt_choice_model_simulator_torch(
        theta_true.repeat_interleave(T, dim=0), rng=child_seed(seed, 2), mu_sensory=cfg.MU_SENSORY,
        pulse_sides=pulses,
    )
    x = pack_x_rt_choice(x, log_rt=cfg.LOG_RT_MANUALLY)
    x_d = x.reshape(D, T, 2)
    s_d = pulses.reshape(D, T, P)

    mode_hop = _mode_hop(cfg, bij)
    # Parallel tempering: R replicas per (dataset, chain), contiguous, cold
    # rung first; beta rides in ``data``, so one potential call serves every
    # rung.
    R = max(int(cfg.MCMC_PT_REPLICAS), 1)
    if R > 1 and cfg.MCMC_METHOD in ("slice", "slice_np_vectorized"):
        raise ValueError(
            "MCMC_PT_REPLICAS > 1 requires the NUTS sampler "
            "(parallel tempering is not wired into run_slice)"
        )
    ladder = geometric_ladder(R, cfg.MCMC_PT_BETA_MIN)

    per_chain = math.ceil(post_samples / C)
    G = min(group_size, D)  # datasets per launch
    n_groups = math.ceil(D / G)
    pooled_groups, swap_accepts = [], []
    rhat_per_ds, ess_per_ds, div_per_ds = [], [], []
    calls = [0]

    # Crash-resume guard: segment checkpoints are only valid for the same
    # (seed, workload shape, number of ranks); clear any stale ones from a
    # different run.
    from .parallel.comm import barrier, rank, world_size

    n_ranks = world_size() if mesh is not None else 1
    writer = mesh is None or rank() == 0  # the rank that clears, prints and writes
    verbose = verbose and writer
    run_id = hashlib.sha256(
        np.asarray(seed, np.int64).tobytes() + f"{D}/{C}/{cfg.WARMUP_STEPS}/{per_chain}/{T}/R={R}".encode()
        + (f"/ranks={n_ranks}".encode() if mesh is not None else b"")
    ).hexdigest()[:16]
    ckpt_root = outdir / "nuts_ckpt"
    run_id_file = ckpt_root / "run_id.txt"
    if writer:
        if ckpt_root.exists() and (not run_id_file.exists() or run_id_file.read_text() != run_id):
            shutil.rmtree(ckpt_root)
        ckpt_root.mkdir(parents=True, exist_ok=True)
        run_id_file.write_text(run_id)
        # Stale partials from a previous run in the same outdir would read as a
        # snapshot of this run until the first group lands.
        for stale in ("sbc_ranks.partial.npy", "partial_summary.json"):
            (outdir / stale).unlink(missing_ok=True)
    if mesh is not None:
        barrier()
    if verbose:
        print(f"[run_sbc] batched: {n_groups} groups of {G} datasets x {C} chains, {per_chain} draws/chain",
              flush=True)

    def _mixing_stats(cold_gi):
        """(split-R-hat max, min-ESS) over one dataset's cold chains."""
        if C >= 2 and per_chain >= 10:
            return float(np.max(split_r_hat(cold_gi))), float(np.min(effective_sample_size(cold_gi)))
        return float("nan"), float("nan")

    def _launch(idx, seed_init, seed_run, warmup, ladder_arr, ckpt_name, tau_init=False):
        rows = torch.as_tensor(np.asarray(idx), device=device)
        *out, n_calls = _sbc_launch(cfg, prior_theta, est, x_d[rows], s_d[rows], seed_init, seed_run, warmup,
                                    ladder_arr, per_chain, mode_hop, tau_init=tau_init,
                                    checkpoint_dir=str(ckpt_root / ckpt_name), mesh=mesh)
        calls[0] += n_calls
        return out

    tt_np = theta_true.cpu().numpy()
    for g in range(n_groups):
        lo = g * G
        idx = (np.arange(G) + lo) % D  # pad the final group by wrap-around
        cold_np, div_cold, acc, div_total, swap = _launch(
            idx, child_seed(seed, 300 + g), child_seed(seed, 400 + g), cfg.WARMUP_STEPS, ladder, f"group_{g}")
        pooled_groups.append(_pooled(cold_np, post_samples))
        # Per-dataset mixing diagnostics over the cold chains: pooled ranks
        # from unmixed chains bias every uniformity number.
        for gi in range(G):
            if lo + gi >= D:
                break  # wrap-around padding of the final group
            div_per_ds.append(float(div_cold[gi]) if div_cold is not None else float("nan"))
            r_, e_ = _mixing_stats(cold_np[gi])
            rhat_per_ds.append(r_)
            ess_per_ds.append(e_)
        swap_accepts.append(swap)
        if verbose:
            # Only statistics the sampler produced: slice has no divergences.
            div_str = "n/a" if div_total is None else str(div_total)
            sw_str = f" swap_accept={swap:.3f}" if swap is not None else ""
            print(f"[run_sbc] group {g + 1}/{n_groups}: {G} datasets x {C} chains"
                  f"{' x ' + str(R) + ' replicas' if R > 1 else ''} "
                  f"mean_accept={acc:.3f} divergences={div_str}{sw_str}", flush=True)
        # Partial results after every group, so a run cut short leaves a
        # readable uniformity readout over the datasets it finished.
        done = min((g + 1) * G, D)
        if not writer:
            continue
        part_ranks = (np.concatenate(pooled_groups, axis=0)[:done] < tt_np[:done, None, :]).sum(axis=1)
        partial = {
            "datasets_done": int(done),
            "datasets_total": int(D),
            "rhat_max_per_dataset": [float(v) for v in rhat_per_ds[:done]],
            "min_ess_per_dataset": [float(v) for v in ess_per_ds[:done]],
            "divergences_per_dataset": [float(v) for v in div_per_ds[:done]],
        }
        if done >= 8:  # uniformity tests are meaningless below ~8 datasets
            try:
                stats = sbc_uniformity_stats(part_ranks, post_samples)
                partial.update(ks_pvalues=stats["ks_pvalues"], chi2_pvalues=stats["chi2_pvalues"])
            except Exception:  # scipy quirks must not kill the run
                pass
        # Atomic: a crash mid-write never leaves a truncated snapshot.
        tmp_npy = outdir / "sbc_ranks.partial.tmp.npy"
        np.save(tmp_npy, part_ranks)
        os.replace(tmp_npy, outdir / "sbc_ranks.partial.npy")
        tmp_js = outdir / "partial_summary.json.tmp"
        tmp_js.write_text(json.dumps(partial, indent=2))
        os.replace(tmp_js, outdir / "partial_summary.json")

    samples_np = np.concatenate(pooled_groups, axis=0)[:D]
    rhat_np = np.asarray(rhat_per_ds[:D], dtype=float)
    ess_np = np.asarray(ess_per_ds[:D], dtype=float)
    div_np = np.asarray(div_per_ds[:D], dtype=float)

    # Mixing gate and remediation: rather than pool ranks from unmixed
    # chains, re-run the flagged datasets with a longer warmup and a hotter
    # ladder, substitute their draws unconditionally (the remediated run
    # strictly dominates, so this is no pick between runs) and record the
    # diagnostics before and after.
    def _flagged_idx():
        return np.where(
            (~np.isfinite(rhat_np)) | (rhat_np > cfg.SBC_RHAT_GATE) | (ess_np < cfg.SBC_MIN_ESS_GATE)
        )[0]

    gate_active = C >= 2 and per_chain >= 10
    remediation = None
    flagged0 = _flagged_idx() if gate_active else np.asarray([], dtype=int)
    if cfg.SBC_REMEDIATE and flagged0.size:
        todo0 = flagged0[: int(cfg.SBC_REMEDIATE_MAX)]
        rhat_before = rhat_np[todo0].tolist()
        rounds = []
        warm1, beta1 = None, None
        todo = todo0
        for rnd in range(1, max(int(cfg.SBC_REMEDIATE_ROUNDS), 1) + 1):
            if rnd > 1:
                # Escalate only the datasets the previous round left dirty.
                todo = np.intersect1d(_flagged_idx(), todo0)
                if todo.size == 0:
                    break
            warm2 = 2 * rnd * cfg.WARMUP_STEPS
            beta2 = cfg.MCMC_PT_BETA_MIN / (2.0**rnd) if R > 1 else None
            hot = geometric_ladder(R, beta2) if R > 1 else ladder
            if rnd == 1:
                warm1, beta1 = warm2, beta2
            if verbose:
                print(f"[run_sbc] mixing gate round {rnd}: {todo.size}/{D} datasets flagged (R-hat > "
                      f"{cfg.SBC_RHAT_GATE} or min-ESS < {cfg.SBC_MIN_ESS_GATE}); remediating with warmup {warm2}"
                      + (f", beta_min {beta2}" if beta2 is not None else ""), flush=True)
            for rg in range(math.ceil(todo.size / G)):
                sub = todo[rg * G : (rg + 1) * G]
                cold_np, div_cold, acc, div_total, swap = _launch(
                    np.resize(sub, G),  # pad by wrap-around within sub
                    child_seed(seed, 7000 + 131 * rnd + rg), child_seed(seed, 7100 + 131 * rnd + rg),
                    warm2, hot, f"remed_{rnd}_{rg}", tau_init=cfg.SBC_REMEDIATE_TAU_INIT,
                )
                for gi, ds in enumerate(sub.tolist()):
                    samples_np[ds] = _pooled(cold_np[gi], post_samples)
                    rhat_np[ds], ess_np[ds] = _mixing_stats(cold_np[gi])
                    if div_cold is not None:
                        div_np[ds] = float(div_cold[gi])
                if swap is not None:
                    swap_accepts.append(swap)
                if verbose:
                    print(f"[run_sbc] remediation round {rnd} group {rg + 1}: datasets {sub.tolist()} "
                          f"mean_accept={acc:.3f}", flush=True)
            rounds.append({
                "round": rnd,
                "warmup": int(warm2),
                "beta_min": beta2,
                "datasets": [int(v) for v in todo],
                "rhat_after": [float(v) for v in rhat_np[todo]],
            })
        still = _flagged_idx()
        remediation = {
            "flagged": [int(v) for v in flagged0],
            "remediated": [int(v) for v in todo0],
            "warmup": int(warm1),
            "beta_min": beta1,
            "rhat_before": rhat_before,
            "rhat_after": [float(v) for v in rhat_np[todo0]],
            "still_flagged": [int(v) for v in still],
            "rounds": rounds,
        }
        if verbose:
            print(f"[run_sbc] remediation: {int(still.size)}/{D} datasets still flagged after "
                  f"{len(rounds)} round(s)", flush=True)

    ranks = (samples_np < tt_np[:, None, :]).sum(axis=1)
    if verbose:
        for i in range(D):
            print(f"[run_sbc] dataset {i + 1}/{D} ranks={ranks[i].tolist()}")

    flagged_final = _flagged_idx() if gate_active else np.asarray([], dtype=int)
    if writer:
        np.save(outdir / "sbc_thetas_true.npy", tt_np)
        np.save(outdir / "sbc_ranks.npy", ranks)
        # The pooled posterior draws (D, S, dim), for analyses after the run.
        np.save(outdir / "sbc_samples.npy", samples_np.astype(np.float32))
        np.savez(outdir / "sbc_mixing_diagnostics.npz", rhat_max=rhat_np, min_ess=ess_np, divergences=div_np,
                 flagged_final=flagged_final)
    if verbose:
        print(f"[run_sbc] wrote {outdir / 'sbc_thetas_true.npy'}")
        print(f"[run_sbc] wrote {outdir / 'sbc_ranks.npy'}")
        n_bad = int(np.sum(rhat_np > 1.05)) if rhat_np.size else 0
        print(f"[run_sbc] per-dataset mixing: max split-R-hat="
              f"{np.nanmax(rhat_np) if rhat_np.size else float('nan'):.3f}, "
              f"min ESS={np.nanmin(ess_np) if ess_np.size else float('nan'):.0f}, "
              f"{n_bad}/{D} datasets with R-hat > 1.05")
    if writer:
        _plot_sbc_rank_histograms(ranks, post_samples, outdir)
    return {
        "thetas_true": tt_np,
        "ranks": ranks,
        "all_samples": [samples_np[i] for i in range(D)],
        "rhat_max": rhat_np,
        "min_ess": ess_np,
        "divergences_per_dataset": div_np,
        "swap_accept": [s for s in swap_accepts if s is not None] or None,
        "remediation": remediation,
        "flagged_final": [int(v) for v in flagged_final],
        "potential_calls": calls[0],
    }


_BATCHED_METHODS = ("nuts", "nuts_pyro", "hmc", "slice", "slice_np_vectorized")


def run_sbc(
    cfg: RunConfig,
    prior_theta: Distribution,
    density_estimator: MNLE,
    device=None,
    *,
    num_datasets: Optional[int] = None,
    num_posterior_samples: Optional[int] = None,
    outdir: str | Path = "mnle_outputs",
    seed: int = 0,
    verbose: bool = True,
    batched: bool = True,
    group_size: int = 8,
    mesh=None,
) -> dict:
    """Simulation-based calibration on ``device`` (default: the
    estimator's). For each dataset: theta_true ~ prior, simulate a session,
    sample the posterior, rank theta_true among the posterior draws. Returns
    {"thetas_true", "ranks", "all_samples"} and writes sbc_thetas_true.npy,
    sbc_ranks.npy, sbc_rank_histograms.png and sbc_ecdf.png into
    ``outdir``.

    ``batched=True`` (default) folds the datasets into the chain axis
    (``_run_sbc_batched``: also the mixing gate, its remediation, the
    per-dataset diagnostics, sbc_samples.npy, sbc_mixing_diagnostics.npz
    and the partials after every group); ``batched=False`` runs the
    datasets one after another through ``run_inference_mcmc``. ``mesh``
    (a ``parallel.mesh.default_mesh`` of the ranks, every rank calling with
    the same arguments) splits the batched driver's rows over the ranks, as
    the JAX package shards them over its mesh, and gives every rank the
    unsharded run's result; rank 0 writes the files. The serial driver takes
    no mesh."""
    if mesh is not None and not (batched and cfg.MCMC_METHOD in _BATCHED_METHODS):
        raise ValueError(f"run_sbc(mesh=...) runs the batched driver (batched=True, MCMC_METHOD in "
                         f"{_BATCHED_METHODS}), got batched={batched}, MCMC_METHOD={cfg.MCMC_METHOD!r}")
    device = torch.device(device) if device is not None else density_estimator.device
    density_estimator.to(device)
    num_datasets = int(num_datasets or cfg.SBC_NUM_DATASETS)
    post_samples = int(num_posterior_samples or cfg.SBC_POST_SAMPLES)
    seed = as_seed(seed)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    if batched and cfg.MCMC_METHOD in _BATCHED_METHODS:
        return _run_sbc_batched(cfg, prior_theta, density_estimator, num_datasets, post_samples, outdir, seed,
                                verbose, device, group_size=group_size, mesh=mesh)

    sbc_cfg = cfg.replace(POSTERIOR_SAMPLES=post_samples)
    thetas_true, ranks, all_samples = [], [], []
    for i in range(num_datasets):
        k = child_seed(seed, i)
        theta_true = prior_theta.sample(make_generator(child_seed(k, 0), device), (1,))[0]
        x_o, pulses_o = simulate_session_data_rt_choice(
            theta_true, cfg.NUM_TRIALS_OBS, rng=child_seed(k, 1), mu_sensory=cfg.MU_SENSORY,
            p_success=cfg.P_SUCCESS, return_pulse_sides=True,
        )
        x_o = pack_x_rt_choice(x_o, log_rt=cfg.LOG_RT_MANUALLY)
        samples = run_inference_mcmc(sbc_cfg, prior_theta, density_estimator, x_o, pulses_o, device,
                                     seed=child_seed(k, 2), verbose=False)
        theta_np, samples_np = theta_true.cpu().numpy(), samples.cpu().numpy()
        r = _compute_ranks(samples_np, theta_np)
        thetas_true.append(theta_np)
        ranks.append(r)
        all_samples.append(samples_np)
        if verbose:
            print(f"[run_sbc] dataset {i + 1}/{num_datasets} ranks={r.tolist()}")

    thetas_true = np.stack(thetas_true)
    ranks = np.stack(ranks)
    np.save(outdir / "sbc_thetas_true.npy", thetas_true)
    np.save(outdir / "sbc_ranks.npy", ranks)
    if verbose:
        print(f"[run_sbc] wrote {outdir / 'sbc_thetas_true.npy'}")
        print(f"[run_sbc] wrote {outdir / 'sbc_ranks.npy'}")
    _plot_sbc_rank_histograms(ranks, post_samples, outdir)
    return {"thetas_true": thetas_true, "ranks": ranks, "all_samples": all_samples}
