"""MNLE persistence and MCMC inference (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/mnle.py``. Ported so far:
``load_model`` (the JAX ``save_model`` ``.npz`` layout: ``param:<keystr>``
leaves, ``stat:*`` arrays and the ``__meta__`` JSON, read with numpy alone)
and ``run_inference_mcmc``, for the log, shifted-log and pulse-grid RT
representations (the pulse rep's absolute anchor through kernels K2p/K3p).
Training, ``save_model``, ensembles and SBC follow in later slices.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from .distributions import Distribution, mcmc_transform
from .inference.mcmc import MCMCPosterior, compose_moves, make_dim_slice, make_grid_hop
from .nets.mnle_net import MNLE, MNLEConfig, mnle_from_flax_params
from .potentials import ConditionedMNLELogLikelihood, ThetaOnlyPosteriorPotential
from .run_config import RunConfig

__all__ = ["load_model", "run_inference_mcmc"]

_DEFAULT_MODEL_FILENAME = "mnle_rt_choice_model.npz"
_KEY_PART = re.compile(r"\['([^']*)'\]")


def _model_dir() -> Path:
    return Path(os.environ.get("MODEL_DIR", Path.home() / "models"))


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
    """Load an estimator saved by the JAX ``save_model`` from
    ``$MODEL_DIR/filename`` (default ``~/models``) onto ``device`` (default:
    the CUDA card; pass ``device="cpu"`` for the CPU)."""
    path = _model_dir() / filename
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        cfg = MNLEConfig(**meta["mnle_config"])
        params = _unflatten(data)
        stats = {k: np.asarray(data[f"stat:{k}"]) for k in ("cond_mean", "cond_std", "x_mean", "x_std")}
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
