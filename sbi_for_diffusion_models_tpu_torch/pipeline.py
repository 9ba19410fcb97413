"""End-to-end pipeline: simulate -> train MNLE -> MCMC -> SBC (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/pipeline.py``:
``build_prior_theta``, ``main``, ``SMOKE_CONFIG`` and the CLI, with the same
prior, stage order, ``$OUTDIR`` convention, artifact filenames and
``metrics.jsonl`` records. ``main`` runs on ``device`` (default: the CUDA
card). Run it as ``python -m sbi_for_diffusion_models_tpu_torch.pipeline
[--smoke] [--preset calibrated|reference] [--seed N]``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from .distributions import Beta, LogNormal, MultipleIndependent
from .run_config import RUN_CONFIG_PARAMS, RunConfig

__all__ = ["build_prior_theta", "main", "SMOKE_CONFIG", "THETA_LABELS"]

THETA_LABELS = ["a0", "lam", "v", "B", "tau"]


def build_prior_theta() -> MultipleIndependent:
    """Prior over theta = [a0, lam, v, B, tau]: Beta(2,2) a0; LogNormal(-1,1)
    lam; LogNormal(0,1) v; LogNormal(2.75,0.5) B; Beta(2,2) tau."""
    return MultipleIndependent(
        [
            Beta(2.0, 2.0),
            LogNormal(-1.0, 1.0),
            LogNormal(0.0, 1.0),
            LogNormal(2.75, 0.5),
            Beta(2.0, 2.0),
        ]
    )


def main(cfg: RunConfig = RUN_CONFIG_PARAMS, device=None, *, seed: int = 0) -> dict:
    """Run the full pipeline on ``device`` (default: the CUDA card): simulate
    the training set, train and save the MNLE, sample the posterior of an
    observed session from a prior draw, then SBC. Writes
    ``posterior_samples_theta.npy``, ``pairplot_theta.png``, the SBC
    artifacts and ``metrics.jsonl`` into ``$OUTDIR`` (default
    ``mnle_outputs``), the model into ``$MODEL_DIR``.

    Streams: ``utils/rng.child_seed(seed, k)`` with the JAX package's
    ``fold_in`` tags (1 simulate, 2 train, 3 theta_true, 4 MCMC, 5 SBC); the
    observed session uses seed 123, as in the JAX package."""
    from .analysis import pairplot
    from .data_simulator import simulate_observed_session, simulate_training_set_with_conditions, summarize_trials
    from .mnle import run_inference_mcmc, run_sbc, save_model, train_mnle
    from .models.rt_choice_model import n_pulses_max_from_schedule, pulse_schedule
    from .proposals import ExtendedProposal, PulseSequenceProposal
    from .utils.device import resolve_device
    from .utils.metrics import MetricsLogger
    from .utils.rng import as_seed, child_seed, make_generator

    device = resolve_device(device)
    t_start = time.time()
    seed = as_seed(seed)
    outdir = Path(os.environ.get("OUTDIR", "mnle_outputs"))
    outdir.mkdir(parents=True, exist_ok=True)
    metrics = MetricsLogger(outdir / "metrics.jsonl")

    n_max, steps_per_pulse = pulse_schedule()
    n_pulses = n_pulses_max_from_schedule(n_max, steps_per_pulse)
    print(f"[pipeline] n_max={n_max} steps_per_pulse={steps_per_pulse} P={n_pulses} device={device}")

    prior_theta = build_prior_theta()
    pulse_proposal = PulseSequenceProposal(n_pulses, cfg.P_SUCCESS, seed=0, device=device)
    proposal_z = ExtendedProposal(prior_theta, pulse_proposal)

    # 1. Simulate the training set (summarize_trials reads it back: the
    # wall includes the device's work).
    t0 = time.time()
    z_train, x_train = simulate_training_set_with_conditions(cfg, proposal_z, device=device, seed=child_seed(seed, 1))
    summarize_trials("train", x_train)
    sim_wall = time.time() - t0
    metrics.log("simulate", "wall_s", sim_wall)
    metrics.log("simulate", "nominal_trial_steps_per_s", cfg.NUM_SIMULATIONS * n_max / max(sim_wall, 1e-9))

    # 2. Train the MNLE.
    t0 = time.time()
    density_estimator = train_mnle(cfg, proposal_z, z_train, x_train, device, seed=child_seed(seed, 2))
    metrics.log("train", "wall_s", time.time() - t0)
    save_model(density_estimator, cfg)

    # 3. Observed session from a prior draw.
    theta_true = prior_theta.sample(make_generator(child_seed(seed, 3), device), (1,))[0]
    print(f"[pipeline] theta_true = {theta_true.cpu().numpy().round(4).tolist()}")
    x_o, pulses_o = simulate_observed_session(
        theta_true, cfg.NUM_TRIALS_OBS, mu_sensory=cfg.MU_SENSORY, p_success=cfg.P_SUCCESS,
        log_rt=cfg.LOG_RT_MANUALLY, seed=123, device=device,
    )
    summarize_trials("observed", x_o)

    # 4. MCMC posterior (read back inside the wall).
    t0 = time.time()
    samples = run_inference_mcmc(cfg, prior_theta, density_estimator, x_o, pulses_o, device,
                                 seed=child_seed(seed, 4)).cpu().numpy()
    mcmc_wall = time.time() - t0
    metrics.log("mcmc", "wall_s", mcmc_wall)
    metrics.log("mcmc", "posterior_samples_per_s", cfg.POSTERIOR_SAMPLES / max(mcmc_wall, 1e-9))

    # 5. Artifacts with the reference's filenames.
    np.save(outdir / "posterior_samples_theta.npy", samples)
    print(f"[pipeline] wrote {outdir / 'posterior_samples_theta.npy'}")
    theta_true_np = theta_true.cpu().numpy()
    pairplot(samples, points=theta_true_np, labels=THETA_LABELS, save_path=outdir / "pairplot_theta.png")

    # 6. SBC.
    t0 = time.time()
    sbc = run_sbc(cfg, prior_theta, density_estimator, device, outdir=outdir, seed=child_seed(seed, 5))
    metrics.log("sbc", "wall_s", time.time() - t0)

    metrics.log("pipeline", "total_wall_s", time.time() - t_start)
    print(f"[pipeline] total wall-clock: {time.time() - t_start:.1f}s")
    return {
        "density_estimator": density_estimator,
        "theta_true": theta_true_np,
        "posterior_samples": samples,
        "sbc": sbc,
    }


SMOKE_CONFIG = RUN_CONFIG_PARAMS.replace(
    NUM_SIMULATIONS=2000,
    TRAIN_BATCH_SIZE=512,
    TRAIN_MAX_EPOCHS=30,
    TRAIN_STOP_AFTER_EPOCHS=8,
    MNLE_HIDDEN_FEATURES=64,
    MNLE_NUM_TRANSFORMS=4,
    NUM_TRIALS_OBS=20,
    NUM_CHAINS=4,
    WARMUP_STEPS=60,
    POSTERIOR_SAMPLES=200,
    SBC_NUM_DATASETS=2,
    SBC_POST_SAMPLES=100,
    # At 25 draws/chain the min-ESS gate flags every dataset, so the full
    # escalation ladder would triple the smoke SBC's sampling cost for no
    # signal; one remediation round keeps the gate exercised but cheap.
    SBC_REMEDIATE_ROUNDS=1,
)


def _cli(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Run the full SBI pipeline on the CUDA card.")
    p.add_argument("--smoke", action="store_true", help="small-scale config: fewer sims/epochs/chains")
    p.add_argument(
        "--preset",
        choices=("calibrated", "reference"),
        default="calibrated",
        help="'calibrated' (default): the stack the SBC oracle passes with "
        "(run_config.CALIBRATED_CONFIG: shifted-log censored MNLE at 10M "
        "sims, PT6 + tau-slice NUTS); 'reference': the reference's exact "
        "default field values, which the repo's own calibration index shows "
        "mis-calibrated at scale",
    )
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.smoke:
        cfg = SMOKE_CONFIG
    elif args.preset == "calibrated":
        from .run_config import CALIBRATED_CONFIG

        cfg = CALIBRATED_CONFIG
    else:
        cfg = RUN_CONFIG_PARAMS
    return main(cfg, seed=args.seed)


if __name__ == "__main__":
    _cli()
