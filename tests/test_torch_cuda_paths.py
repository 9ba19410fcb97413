"""PyTorch port: its paths on the card, each once through its public entry
points at a cut of its configuration, with the checks only a whole path
makes: which kernels it launched (``CudaKernel.launches``); K2 (K2p) at
under 5 % of K3's (K3p's) launches where a gradient call launches K3 alone;
the draws' shapes and support; ``sample`` on the card against the CPU's
plain path; save and load bit for bit; a run resumed after SIGKILL and an
injected device error, bit for bit; SBC's outputs; K2/K3 on the rows a path
gave them (``card_common.hold_rows``); and the multi-device paths in an
NCCL world of one and on 4 ranks. The kernels themselves are held in the
other ``test_torch_cuda*.py`` files. Without a CUDA device (or without nvcc
to build the kernels) every test here is skipped.

This module imports no JAX, and nothing at its import touches the card or
starts a process: the resume test's child and the multi-device ranks import
it.
"""

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
from sbi_for_diffusion_models_tpu_torch.ops import ceiling_cuda, ddm_cuda, density_cuda, nuts_cuda  # noqa: F401
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
from sbi_for_diffusion_models_tpu_torch.utils import metrics
from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

from card_common import hold_rows, observed_session, same_distribution, session_pairs, session_rows

pytestmark = pytest.mark.requires_cuda

DEV = torch.device("cuda", 0)
ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "artifacts" / "models"
MODEL_FILE = "mnle_10m_shifted_logt_affine.npz"
PULSE_MODEL_FILE = "mnle_1m_pulseabs.npz"
SHARP_MODEL_FILE = "mnle_10m_shifted_logt_sharp.npz"
ENSEMBLE_FILES = ("mnle_10m.npz", "mnle_calibration.npz", "mnle_large_budget.npz")  # three models of one config
N_SIM = 131_072  # the training set of the training and embedding paths
ROWS_MAIN, ROWS_FOLD, ROWS_SBC = 1_200, 9_600, 115_200
P_MIN = 1e-3  # ``sample`` on the card against the CPU's plain path
NUTS, DENSITY = ("nuts_leaf",), ("density_pre", "density_post")
# The cuts of the calibrated sampler (PT6 x 4 chains, grid hop, t_nd slice; warmup, draws).
SERVE_WARMUP, SERVE_DRAWS, PULSE_DRAWS = 10, 40, 20
SLICE_WARMUP, SLICE_DRAWS = 20, 240  # 24 untempered chains: 10 draws each
TRAIN_EPOCHS, TRAIN_MIN_DROP, TRAIN_CHECKPOINT_EVERY = 10, 0.5, 5  # nats the last validation loss must fall
TRAIN_SERVE_WARMUP, TRAIN_SERVE_DRAWS = 10, 20
SBC_WARMUP, SBC_DRAWS = 5, 40  # 10 draws a chain: the mixing gate is active
RESUME_WARMUP, RESUME_DRAWS, RESUME_SEGMENT = 10, 20, 5  # 30 transitions, 6 segments; draws a chain
RESUME_TREE_DEPTH = 6  # the resume path tests exactness, not mixing
RESUME_CUT_AT = 3  # the cut child is killed once its checkpoint's next_segment reaches this
RESUME_FAULT_CALL = 10  # the resumed run's potential call that raises the injected device error
NEW_WARMUP, NEW_DRAWS, NEW_TREE_DEPTH = 10, 10, 6  # the sharp, ensemble and embedding paths' sampler
SAMPLE_CARD, SAMPLE_CPU = 131_072, 8_192  # ``sample`` draws on the card and on the CPU, at 64 conditions
EMBED_DIM, EMBED_EPOCHS = 32, 2  # "append": context 85 + 32 + 6 = 123
# The SNPE example's shape (examples/snpe_snle_choice_model.py): 20,000 thetas from its BoxUniform prior, x the
# mean choice of 8 trials of the choice-only model at n_max 4,000 and t_max 2 s with two resample passes.
VARIANT_THETAS, VARIANT_REPS, VARIANT_7P_TRIALS = 20_000, 8, 1_200
CHOICE_GRID = {"t_max": 2.0, "n_max": 4_000, "steps_per_pulse": 200, "chunk_steps": 200}
SNPE_LO, SNPE_HI = (0.1, 0.05, 0.2, 2.0, 0.0), (0.9, 1.0, 3.0, 20.0, 0.5)
SNPE_THETAS, SNPE_DRAWS, SNPE_EPOCHS = 20_000, 2_000, 30  # the example's 60 epochs, cut (patience 12, as there)
SNPE_WARMUP, SNPE_CHAIN_DRAWS = 20, 20  # the SNLE posterior's NUTS run: 4 chains, trees capped at depth 6
# The hierarchical coverage configuration (artifacts/hierarchical_coverage_pt_a.json), cut from warmup 250, 300
# draws a chain, depth 8.
HIER_WARMUP, HIER_DRAWS, HIER_TREE_DEPTH, HIER_SEED = 10, 10, 6, 2000
# The multi-device path: its SBC fold is the SBC path's 8 datasets (9,600 rows a K3 launch) at warmup 5, 20 draws
# (5 a chain: no mixing gate, no remediation), depth 6; its hierarchical fold is the hierarchical path's.
MD_RANKS, MD_WARMUP, MD_DRAWS, MD_TREE_DEPTH = 4, 5, 20, 6
MD_DEADLINE_S = 420.0  # the ranks' deadline; their collectives time out at the same limit
SBC_ARTIFACTS = ("sbc_thetas_true.npy", "sbc_ranks.npy", "sbc_samples.npy", "sbc_mixing_diagnostics.npz",
                 "sbc_ranks.partial.npy", "partial_summary.json")
SBC_PLOTS = ("sbc_rank_histograms.png", "sbc_ecdf.png")


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ with no CPU mode")
    if not (Path("/usr/local/cuda/bin/nvcc").exists() or shutil.which("nvcc")):
        pytest.skip("needs nvcc: the kernels are built from source at first use")


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    """Skip without a card (decided per test, never at import); the
    committed models, TF32 off."""
    _card_or_skip()
    monkeypatch.setenv("MODEL_DIR", str(MODELS))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.fixture(scope="module")
def session():
    """(prior, x_o, pulses_o): the observed session the serving paths sample
    (``observed_session``)."""
    _card_or_skip()  # a module's fixture is set up before the autouse one
    return observed_session(DEV)


@pytest.fixture(scope="module")
def training_set():
    """N_SIM simulated training pairs at the flagship's width, simulated on
    K1 (``simulate_training_set_with_conditions``), for the training and
    embedding paths: (proposal, z, x)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_training_set_with_conditions
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import n_pulses_max_from_schedule, pulse_schedule
    from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal

    _card_or_skip()
    P = n_pulses_max_from_schedule(*pulse_schedule())
    proposal = ExtendedProposal(build_prior_theta(), PulseSequenceProposal(P, CALIBRATED_CONFIG.P_SUCCESS, device=DEV))
    (z, x), launches = _launches(lambda: simulate_training_set_with_conditions(CALIBRATED_CONFIG, proposal,
                                                                              num_simulations=N_SIM, device=DEV))
    assert launches["ddm_rt_choice"] > 0
    assert tuple(x.shape) == (N_SIM, 2) and tuple(z.shape) == (N_SIM, 5 + P)
    return proposal, z, x


def _launches(run):
    """``run()``'s result and each kernel's launches during it."""
    before = {name: k.launches for name, k in KERNELS.items()}
    out = run()
    torch.cuda.synchronize()
    return out, {name: k.launches - before[name] for name, k in KERNELS.items()}


def _launched(launches: dict, names, fwd: str = None, bwd: str = None) -> None:
    """Each kernel of ``names`` launched; with ``fwd`` and ``bwd``, the
    forward kernel less than 5 % as often as the backward one (a gradient
    call launches the backward kernel alone, which writes the value too)."""
    assert not [n for n in names if launches[n] <= 0], launches
    if fwd is not None:
        assert launches[fwd] < 0.05 * launches[bwd], launches


@contextlib.contextmanager
def _k3_rows(monkeypatch):
    """Records, around K3's wrapper, the row count of every call and the
    inputs of the first call at each row count, ``{rows: ((t, onehot, ctx),
    weights, cotangent)}``, to be held after the path's launches are read."""
    k3, seen, first = mc.rows_logp_and_vjp, [], {}

    def recording(t, oh, ctx, w, g):
        seen.append(t.shape[0])
        if t.shape[0] not in first:
            first[t.shape[0]] = ((t.clone(), oh.clone(), ctx.clone()), w, g.clone())
        return k3(t, oh, ctx, w, g)

    with monkeypatch.context() as m:
        m.setattr(mc, "rows_logp_and_vjp", recording)
        yield seen, first


def _sample_posterior(est, session, warmup: int, draws: int, max_depth: int = None, **cut):
    """The calibrated sampler on the observed session, cut to ``warmup`` and
    ``draws`` (trees capped at ``max_depth`` where given): the draws finite,
    inside the prior's support and of their shape."""
    prior, x_o, pulses_o = session
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws, **cut)
    if max_depth is not None:
        cfg = cfg.replace(MCMC_MAX_TREE_DEPTH=max_depth)
    samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=DEV, seed=0, return_info=True,
                                       verbose=False)
    assert tuple(samples.shape) == (draws, 5) and bool(torch.isfinite(samples).all())
    assert bool(torch.isfinite(prior.log_prob(samples)).all())
    return samples, info


def _hold_sample(est, est_cpu):
    """``sample`` on the card (SAMPLE_CARD draws) against the port's plain
    path on the CPU (SAMPLE_CPU draws of ``est_cpu``, the same model loaded
    there) at the same 64 conditions (a prior draw and a +-1 stimulus each):
    each p of ``same_distribution`` >= P_MIN (a choice's RTs where both
    sides have over 20 draws of it), every draw and its log-prob
    finite, censored draws at T_MAX. Returns the card's draws and their
    conditions."""
    from sbi_for_diffusion_models_tpu_torch.constants import T_MAX
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import generate_pulse_matrix

    gen = make_generator(17, DEV)
    cond = torch.cat([build_prior_theta().sample(gen, (64,)), generate_pulse_matrix(gen, 64, 80)], -1)
    card_cond = cond.repeat(SAMPLE_CARD // 64, 1)
    draws = est.sample(5, card_cond)
    cpu = est_cpu.sample(6, cond.cpu().repeat(SAMPLE_CPU // 64, 1))
    censored = est.cfg.censored_category if est.cfg.censor_rt else None
    p = same_distribution(draws, cpu, censored, at_least=21)
    assert min(p.values()) >= P_MIN, p
    assert bool(torch.isfinite(draws).all()) and bool(torch.isfinite(est.log_prob(draws, card_cond)).all())
    assert censored is None or bool((draws[draws[:, 1] == censored, 0] == T_MAX).all())
    return draws, card_cond


def _closed_form_against_autograd(est, session) -> None:
    """One ``log_lik_and_grad`` call (K3 per member) at 24 prior thetas on
    the observed session against autograd of ``log_lik_fn`` through the
    fused ``autograd.Function`` (K2 forward, K3 backward): the value to
    1e-4 and each row's gradient to 1e-3 x max(1, its largest |ref|)."""
    prior, x_o, pulses_o = session
    theta = prior.sample(make_generator(19, DEV), (24,))
    lik = ConditionedMNLELogLikelihood(est, pulses_o, logprob_kernel="pallas")
    ll, g = lik.log_lik_and_grad(x_o, theta)
    th = theta.clone().requires_grad_(True)
    ll_auto = lik.log_lik_fn(est.params, x_o, th)
    (g_auto,) = torch.autograd.grad(ll_auto.sum(), th)
    ll_auto = ll_auto.detach()
    assert float(((ll - ll_auto).abs() / ll_auto.abs().clamp(min=1.0)).max()) <= 1e-4
    assert float(((g - g_auto).abs().amax(1) / g_auto.abs().amax(1).clamp(min=1.0)).max()) <= 1e-3
    assert bool(torch.isfinite(g).all())


def _check_sbc_outputs(outdir: Path, out: dict, datasets: int, post: int) -> None:
    """``run_sbc``'s return dict and files: every .npy/.npz/.json artifact
    (the plots too where matplotlib imports), ranks in [0, post], finite
    draws inside the prior's support, the files equal to the dict."""
    import importlib.util

    wanted = SBC_ARTIFACTS + (SBC_PLOTS if importlib.util.find_spec("matplotlib") else ())
    assert not [f for f in wanted if not (outdir / f).exists()]
    ranks, samples = out["ranks"], np.stack(out["all_samples"])
    assert ranks.shape == (datasets, 5) and ((ranks >= 0) & (ranks <= post)).all(), ranks
    assert samples.shape == (datasets, post, 5) and np.isfinite(samples).all()
    assert ((samples[..., [0, 4]] > 0) & (samples[..., [0, 4]] < 1)).all() and (samples[..., 1:4] > 0).all()
    assert np.array_equal(np.load(outdir / "sbc_ranks.npy"), ranks)
    assert np.array_equal(np.load(outdir / "sbc_samples.npy"), samples.astype(np.float32))


def test_flagship_serving_path(session, training_set):
    """The flagship path: its training set simulated on K1 (the
    ``training_set`` fixture), then the flagship under the calibrated
    sampler: K2, K3 and the leaf kernel launched, K2 under 5 % of K3 (the
    density pair's launches a call: ``test_run_inference_mcmc_draws_are_unchanged``);
    then its ``sample`` against the CPU's plain path."""
    est = load_model(MODEL_FILE, device=DEV)
    _, launches = _launches(lambda: _sample_posterior(est, session, SERVE_WARMUP, SERVE_DRAWS))
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS), "mnle_logprob_fwd", "mnle_logprob_bwd")
    _hold_sample(est, load_model(MODEL_FILE, device="cpu"))


def test_pulse_grid_serving_path(session):
    """The pulse-grid model under the same sampler: K2p, K3p, the leaf
    kernel and the density pair launched, K2p under 5 % of K3p; then its
    ``sample`` (the slot head's draw, the circular splines' inverse) against
    the CPU's plain path."""
    est = load_model(PULSE_MODEL_FILE, device=DEV)
    _, launches = _launches(lambda: _sample_posterior(est, session, SERVE_WARMUP, PULSE_DRAWS))
    _launched(launches, ("mnle_pulse_fwd", "mnle_pulse_bwd", *NUTS, *DENSITY), "mnle_pulse_fwd", "mnle_pulse_bwd")
    _hold_sample(est, load_model(PULSE_MODEL_FILE, device="cpu"))


def test_slice_path(session):
    """``MCMC_METHOD="slice"`` on the flagship: tempering is NUTS-only, so
    the PT6 x 4 chains become 24 untempered chains, 1,200 rows a density
    call; no grid hop or t_nd slice. One K2 launch a density call and no K3
    (the slice sampler takes no gradient); the density pair launched."""
    est = load_model(MODEL_FILE, device=DEV)
    chains = CALIBRATED_CONFIG.NUM_CHAINS * CALIBRATED_CONFIG.MCMC_PT_REPLICAS
    (_, info), launches = _launches(lambda: _sample_posterior(
        est, session, SLICE_WARMUP, SLICE_DRAWS, MCMC_METHOD="slice", MCMC_PT_REPLICAS=1, NUM_CHAINS=chains,
        MCMC_GRID_HOP=False, MCMC_TAU_SLICE=False))
    _launched(launches, DENSITY)
    assert launches["mnle_logprob_bwd"] == 0 and launches["mnle_logprob_fwd"] == info["potential_calls"] > 0


@contextlib.contextmanager
def _run_nuts_with(**options):
    """Give every ``run_nuts`` call of ``MCMCPosterior.sample`` the segment
    options ``options``; ``fault_call``, where given, makes that call's
    closed-form potential raise one ``torch.AcceleratorError`` on its
    ``fault_call``-th call. Yields the list of faults raised."""
    from sbi_for_diffusion_models_tpu_torch.inference import mcmc

    real, faults = mcmc.run_nuts, []
    fault_call = options.pop("fault_call", None)

    def patched(*args, **kwargs):
        vg, calls = kwargs["value_and_grad_fn"], [0]

        def faulty(u, beta, need_grad=True):
            calls[0] += 1
            if calls[0] == fault_call:
                faults.append(calls[0])
                raise torch.AcceleratorError("injected device error (the resume test)")
            return vg(u, beta, need_grad)

        if fault_call is not None:
            kwargs["value_and_grad_fn"] = faulty
        return real(*args, **kwargs, **options)

    mcmc.run_nuts = patched
    try:
        yield faults
    finally:
        mcmc.run_nuts = real


def _resume_run(**options) -> dict:
    """The flagship serving path's sampler on the observed session, cut to
    RESUME_WARMUP / RESUME_DRAWS a chain in segments of RESUME_SEGMENT
    transitions, trees capped at RESUME_TREE_DEPTH, with the run_nuts
    ``options``: its draws, info, faults and what it printed."""
    prior, x_o, pulses_o = observed_session(DEV)
    est = load_model(str(MODELS / MODEL_FILE), device=DEV)
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=RESUME_WARMUP, MCMC_MAX_TREE_DEPTH=RESUME_TREE_DEPTH,
                                    POSTERIOR_SAMPLES=RESUME_DRAWS * CALIBRATED_CONFIG.NUM_CHAINS)
    printed = io.StringIO()
    with _run_nuts_with(segment_length=RESUME_SEGMENT, **options) as faults, contextlib.redirect_stdout(printed):
        samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=DEV, seed=0, return_info=True,
                                           verbose=False)
        torch.cuda.synchronize()
    return {"samples": samples, "info": info, "printed": printed.getvalue(), "faults": faults}


def resume_child(ckpt_dir: str) -> None:
    """The cut run, in a process of its own: the resume test's run with
    ``checkpoint_dir``; the test kills it with SIGKILL partway."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _resume_run(checkpoint_dir=ckpt_dir, mirror_every=1)


def test_resume_path(tmp_path):
    """A reference run; the same run with ``checkpoint_dir`` in a child
    process, killed with SIGKILL once its checkpoint reaches segment
    RESUME_CUT_AT; then the same call here, resumed from that checkpoint with
    ``device_retries=1`` and one ``torch.AcceleratorError`` raised by the
    potential (not a real device loss) in the first segment it runs, which it
    replays from the host mirror. Draws, accept probabilities, tree sizes,
    divergences, step sizes and mass matrices equal the reference run's bit
    for bit; K2, K3, the leaf kernel and the density pair launched."""
    n_segments = -(-(RESUME_WARMUP + RESUME_DRAWS) // RESUME_SEGMENT)
    ckpt_dir = tmp_path / "nuts"
    ckpt_file = ckpt_dir / "nuts_segments.npz"

    def next_segment():
        with np.load(ckpt_file) as blob:
            return int(blob["next_segment"])

    def run():
        ref = _resume_run(mirror_every=1)
        log_path = tmp_path / "child.log"
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)])}
        code = f"import test_torch_cuda_paths as t; t.resume_child({str(ckpt_dir)!r})"
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            child = subprocess.Popen([sys.executable, "-c", code], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                                     env=env)
            try:
                while not (ckpt_file.exists() and next_segment() >= RESUME_CUT_AT):
                    assert child.poll() is None and time.perf_counter() - t0 < 600, log_path.read_text()[-4000:]
                    time.sleep(0.05)
            finally:
                child.kill()
                child.wait()
        cut = next_segment()
        assert RESUME_CUT_AT <= cut < n_segments
        res = _resume_run(checkpoint_dir=str(ckpt_dir), mirror_every=1, device_retries=1,
                          fault_call=RESUME_FAULT_CALL)
        return ref, res, cut

    (ref, res, cut), launches = _launches(run)
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY))
    assert f"[run_nuts] resumed at segment {cut}/{n_segments}" in res["printed"], res["printed"]
    assert (f"[run_nuts] device lost near segment {cut} (AcceleratorError); waiting for recovery, then replaying "
            f"from segment {cut} (attempt 1/1)") in res["printed"], res["printed"]
    assert res["faults"] == [RESUME_FAULT_CALL] and next_segment() == n_segments
    assert torch.equal(ref["samples"], res["samples"])
    for k in ("accept_prob", "num_steps", "diverging", "step_size", "inv_mass"):
        assert torch.equal(ref["info"][k], res["info"][k]), k


def test_training_path(session, training_set, tmp_path, monkeypatch):
    """``train_mnle`` at the flagship's full width (cond-affine head) on the
    simulated pairs, TRAIN_EPOCHS epochs with a checkpoint every
    TRAIN_CHECKPOINT_EVERY: finite validation losses, the last at least
    TRAIN_MIN_DROP below the first; the newest checkpoint the last epoch's,
    and the same call again runs no epoch and returns the saved weights bit
    for bit; ``save_model`` / ``load_model`` bit for bit, no weight
    requiring gradients, the same fingerprint after a reload; the loaded
    model sampled (K2, K3, the leaf kernel and the density pair launched,
    K2 under 5 % of K3). Then K2/K3 on the trained model's session rows at
    1,200 and 115,200 (``hold_rows``)."""
    import sbi_for_diffusion_models_tpu_torch as port
    from sbi_for_diffusion_models_tpu_torch.utils.checkpoint import latest_step, restore_train_state

    proposal, z, x = training_set
    cfg = CALIBRATED_CONFIG.replace(MNLE_COND_AFFINE=True, TRAIN_MAX_EPOCHS=TRAIN_EPOCHS,
                                    TRAIN_STOP_AFTER_EPOCHS=TRAIN_EPOCHS)
    ckpt_dir = tmp_path / "train_ckpt"
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))

    def run():
        est = port.train_mnle(cfg, proposal, z, x, seed=0, checkpoint_dir=str(ckpt_dir),
                              checkpoint_every=TRAIN_CHECKPOINT_EVERY, verbose=False)
        m = est.cfg
        assert (m.rt_rep, m.censor_rt, m.cond_affine, m.log_condition_dims, m.hidden_features, m.num_transforms,
                m.num_bins, m.condition_dim) == ("shifted_log", True, True, (1, 2, 3), 128, 10, 24, 85)
        vl = est.train_meta["val_losses"]
        assert est.train_meta["epochs_run"] == TRAIN_EPOCHS and bool(np.isfinite(vl).all()), vl
        assert vl[-1] < vl[0] - TRAIN_MIN_DROP, vl

        assert latest_step(ckpt_dir) == TRAIN_EPOCHS - 1
        saved = restore_train_state(ckpt_dir)["params"]
        again = port.train_mnle(cfg, proposal, z, x, seed=0, checkpoint_dir=str(ckpt_dir),
                                checkpoint_every=TRAIN_CHECKPOINT_EVERY, verbose=False)
        state = again.net.state_dict()
        assert again.train_meta["epochs_run"] == 0
        assert all(torch.equal(v.to(DEV), state[k]) for k, v in saved.items())

        path = port.save_model(est, cfg, "trained.npz")
        loaded = port.load_model("trained.npz", device=DEV)
        assert all(torch.equal(a, b) for a, b in zip(est.net.parameters(), loaded.net.parameters()))
        assert not any(p.requires_grad for p in loaded.net.parameters())
        port.save_model(loaded, cfg, "again.npz")
        fingerprints = []
        for p in (path, tmp_path / "again.npz"):
            with np.load(p) as data:
                fingerprints.append(json.loads(str(data["__meta__"]))["param_fingerprint"])
        assert fingerprints[0] == fingerprints[1]
        _sample_posterior(loaded, session, TRAIN_SERVE_WARMUP, TRAIN_SERVE_DRAWS)
        return loaded

    est, launches = _launches(run)
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), "mnle_logprob_fwd",
              "mnle_logprob_bwd")
    rows = session_rows(est, build_prior_theta(), DEV, ROWS_SBC // ROWS_MAIN)
    w = mc.pack_mnle_weights(est)
    for n in (ROWS_MAIN, ROWS_SBC):
        g = torch.randn((n,), generator=torch.Generator(DEV).manual_seed(5), device=DEV)
        hold_rows(w, tuple(a[:n].contiguous() for a in rows), g)


def test_sbc_path(tmp_path, monkeypatch):
    """``run_sbc`` on the flagship under ``CALIBRATED_CONFIG``: 8 datasets,
    one group of the fold (9,600 rows a call), warmup SBC_WARMUP, SBC_DRAWS
    draws, one remediation round of up to 8 datasets. K1, K3, the leaf
    kernel and the density pair launched, K3 at 9,600 rows on every call, K2
    under 5 % of K3; SBC's outputs; the run id and group 0's finished segment
    checkpoint in ``outdir``. Then K2/K3 on the rows of the fold's first
    gradient call (``hold_rows``), and that call's values and gradients
    against one single-session ``log_lik_and_grad`` per dataset's 24 rows,
    within the value's and the gradients' tolerances of the row check in
    float32 ulps of each row's scale."""
    from sbi_for_diffusion_models_tpu_torch.inference.nuts import run_nuts

    datasets = 8
    cfg = CALIBRATED_CONFIG.replace(SBC_NUM_DATASETS=datasets, WARMUP_STEPS=SBC_WARMUP, SBC_POST_SAMPLES=SBC_DRAWS,
                                    SBC_REMEDIATE_ROUNDS=1, SBC_REMEDIATE_MAX=8)
    est = load_model(MODEL_FILE, device=DEV)
    fold_rows = datasets * cfg.NUM_CHAINS * cfg.MCMC_PT_REPLICAS * cfg.NUM_TRIALS_OBS
    first = {}
    real = ConditionedMNLELogLikelihood.log_lik_and_grad

    def recording(self, x, theta, need_grad=True, sessions=None):
        out = real(self, x, theta, need_grad, sessions)
        if need_grad and sessions is not None and not first:
            first.update(lik=self, x=x, theta=theta.clone(), sessions=sessions, ll=out[0].clone(),
                         grad=out[1].clone())
        return out

    monkeypatch.setattr(ConditionedMNLELogLikelihood, "log_lik_and_grad", recording)
    with _k3_rows(monkeypatch) as (seen, k3_first):
        out, launches = _launches(lambda: tmnle.run_sbc(cfg, build_prior_theta(), est, DEV, outdir=str(tmp_path),
                                                        seed=0))
    _launched(launches, ("ddm_rt_choice", "mnle_logprob_bwd", *NUTS, *DENSITY), "mnle_logprob_fwd",
              "mnle_logprob_bwd")
    assert set(seen) == {fold_rows} and len(seen) == launches["mnle_logprob_bwd"]
    _check_sbc_outputs(tmp_path, out, datasets, SBC_DRAWS)
    ckpt = tmp_path / "nuts_ckpt"
    segments = -(-(SBC_WARMUP + -(-SBC_DRAWS // cfg.NUM_CHAINS)) // run_nuts.__kwdefaults__["segment_length"])
    with np.load(ckpt / "group_0" / "nuts_segments.npz") as blob:
        assert int(blob["next_segment"]) == segments
    assert (ckpt / "run_id.txt").is_file()

    rows, w, g = k3_first[fold_rows]
    hold_rows(w, rows, g)

    # Per-row outputs of a kernel do not depend on the other rows: expect equal bits; a difference is counted in
    # float32 ulps of the row's scale (|ll|; the row's largest |grad|) and may not reach the row check's tolerances.
    eps = torch.finfo(torch.float32).eps
    x_g, theta, sessions = first["x"], first["theta"], first["sessions"]
    worst = {"ll": 0.0, "grad": 0.0}
    for d in range(x_g.shape[0]):
        idx = torch.nonzero(sessions == d).reshape(-1)
        single = ConditionedMNLELogLikelihood(est, first["lik"].local_theta[d], logprob_kernel=cfg.MNLE_LOGPROB_KERNEL)
        ll_d, g_d = single.log_lik_and_grad(x_g[d], theta[idx])
        for name, fold_v, single_v, scale in (("ll", first["ll"][idx], ll_d, ll_d.abs()),
                                              ("grad", first["grad"][idx], g_d, g_d.abs().amax(-1, keepdim=True))):
            worst[name] = max(worst[name], float(((fold_v - single_v).abs() / (eps * scale.clamp(min=1.0))).max()))
    assert worst["ll"] * eps <= 1e-4 and worst["grad"] * eps <= 1e-3, worst


def test_cli_smoke_path(tmp_path, monkeypatch):
    """The CLI's smoke path, ``pipeline._cli(["--smoke"])`` in this process
    (simulate, train, save, MCMC and SBC at ``SMOKE_CONFIG``) into a
    temporary ``OUTDIR`` and ``MODEL_DIR``: the posterior samples, the model,
    SBC's outputs and the five ``metrics.jsonl`` stages; K1, K3, the leaf
    kernel and the density pair launched (every potential call of that
    config wants a gradient, so K2 launches only if NUTS falls back to
    slice). Then K2/K3 on the model ``--smoke`` trained (log rep, no
    censoring, no cond-affine head, SMOKE_CONFIG's width): on the rows of
    the path's first K3 call at each row count and at 1,200 rows of
    prior-draw sessions (``hold_rows``)."""
    import importlib.util

    from sbi_for_diffusion_models_tpu_torch import pipeline

    cfg = pipeline.SMOKE_CONFIG
    out_dir, model_dir = tmp_path / "out", tmp_path / "models"
    monkeypatch.setenv("OUTDIR", str(out_dir))
    monkeypatch.setenv("MODEL_DIR", str(model_dir))
    with _k3_rows(monkeypatch) as (seen, k3_first):
        result, launches = _launches(lambda: pipeline._cli(["--smoke"]))
    _launched(launches, ("ddm_rt_choice", "mnle_logprob_bwd", *NUTS, *DENSITY))
    records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert {r["stage"] for r in records} == {"simulate", "train", "mcmc", "sbc", "pipeline"}
    wanted = ("posterior_samples_theta.npy",) + (("pairplot_theta.png",) if importlib.util.find_spec("matplotlib")
                                                else ())
    assert all((out_dir / f).exists() for f in wanted) and (model_dir / "mnle_rt_choice_model.npz").exists()
    samples = np.load(out_dir / "posterior_samples_theta.npy")
    assert samples.shape == (cfg.POSTERIOR_SAMPLES, 5) and np.isfinite(samples).all()
    _check_sbc_outputs(out_dir, result["sbc"], cfg.SBC_NUM_DATASETS, cfg.SBC_POST_SAMPLES)
    est = result["density_estimator"]
    m = est.cfg
    assert (m.rt_rep, m.censor_rt, m.cond_affine, m.hidden_features, m.num_transforms) == (
        "log", False, False, cfg.MNLE_HIDDEN_FEATURES, cfg.MNLE_NUM_TRANSFORMS)
    assert seen and len(seen) == launches["mnle_logprob_bwd"]
    for rows, w, g in k3_first.values():
        hold_rows(w, rows, g)
    rows = session_rows(est, build_prior_theta(), DEV, 1)
    hold_rows(mc.pack_mnle_weights(est), rows, torch.randn((ROWS_MAIN,), generator=torch.Generator(DEV).manual_seed(5),
                                                          device=DEV))


def test_tail_sharp_path(session):
    """The committed tail-sharp model (shifted-log RT, k = 1.5) under the
    calibrated sampler at NEW_WARMUP / NEW_DRAWS a chain, trees capped at
    NEW_TREE_DEPTH: K2, K3, the leaf kernel and the density pair launched (at
    this depth the value-only calls of the grid hop and the t_nd slice are a
    large share). Then the closed-form gradient against autograd, ``sample``
    on the card against the CPU's plain path, and ``tail_sharp_inverse``'s
    round trip on the card's draws that are not censored (to 1e-4 x max(1,
    |t|)). Its rows: ``test_k2_k3_match_their_plain_versions``."""
    from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import tail_sharp_inverse, tail_sharp_transform

    est = load_model(SHARP_MODEL_FILE, device=DEV)
    _, launches = _launches(lambda: _sample_posterior(est, session, NEW_WARMUP, NEW_DRAWS * 4, NEW_TREE_DEPTH))
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY))
    _closed_form_against_autograd(est, session)
    draws, cond = _hold_sample(est, load_model(SHARP_MODEL_FILE, device="cpu"))
    cfg = est.cfg
    live = draws[:, 1] != cfg.censored_category
    t = (torch.log(draws[live, 0] - cond[live, cfg.tnd_index]) - est.x_mean) / est.x_std
    back = tail_sharp_inverse(cfg, tail_sharp_transform(cfg, t)[0])
    assert float(((back - t).abs() / t.abs().clamp(min=1.0)).max()) <= 1e-4


def _float64_copy(est):
    """The estimator with its network and stats in float64 (a copy)."""
    import copy

    out = copy.deepcopy(est)
    out.net.double()
    for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
        setattr(out, name, getattr(out, name).to(torch.float64))
    return out


def test_ensemble_path(session):
    """``load_ensemble`` of ENSEMBLE_FILES (three committed full-width log-rep
    models of one config) under the calibrated sampler at the sharp path's
    cut: one kernel launch a member each potential call (K3 for a gradient
    call, K2 for a value-only call or ``log_lik_fn``), counted against the
    recorder's ``potential`` spans; the leaf kernel and the density pair
    launched. Then the mixture's rows against float64, the closed-form
    gradient against autograd, and ``sample`` against the CPU's plain path.

    The mixture: its 1,200 rows of one session through the members' fused
    paths against the float64 log-mean-exp of the members' float64 rows,
    each row to 1e-4 x max(1, |ref|) plus twice its spread where steep
    (``ops/rowcheck``). The members were trained without censoring, with the
    censored trials pinned at 8 s: on the session's censored rows their
    float32 evaluation, the plain version's as well, can be off float64 by far
    more than their spread. So the kernel's rows may exceed their allowance on
    as large a share as the plain float32 version's do, and on 0.1 %
    otherwise; the worst row as ``row_check`` limits it."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_ensemble
    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import MAX_OVER_SHARE, reference, row_check

    ens = load_ensemble(",".join(ENSEMBLE_FILES), device=DEV)
    K = len(ens)
    metrics.enable()
    try:
        _, launches = _launches(lambda: _sample_posterior(ens, session, NEW_WARMUP, NEW_DRAWS * 4, NEW_TREE_DEPTH))
    finally:
        spans, counters = metrics.drain()
    calls = sum(1 for s in spans if s.name == "potential")
    assert counters.get("spans.dropped", 0) == 0 and calls > 0
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY))
    fwd, bwd = launches["mnle_logprob_fwd"], launches["mnle_logprob_bwd"]
    assert fwd % K == 0 and bwd % K == 0 and fwd + bwd == K * calls, (launches, calls)

    (xr, cr), = session_pairs(session[0], DEV, 1)
    fused, plain = ens.dispatch_log_prob("pallas"), ens.dispatch_log_prob("xla")
    with torch.no_grad():
        kern, plain_v = fused(xr, cr), plain(xr, cr)
        members64 = [_float64_copy(m) for m in ens.members]
        choice = xr[:, 1].double()

        def run(rt, cond, g):
            lps = torch.stack([m.log_prob_fn(m.net, torch.stack([rt, choice], -1), cond) for m in members64])
            return (torch.logsumexp(lps, 0) - math.log(len(members64)),)

        ref, spread = reference(run, (xr[:, 0], cr), torch.zeros_like(xr[:, 0]), (1,))
        c = row_check(kern, plain_v, ref[0], spread[0], value=True)
    assert bool(torch.isfinite(kern).all()) and c.share <= max(MAX_OVER_SHARE, c.plain_share) and c.worst <= c.limit, c
    _closed_form_against_autograd(ens, session)
    _hold_sample(ens, load_ensemble(list(ENSEMBLE_FILES), device="cpu"))


def test_embedding_path(session, training_set, tmp_path, monkeypatch):
    """``train_mnle`` with MNLE_EMBED_DIM = EMBED_DIM in "append" mode
    (context width 123) for EMBED_EPOCHS epochs on the simulated pairs,
    ``save_model`` / ``load_model`` bit for bit, the loaded model sampled at
    the sharp path's cut, and one value-only call of a "replace"-mode network
    (context width 43) that ``train_mnle`` builds without training: K2, K3,
    the leaf kernel and the density pair launched. Then K2/K3 at width 123
    on its session rows at 1,200 and 9,600 (``hold_rows``), the replace-mode
    call against the plain path (1e-4 x max(1, |ref|)), and the closed-form
    gradient against autograd."""
    import sbi_for_diffusion_models_tpu_torch as port

    proposal, z, x = training_set
    prior, x_o, pulses_o = session
    cfg = CALIBRATED_CONFIG.replace(MNLE_EMBED_DIM=EMBED_DIM, MNLE_EMBED_MODE="append", TRAIN_MAX_EPOCHS=EMBED_EPOCHS,
                                    TRAIN_STOP_AFTER_EPOCHS=EMBED_EPOCHS)
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    theta = prior.sample(make_generator(23, DEV), (24,))

    def run():
        est = port.train_mnle(cfg, proposal, z, x, seed=0, verbose=False)
        m, meta = est.cfg, est.train_meta
        assert (m.pulse_dim, m.embed_dim, m.embed_mode, m.context_dim) == (80, EMBED_DIM, "append", 123)
        assert meta["epochs_run"] == EMBED_EPOCHS and all(map(math.isfinite, meta["val_losses"]))
        port.save_model(est, cfg, "embed.npz")
        loaded = port.load_model("embed.npz", device=DEV)
        assert loaded.cfg == est.cfg
        assert all(torch.equal(a, b) for a, b in zip(est.net.state_dict().values(), loaded.net.state_dict().values()))
        _sample_posterior(loaded, session, NEW_WARMUP, NEW_DRAWS * 4, NEW_TREE_DEPTH)
        replace = port.train_mnle(cfg.replace(MNLE_EMBED_MODE="replace", TRAIN_MAX_EPOCHS=0), proposal, z, x, seed=1,
                                  verbose=False)
        lik = ConditionedMNLELogLikelihood(replace, pulses_o, logprob_kernel="pallas")
        return loaded, replace, lik.log_lik_and_grad(x_o, theta, need_grad=False)[0]

    (est, replace, value), launches = _launches(run)
    _launched(launches, ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY))
    rows = session_rows(est, prior, DEV, ROWS_FOLD // ROWS_MAIN)
    w = mc.pack_mnle_weights(est)
    for n in (ROWS_MAIN, ROWS_FOLD):
        hold_rows(w, tuple(a[:n].contiguous() for a in rows),
                  torch.randn((n,), generator=torch.Generator(DEV).manual_seed(5), device=DEV))
    assert replace.net.cat_net.layers[0].in_features == 43
    plain = ConditionedMNLELogLikelihood(replace, pulses_o, logprob_kernel="xla").log_lik_fn(replace.params, x_o, theta)
    assert float(((value - plain).abs() / plain.abs().clamp(min=1.0)).max()) <= 1e-4
    _closed_form_against_autograd(est, session)


def test_choice_only_and_seven_parameter_simulators():
    """``ddm_choice_scan`` at the SNPE example's shape, as the example calls
    it (VARIANT_THETAS thetas x VARIANT_REPS trials at n_max 4,000, t_max 2
    s), with no and with two resample passes, and the entry point
    ``choice_model_simulator_torch`` on the same trials at its default grid
    the same two ways: choices in {-1, 0, 1} (-1: invalid), of their shape
    and dtype, the resampled runs with no more invalid trials than the
    single pass; ``simulate_session_data_7p`` for one session of
    VARIANT_7P_TRIALS trials (K1's per-trial noise-scale instances), finite.
    K1 launched. (K1's per-trial noise scale itself:
    ``test_k1_per_trial_noise_scale``.)"""
    from sbi_for_diffusion_models_tpu_torch.distributions import BoxUniform
    from sbi_for_diffusion_models_tpu_torch.models import choice_model_simulator_torch
    from sbi_for_diffusion_models_tpu_torch.models.pulse_ddm_7p import simulate_session_data_7p
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_choice_scan

    def run():
        theta = BoxUniform(SNPE_LO, SNPE_HI).sample(make_generator(0, DEV), (VARIANT_THETAS,))
        theta = theta.repeat_interleave(VARIANT_REPS, 0)
        invalid = {}
        for passes in (0, 2):
            x = ddm_choice_scan(theta, 1, max_resamples=passes, **CHOICE_GRID)
            assert tuple(x.shape) == (theta.shape[0],) and set(x.unique().tolist()) <= {-1, 0, 1}
            invalid["scan", passes] = float((x < 0).double().mean())
            x = choice_model_simulator_torch(theta, 1, resample_invalid=passes > 0, max_resamples=2)
            assert tuple(x.shape) == (theta.shape[0], 1) and x.dtype == torch.float32
            assert set(x.unique().tolist()) <= {-1.0, 0.0, 1.0}
            invalid["entry point", passes] = float((x < 0).double().mean())
        assert all(invalid[k, 2] <= invalid[k, 0] for k in ("scan", "entry point")), invalid
        x7 = simulate_session_data_7p(torch.tensor([0.5, 0.3, 1.5, 8.0, 1.0, 0.1, 0.5], device=DEV),
                                      VARIANT_7P_TRIALS, 2)
        assert tuple(x7.shape) == (VARIANT_7P_TRIALS, 2) and bool(torch.isfinite(x7).all())

    _, launches = _launches(run)
    _launched(launches, ("ddm_rt_choice",))


def _hierarchical_setup(device):
    """The coverage configuration's data (``artifacts/hierarchical_coverage_pt_a.json``):
    its model loaded, the hyperprior moment-matched, and its datasets of
    subjects x trials drawn from the exact hyperprior (hyper_shrink 1) and
    simulated on K1."""
    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import HierarchicalModel, simulate_hierarchical_sessions

    conf = json.loads((ROOT / "artifacts" / "hierarchical_coverage_pt_a.json").read_text())
    est = load_model(str(MODELS / conf["model_file"]), device=device)
    prior = build_prior_theta()
    model = HierarchicalModel.from_prior(prior, device=device)
    sims = [simulate_hierarchical_sessions(prior, conf["subjects"], conf["trials"], model=model,
                                           seed=conf["seed"] + 1000 + r, hyper_shrink=1.0) for r in range(conf["reps"])]
    return conf, est, prior, model, torch.stack([s[1] for s in sims]), torch.stack([s[2] for s in sims])


def _run_hierarchical(mesh=None, device=DEV):
    """``run_hierarchical_inference`` at the coverage configuration, warmup
    HIER_WARMUP, HIER_DRAWS draws a chain, trees capped at HIER_TREE_DEPTH,
    on ``device``, on ``mesh`` or unsharded: (setup, output)."""
    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import run_hierarchical_inference

    setup = conf, est, prior, model, xs, ps = _hierarchical_setup(device)
    out = run_hierarchical_inference(est, prior, xs, ps, model=model, num_chains=conf["chains"],
                                     num_warmup=HIER_WARMUP, num_samples=HIER_DRAWS, max_tree_depth=HIER_TREE_DEPTH,
                                     pt_replicas=conf["pt_replicas"], pt_beta_min=conf["pt_beta_min"],
                                     segment_length=8, seed=HIER_SEED, mesh=mesh, verbose=False)
    return setup, out


def test_hierarchical_path(monkeypatch):
    """The hierarchical path at the coverage configuration
    (``mnle_1m_censor.npz``, 4 datasets x 4 subjects x 20 trials, 4 chains x
    6 rungs in one sampler launch): K1 and K3 launched, every K3 launch at
    the fold's B*C*R*S*T = 7,680 rows, the outputs of their shapes inside
    the prior's support. Then K2/K3 on the rows of its first K3 call
    (``hold_rows``), and the fold's first value-and-gradient call (closed
    form around one K3 launch) against autograd through the plain row
    function: each row's value to 1e-4 and its gradient to 1e-3 x max(1, its
    largest |ref|). (The leaf kernel at every leaf:
    ``test_hierarchical_run_at_64_subjects_takes_the_kernel_at_every_leaf``;
    no density pair: ``test_the_hierarchical_path_makes_no_density_launch``.)"""
    from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu_torch.inference.nuts import geometric_ladder
    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import _hierarchical_density

    with _k3_rows(monkeypatch) as (seen, k3_first):
        ((conf, est, prior, model, xs, ps), out), launches = _launches(_run_hierarchical)
    _launched(launches, ("ddm_rt_choice", "mnle_logprob_bwd"))
    B, S, T = xs.shape[:3]
    C, R = conf["chains"], conf["pt_replicas"]
    rows = B * C * R * S * T
    assert set(seen) == {rows} and len(seen) == launches["mnle_logprob_bwd"]
    theta = out["theta_subjects"]
    assert theta.shape == (B, C * HIER_DRAWS, S, 5) and out["raw"].shape[:3] == (B, C, HIER_DRAWS)
    assert bool(torch.isfinite(prior.log_prob(torch.from_numpy(theta.reshape(-1, 5)))).all())
    k3_rows, w, g = k3_first[rows]
    hold_rows(w, k3_rows, g)

    # The fold's first call: the sampler's starting rows, as run_hierarchical_inference makes them.
    bij = mcmc_transform(prior)
    D, dim = model.theta_dim, model.dim(S)
    center = torch.cat([model.mu_loc, model.log_tau_loc, torch.zeros(S * D, device=DEV)])
    scale = torch.cat([model.mu_scale, model.log_tau_scale, torch.ones(S * D, device=DEV)])
    q = center + 0.1 * scale * torch.randn((B * C * R, dim), generator=make_generator(child_seed(HIER_SEED, 0), DEV),
                                           device=DEV)
    data = (torch.arange(B, device=DEV).repeat_interleave(C * R),
            torch.as_tensor(geometric_ladder(R, conf["pt_beta_min"]), device=DEV).repeat(B * C))
    value, grad = _hierarchical_density(model, bij, est, xs, ps)[2](q, data)
    logp_plain, _, none = _hierarchical_density(model, bij, est, xs, ps, logprob_kernel="xla")
    q_ = q.clone().requires_grad_(True)
    v_auto = logp_plain(q_, data)
    (g_auto,) = torch.autograd.grad(v_auto.sum(), q_)
    v_auto = v_auto.detach()
    assert none is None and bool(torch.isfinite(grad).all())
    assert float(((value - v_auto).abs() / v_auto.abs().clamp(min=1.0)).max()) <= 1e-4
    assert float(((grad - g_auto).abs().amax(1) / g_auto.abs().amax(1).clamp(min=1.0)).max()) <= 1e-3


def test_snpe_and_snle_path():
    """SNPE and SNLE at the example's shape (``examples/snpe_snle_choice_model.py``):
    the BoxUniform prior, SNPE_THETAS thetas, x the mean choice over
    VARIANT_REPS trials of the choice-only simulator (K1) with two resample
    passes; ``train_snpe`` and ``train_snle`` with their epochs capped at
    SNPE_EPOCHS, each validation loss falling below its first epoch's;
    ``DirectPosterior.sample`` of SNPE_DRAWS draws, all inside the prior's
    support; and a short ``make_posterior(x_o)`` NUTS run (4 chains, warmup
    SNPE_WARMUP, SNPE_CHAIN_DRAWS draws a chain, trees capped at depth 6)
    inside it too. K1 and the leaf kernel launched."""
    from sbi_for_diffusion_models_tpu_torch.distributions import BoxUniform
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_choice_scan
    from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS
    from sbi_for_diffusion_models_tpu_torch.snpe import train_snle, train_snpe

    cfg = RUN_CONFIG_PARAMS.replace(TRAIN_MAX_EPOCHS=SNPE_EPOCHS, TRAIN_STOP_AFTER_EPOCHS=12, TRAIN_BATCH_SIZE=1024,
                                    NUM_CHAINS=4, WARMUP_STEPS=SNPE_WARMUP, MCMC_MAX_TREE_DEPTH=6)
    prior = BoxUniform(SNPE_LO, SNPE_HI)

    def run():
        theta = prior.sample(make_generator(0, DEV), (SNPE_THETAS,))
        choices = ddm_choice_scan(theta.repeat_interleave(VARIANT_REPS, 0), 1, max_resamples=2, **CHOICE_GRID)
        x = choices.reshape(SNPE_THETAS, VARIANT_REPS).to(torch.float32).mean(1, keepdim=True)
        x_o = ddm_choice_scan(torch.tensor([0.5, 0.3, 1.5, 8.0, 0.1], device=DEV).repeat(VARIANT_REPS, 1), 2,
                              max_resamples=2, **CHOICE_GRID).to(torch.float32).reshape(1, VARIANT_REPS).mean(1, True)
        post = train_snpe(cfg, prior, theta, x, seed=3)
        draws = post.sample((SNPE_DRAWS,), x_o[0], seed=4)
        flow, make_posterior = train_snle(cfg, prior, theta, x, seed=5)
        nle = make_posterior(x_o).sample((4 * SNPE_CHAIN_DRAWS,), seed=6)
        return draws, nle, (post.flow.train_meta, flow.train_meta)

    (draws, nle, metas), launches = _launches(run)
    _launched(launches, ("ddm_rt_choice", *NUTS))
    assert tuple(draws.shape) == (SNPE_DRAWS, 5) and bool(torch.isfinite(prior.log_prob(draws)).all())
    assert tuple(nle.shape) == (4 * SNPE_CHAIN_DRAWS, 5) and bool(torch.isfinite(prior.log_prob(nle)).all())
    assert all(m["best_val_loss"] < m["val_losses"][0] for m in metas), metas


def _md_sbc(mesh, outdir: str):
    """The multi-device path's SBC fold (``run_sbc`` on the flagship under
    ``CALIBRATED_CONFIG``: 8 datasets, warmup MD_WARMUP, MD_DRAWS draws,
    trees capped at MD_TREE_DEPTH), on ``mesh`` or unsharded: (pooled draws
    (8, MD_DRAWS, 5), potential calls)."""
    cfg = CALIBRATED_CONFIG.replace(SBC_NUM_DATASETS=8, WARMUP_STEPS=MD_WARMUP, SBC_POST_SAMPLES=MD_DRAWS,
                                    MCMC_MAX_TREE_DEPTH=MD_TREE_DEPTH)
    est = load_model(str(MODELS / MODEL_FILE), device=torch.device("cuda", torch.cuda.current_device()))
    out = tmnle.run_sbc(cfg, build_prior_theta(), est, est.device, outdir=outdir, seed=13, verbose=False, mesh=mesh)
    return np.stack(out["all_samples"]), out["potential_calls"]


def _md_k1_inputs(device):
    """(theta, stimulus, n_max, steps_per_pulse): N_SIM prior draws (seed
    41), the multi-device path's K1 batch."""
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )

    n_max, spp = pulse_schedule()
    gen = make_generator(41, device)
    theta = build_prior_theta().sample(gen, (N_SIM,))
    return theta, generate_pulse_matrix(gen, N_SIM, n_pulses_max_from_schedule(n_max, spp)), n_max, spp


def md_rank(outdir: str) -> dict:
    """A rank of the multi-device world (gloo ranks sharing the card, or
    NCCL ranks one a card): K1 at N_SIM trials in the ranks' blocks
    (``sharded_simulate``), the SBC fold of ``_md_sbc`` and the hierarchical
    fold of ``_run_hierarchical`` split over the ranks, and
    ``dryrun_multichip``; returns the rank's launches and calls, and rank 0
    also the gathered outputs."""
    import torch.distributed as dist

    from sbi_for_diffusion_models_tpu_torch.graft_entry import dryrun_multichip
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.parallel.mesh import default_mesh, sharded_simulate

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()

    def run():
        theta, s, n_max, spp = _md_k1_inputs(device)
        x = sharded_simulate(ddm_rt_choice_cuda, theta, s, 41, mesh=default_mesh(world, "data"), n_max=n_max,
                             steps_per_pulse=spp)
        chains = default_mesh(world, "chains")
        draws, calls = _md_sbc(chains, outdir)
        _, hier = _run_hierarchical(chains, device)
        dryrun_multichip(world, device=device)
        return x, draws, calls, hier

    (x, draws, calls, hier), launches = _launches(run)
    out = {"launches": launches, "calls": calls, "hier_calls": hier["info"]["potential_calls"]}
    if dist.get_rank() == 0:
        out.update(k1=x.cpu().numpy(), draws=draws, hier=hier["raw"])
    return out


def test_multidevice_path(tmp_path):
    """``parallel/`` on the cards this host has. (a) An NCCL world of one in
    this process (a ``FileStore``, no port): ``dryrun_multichip(1)``, the
    SBC fold of ``_md_sbc`` through ``run_sbc(mesh=...)`` and the
    hierarchical fold through ``run_hierarchical_inference(mesh=...)``,
    their draws and calls equal to the unsharded calls' bit for bit. (b)
    MD_RANKS ranks started with a deadline (``launch_local``): over NCCL, one
    a card, where the host has MD_RANKS cards, else sharing the card over
    gloo (NCCL refuses two ranks on one card). K1's blocks, one a rank, equal
    one unsharded launch bit for bit; the ranks make the same calls; the SBC
    fold's and the hierarchical fold's draws are finite. K1, K2, K3, the leaf
    kernel and the density pair launched on the sharded paths, summed over
    (a) and the ranks. (K1's trial offsets themselves:
    ``test_k1_blocks_with_their_offsets_equal_one_launch``.)"""
    import torch.distributed as dist

    from sbi_for_diffusion_models_tpu_torch.graft_entry import dryrun_multichip
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.parallel.mesh import default_mesh
    from sbi_for_diffusion_models_tpu_torch.parallel.multihost import init_group, launch_local

    ref, ref_calls = _md_sbc(None, str(tmp_path / "ref"))
    _, hier_ref = _run_hierarchical()

    init_group(1, 0, store=dist.FileStore(str(tmp_path / "store"), 1), device=DEV)
    try:
        def world_of_one():
            dryrun_multichip(1)
            mesh = default_mesh(1, "chains")
            return _md_sbc(mesh, str(tmp_path / "one")), _run_hierarchical(mesh)[1]

        ((one, one_calls), hier_one), launches = _launches(world_of_one)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(one, ref) and one_calls == ref_calls
    assert np.array_equal(hier_one["raw"], hier_ref["raw"])

    backend = "nccl" if torch.cuda.device_count() >= MD_RANKS else "gloo"
    theta, s, n_max, spp = _md_k1_inputs(DEV)
    whole = ddm_rt_choice_cuda(theta, s, 41, n_max=n_max, steps_per_pulse=spp).cpu().numpy()
    ranks = launch_local(md_rank, MD_RANKS, (str(tmp_path / "ranks"),), device="cuda", backend=backend,
                         timeout_s=MD_DEADLINE_S)
    assert np.array_equal(ranks[0]["k1"], whole)
    assert len({(r["calls"], r["hier_calls"]) for r in ranks}) == 1
    assert np.isfinite(ranks[0]["draws"]).all() and np.isfinite(ranks[0]["hier"]).all()
    total = {k: launches[k] + sum(r["launches"][k] for r in ranks) for k in launches}
    _launched(total, ("ddm_rt_choice", "mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY))
