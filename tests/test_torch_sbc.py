"""PyTorch port: simulation-based calibration (``mnle.run_sbc``).

The fold's potential (every dataset x chain x replica row carrying its own
session and beta) against the JAX package's fold density (``mnle.py``'s
``_ll``/``logp``, built here from its public pieces) for the shifted-log and
pulse-grid reps, and the kernel wrapper each call reaches; the host-side
statistics against the JAX functions exactly; the fold against
single-session sampling in distribution; then one counterpart of each test
of ``tests/test_sbc.py``, on the CPU, where the kernel wrappers take their
plain versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu import analysis as janalysis
from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu.inference.nuts import geometric_ladder as j_ladder
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig as JConfig
from sbi_for_diffusion_models_tpu.nets.mnle_net import build_mnle as jbuild_mnle
from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta as j_prior
from sbi_for_diffusion_models_tpu_torch import analysis as tanalysis
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle, mnle_from_flax_params
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS

TINY = dict(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=5)
REPS = {
    "shifted_log": dict(rt_rep="shifted_log", censor_rt=True, log_condition_dims=(1, 2, 3), cond_affine=True),
    "pulse": dict(rt_rep="pulse", censor_rt=True),  # absolute anchor
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor operations; with several threads
    each, the test workers running beside them make them many times slower.
    One thread is as fast alone and keeps its pace under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The fold's potential against the JAX fold density
# ---------------------------------------------------------------------------
def _jax_and_port_estimators(rep):
    """A tiny JAX MNLE of ``rep`` with standardization stats that are not
    the identity, and the same model carried across to the port."""
    cfg = JConfig(**TINY, **REPS[rep])
    est = jbuild_mnle(jax.random.key(3), cfg)
    rng = np.random.default_rng(4)
    est = est.__class__(
        cfg=cfg, params=est.params,
        cond_mean=jnp.asarray(0.2 * rng.normal(size=85), jnp.float32),
        cond_std=jnp.asarray(rng.uniform(0.6, 1.6, 85), jnp.float32),
        x_mean=jnp.float32(-0.4), x_std=jnp.float32(1.3), train_meta=None,
    )
    tree = jax.tree.map(np.asarray, est.params)
    port = mnle_from_flax_params(MNLEConfig(**cfg.__dict__), tree, est.cond_mean, est.cond_std, est.x_mean,
                                 est.x_std, device="cpu")
    return est, port


def _fold_inputs(G=3, C=2, R=3, T=7, seed=5):
    """G different sessions (numpy: RTs after a per-session onset, some
    trials censored at the 8 s window end), and for the G x C x R rows
    thetas in the prior's bulk with onsets below each session's first RT,
    and the rows' betas (a geometric ladder, cold rung first)."""
    rng = np.random.default_rng(seed)
    onset = np.array([0.12, 0.3, 0.55])[:G]
    choice = rng.choice([0.0, 1.0, 2.0], (G, T), p=[0.45, 0.4, 0.15])
    rt = np.where(choice == 2.0, 8.0, onset[:, None] + 0.02 + rng.gamma(2.0, 0.3, (G, T)))
    x = np.stack([rt, choice], -1).astype(np.float32)
    s = np.where(rng.random((G, T, 80)) < 0.5, 1.0, -1.0).astype(np.float32)
    N = G * C * R
    tnd = np.repeat(onset, C * R) * rng.uniform(0.2, 0.95, N)
    theta = np.stack([rng.uniform(0.2, 0.8, N), rng.lognormal(-1, 0.5, N), rng.lognormal(0, 0.5, N),
                      rng.lognormal(2.75, 0.3, N), tnd], -1).astype(np.float32)
    betas = np.tile(j_ladder(R, 0.1), G * C).astype(np.float32)
    return x, s, theta, betas, C * R


def _jax_fold(jest, x, s, theta, betas, reps, temperature):
    """The JAX fold's ``logp`` and its u-gradient per row, written as
    ``mnle.py`` writes it: data = (x_o, s_o, beta) per row."""
    prior = j_prior()
    bij = jd.mcmc_transform(prior)
    lp_fn = jest.dispatch_log_prob("xla")

    def _ll(u, data):
        x_o, s_o = data[0], data[1]
        th = bij.forward(u)
        cond = jnp.concatenate([jnp.broadcast_to(th, (s_o.shape[0], th.shape[-1])), s_o], axis=-1)
        return jnp.sum(lp_fn(x_o, cond)) / temperature

    def logp(u, data):
        th = bij.forward(u)
        lp = prior.log_prob(th) + bij.forward_log_det(u)
        return lp + data[2] * _ll(u, data)

    data = (jnp.repeat(jnp.asarray(x), reps, axis=0), jnp.repeat(jnp.asarray(s), reps, axis=0), jnp.asarray(betas))
    u = bij.inverse(jnp.asarray(theta))
    v, g = jax.jit(jax.vmap(jax.value_and_grad(logp)))(u, data)
    return np.asarray(u), np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_fold_potential_matches_the_jax_fold_and_takes_one_launch(rep, monkeypatch):
    """Three datasets x 2 chains x 3 replicas, each dataset its own session,
    each row its own beta: the fold's value (rtol 1e-4) and u-gradient (rtol
    1e-3, atol 1e-3 x max |g|) against JAX's. A gradient call reaches the
    combined value-and-VJP wrapper once and no other kernel wrapper; a
    value-only call (the t_nd slice, the replica exchange) the value wrapper
    once."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    jest, est = _jax_and_port_estimators(rep)
    x, s, theta, betas, reps = _fold_inputs()
    cfg = RUN_CONFIG_PARAMS.replace(TEMPERATURE=1.5, MNLE_RT_REP=rep, MNLE_CENSOR_RT=True)
    u, ref_v, ref_g = _jax_fold(jest, x, s, theta, betas, reps, cfg.TEMPERATURE)

    prior = build_prior_theta()
    logp, ll, vg = tmnle._fold_density(cfg, prior, mcmc_transform(prior), est, torch.from_numpy(x),
                                       torch.from_numpy(s))
    sessions = torch.arange(x.shape[0]).repeat_interleave(reps)
    data = (sessions, torch.from_numpy(betas))

    names = ("rows_logp", "rows_logp_and_vjp", "rows_logp_vjp", "rows_logp_pulse", "rows_logp_pulse_and_vjp",
             "rows_logp_pulse_vjp")
    calls = dict.fromkeys(names, 0)

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in names:
        monkeypatch.setattr(mc, name, counted(name, getattr(mc, name)))
    suffix = "_pulse" if rep == "pulse" else ""
    uu = torch.from_numpy(u)
    val, g = vg(uu, data)
    assert calls == {**dict.fromkeys(names, 0), f"rows_logp{suffix}_and_vjp": 1}
    calls.update(dict.fromkeys(names, 0))
    val_only, none = vg(uu, data, need_grad=False)
    assert none is None and calls == {**dict.fromkeys(names, 0), f"rows_logp{suffix}": 1}

    assert np.isfinite(ref_v).all() and np.isfinite(ref_g).all()
    np.testing.assert_allclose(val.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(val_only.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    # The autograd density the sampler falls back to is the same function.
    np.testing.assert_allclose(logp(uu, data).numpy(), ref_v, rtol=1e-4)
    # ll is the untempered term beta multiplies: logp at beta 0 plus ll.
    zero = (sessions, torch.zeros(len(betas)))
    np.testing.assert_allclose((logp(uu, zero) + ll(uu, data)).numpy(), logp(uu, (sessions, torch.ones(len(betas))))
                               .numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# Host-side statistics, exactly as the JAX package computes them
# ---------------------------------------------------------------------------
def test_host_statistics_and_pooling_equal_the_jax_functions():
    rng = np.random.default_rng(12)
    samples = rng.normal(size=(40, 5))
    theta = rng.normal(size=5)
    np.testing.assert_array_equal(tmnle._compute_ranks(samples, theta), jmnle._compute_ranks(samples, theta))
    np.testing.assert_array_equal(tmnle._compute_ranks([[0.1, 5.0], [0.2, 4.0], [0.3, 3.0]], [0.25, 10.0]), [2, 3])

    ranks = rng.integers(0, 61, (23, 5))
    assert tanalysis.sbc_uniformity_stats(ranks, 60) == janalysis.sbc_uniformity_stats(ranks, 60)
    for n in (1, 8, 96):
        for got, want in zip(tanalysis._ecdf_band(n, n_sim=300), janalysis._ecdf_band(n, n_sim=300)):
            np.testing.assert_array_equal(got, want)

    # Pooling: mnle.py's (G, C, S, dim) -> swapaxes(1, 2) -> (G, C*S, dim) -> first post_samples.
    G, C, S, dim, post = 3, 4, 7, 5, 25
    cold = rng.normal(size=(G, C, S, dim))
    want = cold.swapaxes(1, 2).reshape(G, C * S, -1)[:, :post]
    np.testing.assert_array_equal(tmnle._pooled(cold, post), want)
    for gi in range(G):  # the remediation's per-dataset form
        np.testing.assert_array_equal(tmnle._pooled(cold[gi], post), cold[gi].swapaxes(0, 1).reshape(C * S, -1)[:post])


@pytest.mark.parametrize("log_rt", [False, True])
def test_min_rt_tau_init_lies_below_the_session_onset_bound(log_rt):
    """The remediation's t_nd starts: within [1e-3, min(0.98, 0.95 x the
    session's smallest RT)] (exactly 1e-3 where that bound lies below
    1e-3), RTs read through exp under LOG_RT_MANUALLY, the other columns
    untouched; sessions whose smallest RT is tiny or large reach both clip
    bounds."""
    rng = np.random.default_rng(7)
    Gl, T, reps = 5, 12, 6
    rt = rng.uniform(0.3, 3.0, (Gl, T))
    rt[0, 3] = 5e-4  # 0.95 x 5e-4 < 1e-3: clipped up
    rt[1] += 30.0  # 0.95 x min rt > 0.98: clipped down
    x_g = np.stack([np.log(rt) if log_rt else rt, rng.integers(0, 3, (Gl, T))], -1).astype(np.float32)
    theta = build_prior_theta().sample(torch.Generator().manual_seed(1), (Gl * reps,))
    out = tmnle._min_rt_tau_init(theta, torch.from_numpy(x_g), reps, log_rt, torch.Generator().manual_seed(2))
    tau = out[:, 4].numpy()
    min_rt = np.repeat(rt.min(1), reps)
    assert (tau >= np.float32(1e-3)).all()
    assert (tau <= np.maximum(np.float32(1e-3), np.minimum(0.98, 0.95 * min_rt) * (1 + 1e-6))).all()
    assert (tau[:reps] == np.float32(1e-3)).all() and (tau[reps:2 * reps] == np.float32(0.98)).all()
    assert torch.equal(out[:, :4], theta[:, :4])


# ---------------------------------------------------------------------------
# The fold against single-session sampling
# ---------------------------------------------------------------------------
def test_fold_of_two_sessions_agrees_with_each_session_sampled_alone():
    """Two sessions with far-apart onsets folded into one launch: each
    dataset's pooled draws agree in distribution with ``run_inference_mcmc``
    on that session alone (two-sample KS per dimension, p > 1e-3), and the
    t_nd draws respect their own session's smallest RT. A dataset/chain
    mix-up fails on t_nd."""
    _, est = _jax_and_port_estimators("shifted_log")
    rng = np.random.default_rng(21)
    T = 6
    rt = np.stack([0.15 + rng.gamma(2.0, 0.2, T), 0.8 + rng.gamma(2.0, 0.2, T)])
    x = np.stack([rt, rng.integers(0, 2, (2, T))], -1).astype(np.float32)
    s = np.where(rng.random((2, T, 80)) < 0.5, 1.0, -1.0).astype(np.float32)
    # Many short chains: the pooled draws of 64 chains are close to
    # independent, which the KS test assumes.
    per_chain = 12
    cfg = RUN_CONFIG_PARAMS.replace(NUM_CHAINS=64, MCMC_MAX_TREE_DEPTH=4, MNLE_RT_REP="shifted_log",
                                    MNLE_CENSOR_RT=True, POSTERIOR_SAMPLES=64 * per_chain, WARMUP_STEPS=40)
    prior = build_prior_theta()
    cold = tmnle._sbc_launch(cfg, prior, est, torch.from_numpy(x), torch.from_numpy(s), 11, 12, cfg.WARMUP_STEPS,
                             j_ladder(1, 0.1), per_chain, tmnle._mode_hop(cfg, mcmc_transform(prior)))[0]
    pooled = tmnle._pooled(cold, cfg.POSTERIOR_SAMPLES)
    for d in range(2):
        alone = tmnle.run_inference_mcmc(cfg, prior, est, x[d], s[d], "cpu", seed=30 + d, verbose=False).numpy()
        assert pooled[d, :, 4].max() < rt[d].min() and alone[:, 4].max() < rt[d].min()
        p = [stats.ks_2samp(pooled[d, :, k], alone[:, k]).pvalue for k in range(5)]
        assert min(p) > 1e-3, (d, p)
    assert stats.ks_2samp(pooled[0, :, 4], pooled[1, :, 4]).pvalue < 1e-6  # the sessions' posteriors differ


# ---------------------------------------------------------------------------
# Counterparts of tests/test_sbc.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_setup():
    prior = build_prior_theta()
    est = build_mnle(0, MNLEConfig(**TINY), device="cpu")
    cfg = RUN_CONFIG_PARAMS.replace(
        NUM_TRIALS_OBS=5, NUM_CHAINS=2, WARMUP_STEPS=25,
        SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20, MCMC_MAX_TREE_DEPTH=4,
        # The untrained tiny estimator leaves chains unmixed, which would
        # trip the mixing gate and re-run every dataset; the gate has its
        # own tests below.
        SBC_REMEDIATE=False,
    )
    return prior, est, cfg


def _in_support(s):
    assert np.isfinite(s).all()
    assert (s[:, 0] > 0).all() and (s[:, 0] < 1).all()
    assert (s[:, 1:4] > 0).all()
    assert (s[:, 4] > 0).all() and (s[:, 4] < 1).all()


def test_torch_run_sbc_batched_shapes_and_files(tiny_setup, tmp_path):
    prior, est, cfg = tiny_setup
    (tmp_path / "partial_summary.json").write_text("{}")  # a stale partial of another run
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    assert out["ranks"].shape == (2, 5) and out["thetas_true"].shape == (2, 5)
    assert (out["ranks"] >= 0).all() and (out["ranks"] <= 20).all()
    assert len(out["all_samples"]) == 2 and out["all_samples"][0].shape == (20, 5)
    for f in ("sbc_thetas_true.npy", "sbc_ranks.npy", "sbc_samples.npy", "sbc_mixing_diagnostics.npz",
              "sbc_rank_histograms.png", "sbc_ecdf.png"):
        assert (tmp_path / f).exists(), f
    _in_support(out["all_samples"][0])
    np.testing.assert_array_equal(np.load(tmp_path / "sbc_samples.npy"), np.stack(out["all_samples"]))
    assert np.load(tmp_path / "sbc_samples.npy").dtype == np.float32
    np.testing.assert_array_equal(np.load(tmp_path / "sbc_ranks.npy"), out["ranks"])
    np.testing.assert_array_equal(out["ranks"], [tmnle._compute_ranks(sm, th)
                                                 for sm, th in zip(out["all_samples"], out["thetas_true"])])
    div = np.asarray(out["divergences_per_dataset"])
    assert div.shape == (2,) and np.isfinite(div).all() and (div >= 0).all()
    assert "divergences" in np.load(tmp_path / "sbc_mixing_diagnostics.npz")
    assert out["potential_calls"] > 0
    partial = json.loads((tmp_path / "partial_summary.json").read_text())
    assert partial["datasets_done"] == partial["datasets_total"] == 2
    assert len(partial["rhat_max_per_dataset"]) == 2
    np.testing.assert_array_equal(np.load(tmp_path / "sbc_ranks.partial.npy"), out["ranks"])


def test_torch_run_sbc_serial_matches_interface(tiny_setup, tmp_path):
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(SBC_NUM_DATASETS=1, SBC_POST_SAMPLES=10, WARMUP_STEPS=15)
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False, batched=False)
    assert out["ranks"].shape == (1, 5) and out["all_samples"][0].shape == (10, 5)
    assert (tmp_path / "sbc_ranks.npy").exists() and (tmp_path / "sbc_rank_histograms.png").exists()


def test_torch_run_sbc_batched_with_slice(tiny_setup, tmp_path):
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(MCMC_METHOD="slice", SBC_NUM_DATASETS=1, SBC_POST_SAMPLES=10, WARMUP_STEPS=10)
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    assert out["ranks"].shape == (1, 5)
    _in_support(out["all_samples"][0])
    assert np.isnan(out["divergences_per_dataset"]).all()  # slice has no divergences


def test_run_id_guard_clears_another_runs_checkpoints_and_keeps_its_own(tiny_setup, tmp_path):
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(SBC_NUM_DATASETS=1, SBC_POST_SAMPLES=10, WARMUP_STEPS=10)
    stale = tmp_path / "nuts_ckpt" / "group_0"
    stale.mkdir(parents=True)
    (tmp_path / "nuts_ckpt" / "run_id.txt").write_text("another run")
    (stale / "leftover").write_text("")
    first = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    assert not (stale / "leftover").exists()
    run_id = (tmp_path / "nuts_ckpt" / "run_id.txt").read_text()
    ckpt = stale / "nuts_segments.npz"
    with np.load(ckpt) as blob:
        assert int(blob["next_segment"]) == 1  # 15 transitions: one segment of 50
    written = ckpt.read_bytes()
    # The same arguments: the checkpoint is kept and replayed, without a potential call.
    again = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    assert (tmp_path / "nuts_ckpt" / "run_id.txt").read_text() == run_id and ckpt.read_bytes() == written
    assert again["potential_calls"] == 0 and first["potential_calls"] > 0
    np.testing.assert_array_equal(again["ranks"], first["ranks"])
    # Another seed is another run: its guard clears the directory.
    tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=1, verbose=False)
    assert (tmp_path / "nuts_ckpt" / "run_id.txt").read_text() != run_id


class _Cut(Exception):
    """Stands for the process being killed."""


def test_a_cut_run_sbc_resumes_to_the_uninterrupted_ranks(tiny_setup, tmp_path, monkeypatch, capsys):
    """Two groups of one dataset, each sampler run in segments of 10
    transitions (35 in all); the run is cut inside the second group and run
    again in the same ``outdir``: the first group replays from its finished
    checkpoint, the second resumes at its last segment, and the ranks and
    draws are the uninterrupted run's."""
    prior, est, cfg = tiny_setup
    real, cut_after = tmnle.run_nuts, [None]

    def short_segments(*a, **kw):
        kw["segment_length"] = 10
        if cut_after[0] is not None and kw["checkpoint_dir"].endswith("group_1"):
            vg, n = kw["value_and_grad_fn"], [0]

            def vg_cut(u, data, need_grad=True):
                n[0] += 1
                if n[0] > cut_after[0]:
                    raise _Cut
                return vg(u, data, need_grad)

            kw["value_and_grad_fn"] = vg_cut
        return real(*a, **kw)

    monkeypatch.setattr(tmnle, "run_nuts", short_segments)
    full = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path / "full", seed=3, verbose=False, group_size=1)
    cut_after[0] = full["potential_calls"] // 4  # about half of the second group's calls
    with pytest.raises(_Cut):
        tmnle.run_sbc(cfg, prior, est, outdir=tmp_path / "cut", seed=3, verbose=False, group_size=1)
    with np.load(tmp_path / "cut" / "nuts_ckpt" / "group_1" / "nuts_segments.npz") as blob:
        done = int(blob["next_segment"])
    assert 0 < done < 4
    cut_after[0] = None
    capsys.readouterr()
    resumed = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path / "cut", seed=3, verbose=False, group_size=1)
    out = capsys.readouterr().out
    assert "[run_nuts] resumed at segment 4/4" in out and f"[run_nuts] resumed at segment {done}/4" in out
    np.testing.assert_array_equal(resumed["ranks"], full["ranks"])
    np.testing.assert_array_equal(np.stack(resumed["all_samples"]), np.stack(full["all_samples"]))
    assert 0 < resumed["potential_calls"] < full["potential_calls"] // 2


def test_torch_run_sbc_batched_with_pulse_rep(tmp_path):
    """SBC with the pulse-grid RT representation: the potential, the
    sampler's closed-form gradients through the phase features, and the
    rank statistics compose."""
    prior = build_prior_theta()
    est = build_mnle(5, MNLEConfig(**TINY, rt_rep="pulse", censor_rt=True), device="cpu")
    cfg = RUN_CONFIG_PARAMS.replace(
        NUM_TRIALS_OBS=5, NUM_CHAINS=2, WARMUP_STEPS=25, SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20,
        MCMC_MAX_TREE_DEPTH=4, MNLE_RT_REP="pulse", MNLE_CENSOR_RT=True, SBC_REMEDIATE=False,
    )
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    assert out["ranks"].shape == (2, 5)
    _in_support(out["all_samples"][0])


def test_torch_run_sbc_batched_with_parallel_tempering(tiny_setup, tmp_path):
    """MCMC_PT_REPLICAS > 1: only cold-rung draws enter the ranks; the
    per-dataset mixing diagnostics land in the output and on disk."""
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(SBC_NUM_DATASETS=3, SBC_POST_SAMPLES=20, WARMUP_STEPS=20, MCMC_PT_REPLICAS=2,
                      MCMC_PT_BETA_MIN=0.3)
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False, group_size=2)
    assert out["ranks"].shape == (3, 5)  # two groups, the second padded by wrap-around
    assert (out["ranks"] >= 0).all() and (out["ranks"] <= 20).all()
    assert out["all_samples"][2].shape == (20, 5)
    _in_support(out["all_samples"][0])
    assert out["rhat_max"].shape == out["min_ess"].shape == (3,)
    assert np.isfinite(out["rhat_max"]).all()
    assert out["swap_accept"] is not None and len(out["swap_accept"]) == 2
    assert all(0.0 <= a <= 1.0 for a in out["swap_accept"])
    blob = np.load(tmp_path / "sbc_mixing_diagnostics.npz")
    np.testing.assert_array_equal(blob["rhat_max"], out["rhat_max"])
    np.testing.assert_array_equal(blob["min_ess"], out["min_ess"])


def test_torch_run_sbc_pt_rejects_slice(tiny_setup, tmp_path):
    prior, est, cfg = tiny_setup
    with pytest.raises(ValueError, match="PT_REPLICAS"):
        tmnle.run_sbc(cfg.replace(MCMC_METHOD="slice", MCMC_PT_REPLICAS=2), prior, est, outdir=tmp_path, seed=0,
                      verbose=False)


def test_torch_sbc_mixing_gate_remediation(tiny_setup, tmp_path):
    """With an impossible gate every dataset is flagged, the remediation
    pass re-runs them with doubled warmup, substitutes the draws and
    records the diagnostics before and after; flagged_final lands in the
    npz."""
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20, WARMUP_STEPS=15, SBC_RHAT_GATE=-1.0,
                      SBC_REMEDIATE=True, SBC_REMEDIATE_ROUNDS=1)
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    rem = out["remediation"]
    assert rem["flagged"] == [0, 1] and rem["remediated"] == [0, 1]
    assert rem["warmup"] == 30
    assert len(rem["rhat_before"]) == len(rem["rhat_after"]) == 2
    assert rem["still_flagged"] == [0, 1]  # the gate is impossible
    assert len(rem["rounds"]) == 1
    assert out["flagged_final"] == [0, 1]
    assert out["ranks"].shape == (2, 5) and out["all_samples"][0].shape == (20, 5)
    _in_support(out["all_samples"][0])
    np.testing.assert_array_equal(np.load(tmp_path / "sbc_mixing_diagnostics.npz")["flagged_final"], [0, 1])


def test_torch_sbc_remediation_substitutes_draws(tiny_setup, tmp_path):
    """The remediation pass replaces the flagged datasets' draws (fresh
    streams and doubled warmup), and SBC_REMEDIATE=False leaves the main
    pass's draws, which are the same in both runs, untouched."""
    prior, est, cfg = tiny_setup
    base = cfg.replace(SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20, WARMUP_STEPS=15, SBC_RHAT_GATE=-1.0)
    out_off = tmnle.run_sbc(base.replace(SBC_REMEDIATE=False), prior, est, outdir=tmp_path / "off", seed=0,
                            verbose=False)
    assert out_off["remediation"] is None
    assert out_off["flagged_final"] == [0, 1]  # flagged but not re-run
    out_on = tmnle.run_sbc(base.replace(SBC_REMEDIATE=True, SBC_REMEDIATE_ROUNDS=1), prior, est,
                           outdir=tmp_path / "on", seed=0, verbose=False)
    np.testing.assert_array_equal(out_on["thetas_true"], out_off["thetas_true"])
    assert not np.allclose(out_off["all_samples"][0], out_on["all_samples"][0])


def test_torch_sbc_remediation_escalates_rounds(tiny_setup, tmp_path):
    """An impossible gate forces every escalation round to run; each
    doubles the warmup again (2x, 4x) and records its own diagnostics, and
    the min-RT-informed t_nd start keeps the draws valid posterior
    samples."""
    prior, est, cfg = tiny_setup
    cfg = cfg.replace(SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20, WARMUP_STEPS=10, SBC_RHAT_GATE=-1.0,
                      SBC_REMEDIATE=True, SBC_REMEDIATE_ROUNDS=2, SBC_REMEDIATE_TAU_INIT=True)
    out = tmnle.run_sbc(cfg, prior, est, outdir=tmp_path, seed=0, verbose=False)
    rem = out["remediation"]
    assert [r["round"] for r in rem["rounds"]] == [1, 2]
    assert [r["warmup"] for r in rem["rounds"]] == [20, 40]
    assert rem["warmup"] == 20  # the first round's
    _in_support(np.asarray(out["all_samples"]).reshape(-1, 5))
