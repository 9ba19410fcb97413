"""PyTorch port: the sampler. Adaptation pieces exactly against the JAX
package, NUTS with parallel tempering on a Gaussian, the extra moves, and a
tiny end-to-end ``run_inference_mcmc`` on the CPU for the shifted-log and
the pulse-grid representations.

The JAX functions are run op by op (``vmap`` without ``jit``): compiled, XLA's
CPU backend fuses ``a + b * c`` into one multiply-add, which rounds once
where each framework's single operations round twice.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu.inference import nuts as jn
from sbi_for_diffusion_models_tpu_torch.distributions import Bijector, interval_support, real_support
from sbi_for_diffusion_models_tpu_torch.inference import mcmc as tm
from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator


def test_dual_averaging_matches_jax_exactly():
    rng = np.random.default_rng(0)
    eps0 = rng.uniform(0.01, 2.0, 6).astype(np.float32)
    accepts = rng.uniform(0, 1, (30, 6)).astype(np.float32)
    js = jax.vmap(jn._da_init)(jnp.asarray(eps0))
    ts = tn._da_init(torch.from_numpy(eps0))
    # The two frameworks' float32 log may differ in the last bit.
    for name in ("log_eps", "log_eps_avg", "h_avg", "mu", "count"):
        np.testing.assert_array_max_ulp(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), maxulp=1)
    # The update itself is exact: start both from the same state.
    ts = tn._DAState(*(torch.from_numpy(np.array(v)) for v in js))
    upd = jax.vmap(lambda s, a: jn._da_update(s, a, 0.8))
    for a in accepts:
        js = upd(js, jnp.asarray(a))
        ts = tn._da_update(ts, torch.from_numpy(a), 0.8)
        for name in ("log_eps", "log_eps_avg", "h_avg", "mu", "count"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)


def test_welford_matches_jax_exactly():
    rng = np.random.default_rng(1)
    xs = rng.normal(2.0, 3.0, (25, 4, 3)).astype(np.float32)  # steps, chains, dim
    jw = jax.vmap(lambda _: jn._welford_init(3))(jnp.arange(4))
    tw = tn._welford_init((4, 3))
    upd = jax.vmap(jn._welford_update)
    for x in xs:
        jw = upd(jw, jnp.asarray(x))
        tw = tn._welford_update(tw, torch.from_numpy(x))
        np.testing.assert_array_equal(tw.mean.numpy(), np.asarray(jw.mean))
        np.testing.assert_array_equal(tw.m2.numpy(), np.asarray(jw.m2))
        np.testing.assert_array_equal(tw.count.numpy(), np.asarray(jw.count))
    np.testing.assert_array_equal(tn._welford_var(tw).numpy(), np.asarray(jax.vmap(jn._welford_var)(jw)))


@pytest.mark.parametrize("num_warmup", [0, 5, 20, 21, 50, 75, 100, 150, 200, 1000])
def test_warmup_schedule_matches_jax(num_warmup):
    assert tn._warmup_schedule(num_warmup) == jn._warmup_schedule(num_warmup)


@pytest.mark.parametrize("R,beta_min", [(1, 0.1), (2, 0.5), (6, 0.04), (8, 0.1)])
def test_geometric_ladder_matches_jax(R, beta_min):
    np.testing.assert_array_equal(tn.geometric_ladder(R, beta_min), jn.geometric_ladder(R, beta_min))


@pytest.mark.parametrize("sweep_idx", [0, 1, 2, 7])
def test_exchange_sweep_matches_jax_given_the_same_uniforms(sweep_idx):
    M, R, D = 3, 5, 2
    rng = np.random.default_rng(sweep_idx)
    u = rng.normal(size=(M * R, D)).astype(np.float32)
    betas = np.tile(jn.geometric_ladder(R, 0.1), M)
    key = jax.random.key(11 + sweep_idx)

    def jll(x):
        return -0.5 * jnp.sum((x - 0.3) ** 2) * 40.0

    jex = jn.ReplicaExchange(n_replicas=R, betas=jnp.asarray(betas), ll_fn=jll)
    jperm, jacc = jn._exchange_sweep(jex, key, sweep_idx, jnp.asarray(u), None)
    uni = torch.from_numpy(np.array(jax.random.uniform(key, (M, R))))
    tex = tn.ReplicaExchange(
        n_replicas=R, betas=torch.from_numpy(betas), ll_fn=lambda x: -0.5 * ((x - 0.3) ** 2).sum(-1) * 40.0
    )
    tperm, tacc = tn._exchange_sweep(tex, uni, sweep_idx, torch.from_numpy(u), None)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert abs(float(tacc) - float(jacc)) < 1e-6  # a mean, summed in another order
    assert sorted(tperm.tolist()) == list(range(M * R))


MEAN = torch.tensor([1.0, -2.0])
COV = torch.tensor([[1.0, 0.8], [0.8, 1.5]])
PREC = torch.linalg.inv(COV)


def _gauss_logp(u):
    d = u - MEAN
    return -0.5 * ((d @ PREC) * d).sum(-1)


def test_nuts_with_parallel_tempering_recovers_correlated_gaussian():
    C, R = 4, 3
    betas = torch.as_tensor(tn.geometric_ladder(R, 0.2)).repeat(C)
    ex = tn.ReplicaExchange(n_replicas=R, betas=betas, ll_fn=lambda u, b: _gauss_logp(u))
    init = torch.randn((C * R, 2), generator=make_generator(0)) * 3.0
    samples, info = tn.run_nuts(
        1, lambda u, b: b * _gauss_logp(u), init, num_warmup=150, num_samples=400, data=betas, exchange=ex,
        max_depth=6,
    )
    assert samples.shape == (C * R, 400, 2)
    cold = samples.reshape(C, R, 400, 2)[:, 0]
    flat = cold.reshape(-1, 2)
    assert torch.allclose(flat.mean(0), MEAN, atol=0.1), flat.mean(0)
    var = flat.var(0)
    assert torch.all((var / COV.diag() - 1.0).abs() < 0.2), var
    assert 0.0 < info["swap_accept"] <= 1.0
    assert int(info["diverging"].sum()) == 0
    assert info["step_size"].shape == (C * R,)
    assert float(np.max(split_r_hat(cold))) < 1.1
    assert float(np.min(effective_sample_size(cold))) > 100


def test_nuts_step_and_step_size_search_shapes():
    vg = tn.value_and_grad(_gauss_logp)
    u = torch.zeros((5, 2))
    gen = make_generator(3)
    eps = tn.find_reasonable_step_size(gen, vg, u, torch.ones(5, 2))
    assert eps.shape == (5,) and torch.all(eps > 0)
    logp, g = vg(u)
    u2, logp2, g2, info = tn.nuts_step(gen, u, logp, g, vg_fn=vg, eps=eps, inv_mass=torch.ones(5, 2), max_depth=4)
    assert u2.shape == (5, 2)
    torch.testing.assert_close(logp2, _gauss_logp(u2))
    torch.testing.assert_close(g2, vg(u2)[1])
    assert set(info) == {"accept_prob", "num_steps", "diverging", "depth"}
    assert torch.all(info["num_steps"] >= 1) and torch.all(info["depth"] <= 4)


def test_dim_slice_preserves_the_conditional():
    """Repeated slice updates of coordinate 0 of a batch of chains sample its
    full conditional N(mean_0 + rho*(u_1 - mean_1), var_0|1)."""
    move = tm.make_dim_slice(0, width=0.5)
    vg = tn.value_and_grad(_gauss_logp)
    C = 400
    u = torch.stack([torch.full((C,), 5.0), torch.full((C,), -2.0)], -1)
    logp, g = vg(u)
    gen = make_generator(4)
    draws = []
    for it in range(60):
        u, logp, g = move(gen, u, logp, g, vg)
        if it >= 20:
            draws.append(u[:, 0].clone())
    x = torch.cat(draws)
    cond_var = COV[0, 0] - COV[0, 1] ** 2 / COV[1, 1]
    assert abs(float(x.mean()) - 1.0) < 0.05
    assert abs(float(x.var()) / float(cond_var) - 1.0) < 0.1
    torch.testing.assert_close(logp, _gauss_logp(u))
    assert torch.all(u[:, 1] == -2.0)


def test_grid_hop_moves_by_grid_multiples_and_stays_in_support():
    bij = Bijector([real_support(), interval_support(0.0, 1.0)])

    def logp_theta(theta):  # periodic in theta[1] with period 0.1
        return -0.5 * theta[:, 0] ** 2 + torch.cos(2 * math.pi * theta[:, 1] / 0.1)

    def logp_u(u):
        return logp_theta(bij.forward(u)) + bij.forward_log_det(u)

    vg = tn.value_and_grad(logp_u)
    hop = tm.make_grid_hop(bij, index=1, delta=0.1)
    assert tm.compose_moves(None, hop) is hop and tm.compose_moves() is None
    u = bij.inverse(torch.tensor([[0.0, 0.45]]).repeat(300, 1))
    logp, g = vg(u)
    gen = make_generator(5)
    for _ in range(20):
        u_new, logp, g = hop(gen, u, logp, g, vg)
        shift = (bij.forward(u_new)[:, 1] - bij.forward(u)[:, 1]) / 0.1
        assert torch.allclose(shift, shift.round(), atol=1e-3)
        u = u_new
    theta = bij.forward(u)
    assert torch.all((theta[:, 1] > 0) & (theta[:, 1] < 1))
    assert len(torch.unique(theta[:, 1].round(decimals=2))) >= 5  # the hop visits other modes


def test_mcmc_posterior_plain_nuts_and_slice_on_gaussian():
    from sbi_for_diffusion_models_tpu_torch.distributions import Distribution

    class Flat(Distribution):
        event_shape = (2,)

        def sample(self, generator, sample_shape=()):
            return torch.randn(tuple(sample_shape) + (2,), generator=generator)

        def supports(self):
            return [real_support(), real_support()]

    class Pot:
        def potential_fn(self, theta):
            return _gauss_logp(theta)

    post = tm.MCMCPosterior(Pot(), Flat(), Bijector(Flat().supports()), num_chains=4, warmup_steps=100,
                            max_tree_depth=5, verbose=False, device="cpu")
    s = post.sample((400,), seed=2)
    assert s.shape == (400, 2)
    assert torch.allclose(s.mean(0), MEAN, atol=0.25)
    assert set(post.last_info) >= {"accept_prob", "diverging", "step_size", "inv_mass"}
    post = tm.MCMCPosterior(Pot(), Flat(), Bijector(Flat().supports()), method="slice", num_chains=4,
                            warmup_steps=100, verbose=False, device="cpu")
    s = post.sample((400,), seed=2)
    assert s.shape == (400, 2)
    assert torch.allclose(s.mean(0), MEAN, atol=0.25)
    assert set(post.last_info) >= {"accept_prob", "width"}


def _tiny_estimator(pulse: bool):
    """A tiny random MNLE with the full 85-dim condition: the calibrated
    shifted-log cond-affine model, or the pulse-grid model (absolute
    anchor, slot head over 80 slots, circular spline heads on [emb, kf])."""
    from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, mnle_from_flax_params

    rng = np.random.default_rng(0)
    if pulse:
        cfg = MNLEConfig(hidden_features=16, num_transforms=2, num_bins=4, censor_rt=True, rt_rep="pulse")
    else:
        cfg = MNLEConfig(hidden_features=16, num_transforms=2, num_bins=4, censor_rt=True, rt_rep="shifted_log",
                         log_condition_dims=(1, 2, 3), cond_affine=True)

    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    H = 16
    tree = {
        "cat_net": {"Dense_0": dense(85, H), "Dense_1": dense(H, H), "Dense_2": dense(H, 3)},
        "flow_trunk": {"Dense_0": dense(88, H), "Dense_1": dense(H, H), "Dense_2": dense(H, H)},
    }
    if pulse:
        tree.update({f"spline_head_{i}": dense(H + 3, 3 * 4 + 1) for i in range(2)})
        tree["pulse_slot_head"] = dense(H, 80)
    else:
        tree.update({f"spline_head_{i}": dense(H, 3 * 4 - 1) for i in range(2)})
        tree["affine_head"] = dense(H, 2)
    return mnle_from_flax_params(cfg, tree, np.zeros(85), np.ones(85), 0.0, 1.0, device="cpu")


def test_tiny_run_inference_mcmc_end_to_end_on_cpu():
    """The calibrated sampler stack (PT, grid hop, t_nd slice) on a tiny
    random MNLE; on CPU tensors no kernel launches."""
    _tiny_run_inference_mcmc(pulse=False)


def test_tiny_pulse_run_inference_mcmc_end_to_end_on_cpu():
    """The same on a tiny random pulse-grid MNLE (the K2p/K3p path, whose
    wrappers take their plain versions on CPU rows)."""
    _tiny_run_inference_mcmc(pulse=True)


def _tiny_run_inference_mcmc(pulse: bool):
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.mnle import run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    est = _tiny_estimator(pulse)
    x_o, p_o = simulate_observed_session(np.array([0.5, 0.3, 1.2, 10.0, 0.2], np.float32), 10, seed=1, device="cpu")
    for k in KERNELS.values():
        k.launches = 0
    rc = CALIBRATED_CONFIG.replace(WARMUP_STEPS=10, POSTERIOR_SAMPLES=16, NUM_CHAINS=2, MCMC_PT_REPLICAS=2,
                                   MCMC_MAX_TREE_DEPTH=4)
    samples, info = run_inference_mcmc(rc, build_prior_theta(), est, x_o, p_o, seed=0, return_info=True,
                                       verbose=False)
    assert samples.shape == (16, 5) and torch.isfinite(samples).all()
    assert torch.isfinite(build_prior_theta().log_prob(samples)).all()
    assert info["diverging"].shape == (4, 8)  # every rung of every chain
    assert info["potential_calls"] > 0
    assert {k: v.launches for k, v in KERNELS.items()} == {k: 0 for k in KERNELS}


@pytest.mark.parametrize("method", ["nuts", "hmc"])
@pytest.mark.parametrize("verbose", [False, True])
def test_mcmc_posterior_prints_and_records_diagnostics_as_jax_does(method, verbose, capsys):
    """The JAX ``MCMCPosterior.sample`` prints its ``[mcmc] nuts:`` line only
    for ``method="nuts"`` under ``verbose``, and fills ``_last_diagnostics``
    (printing ``[diagnostics]``) only under ``verbose``; the port does the
    same, with no other change to the draws."""
    from sbi_for_diffusion_models_tpu_torch.distributions import Distribution

    class Flat(Distribution):
        event_shape = (2,)

        def sample(self, generator, sample_shape=()):
            return torch.randn(tuple(sample_shape) + (2,), generator=generator)

        def supports(self):
            return [real_support(), real_support()]

    class Pot:
        def potential_fn(self, theta):
            return _gauss_logp(theta)

    # No NUTS -> slice fallback: its line prints whatever ``verbose`` says (as
    # in JAX), and at 2 chains x 10 draws split R-hat passes its 1.5 limit on
    # about one seed in ten.
    post = tm.MCMCPosterior(Pot(), Flat(), Bijector(Flat().supports()), method=method, num_chains=2,
                            warmup_steps=10, max_tree_depth=3, verbose=verbose, auto_fallback=False, device="cpu")
    s = post.sample((20,), seed=1)
    out = capsys.readouterr().out
    assert s.shape == (20, 2)
    assert ("[mcmc] nuts:" in out) == (verbose and method == "nuts")
    assert ("[diagnostics]" in out) == verbose
    if verbose:
        assert set(post._last_diagnostics) == {"ess", "r_hat"}
    else:
        assert post._last_diagnostics is None and out == ""
