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


# ---------------------------------------------------------------------------
# The leaf body: the plain leaf against the loop body it replaced
# ---------------------------------------------------------------------------
_STATE = ("edge", "prop", "rho", "log_w", "sum_accept", "n_leaves", "turning", "diverging", "live", "r_ckpts",
          "rsum_ckpts")
_LEAF_CASES = ["finite", "nan_logp", "neginf_logp", "divergent"]


def _former_build_subtree(gen, edge, depth, direction, eps, inv_mass, H0, max_depth, vg_fn, active, snapshots=None):
    """``inference/nuts._build_subtree`` as it stood before the leaf kernel,
    verbatim (its spans aside); with ``snapshots`` (a list) it runs every
    leaf, without the lagged flag's stop, and appends the state after each."""
    _kinetic, _popcount, _trailing_ones, _MAX_DELTA_ENERGY = tn._kinetic, tn._popcount, tn._trailing_ones, \
        tn._MAX_DELTA_ENERGY
    draw = tn.draw
    C = edge.shape[0]
    D = (edge.shape[1] - 1) // 3
    dev = edge.device
    half_e = (0.5 * eps * direction)[:, None]
    e_im = (eps * direction)[:, None] * inv_mass
    prop = torch.cat([edge[:, :D], edge[:, 2 * D :]], dim=1)
    rho = torch.zeros((C, D), dtype=edge.dtype, device=dev)
    log_w = torch.full((C,), -math.inf, device=dev)
    sum_accept = torch.zeros((C,), device=dev)
    n_leaves = torch.zeros((C,), dtype=torch.int64, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    r_ckpts = torch.zeros((C, max_depth + 1, D), dtype=edge.dtype, device=dev)
    rsum_ckpts = torch.zeros_like(r_ckpts)
    live = active.clone()
    flag = tn._LaggedAny(dev, gen)
    flag.push(live)
    for n in range(1 << depth):
        if snapshots is None and not flag.any_before_last():
            break
        u, p, g = edge[:, :D], edge[:, D : 2 * D], edge[:, 2 * D : 3 * D]
        p_half = torch.addcmul(p, half_e, g)
        u_new = torch.addcmul(u, e_im, p_half)
        logp_new, g_new = vg_fn(u_new)
        p_new = torch.addcmul(p_half, half_e, g_new)
        delta = (_kinetic(p_new, inv_mass) - logp_new) - H0
        delta = torch.nan_to_num(delta, nan=math.inf, posinf=math.inf, neginf=-math.inf)
        leaf_log_w = -delta

        # Progressive multinomial sampling within the subtree.
        new_log_w = torch.logaddexp(log_w, leaf_log_w)
        uni = draw(gen, torch.rand, (C,), dev)
        take = live & (torch.log(uni) < leaf_log_w - new_log_w)
        rho_after = rho + p_new
        live_col = live[:, None]

        if n % 2 == 0:
            # Checkpoint store at even leaves.
            slot = _popcount(n >> 1)
            r_ckpts[:, slot] = torch.where(live_col, p_new, r_ckpts[:, slot])
            rsum_ckpts[:, slot] = torch.where(live_col, rho, rsum_ckpts[:, slot])
            leaf_turning = None
        else:
            # U-turn checks for the aligned segments that end at odd leaf n.
            idx_max = _popcount(n >> 1)
            idx_min = idx_max - _trailing_ones(n) + 1
            v_new = p_new * inv_mass
            rho_seg = rho_after[:, None, :] - rsum_ckpts[:, idx_min : idx_max + 1]
            v_ckpt = r_ckpts[:, idx_min : idx_max + 1] * inv_mass[:, None, :]
            leaf_turning = (((v_ckpt * rho_seg).sum(-1) <= 0.0) | ((v_new[:, None, :] * rho_seg).sum(-1) <= 0.0)).any(-1)

        new_edge = torch.cat([u_new, p_new, g_new, logp_new[:, None]], dim=1)
        edge = torch.where(live_col, new_edge, edge)
        prop = torch.where(take[:, None], torch.cat([u_new, g_new, logp_new[:, None]], dim=1), prop)
        rho = torch.where(live_col, rho_after, rho)
        log_w = torch.where(live, new_log_w, log_w)
        sum_accept = sum_accept + torch.where(live, torch.clamp(torch.exp(-delta), max=1.0), 0.0)
        n_leaves = n_leaves + live
        if leaf_turning is not None:
            turning = turning | (live & leaf_turning)
        diverging = diverging | (live & (delta > _MAX_DELTA_ENERGY))
        live = live & ~(turning | diverging)
        flag.push(live)
        if snapshots is not None:
            snapshots.append({k: v.clone() for k, v in zip(_STATE, (
                edge, prop, rho, log_w, sum_accept, n_leaves, turning, diverging, live, r_ckpts, rsum_ckpts))})
    return dict(edge=edge, prop=prop, rho=rho, log_w=log_w, sum_accept=sum_accept, n_leaves=n_leaves,
                turning=turning, diverging=diverging)


def _leaf_inputs(case: str, C: int = 9, D: int = 3, seed: int = 0):
    """A subtree's start on a Gaussian (every third chain inactive) and a
    potential that, by ``case``, gives one chain a NaN or a -inf log-density
    or one past the divergence threshold at its first call."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    u, p, mu = f32(rng.normal(size=(C, D))), f32(rng.normal(size=(C, D))), f32(rng.normal(size=(D,)))
    prec = f32(rng.uniform(0.5, 2.0, (D,)))
    inv_mass = f32(rng.uniform(0.5, 2.0, (C, D)))
    eps = f32(rng.uniform(0.2, 1.2, C))
    direction = torch.where(f32(rng.uniform(size=C)) < 0.5, 1.0, -1.0)
    active = torch.from_numpy(np.arange(C) % 3 != 2)
    calls = [0]

    def gauss(x):
        return -0.5 * ((x - mu) ** 2 * prec).sum(-1), -(x - mu) * prec

    def vg_fn(x):
        logp, g = gauss(x)
        if calls[0] == 0 and case != "finite":
            logp[1] = {"nan_logp": math.nan, "neginf_logp": -math.inf, "divergent": -5000.0}[case]
        calls[0] += 1
        return logp, g

    logp, g = gauss(u)
    H0 = -logp + tn._kinetic(p, inv_mass)
    edge = torch.cat([u, p, g, logp[:, None]], dim=1)
    return dict(edge=edge, direction=direction, eps=eps, inv_mass=inv_mass, H0=H0, active=active), vg_fn, calls


@pytest.mark.parametrize("case", _LEAF_CASES)
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
def test_plain_leaf_equals_the_former_loop_body(depth, case):
    """``_leaf_plain`` after each leaf of a subtree gives every state tensor
    of the loop body it replaced, bit for bit: inactive chains, a NaN or
    -inf log-density and a divergent leaf included."""
    a, vg_old, _ = _leaf_inputs(case)
    _, vg_new, _ = _leaf_inputs(case)
    max_depth = 5
    snaps: list = []
    _former_build_subtree(make_generator(7), a["edge"], depth, a["direction"], a["eps"], a["inv_mass"], a["H0"],
                          max_depth, vg_old, a["active"], snapshots=snaps)
    gen = make_generator(7)
    edge, C, D = a["edge"], a["edge"].shape[0], 3
    half_e = (0.5 * a["eps"] * a["direction"])[:, None]
    e_im = (a["eps"] * a["direction"])[:, None] * a["inv_mass"]
    s = dict(edge=edge, prop=torch.cat([edge[:, :D], edge[:, 2 * D :]], dim=1), rho=torch.zeros((C, D)),
             log_w=torch.full((C,), -math.inf), sum_accept=torch.zeros((C,)),
             n_leaves=torch.zeros((C,), dtype=torch.int64), turning=torch.zeros((C,), dtype=torch.bool),
             diverging=torch.zeros((C,), dtype=torch.bool), live=a["active"].clone(),
             r_ckpts=torch.zeros((C, max_depth + 1, D)), rsum_ckpts=torch.zeros((C, max_depth + 1, D)))
    tn._LaggedAny(edge.device, gen).push(s["live"])  # the former loop's first flag: no draw
    assert len(snaps) == 1 << depth
    for n, want in enumerate(snaps):
        e = s["edge"]
        p_half = torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D])
        u_new = torch.addcmul(e[:, :D], e_im, p_half)
        logp_new, g_new = vg_new(u_new)
        uni = tn.draw(gen, torch.rand, (C,), edge.device)
        s = tn._leaf_plain(n, s, u_new, p_half, logp_new, g_new, uni, half_e, a["inv_mass"], a["H0"])
        for k in _STATE:
            assert torch.equal(s[k], want[k]) or (k in ("edge", "prop") and _equal_with_nans(s[k], want[k])), \
                (n, k)
    if case != "finite":
        assert bool(s["diverging"][1]) == bool(a["active"][1])


def _equal_with_nans(x, y) -> bool:
    return torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


@pytest.mark.parametrize("case", _LEAF_CASES)
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
def test_build_subtree_equals_the_former_one(depth, case):
    """The whole subtree, lagged stop included: the same state, the same
    number of potential calls and the generator left in the same state."""
    a, vg_old, calls_old = _leaf_inputs(case)
    _, vg_new, calls_new = _leaf_inputs(case)
    g_old, g_new = make_generator(11), make_generator(11)
    args = (a["direction"], a["eps"], a["inv_mass"], a["H0"], 5)
    want = _former_build_subtree(g_old, a["edge"], depth, *args, vg_old, a["active"])
    got = tn._build_subtree(g_new, a["edge"].clone(), depth, *args, vg_new, a["active"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]) or _equal_with_nans(got[k], want[k]), k
    assert calls_new[0] == calls_old[0]
    assert torch.equal(g_new.get_state(), g_old.get_state())


def test_build_subtree_on_the_cpu_takes_the_plain_leaf(monkeypatch):
    """CPU tensors take ``_leaf_plain`` at every leaf; ``launch.leaf`` stays
    0 under the recorder and no kernel launches."""
    from sbi_for_diffusion_models_tpu_torch.ops import nuts_cuda
    from sbi_for_diffusion_models_tpu_torch.utils import metrics

    plain = tn._leaf_plain
    seen = []
    monkeypatch.setattr(tn, "_leaf_plain", lambda n, *rest: seen.append(n) or plain(n, *rest))
    a, vg_fn, calls = _leaf_inputs("finite")
    before = nuts_cuda.LEAF.launches
    metrics.enable()
    try:
        tn._build_subtree(make_generator(3), a["edge"], 3, a["direction"], a["eps"], a["inv_mass"], a["H0"], 5,
                          vg_fn, a["active"])
    finally:
        spans, counters = metrics.drain()
    assert seen == list(range(calls[0])) and calls[0] > 0
    assert counters.get("launch.leaf", 0) == 0
    assert sum(s.name == "nuts.leaf" for s in spans) >= calls[0]
    assert nuts_cuda.LEAF.launches == before
