"""PyTorch port: the slice as a whole. On the committed flagship model and
one simulated session, the u-space posterior potential
(``ThetaOnlyPosteriorPotential`` through ``mcmc_transform``) and its gradient
for a batch of theta, against the JAX package; on the committed pulse-grid
model, the closed-form likelihood gradient the sampler uses."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu import potentials as jp
from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta as j_prior
from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import potentials as tp
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta as t_prior

MODEL = "mnle_10m_shifted_logt_affine.npz"


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    try:
        yield jmnle.load_model(MODEL), tmnle.load_model(MODEL, device="cpu")
    finally:
        mp.undo()


def _session():
    """A 50-trial session from a fixed theta, made with numpy: RTs after a
    0.15 s onset, a quarter of the trials censored at the 8 s window end."""
    rng = np.random.default_rng(7)
    choice = rng.choice([0.0, 1.0, 2.0], 50, p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.15 + rng.gamma(2.0, 0.4, 50))
    pulses = np.where(rng.random((50, 80)) < 0.5, 1.0, -1.0)
    return np.stack([rt, choice], -1).astype(np.float32), pulses.astype(np.float32)


def _u_batch():
    rng = np.random.default_rng(8)
    theta = np.stack(
        [rng.uniform(0.2, 0.8, 8), rng.lognormal(-1, 0.5, 8), rng.lognormal(0, 0.5, 8),
         rng.lognormal(2.75, 0.3, 8), rng.uniform(0.01, 0.14, 8)], -1,
    ).astype(np.float32)
    return np.asarray(jd.mcmc_transform(j_prior()).inverse(jnp.asarray(theta)))


@pytest.fixture(scope="module")
def jax_reference(models):
    """JAX value and gradient of the u-space posterior potential at
    ``_u_batch()`` for the ``_session()`` data."""
    jest, _ = models
    x_o, pulses = _session()
    jprior, jbij = j_prior(), jd.mcmc_transform(j_prior())
    jpot = jp.ThetaOnlyPosteriorPotential(
        jprior, jp.ConditionedMNLELogLikelihood(jest, pulses, logprob_kernel="xla"), x_o=x_o
    )

    def j_logp_u(uu):
        return jpot.potential_fn(jbij.forward(uu)) + jbij.forward_log_det(uu)

    ref_v, ref_g = jax.jit(jax.vmap(jax.value_and_grad(j_logp_u)))(jnp.asarray(_u_batch()))
    return np.asarray(ref_v), np.asarray(ref_g)


def test_u_space_posterior_potential_and_gradient_match_jax(models, jax_reference):
    _, est = models
    x_o, pulses = _session()
    u = _u_batch()
    ref_v, ref_g = jax_reference

    tprior, tbij = t_prior(), td.mcmc_transform(t_prior())
    for kernel in ("xla", "pallas"):  # plain path; the fused autograd.Function on CPU rows
        tpot = tp.ThetaOnlyPosteriorPotential(
            tprior, tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel=kernel), x_o=x_o
        )
        uu = torch.from_numpy(u).requires_grad_(True)
        val = tpot.potential_fn(tbij.forward(uu)) + tbij.forward_log_det(uu)
        (g,) = torch.autograd.grad(val.sum(), uu)
        assert np.all(np.isfinite(ref_v)) and np.all(np.abs(ref_v) > 10)
        np.testing.assert_allclose(val.detach().numpy(), ref_v, rtol=1e-4, err_msg=kernel)
        # Gradient entries near zero get the batch's scale as absolute slack.
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max(), err_msg=kernel)
        # The batched __call__ agrees, and masks out-of-support theta to -inf.
        theta = tbij.forward(torch.from_numpy(u))
        np.testing.assert_allclose(tpot(theta).numpy(), tpot.potential_fn(theta).numpy(), rtol=1e-6)
        bad = theta.clone()
        bad[0, 0] = 1.5
        assert tpot(bad)[0] == -np.inf and torch.isfinite(tpot(bad)[1:]).all()


def test_likelihood_shapes_and_stale_params_guard(models):
    _, est = models
    x_o, pulses = _session()
    lik = tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas")
    theta = t_prior().sample(torch.Generator().manual_seed(0), (3,))
    assert lik(x_o, theta).shape == (1, 3)
    assert lik(x_o[None], theta[0]).shape == (1, 1)
    with pytest.raises(ValueError, match="trials"):
        lik(x_o[:10], theta)
    with pytest.raises(ValueError, match="fused log-prob path"):
        lik.log_lik_fn(torch.nn.Linear(1, 1), torch.from_numpy(x_o), theta)
    with pytest.raises(ValueError, match="num_trials"):
        tp.ConditionedMNLELogLikelihood(est, pulses[0])


def test_closed_form_gradient_matches_jax_and_autograd(models, jax_reference):
    """The sampler's closed-form value and gradient (prior, bijector and the
    likelihood's outer transforms around K2/K3) against JAX at beta = 1,
    and against autograd through the tempered density at every PT rung,
    including onsets past some RTs (the shifted-log floor and barrier)."""
    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
    from sbi_for_diffusion_models_tpu_torch.inference.mcmc import MCMCPosterior

    _, est = models
    x_o, pulses = _session()
    u = _u_batch()
    ref_v, ref_g = jax_reference

    tprior, tbij = t_prior(), td.mcmc_transform(t_prior())
    tpot = tp.ThetaOnlyPosteriorPotential(
        tprior, tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas"), x_o=x_o, temperature=1.0
    )
    post = MCMCPosterior(tpot, tprior, tbij, pt_replicas=4, device="cpu")
    vg = post._closed_form_vg()
    val, g = vg(torch.from_numpy(u), torch.ones(8))
    np.testing.assert_allclose(val.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())

    # Tempered rungs and onsets past the first RTs, against autograd.
    uu = torch.from_numpy(u).clone()
    uu[:3, 4] = torch.tensor([0.0, 1.0, 3.0])  # t_nd = 0.5, 0.73, 0.95 s
    betas = torch.as_tensor(tn.geometric_ladder(4, 0.04)).repeat(2)
    base_fn, ll_fn = post._split_logp()
    auto = tn.value_and_grad(lambda x, b: base_fn(x) + b * ll_fn(x), betas)
    v_ref, g_ref = auto(uu)
    v_cf, g_cf = vg(uu, betas)
    np.testing.assert_allclose(v_cf.numpy(), v_ref.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_cf.numpy(), g_ref.numpy(), rtol=1e-5, atol=1e-5 * g_ref.abs().max().item())
    assert vg(uu, betas, False)[1] is None


PULSE_MODEL = "mnle_1m_pulseabs.npz"


@pytest.fixture(scope="module")
def pulse_models():
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    try:
        yield jmnle.load_model(PULSE_MODEL), tmnle.load_model(PULSE_MODEL, device="cpu")
    finally:
        mp.undo()


def _theta_across_grid_wraps():
    """Eight thetas whose onsets t_nd sit on either side of a pulse-grid
    phase wrap ((t_nd / 0.1) mod 1 jumps from ~1 to ~0 at 0.1), and a few
    away from it."""
    rng = np.random.default_rng(9)
    tnd = np.asarray([0.0998, 0.1002, 0.09995, 0.10005, 0.03, 0.07, 0.12, 0.135])
    return np.stack(
        [rng.uniform(0.2, 0.8, 8), rng.lognormal(-1, 0.5, 8), rng.lognormal(0, 0.5, 8),
         rng.lognormal(2.75, 0.3, 8), tnd], -1,
    ).astype(np.float32)


def test_pulse_closed_form_gradient_matches_autograd_and_jax(pulse_models):
    """The pulse model's ``log_lik_and_grad`` (K2p/K3p's plain versions on
    CPU rows, t_nd's gradient through the sin/cos phase features in closed
    form) against autograd of ``log_lik_fn`` and against JAX's gradient of
    its likelihood, with onsets on both sides of a grid phase wrap; then the
    sampler's u-space closed form against JAX's u-space potential."""
    from sbi_for_diffusion_models_tpu_torch.inference.mcmc import MCMCPosterior

    jest, est = pulse_models
    x_o, pulses = _session()
    theta = _theta_across_grid_wraps()
    jlik = jp.ConditionedMNLELogLikelihood(jest, pulses, logprob_kernel="xla")
    ref_v = np.asarray(jax.jit(lambda th: jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))(jnp.asarray(theta)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda th: jnp.sum(jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))))(
        jnp.asarray(theta)))

    lik = tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="auto")
    assert lik.closed_form_grad
    x = torch.from_numpy(x_o)
    th = torch.from_numpy(theta)
    ll, g = lik.log_lik_and_grad(x, th)
    th_ = th.clone().requires_grad_(True)
    ll_auto = lik.log_lik_fn(est.params, x, th_)
    (g_auto,) = torch.autograd.grad(ll_auto.sum(), th_)
    np.testing.assert_allclose(ll.numpy(), ll_auto.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-5, atol=1e-5 * float(g_auto.abs().max()))
    np.testing.assert_allclose(ll.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    assert np.isfinite(g.numpy()).all()
    assert lik.log_lik_and_grad(x, th, need_grad=False)[1] is None

    # The sampler's u-space closed form against JAX's u-space potential.
    jprior, jbij = j_prior(), jd.mcmc_transform(j_prior())
    jpot = jp.ThetaOnlyPosteriorPotential(jprior, jlik, x_o=x_o)
    u = np.asarray(jbij.inverse(jnp.asarray(theta)))
    uv, ug = jax.jit(jax.vmap(jax.value_and_grad(lambda uu: jpot.potential_fn(jbij.forward(uu))
                                                 + jbij.forward_log_det(uu))))(jnp.asarray(u))
    tprior, tbij = t_prior(), td.mcmc_transform(t_prior())
    tpot = tp.ThetaOnlyPosteriorPotential(tprior, lik, x_o=x_o)
    vg = MCMCPosterior(tpot, tprior, tbij, pt_replicas=2, device="cpu")._closed_form_vg()
    val, gu = vg(torch.from_numpy(u), torch.ones(8))
    np.testing.assert_allclose(val.numpy(), np.asarray(uv), rtol=1e-4)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ug), rtol=1e-3, atol=1e-3 * np.abs(np.asarray(ug)).max())


def _log_lik_case(rep, models, pulse_models):
    """The fused likelihood of the committed model of ``rep`` on CPU rows,
    the session and a batch of theta."""
    x_o, pulses = _session()
    if rep == "pulse":
        est, theta = pulse_models[1], _theta_across_grid_wraps()
    else:
        est, theta = models[1], np.asarray(td.mcmc_transform(t_prior()).forward(torch.from_numpy(_u_batch())))
    lik = tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas")
    return lik, torch.from_numpy(x_o), torch.from_numpy(theta)


@pytest.mark.parametrize("rep", ["shifted_log", "pulse"])
def test_log_lik_and_grad_has_the_bits_of_the_separate_value_and_vjp(rep, models, pulse_models, monkeypatch):
    """``log_lik_and_grad`` takes a gradient call's values from the combined
    wrapper (one K3 / K3p launch on the card); on the CPU its (ll, grad)
    are bit for bit those of the value wrapper followed by the VJP wrapper,
    the two launches a gradient call made before, and a value-only call's
    ll is the same bits too."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    lik, x, theta = _log_lik_case(rep, models, pulse_models)
    ll, g = lik.log_lik_and_grad(x, theta)
    ll_value_only, none = lik.log_lik_and_grad(x, theta, need_grad=False)
    assert none is None and torch.equal(ll_value_only, ll)
    if rep == "pulse":
        monkeypatch.setattr(mc, "rows_logp_pulse_and_vjp", lambda *a: (mc.rows_logp_pulse(*a[:-1]),
                                                                       *mc.rows_logp_pulse_vjp(*a)))
    else:
        monkeypatch.setattr(mc, "rows_logp_and_vjp", lambda *a: (mc.rows_logp(*a[:-1]), *mc.rows_logp_vjp(*a)))
    ll_sep, g_sep = lik.log_lik_and_grad(x, theta)
    assert torch.equal(ll, ll_sep) and torch.equal(g, g_sep)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("rep", ["shifted_log", "pulse"])
def test_gradient_call_reaches_only_the_combined_wrapper(rep, models, pulse_models, monkeypatch):
    """A gradient call of ``log_lik_and_grad`` goes through the combined
    value-and-VJP wrapper once and through no other kernel wrapper; a
    value-only call through the value wrapper once (K3 alone, or K2 alone,
    on the card)."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

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
    lik, x, theta = _log_lik_case(rep, models, pulse_models)
    suffix = "_pulse" if rep == "pulse" else ""
    lik.log_lik_and_grad(x, theta)
    assert calls == {**dict.fromkeys(names, 0), f"rows_logp{suffix}_and_vjp": 1}
    calls.update(dict.fromkeys(names, 0))
    lik.log_lik_and_grad(x, theta, need_grad=False)
    assert calls == {**dict.fromkeys(names, 0), f"rows_logp{suffix}": 1}
