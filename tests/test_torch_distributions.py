"""PyTorch port: priors, bijector and proposals against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu.pipeline import build_prior_theta as j_prior
from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta as t_prior
from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

RTOL = 1e-6


def _grid(seed=0, n=257):
    """Points inside and outside each prior's support, including edges."""
    rng = np.random.default_rng(seed)
    theta = np.stack(
        [
            rng.uniform(-0.2, 1.2, n),
            rng.lognormal(-1, 1.5, n) * rng.choice([1, 1, 1, -1], n),
            rng.lognormal(0, 1.5, n),
            rng.lognormal(2.75, 0.8, n),
            rng.uniform(-0.1, 1.1, n),
        ],
        -1,
    ).astype(np.float32)
    theta[:4] = [[0.0, 1e-3, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 4.0, 0.0], [0.5, 0.0, 1.0, 1.0, 0.5], [1e-6, 5.0, 20.0, 40.0, 0.999]]
    return theta


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b, dtype=np.float32), rtol=rtol, atol=atol)


def test_prior_log_prob_matches_jax():
    theta = _grid()
    got = t_prior().log_prob(torch.from_numpy(theta)).numpy()
    ref = np.asarray(j_prior().log_prob(jnp.asarray(theta)))
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(ref).sum() > 100
    _close(got, ref, atol=1e-5)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.Beta([2.0, 0.5], [2.0, 3.0]),
        lambda m: m.LogNormal([-1.0, 2.75], [1.0, 0.5]),
    ],
    ids=["beta", "lognormal"],
)
def test_marginal_log_prob_matches_jax(make):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.1, 1.1, (64, 2)).astype(np.float32) * np.array([1.0, 30.0], np.float32)
    got = make(td).log_prob(torch.from_numpy(x)).numpy()
    ref = np.asarray(make(jd).log_prob(jnp.asarray(x)))
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    _close(got[fin], ref[fin], atol=1e-5)


def test_bijector_forward_inverse_logdet_match_jax():
    jb, tb = jd.mcmc_transform(j_prior()), td.mcmc_transform(t_prior())
    rng = np.random.default_rng(2)
    u = rng.normal(0.0, 3.0, (300, 5)).astype(np.float32)
    _close(tb.forward(torch.from_numpy(u)).numpy(), jb.forward(jnp.asarray(u)))
    _close(tb.forward_log_det(torch.from_numpy(u)).numpy(), jb.forward_log_det(jnp.asarray(u)), atol=1e-6)
    theta = _grid(3)
    _close(tb.inverse(torch.from_numpy(theta)).numpy(), jb.inverse(jnp.asarray(theta)), atol=1e-6)
    assert tb.bounds(0) == (0.0, 1.0) and tb.bounds(1) == (0.0, float("inf"))


def test_prior_samples_in_support_with_prior_moments():
    prior = t_prior()
    s = prior.sample(make_generator(0), (20_000,))
    assert s.shape == (20_000, 5) and s.dtype == torch.float32
    assert torch.isfinite(prior.log_prob(s)).all()
    j = np.asarray(j_prior().sample(jax.random.key(0), (20_000,)))
    # Same distribution: medians of each marginal within 3% of the JAX draws.
    np.testing.assert_allclose(np.median(s.numpy(), 0), np.median(j, 0), rtol=0.03)
    again = prior.sample(make_generator(0), (20_000,))
    assert torch.equal(s, again)


def test_proposals_shapes_and_values():
    pp = PulseSequenceProposal(80, 0.75, device="cpu")
    s = pp.sample(make_generator(1), (4, 3))
    assert s.shape == (4, 3, 80)
    assert set(torch.unique(s).tolist()) <= {-1.0, 1.0}
    assert torch.equal(pp.log_prob(s), torch.zeros(4, 3))
    ext = ExtendedProposal(t_prior(), pp)
    z = ext.sample(make_generator(2), (10,))
    assert z.shape == (10, 85)
    assert torch.isfinite(ext.log_prob(z)).all()
    # Without a generator each draw consumes the proposal's own stream.
    assert not torch.equal(ext.sample(sample_shape=(5,)), ext.sample(sample_shape=(5,)))
    # Majority side agrees with each pulse about p_success of the time.
    big = pp.sample(make_generator(3), (4000,))
    agree = (big == torch.sign(big.sum(-1, keepdim=True) + 0.5)).float().mean()
    assert 0.70 < float(agree) < 0.80


def test_closed_form_prior_and_bijector_gradients_match_jax():
    """``log_prob_and_grad`` of the prior and ``forward_and_grads`` of the
    bijector (the sampler's closed-form gradient) against JAX autodiff, on
    the grid above (inside, outside and at the support's edges)."""
    theta = _grid()
    lp, g = t_prior().log_prob_and_grad(torch.from_numpy(theta))
    ref_lp = np.asarray(j_prior().log_prob(jnp.asarray(theta)))
    # Rows are independent, so the gradient of the sum is each row's gradient.
    ref_g = np.asarray(jax.jit(jax.grad(lambda x: j_prior().log_prob(x).sum()))(jnp.asarray(theta)))
    assert np.array_equal(np.isfinite(lp.numpy()), np.isfinite(ref_lp))
    _close(lp.numpy(), ref_lp, atol=1e-5)
    inside = np.isfinite(ref_lp)
    _close(g.numpy()[inside], ref_g[inside], rtol=1e-5, atol=1e-5)

    bij, jbij = td.mcmc_transform(t_prior()), jd.mcmc_transform(j_prior())
    u = np.random.default_rng(3).normal(0.0, 3.0, (129, 5)).astype(np.float32)
    th, dth, ld, dld = bij.forward_and_grads(torch.from_numpy(u))
    _close(th.numpy(), np.asarray(jbij.forward(jnp.asarray(u))))
    _close(ld.numpy(), np.asarray(jbij.forward_log_det(jnp.asarray(u))), atol=1e-6)
    ju = jnp.asarray(u)
    _, ref_dth = jax.jit(lambda x: jax.jvp(jbij.forward, (x,), (jnp.ones_like(x),)))(ju)  # elementwise: jvp with ones
    _close(dth.numpy(), np.asarray(ref_dth), rtol=1e-5)
    ref_dld = np.asarray(jax.jit(jax.grad(lambda x: jbij.forward_log_det(x).sum()))(ju))
    _close(dld.numpy(), ref_dld, rtol=1e-5, atol=1e-6)
