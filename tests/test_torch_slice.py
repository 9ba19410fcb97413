"""PyTorch port: the batched slice sampler (``inference/slice.py``) and the
NUTS -> slice fallback of ``MCMCPosterior``, on the CPU. Mirrors the JAX
package's slice tests (``tests/test_mcmc.py``) and holds the port's
``run_slice`` to the JAX ``run_slice`` in distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu.inference import mcmc as jm
from sbi_for_diffusion_models_tpu.inference.slice import run_slice as jax_run_slice
from sbi_for_diffusion_models_tpu_torch.distributions import Beta, LogNormal, MultipleIndependent, mcmc_transform
from sbi_for_diffusion_models_tpu_torch.inference import mcmc as tm
from sbi_for_diffusion_models_tpu_torch.inference import slice as ts
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

MU = np.array([1.0, -2.0], np.float32)
COV = np.array([[2.0, 0.9], [0.9, 1.0]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _gauss_logp(u):
    d = u - torch.from_numpy(MU)
    return -0.5 * ((d @ torch.from_numpy(PREC)) * d).sum(-1)


def test_slice_gaussian_moments():
    init = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 2)).astype(np.float32))
    samples, info = ts.run_slice(6, _gauss_logp, init, num_warmup=150, num_samples=600)
    assert samples.shape == (4, 600, 2) and info["accept_prob"].shape == (4, 600)
    s = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), MU, atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.35)


def test_slice_calls_the_density_once_per_iteration_for_all_chains():
    """Every call sees the whole (C, D) batch, never a chain alone, and none
    asks for a gradient."""
    shapes = []

    def logp(u):
        shapes.append((tuple(u.shape), torch.is_grad_enabled()))
        return _gauss_logp(u)

    init = torch.zeros((5, 2))
    _, info = ts.run_slice(make_generator(0), logp, init, num_warmup=3, num_samples=4)
    assert set(shapes) == {((5, 2), False)}
    assert info["potential_calls"] == len(shapes)


def test_slice_gives_each_chain_its_own_data():
    """``data`` (leading axis C) conditions each chain's density, as in
    ``run_nuts`` and the JAX ``run_slice``: chain c samples N(data[c], 0.3^2)."""
    centers = torch.tensor([[-3.0, 0.0], [0.0, 2.0], [5.0, -1.0]])
    samples, _ = ts.run_slice(12, lambda u, c: -0.5 * (((u - c) / 0.3) ** 2).sum(-1), torch.zeros((3, 2)),
                              num_warmup=50, num_samples=300, data=centers)
    torch.testing.assert_close(samples.mean(1), centers, atol=0.1, rtol=0)
    assert torch.allclose(samples.std(1), torch.full((3, 2), 0.3), atol=0.06)


@pytest.mark.parametrize("sigma", [0.01, 10.0])
def test_slice_width_adaptation(sigma):
    """Warmup adapts the bracket to the target's scale: a posterior with
    sigma = 0.01 and one with sigma = 10 both mix from the default width."""
    init = torch.full((2, 2), 0.1 * sigma)
    samples, info = ts.run_slice(8, lambda u: -0.5 * ((u / sigma) ** 2).sum(-1), init,
                                 num_warmup=200, num_samples=500)
    s = samples.reshape(-1).numpy()
    assert abs(s.std() / sigma - 1.0) < 0.25, f"sigma={sigma}: std={s.std()}"
    # Adapted widths land within an order of magnitude of 4 sigma.
    w = float(info["width"].median())
    assert 0.4 * sigma < w < 40 * sigma, f"sigma={sigma}: width={w}"
    assert 0.0 < float(info["accept_prob"].mean()) <= 1.0


def test_slice_matches_the_jax_sampler_in_distribution():
    """The port's and the JAX package's run_slice on one correlated 2-D
    Gaussian from the same numpy starts: a two-sample KS test per dimension
    on every 5th draw (thinned so the draws are close to independent) must
    not reject at p = 1e-3; both runs are seeded, so the test is
    deterministic."""
    init = np.random.default_rng(3).normal(size=(8, 2)).astype(np.float32)
    prec = jnp.asarray(PREC)

    def jax_logp(u):
        d = u - jnp.asarray(MU)
        return -0.5 * d @ prec @ d

    js, _ = jax_run_slice(jax.random.key(4), jax_logp, jnp.asarray(init), num_warmup=100, num_samples=500)
    tsamp, _ = ts.run_slice(4, _gauss_logp, torch.from_numpy(init), num_warmup=100, num_samples=500)
    a = np.asarray(js)[:, ::5].reshape(-1, 2)
    b = tsamp[:, ::5].reshape(-1, 2).numpy()
    for d in range(2):
        p = stats.ks_2samp(a[:, d], b[:, d]).pvalue
        assert p > 1e-3, f"dim {d}: KS p = {p:.3g}"


class _ProductPotential:
    """Beta(5, 5) x LogNormal(0, 0.5): a potential with the prior folded in."""

    prior = MultipleIndependent([Beta(5.0, 5.0), LogNormal(0.0, 0.5)])

    def potential_fn(self, theta):
        return self.prior.log_prob(theta)


def _posterior(method, **kw):
    pot = _ProductPotential()
    return tm.MCMCPosterior(pot, pot.prior, mcmc_transform(pot.prior), method=method, num_chains=4,
                            verbose=False, device="cpu", **kw)


def test_mcmc_posterior_slice_method_with_resampled_starts():
    post = _posterior("slice_np_vectorized", warmup_steps=50, init_strategy="resample")
    s = post.sample((200,), seed=9)
    assert s.shape == (200, 2) and not post.used_fallback
    assert torch.all((s[:, 0] > 0) & (s[:, 0] < 1)) and torch.all(s[:, 1] > 0)
    assert abs(float(s[:, 0].mean()) - 0.5) < 0.1
    assert set(post.last_info) == {"accept_prob", "width", "potential_calls"}


def test_nuts_slice_auto_fallback(monkeypatch):
    """A divergence storm triggers the reference notebooks' NUTS -> slice
    fallback (ryans_test.ipynb cell 4), and the samples come from the slice
    sampler over the prior's support."""

    def fake_run_nuts(seed, logp, init_u, *, num_warmup, num_samples, **kw):
        C, D = init_u.shape
        return torch.zeros((C, num_samples, D)), {
            "accept_prob": torch.full((C, num_samples), 0.1),
            "diverging": torch.ones((C, num_samples), dtype=torch.bool),
            "num_steps": torch.ones((C, num_samples), dtype=torch.int64),
        }

    monkeypatch.setattr(tm, "run_nuts", fake_run_nuts)
    post = _posterior("nuts", warmup_steps=50)
    s = post.sample((200,), seed=10)
    assert post.used_fallback
    assert torch.all((s[:, 0] > 0) & (s[:, 0] < 1)) and torch.all(s[:, 1] > 0)
    assert abs(float(s[:, 0].mean()) - 0.5) < 0.1
    assert "width" in post.last_info


def test_healthy_nuts_does_not_fall_back():
    post = _posterior("nuts", warmup_steps=150, max_tree_depth=5)
    s = post.sample((200,), seed=11)
    assert not post.used_fallback
    assert "diverging" in post.last_info and math.isfinite(float(s.sum()))


@pytest.mark.parametrize("method", ["slice", "slice_np_vectorized"])
def test_parallel_tempering_with_slice_raises_as_in_jax(method):
    """Parallel tempering is NUTS-only: the JAX MCMCPosterior refuses
    pt_replicas > 1 with the slice sampler, and so does the port, where it
    would otherwise sample without tempering."""
    pot = _ProductPotential()
    with pytest.raises(ValueError, match=r"pt_replicas > 1 requires the NUTS"):
        _posterior(method, pt_replicas=6)
    with pytest.raises(ValueError, match=r"pt_replicas > 1 requires the NUTS"):
        jm.MCMCPosterior(pot, None, None, method=method, pt_replicas=6)
    assert _posterior("nuts", pt_replicas=6).pt_replicas == 6
