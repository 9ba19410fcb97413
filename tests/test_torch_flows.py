"""PyTorch port: the coupling NSF (``nets/flows.py``) and SNPE/SNLE
(``snpe.py``) against the JAX package.

A JAX flow's weights are carried into the port (``flow_from_flax_params``)
and back (``flow_to_flax_params``) unchanged; on the same weights the two
packages' ``log_prob`` agree to 1e-4 x max(1, |ref|) for d = 1 and d = 3
(the splines' float32 arithmetic differs in its last bits), and their draws
agree in distribution (two-sample KS per dimension, p > 1e-3). Training is
the port's own (``torch.optim.Adam``); it is held to lowering the
validation loss. SNPE's draws stay in the prior's support; SNLE's
potential equals JAX's on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu import snpe as jsnpe
from sbi_for_diffusion_models_tpu.nets import flows as jflows
from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch import snpe as tsnpe
from sbi_for_diffusion_models_tpu_torch.inference.mcmc import MCMCPosterior
from sbi_for_diffusion_models_tpu_torch.nets import flows as tflows
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS

LO, HI = np.array([0.1, 0.05, 0.2, 2.0, 0.0], np.float32), np.array([0.9, 1.0, 3.0, 20.0, 0.5], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_flow(dim, context_dim, seed=0):
    """A JAX flow with random weights (init, then every leaf perturbed so the
    splines are not near the identity) and non-trivial stats."""
    cfg = jflows.NSFConfig(dim=dim, context_dim=context_dim, hidden_features=16, num_transforms=3, num_bins=5)
    rng = np.random.default_rng(seed)
    stats_ = {"y_mean": rng.normal(size=dim), "y_std": rng.uniform(0.5, 2.0, dim),
              "c_mean": rng.normal(size=context_dim), "c_std": rng.uniform(0.5, 2.0, context_dim)}
    stats_ = {k: v.astype(np.float32) for k, v in stats_.items()}
    flow = jflows.build_flow(jax.random.key(seed), cfg, **stats_)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
                                    flow.params)
    flow = jflows.FlowEstimator(cfg=cfg, params=params, **{k: jnp.asarray(v) for k, v in stats_.items()})
    port = tflows.flow_from_flax_params(tflows.NSFConfig(**cfg.__dict__), params, stats_, device="cpu")
    return flow, port, params


def test_torch_flax_round_trip():
    _, port, params = _jax_flow(3, 2)
    back = tflows.flow_to_flax_params(port)
    assert set(back) == set(params) == {f"conditioner_{t}" for t in range(3)}
    for cond in params:
        assert set(back[cond]) == set(params[cond]) == {"layers_0", "layers_2", "layers_4"}
        for layer in params[cond]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[cond][layer][leaf], params[cond][layer][leaf])
    with pytest.raises(ValueError, match="kernel shape"):
        tflows.flow_from_flax_params(tflows.NSFConfig(dim=2, context_dim=2, hidden_features=16, num_transforms=3,
                                                      num_bins=5), params, {}, device="cpu")


@pytest.mark.parametrize("dim", [1, 3])
def test_torch_log_prob_matches_jax(dim):
    """On the same weights and stats, 512 points (inside and outside the
    spline's tail bound): log_prob within 1e-4 x max(1, |ref|)."""
    flow, port, _ = _jax_flow(dim, 2, seed=dim)
    rng = np.random.default_rng(10 + dim)
    y = (rng.standard_normal((512, dim)) * 3.0).astype(np.float32)
    c = rng.standard_normal((512, 2)).astype(np.float32)
    want = np.asarray(flow.log_prob(y, c))
    got = port.log_prob(y, c).detach().numpy()
    assert got.shape == (512,) and np.all(np.isfinite(want))
    np.testing.assert_array_less(np.abs(got - want), 1e-4 * np.maximum(1.0, np.abs(want)))
    if dim == 1:  # every layer transforms the single dimension
        assert not port.net.masks.any()
    else:
        np.testing.assert_array_equal(port.net.masks.numpy(), [[True, False, True], [False, True, False]] * 1
                                      + [[True, False, True]])


@pytest.mark.parametrize("dim", [1, 3])
def test_torch_sample_matches_jax_in_distribution(dim):
    flow, port, _ = _jax_flow(dim, 2, seed=20 + dim)
    c = np.tile(np.array([[0.3, -0.8]], np.float32), (4000, 1))
    want = np.asarray(flow.sample(jax.random.key(3), c))
    got = port.sample(5, c).numpy()
    assert got.shape == (4000, dim) and np.all(np.isfinite(got))
    for k in range(dim):
        assert stats.ks_2samp(got[:, k], want[:, k]).pvalue > 1e-3
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(port.sample(gen, c[:3]), port.sample(torch.Generator().manual_seed(5), c[:3]))


def test_torch_fit_flow_lowers_the_validation_loss():
    """A conditional Gaussian y = 2 c + 0.3 eps: eight epochs of ``fit_flow``
    take the validation loss below the untrained flow's, and the returned
    flow is the best epoch's."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((800, 1)).astype(np.float32)
    y = (2.0 * c + 0.3 * rng.standard_normal((800, 1))).astype(np.float32)
    cfg = tflows.NSFConfig(dim=1, context_dim=1, hidden_features=16, num_transforms=2, num_bins=5)
    flow = tflows.build_flow(0, cfg, device="cpu", y_mean=y.mean(0), y_std=y.std(0), c_mean=c.mean(0),
                             c_std=c.std(0))
    with torch.no_grad():
        before = float(-flow.log_prob(y, c).mean())
    fitted = tflows.fit_flow(flow, y, c, batch_size=64, max_epochs=8, patience=8, learning_rate=3e-3, seed=1)
    meta = fitted.train_meta
    assert len(meta["val_losses"]) == meta["epochs"] == 8 and meta["steps_per_epoch"] == 720 // 64
    assert meta["val_losses"][-1] < meta["val_losses"][0] - 0.2 and min(meta["val_losses"]) < before - 0.3
    assert meta["best_val_loss"] == min(meta["val_losses"]) and meta["step_ms"] > 0
    assert not any(p.requires_grad for p in fitted.net.parameters())


def _box_data(n, seed):
    """BoxUniform thetas and a 2-d summary of each (mean and spread of a
    noisy function of theta), made with numpy."""
    rng = np.random.default_rng(seed)
    theta = (LO + (HI - LO) * rng.random((n, 5))).astype(np.float32)
    x = np.stack([theta[:, 0] + 0.1 * theta[:, 2] + 0.05 * rng.standard_normal(n),
                  np.log(theta[:, 3]) + 0.1 * rng.standard_normal(n)], -1).astype(np.float32)
    return theta, x


CFG = RUN_CONFIG_PARAMS.replace(TRAIN_MAX_EPOCHS=3, TRAIN_STOP_AFTER_EPOCHS=3, TRAIN_BATCH_SIZE=128, NUM_CHAINS=2,
                                WARMUP_STEPS=5, MCMC_MAX_TREE_DEPTH=3)


def test_torch_snpe_draws_stay_inside_the_prior():
    """SNPE on 2,000 box draws, 15 epochs; the observation is the summary
    of the box's center. A single pass of the flow there leaves some draws
    outside the box; ``sample``'s re-draws (20 passes at most) take every
    one of 500 in, and the same seed gives the same draws."""
    theta, x = _box_data(2000, 0)
    prior = td.BoxUniform(LO, HI)
    post = tsnpe.train_snpe(CFG.replace(TRAIN_MAX_EPOCHS=15, TRAIN_STOP_AFTER_EPOCHS=15), prior, theta, x,
                            hidden_features=16, num_transforms=2, num_bins=5, seed=0, device="cpu")
    assert isinstance(post, tsnpe.DirectPosterior)
    center = (LO + HI) / 2
    x_o = np.array([center[0] + 0.1 * center[2], np.log(center[3])], np.float32)
    raw = post.flow.sample(torch.Generator().manual_seed(0), np.tile(x_o, (500, 1)))
    inside = float(torch.isfinite(prior.log_prob(raw)).double().mean())
    assert 0.05 < inside < 1.0, inside
    draws = post.sample((500,), x_o, seed=4)
    assert draws.shape == (500, 5) and bool(torch.isfinite(prior.log_prob(draws)).all())
    assert torch.equal(draws, post.sample((500,), x_o, seed=4))
    assert post.sample((7,), x_o, generator=torch.Generator().manual_seed(1)).shape == (7, 5)
    assert post.log_prob(draws[:3], np.tile(x_o, (3, 1))).shape == (3,)


def test_torch_snle_potential_matches_jax():
    """``SNLEPotential.potential_fn`` on the same flow weights (a q(x |
    theta) of d = 2 given the 5 thetas) and 6 observations: equal to JAX's
    at each theta to 1e-4 x max(1, |ref|), one theta at a time and in a
    batch; outside the box the prior makes it -inf."""
    flow, port, _ = _jax_flow(2, 5, seed=7)
    rng = np.random.default_rng(8)
    x_o = rng.standard_normal((6, 2)).astype(np.float32)
    theta = (LO + (HI - LO) * rng.random((4, 5))).astype(np.float32)
    jpot = jsnpe.SNLEPotential(jd.BoxUniform(jnp.asarray(LO), jnp.asarray(HI)), flow, x_o=x_o)
    tpot = tsnpe.SNLEPotential(td.BoxUniform(LO, HI), port, x_o=x_o)
    want = np.array([float(jpot.potential_fn(jnp.asarray(t))) for t in theta])
    batch = tpot.potential_fn(torch.from_numpy(theta)).detach().numpy()
    one = np.array([float(tpot.potential_fn(torch.from_numpy(t))) for t in theta])
    np.testing.assert_array_less(np.abs(batch - want), 1e-4 * np.maximum(1.0, np.abs(want)))
    np.testing.assert_array_equal(one, batch)
    bad = theta[:1].copy()
    bad[0, 3] = 30.0
    assert float(tpot.potential_fn(torch.from_numpy(bad))[0]) == -np.inf


def test_torch_train_snle_makes_an_mcmc_posterior():
    theta, x = _box_data(600, 1)
    prior = td.BoxUniform(LO, HI)
    flow, make_posterior = tsnpe.train_snle(CFG, prior, theta, x, hidden_features=16, num_transforms=2, num_bins=5,
                                            seed=2, device="cpu")
    assert isinstance(flow, tflows.FlowEstimator) and flow.cfg.dim == 2 and flow.cfg.context_dim == 5
    post = make_posterior(x[:4])
    assert isinstance(post, MCMCPosterior) and post.device.type == "cpu" and post.method == "nuts"
    draws = post.sample((8,), seed=1)
    assert draws.shape == (8, 5) and bool(torch.isfinite(prior.log_prob(draws)).all())
    assert make_posterior(x[:4], method="slice").method == "slice"
