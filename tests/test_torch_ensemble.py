"""PyTorch port: ``mnle.MNLEEnsemble`` / ``load_ensemble`` against the JAX
package's (after ``tests/test_ensemble.py``): the mixture's log-mean-exp,
the closed-form likelihood gradient (the mixture per trial row, each
member's row gradient weighed by its share of the row), the SBC fold of
several sessions against single-session calls, the kernel launches a call
(one per member), sampling, persistence, and the errors."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu import potentials as jp
from sbi_for_diffusion_models_tpu.nets import mnle_net as jnet
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import potentials as tp
from sbi_for_diffusion_models_tpu_torch.nets import mnle_net as tnet

SMALL = dict(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=6)
REPS = {
    "log": dict(),
    "shifted_log_sharp": dict(rt_rep="shifted_log", censor_rt=True, log_condition_dims=(1, 2, 3), cond_affine=True,
                              tail_sharp_k=1.5, tail_sharp_c=-2.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _member(seed, rep="log", **kw):
    """A small JAX member (its own weights and stats) and its port (made
    once per arguments; the tests do not change them)."""
    cfg = jnet.MNLEConfig(**SMALL, **REPS[rep], **kw)
    jest = jnet.build_mnle(jax.random.key(seed), cfg)
    rng = np.random.default_rng(100 + seed)
    jest = jest.__class__(
        cfg=cfg, params=jest.params,
        cond_mean=jnp.asarray(0.1 * rng.normal(size=85), jnp.float32),
        cond_std=jnp.asarray(rng.uniform(0.7, 1.4, 85), jnp.float32),
        x_mean=jnp.float32(rng.uniform(-0.8, -0.2)), x_std=jnp.float32(rng.uniform(0.8, 1.5)),
        train_meta={"num_train": 100 * (seed + 1), "best_val_loss": -float(seed)},
    )
    tree = jax.tree.map(np.asarray, jest.params)
    est = tnet.mnle_from_flax_params(tnet.MNLEConfig(**cfg.__dict__), tree, jest.cond_mean, jest.cond_std,
                                     jest.x_mean, jest.x_std, train_meta=jest.train_meta, device="cpu")
    return jest, est


def _ensembles(rep="log"):
    pairs = [_member(s, rep) for s in range(3)]
    return jmnle.MNLEEnsemble([j for j, _ in pairs]), tmnle.MNLEEnsemble([t for _, t in pairs])


def _rows(n, seed=31):
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.2, 0.8, n), rng.lognormal(-1, 0.5, n), rng.lognormal(0, 0.5, n),
                      rng.lognormal(2.75, 0.3, n), rng.uniform(0.01, 0.3, n)], -1)
    cond = np.concatenate([theta, np.where(rng.random((n, 80)) < 0.5, 1.0, -1.0)], -1)
    choice = rng.choice([0.0, 1.0, 2.0], n, p=[0.45, 0.4, 0.15])
    rt = np.where(choice == 2.0, 8.0, theta[:, 4] + rng.gamma(2.0, 0.3, n))
    return np.stack([rt, choice], -1).astype(np.float32), cond.astype(np.float32)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_log_prob_is_log_mean_exp_and_matches_jax(rep):
    jens, ens = _ensembles(rep)
    x, cond = _rows(33)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    got = ens.log_prob(xt, ct).numpy()
    members = np.stack([m.log_prob(xt, ct).numpy() for m in ens.members]).astype(np.float64)
    want = np.log(np.mean(np.exp(members), axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jens.log_prob(jnp.asarray(x), jnp.asarray(cond))), rtol=1e-4,
                               atol=1e-4)
    for kernel in ("xla", "pallas", "auto"):  # the members' fused paths on CPU rows, mixed
        np.testing.assert_allclose(ens.dispatch_log_prob(kernel)(xt, ct).detach().numpy(), got, rtol=1e-5, atol=1e-5)


def _session(T=25, seed=32):
    rng = np.random.default_rng(seed)
    choice = rng.choice([0.0, 1.0, 2.0], T, p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.12 + rng.gamma(2.0, 0.3, T))
    pulses = np.where(rng.random((T, 80)) < 0.5, 1.0, -1.0)
    return np.stack([rt, choice], -1).astype(np.float32), pulses.astype(np.float32)


@pytest.mark.parametrize("rep", sorted(REPS))
def test_mixture_gradient_matches_autograd_and_jax(rep):
    """``log_lik_and_grad`` of the ensemble (K3 per member, the rows mixed
    by log-mean-exp, each member's row gradient weighed by its softmax share
    of the row) against autograd of ``log_lik_fn`` and against ``jax.grad``
    of the JAX ensemble's likelihood; and not the mixture of session
    likelihoods, which differs."""
    jens, ens = _ensembles(rep)
    x_o, pulses = _session()
    theta = _rows(6, seed=33)[1][:, :5]
    theta[:, 4] = np.asarray([0.02, 0.05, 0.08, 0.1, 0.11, 0.3], np.float32)  # the last past the first RT
    jlik = jp.ConditionedMNLELogLikelihood(jens, pulses, logprob_kernel="xla")
    ref_v = np.asarray(jax.jit(lambda th: jlik.log_lik_fn(jens.params, jnp.asarray(x_o), th))(jnp.asarray(theta)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda th: jnp.sum(jlik.log_lik_fn(jens.params, jnp.asarray(x_o), th))))(
        jnp.asarray(theta)))
    lik = tp.ConditionedMNLELogLikelihood(ens, pulses, logprob_kernel="pallas")
    x, th = torch.from_numpy(x_o), torch.from_numpy(theta)
    ll, g = lik.log_lik_and_grad(x, th)
    th_ = th.clone().requires_grad_(True)
    ll_auto = lik.log_lik_fn(ens.params, x, th_)
    (g_auto,) = torch.autograd.grad(ll_auto.sum(), th_)
    np.testing.assert_allclose(ll.numpy(), ll_auto.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-5, atol=1e-5 * float(g_auto.abs().max()))
    np.testing.assert_allclose(ll.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    assert torch.equal(lik.log_lik_and_grad(x, th, need_grad=False)[0], ll)
    # The mixture of whole-session likelihoods is another target.
    per_member = torch.stack([tp.ConditionedMNLELogLikelihood(m, pulses, logprob_kernel="pallas")
                              .log_lik_and_grad(x, th, False)[0] for m in ens.members])
    session_mixture = torch.logsumexp(per_member, 0) - math.log(3)
    assert float((session_mixture - ll).abs().max()) > 1e-2


def test_fold_of_two_sessions_equals_two_single_session_calls():
    """The SBC fold (G sessions in one call, each theta row naming its own)
    gives each row what a single-session call gives it."""
    _, ens = _ensembles("shifted_log_sharp")
    xs, ps = zip(*(_session(seed=s) for s in (40, 41)))
    theta = torch.from_numpy(_rows(8, seed=34)[1][:, :5])
    sessions = torch.tensor([0, 1, 1, 0, 0, 1, 0, 1])
    fold = tp.ConditionedMNLELogLikelihood(ens, np.stack(ps), logprob_kernel="pallas")
    ll, g = fold.log_lik_and_grad(torch.from_numpy(np.stack(xs)), theta, sessions=sessions)
    for d in (0, 1):
        idx = torch.nonzero(sessions == d).reshape(-1)
        single = tp.ConditionedMNLELogLikelihood(ens, ps[d], logprob_kernel="pallas")
        ll_d, g_d = single.log_lik_and_grad(torch.from_numpy(xs[d]), theta[idx])
        np.testing.assert_allclose(ll[idx].numpy(), ll_d.numpy(), rtol=1e-6)
        np.testing.assert_allclose(g[idx].numpy(), g_d.numpy(), rtol=1e-5, atol=1e-5 * float(g_d.abs().max()))


def test_a_call_launches_one_kernel_per_member(monkeypatch):
    """A gradient call reaches the combined value-and-VJP wrapper once per
    member (K3, K launches on the card) and no other; a value-only call the
    value wrapper once per member (K2)."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    names = ("rows_logp", "rows_logp_and_vjp", "rows_logp_vjp")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(mc, name)
        monkeypatch.setattr(mc, name, lambda *a, _n=name, _f=fn: (calls.__setitem__(_n, calls[_n] + 1), _f(*a))[1])
    _, ens = _ensembles()
    x_o, pulses = _session()
    lik = tp.ConditionedMNLELogLikelihood(ens, pulses, logprob_kernel="pallas")
    theta = torch.from_numpy(_rows(4, seed=35)[1][:, :5])
    lik.log_lik_and_grad(torch.from_numpy(x_o), theta)
    assert calls == {"rows_logp": 0, "rows_logp_and_vjp": 3, "rows_logp_vjp": 0}
    lik.log_lik_and_grad(torch.from_numpy(x_o), theta, need_grad=False)
    assert calls == {"rows_logp": 3, "rows_logp_and_vjp": 3, "rows_logp_vjp": 0}


def test_sample_rows_come_from_members():
    from test_torch_sample import same_distribution

    jens, ens = _ensembles()
    _, cond = _rows(8, seed=36)
    gen = torch.Generator().manual_seed(7)
    draw = ens.sample(gen, torch.from_numpy(cond))
    assert draw.shape == (8, 2)
    # The same generator state: the picks, then each member's draws in turn.
    gen = torch.Generator().manual_seed(7)
    pick = torch.randint(3, (8,), generator=gen)
    member = torch.stack([m.sample_fn(m.params, gen, torch.from_numpy(cond)) for m in ens.members])
    assert torch.equal(draw, member[pick, torch.arange(8)])
    # In distribution, against the JAX ensemble's sampler.
    big = _rows(12, seed=37)[1][np.arange(6000) % 12]
    p = same_distribution(ens.sample(3, torch.from_numpy(big)).numpy(),
                          np.asarray(jax.jit(jens.sample)(jax.random.key(2), jnp.asarray(big))))
    assert min(p.values()) >= 1e-3, p


def test_save_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    (_, m0), (_, m1) = _member(0), _member(1)
    tmnle.save_model(m0, filename="e.m0.npz")
    tmnle.save_model(m1, filename="e.m1.npz")
    ens2 = tmnle.load_ensemble("e.m0.npz,e.m1.npz", device="cpu")
    assert len(ens2) == 2 and ens2.device == torch.device("cpu")
    x, cond = _rows(7, seed=38)
    want = tmnle.MNLEEnsemble([m0, m1]).log_prob(torch.from_numpy(x), torch.from_numpy(cond))
    assert torch.equal(ens2.log_prob(torch.from_numpy(x), torch.from_numpy(cond)), want)
    assert ens2.train_meta["ensemble_size"] == 2 and ens2.train_meta["num_train"] == 300
    assert ens2.train_meta["best_val_loss"] == [-0.0, -1.0]
    jens = jmnle.load_ensemble(["e.m0.npz", "e.m1.npz"])
    np.testing.assert_allclose(want.numpy(), np.asarray(jens.log_prob(jnp.asarray(x), jnp.asarray(cond))),
                               rtol=1e-4, atol=1e-4)


def test_config_mismatch_raises():
    with pytest.raises(ValueError, match="share one MNLEConfig"):
        tmnle.MNLEEnsemble([_member(0)[1], _member(1, tail_bound=4.0)[1]])


def test_empty_raises():
    with pytest.raises(ValueError, match="at least one member"):
        tmnle.MNLEEnsemble([])


def test_run_sbc_serves_an_ensemble(tmp_path):
    """The SBC fold (datasets x chains in one call, each row its session)
    takes an ensemble as it takes one estimator: ranks in range, the pooled
    draws inside the prior's support."""
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS

    _, ens = _ensembles("shifted_log_sharp")
    prior = build_prior_theta()
    cfg = RUN_CONFIG_PARAMS.replace(NUM_TRIALS_OBS=5, NUM_CHAINS=2, WARMUP_STEPS=4, SBC_NUM_DATASETS=2,
                                    SBC_POST_SAMPLES=4, MCMC_MAX_TREE_DEPTH=2, SBC_REMEDIATE=False,
                                    POSTERIOR_SAMPLES=4, MCMC_AUTO_FALLBACK=False)
    out = tmnle.run_sbc(cfg, prior, ens, "cpu", outdir=tmp_path, seed=0, verbose=False)
    assert out["ranks"].shape == (2, 5) and ((out["ranks"] >= 0) & (out["ranks"] <= 4)).all()
    assert out["potential_calls"] > 0
    samples = torch.from_numpy(np.stack(out["all_samples"]))
    assert samples.shape == (2, 4, 5) and bool(torch.isfinite(prior.log_prob(samples)).all())
