"""PyTorch port: the left-tail sharpening (``MNLEConfig.tail_sharp_k``)
against the JAX package, on the committed sharp model
(``artifacts/models/mnle_10m_shifted_logt_sharp.npz``: shifted-log RT,
log-theta dims, k = 1.5) and on a small model whose sharpening clamp binds:
``log_prob``, the fused path on CPU rows, ``log_lik_and_grad`` (the
transform's derivative in closed form) against autograd and ``jax.grad``,
the Newton inverse, and ``train_mnle``'s automatic threshold."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu import potentials as jp
from sbi_for_diffusion_models_tpu.nets import mnle_net as jnet
from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS as J_RUN_CONFIG
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import potentials as tp
from sbi_for_diffusion_models_tpu_torch.nets import mnle_net as tnet
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS

SHARP = "mnle_10m_shifted_logt_sharp.npz"
MODELS = Path(__file__).resolve().parents[1] / "artifacts" / "models"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharp():
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_DIR", str(MODELS))
    try:
        yield jmnle.load_model(SHARP), tmnle.load_model(SHARP, device="cpu")
    finally:
        mp.undo()


def _rows(n, seed=1):
    """n (x, condition) rows: prior-like theta, +-1 pulses, RTs after the
    onset (some censored at the 8 s window end), a few RTs just past it,
    where the sharpening acts."""
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.2, 0.8, n), rng.lognormal(-1, 0.5, n), rng.lognormal(0, 0.5, n),
                      rng.lognormal(2.75, 0.3, n), rng.uniform(0.01, 0.3, n)], -1)
    pulses = np.where(rng.random((n, 80)) < 0.5, 1.0, -1.0)
    choice = rng.choice([0.0, 1.0, 2.0], n, p=[0.45, 0.4, 0.15])
    rt = theta[:, 4] + rng.gamma(2.0, 0.3, n)
    rt[: n // 8] = theta[: n // 8, 4] + rng.uniform(1e-4, 2e-2, n // 8)  # just past the onset
    rt = np.where(choice == 2.0, 8.0, rt)
    cond = np.concatenate([theta, pulses], -1)
    return np.stack([rt, choice], -1).astype(np.float32), cond.astype(np.float32)


COMMITTED = sorted(p.name for p in MODELS.glob("*.npz"))


@pytest.mark.parametrize("model_file", COMMITTED)
def test_committed_model_log_prob_matches_jax(model_file, monkeypatch):
    """Every committed model loads in the port, and on 64 rows its
    ``log_prob`` and its fused path (the ``autograd.Function`` on CPU rows)
    agree with JAX's ``log_prob`` within 1e-3 x max(1, |ref|). Models
    without censoring get choice-2 rows with ordinary RTs: at the 8 s point
    mass their flow is evaluated where float32 itself (in either package) is
    off the float64 value by more than this tolerance."""
    monkeypatch.setenv("MODEL_DIR", str(MODELS))
    jest, est = jmnle.load_model(model_file), tmnle.load_model(model_file, device="cpu")
    x, cond = _rows(64)
    if not est.cfg.censor_rt:
        x[:, 0] = np.where(x[:, 1] == 2.0, cond[:, 4] + np.random.default_rng(2).gamma(2.0, 0.3, 64), x[:, 0])
    ref = np.asarray(jest.log_prob(jnp.asarray(x), jnp.asarray(cond)))
    lp = est.log_prob(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert np.isfinite(ref).all() and np.isfinite(lp).all()
    assert np.abs(lp - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())
    if not (est.cfg.rt_rep == "pulse" and not est.cfg.circular):
        fused = est.dispatch_log_prob("pallas")(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy()
        np.testing.assert_allclose(fused, lp, rtol=1e-5, atol=1e-5)


def test_sharp_model_is_the_round_4_flagship(sharp):
    """The committed sharp model is the shifted-log, log-theta model with
    k = 1.5 and a threshold resolved by training (c = -3.171)."""
    _, est = sharp
    cfg = est.cfg
    assert (cfg.rt_rep, cfg.censor_rt, cfg.log_condition_dims) == ("shifted_log", True, (1, 2, 3))
    assert cfg.tail_sharp_k == 1.5 and cfg.tail_sharp_c == pytest.approx(-3.1711874)


def _small_sharp(k=3.0, c=-1.0):
    """A small shifted-log JAX model with a steep sharpening, so rows at
    the onset floor sit where its clamp at 30 binds; and its port."""
    cfg = jnet.MNLEConfig(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=6, rt_rep="shifted_log",
                          censor_rt=True, log_condition_dims=(1, 2, 3), tail_sharp_k=k, tail_sharp_c=c)
    jest = jnet.build_mnle(jax.random.key(4), cfg, x_mean=-0.7, x_std=1.1)
    tree = jax.tree.map(np.asarray, jest.params)
    est = tnet.mnle_from_flax_params(tnet.MNLEConfig(**cfg.__dict__), tree, jest.cond_mean, jest.cond_std,
                                     jest.x_mean, jest.x_std, device="cpu")
    return jest, est


def _session(seed=7, T=40):
    rng = np.random.default_rng(seed)
    choice = rng.choice([0.0, 1.0, 2.0], T, p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.12 + rng.gamma(2.0, 0.3, T))
    pulses = np.where(rng.random((T, 80)) < 0.5, 1.0, -1.0)
    return np.stack([rt, choice], -1).astype(np.float32), pulses.astype(np.float32)


def _thetas():
    """Eight thetas: onsets well below the session's first RT, just below
    it (the sharpened left tail), and past it (the floor and barrier)."""
    rng = np.random.default_rng(8)
    x, _ = _session()
    first = float(x[x[:, 1] != 2, 0].min())
    tnd = np.asarray([0.02, 0.06, first - 0.05, first - 0.01, first - 1e-3, first - 1e-5, first + 0.01, first + 0.2])
    return np.stack([rng.uniform(0.2, 0.8, 8), rng.lognormal(-1, 0.5, 8), rng.lognormal(0, 0.5, 8),
                     rng.lognormal(2.75, 0.3, 8), tnd], -1).astype(np.float32)


@pytest.mark.parametrize("model", ["committed", "clamped"])
def test_sharp_log_lik_and_grad_matches_autograd_and_jax(model, sharp):
    """``log_lik_and_grad`` (the sharpening chained into t_nd's gradient in
    closed form, before the kernel's dt) against autograd of ``log_lik_fn``
    and against ``jax.grad`` of the JAX likelihood, with onsets below, at
    and past the first RT; on the small model the clamp binds on the rows
    at the onset floor."""
    jest, est = sharp if model == "committed" else _small_sharp()
    x_o, pulses = _session()
    theta = _thetas()
    jlik = jp.ConditionedMNLELogLikelihood(jest, pulses, logprob_kernel="xla")
    ref_v = np.asarray(jax.jit(lambda th: jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))(jnp.asarray(theta)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda th: jnp.sum(jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))))(
        jnp.asarray(theta)))

    lik = tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas")
    x, th = torch.from_numpy(x_o), torch.from_numpy(theta)
    ll, g = lik.log_lik_and_grad(x, th)
    th_ = th.clone().requires_grad_(True)
    ll_auto = lik.log_lik_fn(est.params, x, th_)
    (g_auto,) = torch.autograd.grad(ll_auto.sum(), th_)
    if model == "clamped":  # some rows at the floor sit where the clamp binds
        t_floor = (np.log(1e-6) - float(est.x_mean)) / float(est.x_std)
        assert -est.cfg.tail_sharp_k * (t_floor - est.cfg.tail_sharp_c) > 30.0
    np.testing.assert_allclose(ll.numpy(), ll_auto.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-5, atol=1e-5 * float(g_auto.abs().max()))
    np.testing.assert_allclose(ll.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    assert np.isfinite(g.numpy()).all()
    assert torch.equal(lik.log_lik_and_grad(x, th, need_grad=False)[0], ll)


def test_tail_sharp_inverse_round_trip_and_jax():
    """The Newton inverse (30 steps, no early exit) against the JAX one and
    as the inverse of the transform, from far below the threshold (where
    the clamp binds) to far above it; the transform's log-det against JAX."""
    cfg = tnet.MNLEConfig(tail_sharp_k=1.5, tail_sharp_c=-3.171)
    jcfg = jnet.MNLEConfig(tail_sharp_k=1.5, tail_sharp_c=-3.171)
    t = np.concatenate([np.linspace(-25.0, 6.0, 4001), [-3.171, -3.17]]).astype(np.float32)
    y, ld = tnet.tail_sharp_transform(cfg, torch.from_numpy(t))
    jy, jld = jnet.tail_sharp_transform(jcfg, jnp.asarray(t))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-6, atol=1e-6)
    back = tnet.tail_sharp_inverse(cfg, y)
    np.testing.assert_allclose(back.numpy(), np.asarray(jnet.tail_sharp_inverse(jcfg, jy)), rtol=1e-6, atol=1e-5)
    unclamped = -1.5 * (t + 3.171) < 30.0  # where the clamp binds, phi is a shift and y rounds away t's bits
    np.testing.assert_allclose(back.numpy()[unclamped], t[unclamped], rtol=1e-5, atol=1e-5)
    assert np.isfinite(back.numpy()).all()


def test_auto_threshold_equals_jax():
    """``MNLE_TAIL_SHARP_C=None``: the threshold train_mnle resolves (the
    0.001 quantile of the standardized flow coordinate over the rows that
    are not censored, minus 0.25) equals the JAX package's on the same
    pairs, and the saved config carries it."""
    rng = np.random.default_rng(3)
    n = 3000
    z = np.concatenate([np.stack([rng.uniform(0.2, 0.8, n), rng.lognormal(-1, 0.5, n), rng.lognormal(0, 0.5, n),
                                  rng.lognormal(2.75, 0.3, n), rng.uniform(0.01, 0.3, n)], -1),
                        np.where(rng.random((n, 80)) < 0.5, 1.0, -1.0)], -1).astype(np.float32)
    choice = rng.choice([0.0, 1.0, 2.0], n, p=[0.45, 0.4, 0.15])
    rt = np.where(choice == 2.0, 8.0, z[:, 4] + rng.gamma(2.0, 0.3, n))
    x = np.stack([rt, choice], -1).astype(np.float32)
    flags = dict(MNLE_RT_REP="shifted_log", MNLE_CENSOR_RT=True, MNLE_TAIL_SHARP_K=1.5, MNLE_TAIL_SHARP_C=None,
                 MNLE_HIDDEN_FEATURES=8, MNLE_NUM_TRANSFORMS=1, MNLE_NUM_BINS=4, TRAIN_MAX_EPOCHS=0)
    proposal = type("P", (), {"theta_dim": 5})()
    jest = jmnle.train_mnle(J_RUN_CONFIG.replace(**flags), proposal, z, x, seed=0, verbose=False)
    est = tmnle.train_mnle(RUN_CONFIG_PARAMS.replace(**flags), proposal, z, x, device="cpu", seed=0, verbose=False)
    assert est.cfg.tail_sharp_c == pytest.approx(jest.cfg.tail_sharp_c, abs=1e-5)
    t = np.log(rt[choice != 2.0] - z[choice != 2.0, 4])
    want = (np.quantile(t, 1e-3) - t.mean()) / t.std() - 0.25
    assert est.cfg.tail_sharp_c == pytest.approx(want, abs=1e-4)
