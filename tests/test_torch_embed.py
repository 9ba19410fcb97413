"""PyTorch port: the pulse embedding (``MNLEConfig.pulse_dim`` with
``embed_dim`` / ``embed_mode``) against the JAX package, at small widths
(hidden 16, 2 transforms), with JAX-initialised weights carried across by
the converter: the physics features, ``log_prob`` in the replace and append
modes (the context the heads read is ``make_context``'s), the fused path on
CPU rows, the closed-form likelihood gradient (the features read |lambda|,
carried through the embedding MLP by a forward-mode pass) against autograd
and ``jax.grad``, normalisation, sampling, and training, saving and
loading an embedded model."""

import functools

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
from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

SMALL = dict(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=6, pulse_dim=80)
MODES = {
    "replace": dict(embed_dim=8),
    "append": dict(embed_dim=8, embed_mode="append"),
    "append_features_only": dict(embed_dim=0, embed_mode="append"),
    "shifted_log_append": dict(embed_dim=8, embed_mode="append", rt_rep="shifted_log", censor_rt=True,
                               log_condition_dims=(1, 2, 3), cond_affine=True),
    "pulse_replace": dict(embed_dim=8, rt_rep="pulse", censor_rt=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(mode, stats=True):
    """A small embedded JAX MNLE, with standardization stats that are not
    the identity unless ``stats`` is False, and the same model carried
    across to the port (made once per arguments; the tests do not change
    them)."""
    cfg = jnet.MNLEConfig(**SMALL, **MODES[mode])
    jest = jnet.build_mnle(jax.random.key(21), cfg)
    rng = np.random.default_rng(22)
    jest = jest if not stats else jest.__class__(
        cfg=cfg, params=jest.params,
        cond_mean=jnp.asarray(0.1 * rng.normal(size=85), jnp.float32),
        cond_std=jnp.asarray(rng.uniform(0.7, 1.4, 85), jnp.float32),
        x_mean=jnp.float32(-0.5), x_std=jnp.float32(1.2), train_meta=None,
    )
    tree = jax.tree.map(np.asarray, jest.params)
    est = tnet.mnle_from_flax_params(tnet.MNLEConfig(**cfg.__dict__), tree, jest.cond_mean, jest.cond_std,
                                     jest.x_mean, jest.x_std, device="cpu")
    return jest, est


def _rows(n, seed=23):
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.2, 0.8, n), rng.lognormal(-1, 0.8, n), rng.lognormal(0, 0.5, n),
                      rng.lognormal(2.75, 0.3, n), rng.uniform(0.01, 0.3, n)], -1)
    theta[:4, 1] *= -1.0  # a negative lambda: the features read |lambda|
    theta[4, 1] = 0.0
    cond = np.concatenate([theta, np.where(rng.random((n, 80)) < 0.5, 1.0, -1.0)], -1)
    choice = rng.choice([0.0, 1.0, 2.0], n, p=[0.45, 0.4, 0.15])
    rt = np.where(choice == 2.0, 8.0, theta[:, 4] + rng.gamma(2.0, 0.3, n))
    return np.stack([rt, choice], -1).astype(np.float32), cond.astype(np.float32)


def test_physics_features_match_jax():
    _, cond = _rows(64)
    want = np.asarray(jnet.pulse_physics_features(jnp.asarray(cond), 5, 80, 1))
    got = tnet.pulse_physics_features(torch.from_numpy(cond), 5, 80, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The closed-form derivative w.r.t. |lambda| against JAX's.
    lam = np.abs(cond[:, 1])

    def feats_of(lam_abs):
        c = jnp.asarray(cond).at[:, 1].set(lam_abs)
        return jnet.pulse_physics_features(c, 5, 80, 1)

    _, jvp = jax.jvp(feats_of, (jnp.asarray(lam),), (jnp.ones_like(jnp.asarray(lam)),))
    c_abs = torch.from_numpy(cond).clone()
    c_abs[:, 1] = torch.from_numpy(lam)
    _, d = tnet.pulse_physics_features(c_abs, 5, 80, 1, lam_tangent=True)
    np.testing.assert_allclose(d.numpy(), np.asarray(jvp), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_embedded_log_prob_and_fused_path_match_jax(mode):
    """``log_prob`` (and the fused path on CPU rows, whose kernels read the
    context) against JAX's, value and condition gradient; the context width
    is the kernels' D (43 in replace mode at embed_dim 32, 123 in append)."""
    jest, est = _models(mode)
    assert est.net.cat_net.layers[0].in_features == est.cfg.context_dim
    x, cond = _rows(64)
    ref_v, ref_g = jax.jit(jax.vmap(jax.value_and_grad(lambda c, a: jest.log_prob_fn(jest.params, a, c))))(
        jnp.asarray(cond), jnp.asarray(x))
    for fn in (est.log_prob, est.dispatch_log_prob("pallas")):
        c = torch.from_numpy(cond).requires_grad_(True)
        lp = fn(torch.from_numpy(x), c)
        (g,) = torch.autograd.grad(lp.sum(), c)
        np.testing.assert_allclose(lp.detach().numpy(), np.asarray(ref_v), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    widths = {m: tnet.MNLEConfig(**{**SMALL, **MODES[m], "embed_dim": 32}).context_dim for m in ("replace", "append")}
    assert widths == {"replace": 43, "append": 123}


def _session(T=30, seed=24):
    rng = np.random.default_rng(seed)
    choice = rng.choice([0.0, 1.0, 2.0], T, p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.12 + rng.gamma(2.0, 0.3, T))
    pulses = np.where(rng.random((T, 80)) < 0.5, 1.0, -1.0)
    return np.stack([rt, choice], -1).astype(np.float32), pulses.astype(np.float32)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_embedded_closed_form_gradient_matches_autograd_and_jax(mode):
    """``log_lik_and_grad`` with the embedding (one launch: the context,
    its lambda tangent through the features and the MLP, K3's dctx) against
    autograd of ``log_lik_fn`` and ``jax.grad`` of JAX's likelihood, with
    lambda of either sign."""
    jest, est = _models(mode)
    x_o, pulses = _session()
    _, cond = _rows(8)
    theta = cond[:, :5]
    jlik = jp.ConditionedMNLELogLikelihood(jest, pulses, logprob_kernel="xla")
    ref_v = np.asarray(jax.jit(lambda th: jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))(jnp.asarray(theta)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda th: jnp.sum(jlik.log_lik_fn(jest.params, jnp.asarray(x_o), th))))(
        jnp.asarray(theta)))
    lik = tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas")
    x, th = torch.from_numpy(x_o), torch.from_numpy(theta)
    ll, g = lik.log_lik_and_grad(x, th)
    th_ = th.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(lik.log_lik_fn(est.params, x, th_).sum(), th_)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-4, atol=1e-5 * float(g_auto.abs().max()))
    np.testing.assert_allclose(ll.numpy(), ref_v, rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-3 * np.abs(ref_g).max())
    assert torch.equal(lik.log_lik_and_grad(x, th, need_grad=False)[0], ll)
    assert float(g[:, 1].abs().min()) > 0.0 or mode == "append_features_only"


@pytest.mark.parametrize("mode", ["replace", "append"])
def test_embedded_log_prob_normalizes(mode):
    """As the JAX package's ``test_embedded_log_prob_normalizes`` (an
    untrained model with unit stats, theta = |N(0, 1)| + 0.1, +-1 pulses):
    the embedded density integrates to 1 over RT and the choices, and to
    JAX's integral."""
    jest, est = _models(mode, stats=False)
    rng = np.random.default_rng(25)
    cond = np.concatenate([np.abs(rng.normal(size=5)) + 0.1, np.where(rng.random(80) < 0.5, 1.0, -1.0)])
    cond = np.broadcast_to(cond.astype(np.float32), (8000, 85))
    rts = np.linspace(1e-3, 60.0, 8000, dtype=np.float32)
    total, want = 0.0, 0.0
    for c in range(3):
        x = np.stack([rts, np.full_like(rts, c)], -1)
        lp = est.log_prob(torch.from_numpy(x), torch.from_numpy(cond.copy()))
        total += float(torch.trapezoid(torch.exp(lp), torch.from_numpy(rts)))
        want += float(jnp.trapezoid(jnp.exp(jax.jit(jest.log_prob)(jnp.asarray(x), jnp.asarray(cond))),
                                    jnp.asarray(rts)))
    assert abs(total - 1.0) < 0.02, f"density integrates to {total}"
    assert total == pytest.approx(want, abs=1e-4)


def test_embedded_sample_matches_jax_in_distribution():
    from test_torch_sample import same_distribution

    jest, est = _models("append")
    cond = _rows(12, seed=26)[1][np.arange(6000) % 12]
    want = np.asarray(jax.jit(jest.sample)(jax.random.key(3), jnp.asarray(cond)))
    got = est.sample(4, torch.from_numpy(cond)).numpy()
    p = same_distribution(got, want)
    assert min(p.values()) >= 1e-3, p


def test_train_save_load_embedded_model(tmp_path, monkeypatch):
    """``train_mnle`` with MNLE_EMBED_DIM > 0 in append mode (the split of
    the condition from the proposal's theta_dim): a context of width 85 +
    embed_dim + 6, a falling loss, and a saved model that the port reloads
    bit for bit and the JAX package loads to the same log-probs."""
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    rng = np.random.default_rng(27)
    x, z = _rows(600, seed=28)
    cfg = CALIBRATED_CONFIG.replace(MNLE_EMBED_DIM=4, MNLE_EMBED_MODE="append", MNLE_HIDDEN_FEATURES=16,
                                    MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=6, TRAIN_BATCH_SIZE=64, TRAIN_MAX_EPOCHS=3,
                                    MNLE_LOG_THETA_DIMS=())
    z[:, 1] = np.abs(z[:, 1]) + 0.05 * rng.random(600).astype(np.float32)
    proposal = type("P", (), {"theta_dim": 5})()
    est = tmnle.train_mnle(cfg, proposal, z, x, device="cpu", seed=0, verbose=False)
    assert (est.cfg.pulse_dim, est.cfg.embed_dim, est.cfg.context_dim) == (80, 4, 95)
    vl = est.train_meta["val_losses"]
    assert np.isfinite(vl).all() and vl[-1] < vl[0]
    tmnle.save_model(est, cfg, "emb.npz")
    back = tmnle.load_model("emb.npz", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(est.net.state_dict().values(), back.net.state_dict().values()))
    jest = jmnle.load_model("emb.npz")
    xs, cs = _rows(32, seed=29)
    np.testing.assert_allclose(back.log_prob(torch.from_numpy(xs), torch.from_numpy(cs)).numpy(),
                               np.asarray(jest.log_prob(jnp.asarray(xs), jnp.asarray(cs))), rtol=1e-4, atol=1e-4)
