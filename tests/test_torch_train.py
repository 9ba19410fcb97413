"""PyTorch port: the training path (``build_mnle``, ``train_step``,
``train_mnle``, ``save_model``) against the JAX package.

The same weights (made by the JAX ``build_mnle``, perturbed with numpy and
carried across by ``mnle_from_flax_params``) and the same numpy batches go
through both packages. Tolerances are stated where they are used.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu import run_config as jrc
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig as JConfig
from sbi_for_diffusion_models_tpu.nets.mnle_net import build_mnle as jbuild_mnle
import sbi_for_diffusion_models_tpu_torch as port
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import run_config as trc
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import (
    MNLEConfig,
    _named_linears,
    build_mnle,
    mnle_from_flax_params,
    mnle_to_flax_params,
)

SMALL = dict(hidden_features=24, num_transforms=3, num_bins=6)
VARIANTS = {
    "log": dict(censor_rt=True),
    "shifted_log_affine": dict(rt_rep="shifted_log", censor_rt=True, cond_affine=True, log_condition_dims=(1, 2, 3)),
    "pulse_abs": dict(rt_rep="pulse", censor_rt=True),
}
CD = 9  # 5 theta + 4 pulse sides
PROPOSAL = types.SimpleNamespace(theta_dim=5)  # all either train_mnle reads of it


def _data(seed, n, cd=CD):
    """(x, z): rts above their t_nd, choices in {0, 1, 2} (2 = censored),
    positive condition columns where a config log-transforms them."""
    rng = np.random.default_rng(seed)
    z = (0.7 * rng.normal(size=(n, cd)) + 0.2).astype(np.float32)
    z[:, 1:4] = np.abs(z[:, 1:4]) + 0.05
    z[:, 4] = rng.uniform(0.0, 0.3, n)
    rt = z[:, 4] + np.exp(0.5 * rng.normal(size=n)) * 0.4 + 0.01
    x = np.stack([rt, rng.integers(0, 3, n)], -1).astype(np.float32)
    return x, z


def _jax_estimator(variant, seed=0):
    """A JAX estimator with every leaf perturbed (so the zero-initialised
    affine head and the zero biases carry gradients of ordinary size) and
    non-trivial stats."""
    cfg = JConfig(condition_dim=CD, num_categories=3, **SMALL, **VARIANTS[variant])
    est = jbuild_mnle(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
                          est.params)
    return est.__class__(
        cfg=cfg, params=params, cond_mean=0.1 * jnp.arange(CD, dtype=jnp.float32),
        cond_std=jnp.linspace(0.5, 2.0, CD), x_mean=jnp.float32(-0.4), x_std=jnp.float32(1.3),
    )


def _port(jest):
    est = mnle_from_flax_params(MNLEConfig(**jest.cfg.__dict__), jax.tree.map(np.asarray, jest.params),
                                jest.cond_mean, jest.cond_std, jest.x_mean, jest.x_std, device="cpu")
    est.net.requires_grad_(True)
    return est


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}") if isinstance(tree[k], dict) else {f"{prefix}/{k}": tree[k]})
    return out


def _grad_tree(est):
    """The port's weight gradients in the flax tree's layout."""
    return {"/" + "/".join(path) + "/" + leaf: g.detach().numpy().T if leaf == "kernel" else g.detach().numpy()
            for path, lin in _named_linears(est.net)
            for leaf, g in (("kernel", lin.weight.grad), ("bias", lin.bias.grad))}


def _jax_loss(jest):
    return lambda p, x, z: -jnp.mean(jest.log_prob_fn(p, x, z))


# ---------------------------------------------------------------------------
# (1) weight gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_loss_and_weight_gradients_match_jax(variant):
    """Loss to 1e-5 relative; every gradient leaf to 1e-4 of that leaf's
    largest entry (float32 sums in another order on either side)."""
    jest = _jax_estimator(variant)
    est = _port(jest)
    x, z = _data(3, 257)
    assert (x[:, 1] == 2).sum() > 20  # censored rows in the batch
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(_jax_loss(jest)))(jest.params, jnp.asarray(x), jnp.asarray(z))
    loss = -est.log_prob_fn(est.net, torch.from_numpy(x), torch.from_numpy(z)).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = _flat(jax.tree.map(np.asarray, ref_grads))
    got = _grad_tree(est)
    assert sorted(got) == sorted(ref)
    for name, want in ref.items():
        scale = float(np.abs(want).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - want).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} > 1e-4 x {scale:.3e}"


# ---------------------------------------------------------------------------
# (2) optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_norm, clip_active", [(5.0, True), (1e3, False)], ids=["as_trained", "clip_idle"])
def test_five_train_steps_match_optax(max_norm, clip_active):
    """Five ``train_step``s against the same five steps of
    ``optax.chain(clip_by_global_norm, adam(cosine_decay_schedule))`` as
    the JAX ``train_mnle`` writes them. At these weights the gradients'
    global norm is above the bound of 5 at every step, so the clip is
    active; with the bound raised to 1e3 it is idle at every step.

    Per-step loss to 1e-5 relative; every parameter after five steps to
    1e-5 absolute, in float32 on both sides (the largest difference seen is
    about 1e-7: Adam's first steps move a weight by about the learning rate
    whatever its gradient's size, which would show as 5e-4 if a gradient
    entry changed sign between the two sides; none does at these weights).
    The rule alone is held in float64 by the next test."""
    lr, T, steps = 5e-4, 8, 5
    jest = _jax_estimator("shifted_log_affine")
    est = _port(jest)
    batches = [_data(10 + i, 128) for i in range(steps)]

    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(optax.cosine_decay_schedule(lr, T, alpha=0.02)))
    loss_fn = _jax_loss(jest)

    @jax.jit
    def jstep(params, opt_state, xb, zb):
        loss, grads = jax.value_and_grad(loss_fn)(params, xb, zb)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    params, opt_state = jest.params, tx.init(jest.params)
    state = tmnle.TrainState(est.net.parameters(), lr, T, max_norm=max_norm)
    for i, (xb, zb) in enumerate(batches):
        params, opt_state, ref_loss, norm = jstep(params, opt_state, jnp.asarray(xb), jnp.asarray(zb))
        loss = tmnle.train_step(est, state, torch.from_numpy(xb), torch.from_numpy(zb), i)
        assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)), i
        assert (float(norm) > max_norm) == clip_active, (i, float(norm))
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(mnle_to_flax_params(est))
    diff = np.concatenate([np.abs(got[k] - ref[k]).reshape(-1) for k in ref])
    assert float(diff.max()) <= 1e-5, float(diff.max())
    moved = np.concatenate([np.abs(ref[k] - np.asarray(v)).reshape(-1)
                            for k, v in _flat(jax.tree.map(np.asarray, jest.params)).items()])
    assert float(np.median(moved)) > 1e-4  # the steps did move the weights


def test_train_state_is_optax_in_float64():
    """The optimizer rule alone, on gradients made with numpy and fed to
    both sides: clip (active and not), schedule and Adam, five steps in
    float64 on both sides, equal to 1e-12."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 7)]
    p0 = [rng.normal(size=s) for s in shapes]
    lr, T = 5e-4, 8
    with jax.enable_x64(True):
        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(optax.cosine_decay_schedule(lr, T, alpha=0.02)))
        jp = [jnp.asarray(p, jnp.float64) for p in p0]
        opt_state = tx.init(jp)
        tp = [torch.tensor(p, dtype=torch.float64, requires_grad=True) for p in p0]
        state = tmnle.TrainState(tp, lr, T)
        for i in range(5):
            # Norm about 0.6 on even steps (clip idle), about 60 on odd ones.
            grads = [rng.normal(size=s) * (0.1 if i % 2 == 0 else 10.0) for s in shapes]
            updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            for p, g in zip(tp, grads):
                p.grad = torch.tensor(g)
            state.apply(i)
            assert abs(state.lr_at(i) - float(optax.cosine_decay_schedule(lr, T, alpha=0.02)(i))) <= 1e-15
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert state.lr_at(100) == pytest.approx(0.02 * lr)  # past T: the floor alpha x init


# ---------------------------------------------------------------------------
# (3) stats and config
# ---------------------------------------------------------------------------
STATS_CASES = {
    "log": {},
    "log_censored": dict(MNLE_CENSOR_RT=True),
    "raw_unscored": dict(SBI_LOG_TRANSFORM_X=False, Z_SCORE_X=None),
    "shifted_log": dict(MNLE_CENSOR_RT=True, MNLE_RT_REP="shifted_log", MNLE_LOG_THETA_DIMS=(1, 2, 3),
                        MNLE_COND_AFFINE=True),
    "pulse_abs": dict(MNLE_CENSOR_RT=True, MNLE_RT_REP="pulse"),
    "pulse_tnd": dict(MNLE_CENSOR_RT=True, MNLE_RT_REP="pulse", MNLE_GRID_ANCHOR="tnd"),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
@pytest.mark.filterwarnings("ignore:MNLE_RT_REP='pulse' is statistically UNCALIBRATED")
def test_train_mnle_stats_and_config_match_jax(case):
    """``train_mnle`` with no epochs: the standardization stats (1e-5
    relative, 1e-6 absolute: float32 means and population stds summed in
    another order), the number of categories and the ``MNLEConfig``."""
    kw = dict(MNLE_HIDDEN_FEATURES=16, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=6, TRAIN_MAX_EPOCHS=0, **STATS_CASES[case])
    x, z = _data(5, 400)
    jest = jmnle.train_mnle(jrc.RUN_CONFIG_PARAMS.replace(**kw), PROPOSAL, z, x, verbose=False)
    est = tmnle.train_mnle(trc.RUN_CONFIG_PARAMS.replace(**kw), PROPOSAL, z, x, device="cpu", verbose=False)
    assert est.cfg == MNLEConfig(**jest.cfg.__dict__)
    assert est.cfg.num_categories == 3
    for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
        np.testing.assert_allclose(getattr(est, name).numpy(), np.asarray(getattr(jest, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert est.train_meta["epochs_run"] == 0 and est.train_meta["num_train"] == 400
    assert not any(p.requires_grad for p in est.net.parameters())


# ---------------------------------------------------------------------------
# (4) initialisation
# ---------------------------------------------------------------------------
def test_build_mnle_initialises_as_flax_does():
    cfg = MNLEConfig(condition_dim=85, hidden_features=64, num_transforms=3, num_bins=8, censor_rt=True,
                     cond_affine=True)
    est = build_mnle(0, cfg, device="cpu")
    jparams = jbuild_mnle(jax.random.key(0), JConfig(**cfg.__dict__)).params
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    flat = _flat(mnle_to_flax_params(est))
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in jflat.items()}
    for name, w in flat.items():
        if name.endswith("bias") or name.startswith("/affine_head"):
            assert not w.any(), name
            assert not jflat[name].any(), name
            continue
        fan_in = w.shape[0]
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566
        assert np.abs(w).max() <= 2.0 * sigma * (1 + 1e-6), name
        # Standard error of the std of n draws is about std / sqrt(2 n):
        # four of them, and the JAX draw of the same leaf beside it.
        tol = 4.0 / np.sqrt(2.0 * w.size)
        assert abs(w.std() / np.sqrt(1.0 / fan_in) - 1.0) <= tol, (name, w.std())
        assert abs(jflat[name].std() / np.sqrt(1.0 / fan_in) - 1.0) <= tol, (name, jflat[name].std())
        assert abs(w.mean()) <= 4.0 * np.sqrt(1.0 / fan_in) / np.sqrt(w.size), name
    assert all(p.requires_grad for p in est.net.parameters())
    # The same seed gives the same weights; another seed gives others.
    again, other = build_mnle(0, cfg, device="cpu"), build_mnle(1, cfg, device="cpu")
    w0 = est.net.flow_trunk.layers[0].weight
    assert torch.equal(w0, again.net.flow_trunk.layers[0].weight)
    assert not torch.equal(w0, other.net.flow_trunk.layers[0].weight)


def test_cond_affine_is_the_identity_at_init():
    """The zero-initialised affine head draws nothing from the generator, so
    one seed gives the same other weights with and without it, and the same
    log-prob."""
    x, z = _data(7, 64)
    base = dict(condition_dim=CD, censor_rt=True, **SMALL)
    lp = [build_mnle(3, MNLEConfig(cond_affine=flag, **base), device="cpu").log_prob(
        torch.from_numpy(x), torch.from_numpy(z)) for flag in (False, True)]
    assert torch.isfinite(lp[0]).all()
    torch.testing.assert_close(lp[0], lp[1], rtol=0, atol=0)


def test_build_mnle_rejects_what_the_jax_build_rejects():
    with pytest.raises(ValueError, match="requires censor_rt=True"):
        build_mnle(0, MNLEConfig(rt_rep="shifted_log"), device="cpu")
    with pytest.raises(ValueError, match="unknown rt_rep"):
        build_mnle(0, MNLEConfig(rt_rep="linear"), device="cpu")
    gen = torch.Generator().manual_seed(4)
    est = build_mnle(gen, MNLEConfig(condition_dim=CD, **SMALL), device="cpu")
    assert est.cond_std.shape == (CD,) and float(est.x_std) == 1.0


# ---------------------------------------------------------------------------
# (5) persistence, both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_saved_model_loads_in_jax(variant, tmp_path, monkeypatch):
    """port ``save_model`` -> JAX ``load_model``: equal log-probs on a batch
    (1e-5 absolute and relative; 1e-4 for the pulse rep, whose circular
    knots the two packages sum in another order, an ulp apart, which moves
    a value in a narrow bin by a few 1e-5), the port's training meta carried
    along."""
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "made" / "models"))  # save_model makes it
    est = _port(_jax_estimator(variant))
    est.train_meta = {"num_train": 7, "val_losses": [1.0, 0.5]}
    path = tmnle.save_model(est, trc.CALIBRATED_CONFIG, "m.npz")
    assert path == tmp_path / "made" / "models" / "m.npz" and path.exists()
    jest = jmnle.load_model("m.npz")
    assert jest.train_meta == est.train_meta
    x, z = _data(8, 100)
    ref = np.asarray(jax.jit(jest.log_prob_fn)(jest.params, jnp.asarray(x), jnp.asarray(z)))
    got = est.log_prob(torch.from_numpy(x), torch.from_numpy(z)).detach().numpy()
    tol = 1e-4 if variant == "pulse_abs" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_saved_model_round_trips_through_the_port(variant, tmp_path, monkeypatch):
    """JAX ``save_model`` -> port ``load_model`` -> port ``save_model``: the
    same keys, bit-equal leaves, the same configs and ``param_fingerprint``."""
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    jest = _jax_estimator(variant)
    jest.train_meta = {"num_train": 11, "epochs_run": 2, "best_val_loss": 0.25, "train_wall_s": 1.5}
    jmnle.save_model(jest, jrc.CALIBRATED_CONFIG, "jax.npz")
    tmnle.save_model(tmnle.load_model("jax.npz", device="cpu"), trc.CALIBRATED_CONFIG, "port.npz")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
        ma, mb = json.loads(str(a["__meta__"])), json.loads(str(b["__meta__"]))
    assert ma == mb
    assert len(ma["param_fingerprint"]) == 16


# ---------------------------------------------------------------------------
# (6) the slice as a whole on the CPU, and the flag errors
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def simulated_pairs():
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_training_set_with_conditions
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal

    proposal = ExtendedProposal(build_prior_theta(), PulseSequenceProposal(80, 0.75, device="cpu"))
    z, x = simulate_training_set_with_conditions(trc.CALIBRATED_CONFIG, proposal, num_simulations=2000,
                                                 device="cpu", seed=1, verbose=False)
    return proposal, z, x


TINY_TRAIN = dict(MNLE_HIDDEN_FEATURES=32, MNLE_NUM_TRANSFORMS=3, MNLE_NUM_BINS=8, MNLE_COND_AFFINE=True,
                  TRAIN_BATCH_SIZE=256, TRAIN_MAX_EPOCHS=6, TRAIN_STOP_AFTER_EPOCHS=6)


def test_simulate_train_save_load_serve_on_the_cpu(simulated_pairs, tmp_path, monkeypatch, capsys):
    """simulate -> ``train_mnle`` -> ``save_model`` -> ``load_model`` ->
    ``run_inference_mcmc`` at a tiny size; the fused kernels' module is out
    of training's reach (K2/K3 give no weight gradients)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    proposal, z, x = simulated_pairs
    cfg = trc.CALIBRATED_CONFIG.replace(**TINY_TRAIN)

    def unreachable(*a, **k):
        raise AssertionError("train_mnle reached the fused inference kernels")

    with monkeypatch.context() as mp:
        mp.setattr(mnle_cuda, "make_fused_logprob", unreachable)
        est = port.train_mnle(cfg, proposal, z, x, seed=0)  # CPU tensors: trains on the CPU
    assert "[train_mnle] epoch 0: train=" in capsys.readouterr().out
    meta = est.train_meta
    assert meta["num_train"] == 2000 and meta["epochs_run"] == 6 and meta["steps_per_epoch"] == 7
    assert len(meta["val_losses"]) == 6 and np.isfinite(meta["val_losses"]).all()
    assert meta["val_losses"][-1] < meta["val_losses"][0] - 0.1  # the validation loss fell
    assert meta["best_val_loss"] == min(meta["val_losses"])
    assert est.device.type == "cpu" and not any(p.requires_grad for p in est.net.parameters())
    assert (est.cfg.rt_rep, est.cfg.censor_rt, est.cfg.cond_affine, est.cfg.condition_dim) == \
        ("shifted_log", True, True, 85)
    # The same seed trains the same model.
    again = port.train_mnle(cfg, proposal, z, x, seed=0, verbose=False)
    assert again.train_meta["val_losses"] == meta["val_losses"]

    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "models"))
    port.save_model(est, cfg, "trained.npz")
    loaded = port.load_model("trained.npz", device="cpu")
    for a, b in zip(est.net.parameters(), loaded.net.parameters()):
        assert torch.equal(a, b)
    assert loaded.train_meta == json.loads(json.dumps(meta))

    x_o, p_o = simulate_observed_session(np.array([0.5, 0.3, 1.2, 10.0, 0.2], np.float32), 10, seed=1, device="cpu")
    rc = cfg.replace(WARMUP_STEPS=10, POSTERIOR_SAMPLES=16, NUM_CHAINS=2, MCMC_PT_REPLICAS=2, MCMC_MAX_TREE_DEPTH=4)
    before = {name: k.launches for name, k in KERNELS.items()}
    samples = port.run_inference_mcmc(rc, build_prior_theta(), loaded, x_o, p_o, seed=0, verbose=False)
    assert samples.shape == (16, 5) and torch.isfinite(samples).all()
    assert {name: k.launches for name, k in KERNELS.items()} == before  # CPU tensors: no kernel launches


def test_best_weights_are_a_copy_and_patience_stops_training(simulated_pairs):
    """With patience 1 and a learning rate that makes the loss rise, training
    stops early and returns the weights of the best epoch, not the last."""
    proposal, z, x = simulated_pairs
    cfg = trc.CALIBRATED_CONFIG.replace(**{**TINY_TRAIN, "TRAIN_MAX_EPOCHS": 30, "TRAIN_STOP_AFTER_EPOCHS": 1,
                                           "TRAIN_LEARNING_RATE": 0.3})
    est = port.train_mnle(cfg, proposal, z[:600], x[:600], seed=2, verbose=False)
    meta = est.train_meta
    assert meta["epochs_run"] < 30
    best = int(np.nanargmin(meta["val_losses"]))
    assert best < meta["epochs_run"] - 1  # a worse epoch came after the best one
    n_val = 60
    perm = torch.randperm(600, generator=torch.Generator().manual_seed(
        tmnle.child_seed(tmnle.as_seed(2), 1)))
    val = perm[:n_val]
    vl = float(-est.log_prob(x[:600][val], z[:600][val]).mean())
    assert vl == pytest.approx(meta["best_val_loss"], rel=1e-5)


FLAG_ERRORS = {
    "z_score_x": (dict(Z_SCORE_X="global"), {}, ValueError, "Z_SCORE_X="),
    "double_log": (dict(LOG_RT_MANUALLY=True), {}, ValueError, "mutually exclusive"),
    "category_overflow": (dict(MNLE_NUM_CATEGORIES=2), {}, ValueError, "contains category 2"),
    "affine_with_pulse": (dict(MNLE_CENSOR_RT=True, MNLE_RT_REP="pulse", MNLE_COND_AFFINE=True), {}, ValueError,
                          "MNLE_COND_AFFINE has no effect"),
    "log_dims_outside": (dict(MNLE_LOG_THETA_DIMS=(1, 99)), {}, ValueError, "outside the condition block"),
    "uncensored_shifted_log": (dict(MNLE_RT_REP="shifted_log"), {}, ValueError, "requires censor_rt=True"),
    # The tail sharpening and the pulse embedding are ported: with each on,
    # the other checks still raise.
    "tail_sharp": (dict(MNLE_TAIL_SHARP_K=2.0, MNLE_TAIL_SHARP_C=-3.0, MNLE_CENSOR_RT=True, MNLE_RT_REP="log",
                        MNLE_NUM_CATEGORIES=2), {}, ValueError, "contains category 2"),
    "pulse_embedding": (dict(MNLE_EMBED_DIM=8, MNLE_LOG_THETA_DIMS=(1, 99)), {}, ValueError,
                        "outside the condition block"),
}


@pytest.mark.parametrize("case", sorted(FLAG_ERRORS))
@pytest.mark.filterwarnings("ignore:MNLE_RT_REP='pulse' is statistically UNCALIBRATED")
def test_train_mnle_rejects_bad_flags(case):
    overrides, kwargs, error, match = FLAG_ERRORS[case]
    x, z = _data(9, 50)
    with pytest.raises(error, match=match):
        tmnle.train_mnle(trc.RUN_CONFIG_PARAMS.replace(**overrides), PROPOSAL, z, x, device="cpu", verbose=False,
                         **kwargs)


def test_pulse_rep_trains_with_its_warning():
    x, z = _data(11, 300)
    cfg = trc.RUN_CONFIG_PARAMS.replace(MNLE_CENSOR_RT=True, MNLE_RT_REP="pulse", MNLE_HIDDEN_FEATURES=16,
                                        MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=6, TRAIN_BATCH_SIZE=64,
                                        TRAIN_MAX_EPOCHS=3)
    with pytest.warns(UserWarning, match="statistically UNCALIBRATED"):
        est = tmnle.train_mnle(cfg, PROPOSAL, torch.from_numpy(z), torch.from_numpy(x), verbose=False)
    assert est.cfg.circular and est.net.pulse_slot_head is not None
    vl = est.train_meta["val_losses"]
    assert np.isfinite(vl).all() and vl[-1] < vl[0]


def test_package_exports_the_training_entry_points():
    import importlib

    assert {"train_mnle", "save_model", "build_mnle"} <= set(port.__all__)
    for name in port.__all__:  # each from the module that defines it
        if name != "constants":
            assert getattr(port, name) is getattr(importlib.import_module(f"{port.__name__}.{port._EXPORTS[name]}"), name)
    assert port.train_mnle is tmnle.train_mnle and port.build_mnle is build_mnle
    from sbi_for_diffusion_models_tpu_torch import snpe
    from sbi_for_diffusion_models_tpu_torch.models import choice_model, hierarchical, pulse_ddm_7p

    for module, names in ((snpe, ("train_snpe", "train_snle", "DirectPosterior")),
                          (hierarchical, ("HierarchicalModel", "run_hierarchical_inference",
                                          "simulate_hierarchical_sessions")),
                          (pulse_ddm_7p, ("rt_choice_model_simulator_7p", "simulate_session_data_7p")),
                          (choice_model, ("ChoiceModelParams", "choice_model_simulator", "choice_model_simulator_torch",
                                          "generate_pulse_sides"))):
        for name in names:  # ported since: each from the module that defines it
            assert name in port.__all__ and getattr(port, name) is getattr(module, name)
    with pytest.raises(AttributeError):
        getattr(port, "train_snpe_v2")
