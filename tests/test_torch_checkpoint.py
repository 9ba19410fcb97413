"""PyTorch port: training checkpoint/resume (``utils/checkpoint.py`` and
``train_mnle(checkpoint_dir=...)``). The round trip, the missing directory and
the fingerprint guard are the JAX ``tests/test_checkpoint.py``'s; the
fingerprint is held to the JAX function's; a cut training run resumes to the
uninterrupted run's weights.
"""

import types

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import run_config as jrc
from sbi_for_diffusion_models_tpu.utils.checkpoint import config_fingerprint as jax_config_fingerprint
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import run_config as trc
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS
from sbi_for_diffusion_models_tpu_torch.utils.checkpoint import (
    config_fingerprint,
    latest_step,
    restore_train_state,
    save_train_state,
)
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator


def _state():
    est = build_mnle(make_generator(0), MNLEConfig(condition_dim=4, hidden_features=8, num_transforms=2, num_bins=4),
                     device="cpu")
    adam = torch.optim.Adam(est.net.parameters(), lr=1e-3)
    est.net.requires_grad_(True)
    sum(p.sum() for p in est.net.parameters()).backward()
    adam.step()  # so the optimizer state holds tensors
    return est.net.state_dict(), adam.state_dict()


def test_roundtrip(tmp_path):
    params, opt_state = _state()
    save_train_state(tmp_path / "ckpt", 3, params, opt_state, 42, cfg=RUN_CONFIG_PARAMS)
    assert latest_step(tmp_path / "ckpt") == 3
    restored = restore_train_state(tmp_path / "ckpt", {"params": params}, cfg=RUN_CONFIG_PARAMS)
    assert int(restored["meta"]["step"]) == 3 and restored["seed"] == 42
    assert list(restored["params"]) == list(params)
    for k, v in params.items():
        assert torch.equal(restored["params"][k], v), k
    for k, v in opt_state["state"].items():
        assert all(torch.equal(restored["opt_state"]["state"][k][n], t) for n, t in v.items())
    # The newest 3 steps are kept.
    for step in (4, 5, 6):
        save_train_state(tmp_path / "ckpt", step, params, opt_state, 42)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["4", "5", "6", "config_fingerprint.txt"]
    assert latest_step(tmp_path / "ckpt") == 6


def test_missing_returns_none(tmp_path):
    assert restore_train_state(tmp_path / "nope", {}) is None
    assert latest_step(tmp_path / "nope") is None


def test_fingerprint_guard(tmp_path):
    params, opt_state = _state()
    save_train_state(tmp_path / "ckpt", 0, params, opt_state, 0, cfg=RUN_CONFIG_PARAMS)
    other = RUN_CONFIG_PARAMS.replace(TRAIN_LEARNING_RATE=99.0)
    assert config_fingerprint(other) != config_fingerprint(RUN_CONFIG_PARAMS)
    with pytest.raises(ValueError, match="different"):
        restore_train_state(tmp_path / "ckpt", {"params": params}, cfg=other)
    # A state of another structure is refused too.
    with pytest.raises(ValueError, match="other parameters"):
        restore_train_state(tmp_path / "ckpt", {"params": {"w": torch.zeros(3)}})


@pytest.mark.parametrize("name", ["RUN_CONFIG_PARAMS", "CALIBRATED_CONFIG", "edited"])
def test_config_fingerprint_is_the_jax_functions(name):
    if name == "edited":
        t = trc.CALIBRATED_CONFIG.replace(TRAIN_LEARNING_RATE=3e-4, MNLE_LOG_THETA_DIMS=(1, 2))
        j = jrc.CALIBRATED_CONFIG.replace(TRAIN_LEARNING_RATE=3e-4, MNLE_LOG_THETA_DIMS=(1, 2))
    else:
        t, j = getattr(trc, name), getattr(jrc, name)
    assert config_fingerprint(t) == jax_config_fingerprint(j)


def _pairs(seed=9, n=400):
    """(x, z): rts above their t_nd, choices in {0, 1, 2} (2 = censored)."""
    rng = np.random.default_rng(seed)
    z = (0.7 * rng.normal(size=(n, 9)) + 0.2).astype(np.float32)
    z[:, 1:4] = np.abs(z[:, 1:4]) + 0.05
    z[:, 4] = rng.uniform(0.0, 0.3, n)
    rt = z[:, 4] + np.exp(0.5 * rng.normal(size=n)) * 0.4 + 0.01
    return np.stack([rt, rng.integers(0, 3, n)], -1).astype(np.float32), z


class _Cut(Exception):
    """Stands for the process being killed."""


def test_a_cut_training_run_resumes_to_the_uninterrupted_weights(tmp_path, monkeypatch, capsys):
    """Cut inside epoch 3 (after epoch 2's checkpoint) and run again with the
    same config and directory: the run resumes at epoch 3, at the learning
    rate and on the batches the uninterrupted run has there, and ends with
    its weights; a third call runs no epoch and returns the saved weights."""
    x, z = _pairs()
    proposal = types.SimpleNamespace(theta_dim=5)
    cfg = RUN_CONFIG_PARAMS.replace(MNLE_HIDDEN_FEATURES=16, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=5,
                                    TRAIN_BATCH_SIZE=64, TRAIN_MAX_EPOCHS=6, TRAIN_STOP_AFTER_EPOCHS=6,
                                    TRAIN_LEARNING_RATE=3e-3)
    kw = dict(device="cpu", seed=4, verbose=False)
    full = tmnle.train_mnle(cfg, proposal, z, x, **kw)
    # The cut run's weights can only match if the uninterrupted best epoch lies after the cut.
    assert int(np.argmin(full.train_meta["val_losses"])) >= 3

    steps_per_epoch = full.train_meta["steps_per_epoch"]
    real, seen = tmnle.train_step, [0]

    def cut_in_epoch_3(*a):
        seen[0] += 1
        if seen[0] > 3 * steps_per_epoch + 2:
            raise _Cut
        return real(*a)

    ck = tmp_path / "ck"
    monkeypatch.setattr(tmnle, "train_step", cut_in_epoch_3)
    with pytest.raises(_Cut):
        tmnle.train_mnle(cfg, proposal, z, x, checkpoint_dir=str(ck), checkpoint_every=1, **kw)
    monkeypatch.setattr(tmnle, "train_step", real)
    assert latest_step(ck) == 2
    resumed = tmnle.train_mnle(cfg, proposal, z, x, checkpoint_dir=str(ck), checkpoint_every=1, verbose=True,
                               device="cpu", seed=4)
    assert "[train_mnle] resumed from epoch 2" in capsys.readouterr().out
    assert resumed.train_meta["epochs_run"] == 3
    assert resumed.train_meta["train_losses"] == full.train_meta["train_losses"][3:]
    for a, b in zip(full.net.parameters(), resumed.net.parameters()):
        assert torch.equal(a, b)

    assert latest_step(ck) == 5
    saved = restore_train_state(ck)["params"]
    again = tmnle.train_mnle(cfg, proposal, z, x, checkpoint_dir=str(ck), checkpoint_every=1, **kw)
    assert again.train_meta["epochs_run"] == 0
    assert all(torch.equal(v, again.net.state_dict()[k]) for k, v in saved.items())
    # Another config in the same directory is refused.
    with pytest.raises(ValueError, match="different"):
        tmnle.train_mnle(cfg.replace(TRAIN_MAX_EPOCHS=7), proposal, z, x, checkpoint_dir=str(ck), **kw)
