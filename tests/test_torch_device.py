"""PyTorch port: entry points run on the CUDA card unless the caller names a
device. With no card (``torch.cuda.is_available`` patched to False, so the
tests mean the same on a machine with one), every entry point called
without ``device`` raises instead of running on the CPU; tensors passed in
keep their device.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import data_simulator as tdata
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
from sbi_for_diffusion_models_tpu_torch.inference.mcmc import MCMCPosterior
from sbi_for_diffusion_models_tpu_torch.models import rt_choice_model as tmodel
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, mnle_from_flax_params
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS
from sbi_for_diffusion_models_tpu_torch.utils.device import default_device, resolve_device

THETA = np.array([0.5, 0.3, 1.2, 10.0, 0.2], np.float32)
MODELS = Path(__file__).resolve().parents[1] / "artifacts" / "models"


def _tiny_tree(cfg):
    rng = np.random.default_rng(0)
    H, D, C = cfg.hidden_features, cfg.condition_dim, cfg.num_categories

    def dense(i, o):
        return {"kernel": rng.normal(size=(i, o)).astype(np.float32), "bias": np.zeros(o, np.float32)}

    return {
        "cat_net": {"Dense_0": dense(D, H), "Dense_1": dense(H, H), "Dense_2": dense(H, C)},
        "flow_trunk": {"Dense_0": dense(D + C, H), "Dense_1": dense(H, H), "Dense_2": dense(H, H)},
        **{f"spline_head_{i}": dense(H, 3 * cfg.num_bins - 1) for i in range(cfg.num_transforms)},
    }


_TINY = MNLEConfig(condition_dim=9, hidden_features=4, num_transforms=1, num_bins=2)

ENTRY_POINTS = {
    "default_device": lambda: default_device(),
    "simulate_training_set_with_conditions": lambda: tdata.simulate_training_set_with_conditions(
        RUN_CONFIG_PARAMS, ExtendedProposal(build_prior_theta(), PulseSequenceProposal(80, device="cpu")),
        num_simulations=4, verbose=False),
    "simulate_observed_session": lambda: tdata.simulate_observed_session(THETA, 4),
    "rt_choice_model_simulator_torch": lambda: tmodel.rt_choice_model_simulator_torch(THETA[None]),
    "simulate_session_data_rt_choice": lambda: tmodel.simulate_session_data_rt_choice(THETA, 4),
    "pack_x_rt_choice": lambda: tmodel.pack_x_rt_choice(np.ones((3, 2), np.float32), log_rt=False),
    "MCMCPosterior": lambda: MCMCPosterior(None, build_prior_theta(), mcmc_transform(build_prior_theta())),
    "PulseSequenceProposal": lambda: PulseSequenceProposal(80),
    "mnle_from_flax_params": lambda: mnle_from_flax_params(_TINY, _tiny_tree(_TINY), 0.0, 1.0, 0.0, 1.0),
    "load_model": lambda: tmnle.load_model("mnle_1m_pulseabs.npz"),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MODEL_DIR", str(MODELS))


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_device_asks_for_the_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_default_device_is_the_card_and_explicit_devices_pass(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda") == resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_tensor_inputs_keep_their_device_without_a_card(no_card):
    theta = torch.from_numpy(THETA)
    x, s = tdata.simulate_observed_session(theta, 4, seed=1)
    assert x.device.type == "cpu" and s.device.type == "cpu"
    out = tmodel.rt_choice_model_simulator_torch(theta[None], rng=2)
    assert out.device.type == "cpu" and out.shape == (1, 2)
    est = tmnle.load_model("mnle_1m_pulseabs.npz", device="cpu")
    assert est.device.type == "cpu"
