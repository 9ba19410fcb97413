"""PyTorch port: the pulse-DDM simulator (plain version of kernel K1) against
the JAX scan and Pallas kernels, and the simulator's public API.

Rounding note. The hit step and the choice agree exactly in every case.
The RT ``t_nd + hit_step*dt`` may differ in its last bit: XLA's CPU backend
contracts that expression into one fused multiply-add, while the port (and
the CUDA kernel K1, which the port matches bit for bit on the card) rounds
the product and the sum separately. The tests therefore check the RT as the
fused operation rounds it, recomputed from the port's hit step, for exact
equality, and the port's own RT to one float32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbi_for_diffusion_models_tpu.models import rt_choice_model as jmodel
from sbi_for_diffusion_models_tpu.ops.ddm_pallas import ddm_rt_choice_pallas
from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan as jax_scan
from sbi_for_diffusion_models_tpu_torch import data_simulator as tdata
from sbi_for_diffusion_models_tpu_torch.models import rt_choice_model as tmodel
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan, sanitize_theta
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS

DT = 5e-4
T_MAX = 0.8  # 1,600 steps, 8 pulses
N_MAX = 1600
SPP = 200
P = 8
KW = dict(dt=DT, t_max=T_MAX, steps_per_pulse=SPP, n_max=N_MAX)


def _hit_steps(x, theta):
    t_nd = np.clip(theta[:, 4], 0.0, np.float32(T_MAX - 1e-6)).astype(np.float32)
    return np.rint((x[:, 0].astype(np.float64) - t_nd) / np.float32(DT)).astype(np.int64)


def _assert_same_outcome(port, ref, theta):
    """Exact choices and hit steps; RT exact as one fused multiply-add
    rounds it (see the module docstring), and within one ulp as computed."""
    np.testing.assert_array_equal(port[:, 1], ref[:, 1])
    steps = _hit_steps(port, theta)
    np.testing.assert_array_equal(steps, _hit_steps(ref, theta))
    t_nd = np.clip(theta[:, 4], 0.0, np.float32(T_MAX - 1e-6)).astype(np.float32)
    fused = (steps * np.float64(np.float32(DT)) + t_nd.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.clip(fused, np.float32(1e-6), np.float32(T_MAX)), ref[:, 0])
    np.testing.assert_array_max_ulp(port[:, 0], ref[:, 0], maxulp=1)


def _random_theta(rng, n):
    return np.stack(
        [
            rng.uniform(0.2, 0.8, n),
            rng.lognormal(-1, 1, n),
            rng.lognormal(0, 1, n),
            rng.lognormal(1.0, 0.3, n),
            rng.uniform(0, 0.3, n),
        ],
        -1,
    ).astype(np.float32)


def test_plain_matches_jax_scan_with_injected_noise():
    """Fed the per-chunk draws jax.random.normal(fold_in(key, c)) of the JAX
    scan kernel, the plain version reproduces it: 0 one-step differences."""
    rng = np.random.default_rng(0)
    n = 256
    theta = _random_theta(rng, n)
    s = np.where(rng.random((n, P)) < 0.5, 1.0, -1.0).astype(np.float32)
    key = jax.random.key(3)
    ref = np.asarray(jax_scan(jnp.asarray(theta), jnp.asarray(s), key, mu_sensory=1.0, chunk_steps=SPP, **KW))
    calls = []

    def noise(c):
        calls.append(c)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, c), (SPP, n), jnp.float32)))

    got = ddm_rt_choice_scan(
        torch.from_numpy(theta), torch.from_numpy(s), mu_sensory=1.0, chunk_steps=SPP, noise=noise, **KW
    ).numpy()
    _assert_same_outcome(got, ref, theta)
    assert set(np.unique(ref[:, 1])) == {0.0, 1.0, 2.0}
    # Chunks after the last active trial are skipped, as in the JAX kernel.
    assert calls == list(range(len(calls))) and len(calls) <= N_MAX // SPP


def _pallas(theta, pulses, **kw):
    return np.asarray(
        ddm_rt_choice_pallas(
            jnp.asarray(theta), jnp.asarray(pulses), jax.random.key(0), tile_rows=8,
            interpret=pltpu.InterpretParams(), **KW, **kw,
        )
    )


def _tile(row, n):
    return np.tile(np.asarray([row], np.float32), (n, 1))


ZERO_NOISE_CASES = {
    # lam = 0: kicks only; a0 = 5, v = 1.2 -> the 5th kick (step 800) hits B = 10.
    "kicks": (_tile([0.5, 0.0, 1.2, 10.0, 0.0], 16), np.ones((16, P), np.float32), 0.0),
    "lower_bound": (_tile([0.5, 0.0, 1.5, 8.0, 0.0], 16), -np.ones((16, P), np.float32), 0.0),
    "censoring_window": (
        np.stack([np.full(4, 0.5), np.zeros(4), np.zeros(4), np.full(4, 10.0),
                  [0.0501, 0.1002, 0.3333, 0.7899]], -1).astype(np.float32),
        np.ones((4, P), np.float32),
        0.0,
    ),
    "leak": (
        _tile([0.4, 2.0, 1.0, 6.0, 0.05], 8),
        np.tile(np.where(np.arange(P) % 2 == 0, 1.0, -1.0).astype(np.float32), (8, 1)),
        0.0,
    ),
    "collapse": (_tile([0.55, 0.0, 0.0, 9.0, 0.0], 8), np.ones((8, P), np.float32), 4.0),
}


@pytest.mark.parametrize("case", sorted(ZERO_NOISE_CASES))
def test_zero_noise_matches_pallas_kernel(case):
    """mu_sensory = 0: the plain version, and the K1 wrapper on CPU tensors,
    follow the Pallas kernel (interpret mode) exactly."""
    theta, pulses, collapse = ZERO_NOISE_CASES[case]
    ref = _pallas(theta, pulses, mu_sensory=0.0, collapse_rate=collapse)
    th, s = torch.from_numpy(theta), torch.from_numpy(pulses)
    plain = ddm_rt_choice_scan(th, s, 5, mu_sensory=0.0, collapse_rate=collapse, chunk_steps=SPP, **KW).numpy()
    wrapped = ddm_rt_choice_cuda(th, s, 9, mu_sensory=0.0, collapse_rate=collapse, **KW).numpy()
    _assert_same_outcome(plain, ref, theta)
    np.testing.assert_array_equal(wrapped, plain)
    if case == "kicks":
        np.testing.assert_array_equal(_hit_steps(plain, theta), 801)
        np.testing.assert_array_equal(plain[:, 1], 1.0)
    if case == "censoring_window":
        np.testing.assert_array_equal(plain[:, 1], 2.0)


def test_zero_noise_random_theta_matches_pallas():
    rng = np.random.default_rng(4)
    theta = _random_theta(rng, 128)
    s = np.where(rng.random((128, P)) < 0.5, 1.0, -1.0).astype(np.float32)
    ref = _pallas(theta, s, mu_sensory=0.0)
    got = ddm_rt_choice_scan(torch.from_numpy(theta), torch.from_numpy(s), mu_sensory=0.0, chunk_steps=SPP, **KW)
    _assert_same_outcome(got.numpy(), ref, theta)


def test_sanitize_theta_matches_jax():
    from sbi_for_diffusion_models_tpu.ops.ddm_scan import sanitize_theta as j_sanitize

    theta = np.asarray([[-0.5, 1.0, -2.0, -3.0, -1.0], [1.5, -1.0, 2.0, 0.0, 9.0]], np.float32)
    for a, b in zip(sanitize_theta(torch.from_numpy(theta)), j_sanitize(jnp.asarray(theta))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_schedule_and_host_pulses_match_jax():
    assert tmodel.pulse_schedule() == jmodel.pulse_schedule()
    n_max, spp = tmodel.pulse_schedule()
    assert tmodel.n_pulses_max_from_schedule(n_max, spp) == jmodel.n_pulses_max_from_schedule(n_max, spp) == 80
    a = tmodel.generate_pulse_matrix_numpy(np.random.default_rng(5), 7, 80)
    b = jmodel.generate_pulse_matrix_numpy(np.random.default_rng(5), 7, 80)
    np.testing.assert_array_equal(a, b)
    x = np.asarray([[0.5, 1.0], [1e-9, 2.0]], np.float32)
    for log_rt in (False, True):
        np.testing.assert_allclose(
            tmodel.pack_x_rt_choice(x, log_rt=log_rt, device="cpu").numpy(),
            np.asarray(jmodel.pack_x_rt_choice(x, log_rt=log_rt)), rtol=1e-6,
        )


def test_simulator_api_shapes_seeds_and_errors():
    theta = np.tile([0.5, 0.3, 1.2, 10.0, 0.2], (6, 1)).astype(np.float32)
    s = tmodel.generate_pulse_matrix_numpy(np.random.default_rng(0), 6, 80)
    a = tmodel.rt_choice_model_simulator_torch(theta, rng=1, pulse_sides=s, device="cpu")
    b = tmodel.rt_choice_model_simulator_torch(theta, rng=1, pulse_sides=s, device="cpu")
    assert a.shape == (6, 2) and torch.equal(a, b)
    assert set(a[:, 1].tolist()) <= {0.0, 1.0, 2.0}
    one = tmodel.rt_choice_model_simulator_torch(theta[0], rng=1, pulse_sides=s[:1], device="cpu")
    assert one.shape == (1, 2)
    with pytest.raises(ValueError, match="shape"):
        tmodel.rt_choice_model_simulator_torch(np.zeros((3, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="needs at least 80"):
        tmodel.rt_choice_model_simulator_torch(theta, pulse_sides=s[:, :10], device="cpu")
    with pytest.raises(ValueError, match="unknown sim kernel"):
        tmodel.dispatch_sim_kernel("xla")
    for kernel in ("auto", "scan", "pallas"):
        run = tmodel.dispatch_sim_kernel(kernel)
        out = run(torch.from_numpy(theta), torch.from_numpy(s), 3, mu_sensory=1.0, collapse_rate=0.0,
                  steps_per_pulse=200, n_max=16000)
        assert out.shape == (6, 2)
    x, pulses = tmodel.simulate_session_data_rt_choice(theta[0], 5, rng=2, return_pulse_sides=True, device="cpu")
    assert x.shape == (5, 2) and pulses.shape == (5, 80)


def test_data_simulator_training_set_and_session():
    proposal = ExtendedProposal(build_prior_theta(), PulseSequenceProposal(80, device="cpu"))
    cfg = RUN_CONFIG_PARAMS.replace(TRAIN_BATCH_SIZE=24)
    z, x = tdata.simulate_training_set_with_conditions(cfg, proposal, num_simulations=40, seed=1, verbose=False,
                                                       device="cpu")
    assert z.shape == (40, 85) and x.shape == (40, 2)
    assert torch.isfinite(x).all() and set(x[:, 1].tolist()) <= {0.0, 1.0, 2.0}
    z2, x2 = tdata.simulate_training_set_with_conditions(cfg, proposal, num_simulations=40, seed=1, verbose=False,
                                                         device="cpu")
    assert torch.equal(z, z2) and torch.equal(x, x2)
    # The simulator conditions on each z row's own pulses.
    again = tdata.sim_wrapper(z[:3], rng=5)
    assert again.shape == (3, 2)
    x_o, p_o = tdata.simulate_observed_session(np.array([0.5, 0.3, 1.2, 10.0, 0.2], np.float32), 12, seed=4,
                                               device="cpu")
    assert x_o.shape == (12, 2) and p_o.shape == (12, 80)
    assert (x_o[:, 0] > 0.2).all()  # rt > t_nd
    tdata.summarize_trials("test", x_o)
