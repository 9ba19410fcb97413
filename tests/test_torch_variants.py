"""PyTorch port: the choice-only and 7-parameter simulators against the JAX
package, and the plain scan's per-trial noise scale.

Every input is made with numpy from a seed and goes through both packages.
Without noise the outcomes are deterministic and must agree: the choice
exactly and the RT to one float32 ulp (XLA's CPU backend contracts ``t_nd +
hit_step*dt`` into a fused multiply-add, the port rounds twice; see
``tests/test_torch_simulator.py``). With noise the two packages draw from
different streams and agree in distribution: chi-square on the choice
counts and two-sample KS on the RTs of each choice, each p > P_MIN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu.models import choice_model as jchoice
from sbi_for_diffusion_models_tpu.models import pulse_ddm_7p as j7p
from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_choice_scan as j_choice_scan
from sbi_for_diffusion_models_tpu.ops.ddm_scan import ddm_rt_choice_scan as j_scan
from sbi_for_diffusion_models_tpu_torch.models import choice_model as tchoice
from sbi_for_diffusion_models_tpu_torch.models import pulse_ddm_7p as t7p
from sbi_for_diffusion_models_tpu_torch.models import rt_choice_model as tmodel
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_choice_scan, ddm_rt_choice_scan

DT, T_MAX, N_MAX, SPP = 5e-4, 0.8, 1600, 200  # a 1,600-step window of 8 pulses
KW = dict(dt=DT, t_max=T_MAX, steps_per_pulse=SPP, n_max=N_MAX)
P_MIN = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _theta(rng, n, strong=False):
    """Random [a0, lam, v, B, t_nd]; ``strong``: drift and bound that end
    nearly every trial inside a short window."""
    v = rng.lognormal(0.7, 0.3, n) if strong else rng.lognormal(0, 1, n)
    B = rng.lognormal(0.8, 0.2, n) if strong else rng.lognormal(1.0, 0.3, n)
    return np.stack([rng.uniform(0.3, 0.7, n), rng.lognormal(-1, 0.5, n), v, B, rng.uniform(0, 0.3, n)],
                    -1).astype(np.float32)


def _assert_same_outcome(port, ref):
    np.testing.assert_array_equal(port[:, 1], ref[:, 1])
    np.testing.assert_array_max_ulp(port[:, 0], ref[:, 0], maxulp=1)


def _p_values(a, b):
    """Chi-square p on the choice counts and KS p on RT per choice (each
    choice both samples have over 20 of), for two (n, 2) samples."""
    choices = np.union1d(np.unique(a[:, 1]), np.unique(b[:, 1]))
    counts = np.array([[np.sum(x[:, 1] == c) for c in choices] for x in (a, b)])
    p = [float(stats.chi2_contingency(counts)[1]) if len(choices) > 1 else 1.0]
    for c in choices:
        if min(np.sum(a[:, 1] == c), np.sum(b[:, 1] == c)) > 20:
            p.append(float(stats.ks_2samp(a[a[:, 1] == c, 0], b[b[:, 1] == c, 0]).pvalue))
    return p


def test_torch_per_trial_mu_sensory_matches_jax_scan_with_injected_noise():
    """A per-trial (N,) mu_sensory in the plain scan, fed the JAX scan's
    per-chunk draws: choices exact, RTs within one ulp, against JAX's scan
    with the same (N,) array; a tensor of equal entries gives the float's
    bits; the K1 wrapper's CPU route takes the same array."""
    rng = np.random.default_rng(0)
    n = 256
    theta = _theta(rng, n)
    s = np.where(rng.random((n, 8)) < 0.5, 1.0, -1.0).astype(np.float32)
    mu = rng.uniform(0.3, 1.7, n).astype(np.float32)
    key = jax.random.key(5)
    ref = np.asarray(j_scan(jnp.asarray(theta), jnp.asarray(s), key, mu_sensory=jnp.asarray(mu), chunk_steps=SPP,
                            **KW))

    def noise(c):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, c), (SPP, n), jnp.float32)))

    th, st = torch.from_numpy(theta), torch.from_numpy(s)
    got = ddm_rt_choice_scan(th, st, mu_sensory=torch.from_numpy(mu), chunk_steps=SPP, noise=noise, **KW).numpy()
    _assert_same_outcome(got, ref)
    assert set(np.unique(ref[:, 1])) == {0.0, 1.0, 2.0}

    scalar = ddm_rt_choice_scan(th, st, 3, mu_sensory=0.8, chunk_steps=SPP, **KW)
    rows = ddm_rt_choice_scan(th, st, 3, mu_sensory=torch.full((n,), 0.8), chunk_steps=SPP, **KW)
    assert torch.equal(scalar, rows)
    wrapped = ddm_rt_choice_cuda(th, st, 4, mu_sensory=torch.from_numpy(mu), **KW)
    assert torch.equal(wrapped, ddm_rt_choice_scan(th, st, 4, mu_sensory=torch.from_numpy(mu), chunk_steps=SPP,
                                                   **KW))
    with pytest.raises(ValueError, match="per-trial mu_sensory"):
        ddm_rt_choice_cuda(th, st, 4, mu_sensory=torch.ones(n - 1), **KW)


@pytest.mark.parametrize("theta", [
    [0.3, 0.5, 1.2, 10.0, 0.2], [1.7, -0.4, np.nan, -3.0, 9.5], [np.nan, np.inf, 0.1, np.nan, np.nan],
    [-0.2, 1.0, 1.0, 0.0, -1.0],
])
def test_torch_choice_model_params_and_pulse_sides_match_jax(theta):
    theta = np.asarray(theta)
    got = tchoice.ChoiceModelParams.from_theta(theta)
    assert got == tchoice.ChoiceModelParams(**jchoice.ChoiceModelParams.from_theta(theta).__dict__)
    assert tchoice.ChoiceModelParams.from_theta(torch.from_numpy(theta)) == got
    with pytest.raises(ValueError, match="5 params"):
        tchoice.ChoiceModelParams.from_theta(theta[:4])
    for n_pulses, p in ((80, 0.75), (7, 0.3), (0, 0.75), (5, 1.5)):
        a = tchoice.generate_pulse_sides(np.random.default_rng(n_pulses), n_pulses, p_success=p)
        b = jchoice.generate_pulse_sides(np.random.default_rng(n_pulses), n_pulses, p_success=p)
        assert a.dtype == np.float32 and a.shape == (max(n_pulses, 0),)
        np.testing.assert_array_equal(a, b)


def _jax_choice_pulses(key, n, P, p_success):
    """The stimulus of the first pass of JAX's ddm_choice_scan."""
    k_stim, _ = jax.random.split(jax.random.fold_in(key, 0))
    correct = jnp.where(jax.random.uniform(jax.random.fold_in(k_stim, 0), (n, 1)) < 0.5, 1.0, -1.0)
    match = jax.random.uniform(jax.random.fold_in(k_stim, 1), (n, P)) < p_success
    return np.array(jnp.where(match, correct, -correct), np.float32)


def test_torch_choice_scan_zero_noise_is_exact_on_given_pulses(monkeypatch):
    """Without noise, on the stimulus JAX's first pass draws (handed to the
    port's pass in place of its own draw), the choices equal JAX's exactly,
    censored trials -1 in both; the same through the K1 dispatch ("pallas",
    its CPU route) and the plain scan (cfg.SIM_KERNEL "scan")."""
    rng = np.random.default_rng(1)
    n = 128
    theta = _theta(rng, n)
    key = jax.random.key(2)
    want = np.asarray(j_choice_scan(jnp.asarray(theta), key, mu_sensory=0.0, chunk_steps=SPP, **KW))
    s = torch.from_numpy(_jax_choice_pulses(key, n, N_MAX // SPP, 0.75))
    monkeypatch.setattr(tmodel, "generate_pulse_matrix", lambda gen, n_, P, p_success: s[:n_])
    for kernel in ("scan", "pallas"):
        monkeypatch.setattr(tmodel, "cfg", tmodel.cfg.replace(SIM_KERNEL=kernel))
        got = ddm_choice_scan(torch.from_numpy(theta), 9, mu_sensory=0.0, chunk_steps=SPP, **KW)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {-1, 0, 1}


@pytest.mark.parametrize("theta", [[0.5, 0.3, 1.5, 4.0, 0.1], [0.3, 1.0, 0.6, 3.0, 0.05], [0.6, 0.1, 3.0, 2.5, 0.25]])
def test_torch_choice_scan_matches_jax_in_distribution(theta):
    """With noise, 3,000 trials at one theta: the port's choice frequencies
    against JAX's by chi-square (p > P_MIN), one pass each."""
    n = 3000
    th = np.tile(np.asarray(theta, np.float32), (n, 1))
    want = np.asarray(j_choice_scan(jnp.asarray(th), jax.random.key(4), chunk_steps=SPP, **KW))
    got = ddm_choice_scan(torch.from_numpy(th), 4, chunk_steps=SPP, **KW).numpy()
    counts = np.array([[np.sum(x == c) for c in (-1, 0, 1)] for x in (got, want)])
    seen = counts.sum(0) > 0
    p = float(stats.chi2_contingency(counts[:, seen])[1])
    assert p > P_MIN, (counts, p)


def test_torch_choice_simulators_resample_and_shapes():
    """``ddm_choice_scan`` on the SNPE example's kind of grid (shorter here):
    the resample passes re-run only the invalid trials and leave fewer, and
    the same seed gives the same output. ``choice_model_simulator_torch``
    (the JAX signature, the default grid): (N, 1) float32 in {-1, 0, 1},
    ``ddm_choice_scan``'s choices; the single-trial API gives an int."""
    rng = np.random.default_rng(3)
    theta = torch.from_numpy(np.tile([0.5, 0.2, 0.4, 6.0, 0.1], (400, 1)).astype(np.float32))
    grid = dict(t_max=T_MAX, n_max=N_MAX)
    once = ddm_choice_scan(theta, 7, **grid)
    again = ddm_choice_scan(theta, 7, max_resamples=3, **grid)
    assert once.shape == again.shape == (400,) and once.dtype == torch.int32
    assert set(np.unique(once.numpy())) <= {-1, 0, 1}
    valid = once >= 0
    assert torch.equal(again[valid], once[valid])  # a valid first pass is kept
    assert 0 < int((again < 0).sum()) < int((once < 0).sum())
    assert torch.equal(once, ddm_choice_scan(theta, 7, **grid))
    strong = np.tile([0.5, 0.2, 3.0, 1.0, 0.1], (8, 1)).astype(np.float32)  # every trial ends inside a pulse or two
    x = tchoice.choice_model_simulator_torch(strong, 7, resample_invalid=True, max_resamples=2, device="cpu")
    assert x.shape == (8, 1) and x.dtype == torch.float32 and set(np.unique(x.numpy())) <= {0.0, 1.0}
    assert torch.equal(x[:, 0], ddm_choice_scan(torch.from_numpy(strong), 7, max_resamples=2).to(torch.float32))
    assert tchoice.choice_model_simulator_torch(strong[0], 7, device="cpu").shape == (1, 1)
    c = tchoice.choice_model_simulator(theta[0], np.random.default_rng(0), device="cpu")
    assert isinstance(c, int) and c in (-1, 0, 1)
    with pytest.raises(ValueError, match="shape"):
        tchoice.choice_model_simulator_torch(np.zeros((3, 4), np.float32), device="cpu")
    with pytest.raises(TypeError):
        tchoice.choice_model_simulator_torch(strong, 7, n_max=N_MAX, device="cpu")  # the JAX signature: no grid
    with pytest.raises(ValueError, match="divisible"):
        ddm_choice_scan(theta, 0, n_max=1650, chunk_steps=200)
    # The JAX package's shape for the same input.
    assert jchoice.choice_model_simulator_torch(theta[:3].numpy(), rng.integers(1 << 30)).shape == (3, 1)


def _theta7(rng, n, sigma_a, sigma_s):
    th = _theta(rng, n, strong=True)
    return np.concatenate([th[:, :4], np.full((n, 1), sigma_a), th[:, 4:], np.full((n, 1), sigma_s)],
                          -1).astype(np.float32)


def test_torch_7p_without_noise_matches_jax_on_the_same_pulses():
    """sigma_a = sigma_s = 0: the 7-parameter simulator is deterministic;
    on the same pulses it equals JAX's (choices exact, RTs within one ulp),
    and the 5-parameter simulator at mu_sensory = 0 on columns [0, 1, 2, 3,
    5]."""
    rng = np.random.default_rng(4)
    n = 64
    theta = _theta7(rng, n, 0.0, 0.0)
    s = np.where(rng.random((n, 80)) < 0.6, 1.0, -1.0).astype(np.float32)
    want = np.asarray(j7p.rt_choice_model_simulator_7p(theta, rng=jax.random.key(1), pulse_sides=s))
    got = t7p.rt_choice_model_simulator_7p(theta, 3, pulse_sides=s, device="cpu")
    assert got.shape == (n, 2) and got.dtype == torch.float32
    _assert_same_outcome(got.numpy(), want)
    five = tmodel.rt_choice_model_simulator_torch(theta[:, [0, 1, 2, 3, 5]], 3, mu_sensory=0.0, pulse_sides=s,
                                                  device="cpu")
    assert torch.equal(got, five)
    assert set(np.unique(want[:, 1])) <= {0.0, 1.0}


def test_torch_7p_with_noise_matches_jax_in_distribution():
    """sigma_a = 0.8, sigma_s = 0.6 at one theta, 2,000 trials on one
    stimulus: chi-square on the choices and KS on RT per choice against
    JAX's draws (p > P_MIN); the sensory noise moves the outcome away from
    the noiseless one."""
    rng = np.random.default_rng(5)
    n = 2000
    theta = np.tile(_theta7(rng, 1, 0.8, 0.6), (n, 1))
    s = np.tile(np.where(rng.random((1, 80)) < 0.7, 1.0, -1.0).astype(np.float32), (n, 1))
    want = np.asarray(j7p.rt_choice_model_simulator_7p(theta, rng=jax.random.key(2), pulse_sides=s))
    got = t7p.rt_choice_model_simulator_7p(theta, 6, pulse_sides=s, device="cpu").numpy()
    p = _p_values(got, want)
    assert min(p) > P_MIN, p
    quiet = theta.copy()
    quiet[:, 6] = 0.0
    base = t7p.rt_choice_model_simulator_7p(quiet, 6, pulse_sides=s, device="cpu").numpy()
    assert min(_p_values(got, base)) < P_MIN


def test_torch_7p_session_and_validation():
    theta = np.array([0.5, 0.2, 2.0, 3.0, 0.5, 0.1, 0.3], np.float32)
    x, pulses = t7p.simulate_session_data_7p(theta, 40, 1, return_pulse_sides=True, device="cpu")
    assert x.shape == (40, 2) and pulses.shape == (40, 80)
    assert set(np.unique(pulses.numpy())) <= {-1.0, 1.0}
    assert torch.equal(x, t7p.simulate_session_data_7p(theta, 40, 1, device="cpu"))
    jx = j7p.simulate_session_data_7p(theta, 40, jax.random.key(0))
    assert tuple(jx.shape) == tuple(x.shape)
    one = t7p.rt_choice_model_simulator_7p(theta, 2, device="cpu")
    assert one.shape == (1, 2) and bool(torch.isfinite(one).all())
    with pytest.raises(ValueError, match=r"\(N,7\)"):
        t7p.rt_choice_model_simulator_7p(np.zeros((3, 5), np.float32), device="cpu")
    with pytest.raises(ValueError, match="needs at least 80"):
        t7p.rt_choice_model_simulator_7p(np.tile(theta, (2, 1)), pulse_sides=np.ones((2, 10), np.float32),
                                         device="cpu")
    with pytest.raises(ValueError, match="first dim"):
        t7p.rt_choice_model_simulator_7p(np.tile(theta, (2, 1)), pulse_sides=np.ones((3, 80), np.float32),
                                         device="cpu")
