"""PyTorch port: the public names (the package root, ``models`` and
``nets`` against the JAX package's ``__init__`` lists, every one ported) and
the small modules behind them,
each against the JAX package: ``datasets``, ``utils/debug``, the ``Normal``
/ ``Uniform`` / ``BoxUniform`` distributions, ``RTChoiceModelParams`` and
the single-trial ``rt_choice_model_simulator``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sbi_for_diffusion_models_tpu as jpkg
import sbi_for_diffusion_models_tpu_torch as port
from sbi_for_diffusion_models_tpu import datasets as jdatasets
from sbi_for_diffusion_models_tpu import distributions as jd
from sbi_for_diffusion_models_tpu.models import rt_choice_model as jmodel
from sbi_for_diffusion_models_tpu.utils import debug as jdebug
from sbi_for_diffusion_models_tpu_torch import datasets as tdatasets
from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch.models import rt_choice_model as tmodel
from sbi_for_diffusion_models_tpu_torch.utils import debug as tdebug


def _jax_public(module):
    """The names the JAX module's own imports bind (its submodules aside)."""
    return {n for n, v in vars(module).items() if not n.startswith("_") and not isinstance(v, type(jpkg))
            or n == "constants"}


def test_root_exports_every_ported_jax_name():
    """The root exports every public name of the JAX package's root (and
    the port's ``MNLEEnsemble`` / ``load_ensemble``), each bound to an
    object of the same kind and name; an unknown name raises."""
    jax_names = _jax_public(jpkg) - {"annotations"}
    assert set(port.__all__) - {"MNLEEnsemble", "load_ensemble"} == jax_names
    for name in port.__all__:
        assert getattr(port, name) is not None
    for name in jax_names - {"constants"}:
        got, want = getattr(port, name), getattr(jpkg, name)
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "__name__", name) == getattr(want, "__name__", name)
    assert port.constants.T_MAX == jpkg.constants.T_MAX and port.MNLEEnsemble.__name__ == "MNLEEnsemble"
    with pytest.raises(AttributeError):
        getattr(port, "not_a_name")


@pytest.mark.parametrize("sub", ["models", "nets", "parallel"])
def test_subpackage_exports_match_jax(sub):
    jmod = importlib.import_module(f"sbi_for_diffusion_models_tpu.{sub}")
    tmod = importlib.import_module(f"sbi_for_diffusion_models_tpu_torch.{sub}")
    assert set(tmod.__all__) == set(jmod.__all__)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None
        assert getattr(getattr(tmod, name), "__name__", name) == getattr(getattr(jmod, name), "__name__", name)


def _table():
    return {
        "rt": np.array([0.5, np.nan, 1e-9, 2.0, 30.0, 0.7], np.float64),
        "choice": np.array([0, 1, 1, 2, 0, np.inf]),
        "subject": np.array(["b", "a", "a", "b", "a", "b"]),
    }


@pytest.mark.parametrize("kw", [dict(), dict(log_rt=True, rt_max=8.0)])
def test_datasets_match_jax(kw):
    """``make_x_from_rat_df`` and ``split_by_subject`` on a mapping (and on
    a pandas DataFrame where pandas imports): the same drops, clamps, logs
    and subject order as JAX's, as float32 tensors on the device asked."""
    table = _table()
    want = np.asarray(jdatasets.make_x_from_rat_df(table, **kw))
    got = tdatasets.make_x_from_rat_df(table, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    ids, xs = tdatasets.split_by_subject(table, device="cpu", **kw)
    jids, jxs = jdatasets.split_by_subject(table, **kw)
    assert ids == jids == ["a", "b"]
    for a, b in zip(xs, jxs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="coded in"):
        tdatasets.make_x_from_rat_df({"rt": np.ones(2), "choice": np.array([0.0, 3.0])}, device="cpu")
    with pytest.raises(TypeError, match="unsupported table type"):
        tdatasets.make_x_from_rat_df([1, 2], device="cpu")
    try:
        import pandas as pd
    except ImportError:  # pandas is optional
        pd = None
    if pd is not None:
        frame = pd.DataFrame(table)
        np.testing.assert_array_equal(tdatasets.make_x_from_rat_df(frame, device="cpu", **kw).numpy(), want)
        assert tdatasets.split_by_subject(frame, device="cpu", **kw)[0] == ["a", "b"]


def test_nan_guard_raises_at_the_first_nan_inside_the_block():
    """``nan_guard`` raises ``FloatingPointError`` naming the operation that
    made a NaN inside the block (forward or backward), lets finite work
    through, and is off again after the block; ``assert_finite`` names the
    array as JAX's does."""
    x = torch.tensor([1.0, -1.0])
    y = torch.tensor([0.0], requires_grad=True)
    with tdebug.nan_guard():
        assert torch.equal(torch.exp(torch.zeros(2)), torch.ones(2))
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
        out = (torch.sqrt(y) * 0.0).sum()  # finite: 0
        with pytest.raises(FloatingPointError, match="NaN produced by"):
            out.backward()  # 0 x d sqrt / dy at 0 = 0 x inf
    assert torch.isnan(torch.sqrt(x)).any()  # off after the block
    bad = np.array([1.0, np.nan, np.inf])
    with pytest.raises(FloatingPointError) as port_err:
        tdebug.assert_finite("theta", np.ones(2), torch.from_numpy(bad))
    with pytest.raises(FloatingPointError) as jax_err:
        jdebug.assert_finite("theta", np.ones(2), bad)
    assert str(port_err.value) == str(jax_err.value) == "theta: array 1 has 2/3 non-finite values"
    tdebug.assert_finite("ok", torch.ones(3))


@pytest.mark.parametrize("name", ["Normal", "Uniform", "BoxUniform"])
def test_distributions_match_jax(name):
    lo, hi = np.array([-1.0, 0.5, 2.0]), np.array([1.0, 3.0, 2.5])
    args = (lo, hi) if name != "Normal" else (np.array([0.3, -1.0, 2.0]), np.array([0.5, 2.0, 1.5]))
    jdist, tdist = getattr(jd, name)(*args), getattr(td, name)(*args)
    rng = np.random.default_rng(5)
    x = rng.uniform(-2.0, 3.5, (200, 3)).astype(np.float32)
    want = np.asarray(jdist.log_prob(jnp.asarray(x)))
    got = tdist.log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], rtol=1e-6, atol=1e-6)
    lp, grad = tdist.log_prob_and_grad(torch.from_numpy(x))
    assert torch.equal(lp, tdist.log_prob(torch.from_numpy(x)))
    if name == "Normal":
        x_ = torch.from_numpy(x).requires_grad_(True)
        (auto,) = torch.autograd.grad(tdist.log_prob(x_).sum(), x_)
        np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=1e-6, atol=1e-6)
    else:  # flat on its box
        assert not bool(grad.any())
    s = tdist.sample(torch.Generator().manual_seed(0), (20000,))
    assert s.shape == (20000, 3) and bool(torch.isfinite(tdist.log_prob(s)).all())
    mean = args[0] if name == "Normal" else (lo + hi) / 2
    np.testing.assert_allclose(s.mean(0).numpy(), mean, atol=0.05)
    assert [(v.kind, v.lo, v.hi) for v in tdist.supports()] == [(v.kind, v.lo, v.hi) for v in jdist.supports()]
    # Inside a prior, through the MCMC bijection.
    prior = td.MultipleIndependent([td.Beta(2.0, 2.0), tdist])
    assert prior.has_closed_form_grad() and prior.event_shape == (4,)


@pytest.mark.parametrize("theta", [
    [0.3, 0.5, 1.2, 10.0, 0.2], [1.7, -0.4, np.nan, -3.0, 9.5], [np.nan, np.inf, 0.1, np.nan, np.nan],
    [-0.2, 1.0, 1.0, 0.0, -1.0],
])
def test_rt_choice_model_params_match_jax(theta):
    theta = np.asarray(theta)
    assert tmodel.RTChoiceModelParams.from_theta(theta) == tmodel.RTChoiceModelParams(
        **jmodel.RTChoiceModelParams.from_theta(theta).__dict__)
    assert tmodel.RTChoiceModelParams.from_theta(torch.from_numpy(theta)) == tmodel.RTChoiceModelParams.from_theta(
        theta)
    with pytest.raises(ValueError, match="5 params"):
        tmodel.RTChoiceModelParams.from_theta(theta[:4])


def test_single_trial_simulator_matches_jax():
    """``rt_choice_model_simulator`` (one trial, Python numbers) through the
    port's dispatch on the CPU: without sensory noise the trial is
    deterministic and equals JAX's (RT within one float32 ulp, see
    ``tests/test_torch_simulator.py``); with it, a trial and a choice."""
    rng = np.random.default_rng(6)
    pulses = np.where(rng.random((1, 80)) < 0.7, 1.0, -1.0).astype(np.float32)
    theta = np.array([0.5, 0.3, 3.0, 4.0, 0.15], np.float32)
    rt, choice = tmodel.rt_choice_model_simulator(theta, 3, mu_sensory=0.0, pulse_sides=pulses, device="cpu")
    jrt, jchoice = jmodel.rt_choice_model_simulator(theta, np.random.default_rng(3), mu_sensory=0.0,
                                                    pulse_sides=pulses)
    assert isinstance(rt, float) and isinstance(choice, int)
    assert choice == jchoice and 0.15 < rt < 8.0
    np.testing.assert_array_max_ulp(np.float32(rt), np.float32(jrt), maxulp=1)
    rt, choice = port.rt_choice_model_simulator(theta, np.random.default_rng(4), pulse_sides=pulses, device="cpu")
    assert choice in (0, 1, 2) and 0.15 < rt <= 8.0
