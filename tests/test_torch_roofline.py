"""PyTorch port: kernel K4's plain version against the JAX chain body, and
the roofline entry point's arithmetic.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s timing); on CPU tensors its wrapper takes the plain version,
which is what runs here.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import roofline
from sbi_for_diffusion_models_tpu_torch.ops import _cuda
from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import K4, ceiling_chain, ceiling_plain, fma_tolerance

ROOT = Path(__file__).resolve().parents[1]


def _jax_chain(x, K, kind):
    """The chain body of ``benchmarks/roofline.py`` (``vpu_ceiling.make``),
    restated: importing that file starts the JAX compile cache."""

    def body8(x):
        if kind == "fma":
            c = jnp.float32(1.0000001)
            d = jnp.float32(1e-7)
            for _ in range(8):
                x = x * c + d
        else:
            x = jnp.exp(x * jnp.float32(1e-3))
            x = jnp.log(x + jnp.float32(1.5))
            x = jnp.sqrt(x * x + jnp.float32(0.25))
            x = jnp.sin(x)
            x = x * jnp.float32(1.0001) + jnp.float32(1e-6)
            x = jnp.maximum(x, jnp.float32(-10.0))
            x = jnp.minimum(x, jnp.float32(10.0))
            x = x + jnp.float32(1e-6)
        return x

    return jax.jit(lambda v: jax.lax.fori_loop(0, K // 8, lambda i, v: body8(v), v))(x)


def _inputs(seed=0, shape=(3, 8, 128)):
    return np.random.default_rng(seed).uniform(0.25, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("K", [64, 512])
@pytest.mark.parametrize("kind", ["fma", "transcendental"])
def test_ceiling_plain_matches_the_jax_chain(kind, K):
    """fma: both sides are float32 chains that round the product and the
    sum (XLA may contract them into one FMA), so each is held to the float64
    evaluation within ``fma_tolerance`` at two roundings a step (K x 2^-23 x
    the value), and to each other within twice that; the chain moved every
    value by more than that tolerance. transcendental: the chain contracts
    towards a fixed point, so rounding does not add up: 4 float32 ulps of
    the value (about 5e-7) whatever K."""
    x = _inputs()
    got = ceiling_chain(torch.from_numpy(x), K, kind).numpy()  # a CPU tensor: the plain version
    ref = np.asarray(_jax_chain(jnp.asarray(x), K, kind))
    exact = ceiling_plain(torch.from_numpy(x).double(), K, kind).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape and exact.dtype == np.float64
    tol = fma_tolerance(K, np.abs(exact), roundings=2) if kind == "fma" else 4 * 2.0**-23
    assert (np.abs(got - exact) <= tol).all()
    assert (np.abs(ref - exact) <= tol).all()
    assert (np.abs(got - ref) <= 2 * tol).all()
    assert (np.abs(exact - x) > tol).all()  # the chain did something
    assert torch.equal(ceiling_plain(torch.from_numpy(x), K, kind), torch.from_numpy(got))


@pytest.mark.parametrize("K", [64, 1024])
def test_ceiling_plain_fused_rounds_once_a_step(K):
    """The fused route of the plain fma chain: within ``fma_tolerance`` at
    one rounding a step of the float64 evaluation, equal to a float32 FMA
    chain written out with numpy (exact product and sum in float64, rounded
    once), and a turn short or long is further from it than FUSED_ULPS."""
    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import FUSED_ULPS

    x = _inputs(2, (4, 128))
    fused = ceiling_plain(torch.from_numpy(x), K, "fma", fused=True)
    assert fused.dtype == torch.float32
    exact = ceiling_plain(torch.from_numpy(x).double(), K, "fma")
    assert ((fused.double() - exact).abs() <= fma_tolerance(K, exact.abs())).all()
    c, d = float(np.float32(1.0000001)), float(np.float32(1e-7))
    want = x.copy()
    for _ in range(K):
        want = (want.astype(np.float64) * c + d).astype(np.float32)
    assert np.array_equal(fused.numpy(), want)
    ulp = np.spacing(np.abs(want))
    for other in (K - 8, K + 8):
        off = ceiling_plain(torch.from_numpy(x), other, "fma", fused=True).numpy()
        assert (np.abs(off - want) > FUSED_ULPS * ulp).all()
    with pytest.raises(ValueError, match="fused=True"):
        ceiling_plain(torch.from_numpy(x), K, "transcendental", fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        ceiling_plain(torch.from_numpy(x).double(), K, "fma", fused=True)


def test_fused_row_without_a_model_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="mnle_1m_censor.npz"):
        roofline._fused_row({}, torch.device("cpu"))


def test_simulator_inputs_are_the_roofline_trials():
    theta, pulses, n_max, spp = roofline.simulator_inputs(6, torch.device("cpu"))
    assert theta.shape == (6, 5) and pulses.shape == (6, n_max // spp) and theta.dtype == pulses.dtype == torch.float32
    assert theta[3].tolist() == pytest.approx([0.5, 0.1, 1.0, 30.0, 0.1]) and not torch.equal(pulses[0], pulses[1])
    assert torch.equal(pulses, roofline.simulator_inputs(6, torch.device("cpu"))[1])


def test_ceiling_chain_on_the_cpu_launches_nothing_and_checks_its_arguments():
    x = torch.from_numpy(_inputs(1, (4, 128)))
    before = K4.launches
    assert torch.equal(ceiling_chain(x, 7, "fma"), x)  # 7 // 8 = 0 turns
    assert ceiling_chain(x, 16, "fma").shape == x.shape
    assert K4.launches == before and _cuda.KERNELS["issue_ceiling"] is K4
    with pytest.raises(ValueError, match="unknown kind"):
        ceiling_chain(x, 8, "exp")
    with pytest.raises(ValueError, match="unknown kind"):
        roofline.issue_ceiling("exp", device="cpu")
    # One FMA rounding a step against two: the tolerance grows with K.
    assert fma_tolerance(1024, 1.0) == pytest.approx(1024 * 2.0**-24, rel=2e-4)
    assert fma_tolerance(8, 0.5, roundings=2) == fma_tolerance(8, 1.0) > 8 * 2.0**-24


def test_ceiling_from_times_differences_the_two_chain_lengths():
    n, lo, hi = 2_097_152, 1 << 14, 1 << 17
    # 1 ms of launch cost on both, 10 T ops/s of issue rate: the cost cancels.
    rate = 10e12
    t_lo, t_hi = 1e-3 + n * lo / rate, 1e-3 + n * hi / rate
    assert roofline.ceiling_from_times(n, lo, hi, t_lo, t_hi) == pytest.approx(rate, rel=1e-12)
    assert n * hi / t_hi < rate  # the long chain alone reads low
    # Noise swamped the difference: the long chain's own rate, a lower bound.
    assert roofline.ceiling_from_times(n, lo, hi, 0.03, 0.03) == n * hi / 0.03
    assert roofline.ceiling_from_times(n, lo, hi, 0.04, 0.03) == n * hi / 0.03


def test_issue_ceiling_times_both_chain_lengths(monkeypatch):
    """``issue_ceiling`` on injected times: the short chain first, then the
    long one, at the shape (G, R, 128) of 0.5s, differenced."""
    calls = []

    def fake_median_seconds(fn, reps, device):
        out = fn()
        calls.append((tuple(out.shape), float(out.flatten()[0]), reps))
        return [0.002, 0.010][len(calls) - 1]

    monkeypatch.setattr(roofline, "_median_seconds", fake_median_seconds)
    ops, t_lo, t_hi, n = roofline.issue_ceiling("fma", R=2, G=3, K_lo=8, K_hi=64, reps=3, device="cpu")
    assert (t_lo, t_hi, n) == (0.002, 0.010, 3 * 2 * 128) and ops == pytest.approx(3 * 2 * 128 * (64 - 8) / 0.008)
    assert [c[0] for c in calls] == [(3, 2, 128)] * 2 and [c[2] for c in calls] == [3, 3]
    x = torch.full((1,), 0.5)
    assert calls[0][1] == float(ceiling_plain(x, 8, "fma")) and calls[1][1] == float(ceiling_plain(x, 64, "fma"))


def test_mnle_layer_shapes_counts_every_product():
    from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle
    from sbi_for_diffusion_models_tpu_torch.ops.mnle_cuda import pack_mnle_weights

    cfg = MNLEConfig(condition_dim=9, hidden_features=16, num_transforms=2, num_bins=4, censor_rt=True,
                     cond_affine=True)
    w = pack_mnle_weights(build_mnle(0, cfg, device="cpu"))
    assert roofline.mnle_layer_shapes(w) == [(9, 16), (16, 16), (16, 3), (12, 16), (16, 16), (16, 16), (16, 24)]
    pulse = pack_mnle_weights(build_mnle(0, MNLEConfig(condition_dim=9, hidden_features=16, num_transforms=2,
                                                       num_bins=4, censor_rt=True, rt_rep="pulse"), device="cpu"))
    assert roofline.mnle_layer_shapes(pulse)[-2:] == [(16, 80), (19, 26)]


def test_roofline_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.issue_ceiling("fma")


_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|sbi_for_diffusion_models_tpu)(?:[\s.]|$)", re.M)


def test_no_port_source_imports_jax_or_the_jax_package():
    """No module of the port, and none of the scripts and tests that run it
    on the card (``chip_smoke.py``, ``plant_faults.py``, ``compare_k3.py``,
    the card test files ``tests/test_torch_cuda*.py`` and what they load,
    the K1 fixture ``tests/k1_fixture.py`` and ``tests/card_common.py``), has
    an import of jax, flax, optax or the JAX package."""
    files = sorted((ROOT / "sbi_for_diffusion_models_tpu_torch").rglob("*.py"))
    files += [ROOT / f for f in ("chip_smoke.py", "plant_faults.py", "compare_k3.py", "tests/k1_fixture.py",
                                         "tests/card_common.py")]
    files += sorted((ROOT / "tests").glob("test_torch_cuda*.py"))
    assert len(files) >= 30
    bad = {str(f.relative_to(ROOT)): m.group(0).strip() for f in files if (m := _JAX_IMPORT.search(f.read_text()))}
    assert not bad, bad
    assert _JAX_IMPORT.search("from sbi_for_diffusion_models_tpu.mnle import x") and _JAX_IMPORT.search("import optax")
    assert not _JAX_IMPORT.search("from sbi_for_diffusion_models_tpu_torch.mnle import x")
