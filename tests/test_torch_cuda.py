"""PyTorch port: the CUDA kernels K1, K2, K3, K2p, K3p and K4 against their
plain versions on the card. Without a CUDA device (or without nvcc to build the kernels)
every test here is skipped; ``chip_smoke.py`` runs the same checks at the
main path's full sizes.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, mnle_from_flax_params
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import FUSED_ULPS, K4, ceiling_chain, ceiling_plain, fma_tolerance
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import K1, ddm_rt_choice_cuda
from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference, row_check
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

pytestmark = pytest.mark.requires_cuda

DEV = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _needs_card():
    """Skip unless there is a CUDA device and nvcc (decided per test, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    if not (Path("/usr/local/cuda/bin/nvcc").exists() or shutil.which("nvcc")):
        pytest.skip("needs nvcc: the kernels are built from source at first use")


KW = dict(dt=5e-4, t_max=0.8, steps_per_pulse=200, n_max=1600)


def _theta_and_pulses(n, seed=0):
    gen = make_generator(seed, DEV)
    theta = build_prior_theta().sample(gen, (n,))
    theta[:, 4] = theta[:, 4] * 0.3  # onsets inside the 0.8 s window
    s = torch.where(torch.rand((n, 8), generator=gen, device=DEV) < 0.5, 1.0, -1.0)
    return theta.contiguous(), s.contiguous()


def test_k1_equals_its_plain_version_without_noise_and_counts_launches():
    theta, s = _theta_and_pulses(8192)
    before = K1.launches
    got = ddm_rt_choice_cuda(theta, s, 1, mu_sensory=0.0, **KW)
    ref = ddm_rt_choice_scan(theta, s, 2, mu_sensory=0.0, chunk_steps=200, **KW)
    assert K1.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_k1_is_deterministic_per_seed_and_differs_across_seeds():
    theta, s = _theta_and_pulses(4096, seed=1)
    a = ddm_rt_choice_cuda(theta, s, 5, **KW)
    b = ddm_rt_choice_cuda(theta, s, 5, **KW)
    c = ddm_rt_choice_cuda(theta, s, 6, **KW)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert set(a[:, 1].unique().tolist()) <= {0.0, 1.0, 2.0}


def _small_estimator(**kw):
    cfg = MNLEConfig(condition_dim=9, hidden_features=32, num_transforms=4, num_bins=8, **kw)
    rng = np.random.default_rng(0)
    H, C, D = cfg.hidden_features, cfg.num_categories, cfg.condition_dim
    S = 3 * cfg.num_bins + 1 if cfg.circular else 3 * cfg.num_bins - 1

    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    L = cfg.trunk_depth
    tree = {
        "cat_net": {f"Dense_{i}": dense(*io) for i, io in enumerate([(D, H)] + [(H, H)] * (L - 1) + [(H, C)])},
        "flow_trunk": {f"Dense_{i}": dense(*io) for i, io in enumerate([(D + C, H)] + [(H, H)] * (L - 1) + [(H, H)])},
    }
    for i in range(cfg.num_transforms):
        tree[f"spline_head_{i}"] = dense(H + cfg.num_slot_features, S)
    if cfg.cond_affine:
        tree["affine_head"] = dense(H, 2)
    if cfg.rt_rep == "pulse":
        tree["pulse_slot_head"] = dense(H, cfg.num_pulse_slots)
    return mnle_from_flax_params(cfg, tree, np.zeros(D), np.ones(D), 0.0, 1.0)  # default: the card


@pytest.mark.parametrize("variant", [{}, dict(censor_rt=True, cond_affine=True)], ids=["log", "censor_affine"])
def test_k2_k3_match_their_plain_versions(variant):
    est = _small_estimator(**variant)
    w = mc.pack_mnle_weights(est)
    gen = torch.Generator(DEV).manual_seed(0)
    n = 1000  # not a multiple of the 16-row tile
    t = 2.0 * torch.randn((n,), generator=gen, device=DEV)
    ctx = torch.randn((n, 9), generator=gen, device=DEV)
    oh = torch.nn.functional.one_hot(torch.randint(0, 3, (n,), generator=gen, device=DEV), 3).float()
    g = torch.randn((n,), generator=gen, device=DEV)
    # Reference: the plain version in float64 on the same float32 inputs and
    # weights (two float32 evaluations differ by their own rounding).
    w64 = w.astype(torch.float64)
    args64 = (t.double(), oh.double(), ctx.double(), w64)
    val = mc.rows_logp(t, oh, ctx, w).double()
    ref = mc.rows_logp_plain(*args64)
    assert float(((val - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 1e-4
    dt, dctx = mc.rows_logp_vjp(t, oh, ctx, w, g)
    dt_ref, dctx_ref = mc.rows_logp_vjp_plain(*args64, g.double())
    for got, want in ((dt, dt_ref), (dctx, dctx_ref)):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-3


def test_wrappers_reject_wrong_dtypes():
    est = _small_estimator()
    w = mc.pack_mnle_weights(est)
    t = torch.zeros((4,), device=DEV, dtype=torch.float64)
    with pytest.raises(ValueError):
        mc.rows_logp(t, torch.zeros((4, 3), device=DEV), torch.zeros((4, 9), device=DEV), w)


def test_k2p_k3p_match_their_plain_versions():
    """K2p/K3p on a small pulse-grid model (1,000 rows, not a multiple of the
    16-row tile; censored rows, phases at the clip edges and one slot index
    past the last slot) against the plain version in float64 on the same
    float32 inputs and weights."""
    est = _small_estimator(rt_rep="pulse", censor_rt=True)
    assert est.device.type == "cuda"
    w = mc.pack_mnle_weights(est)
    gen = torch.Generator(DEV).manual_seed(1)
    n = 1000
    phi = torch.rand((n,), generator=gen, device=DEV)
    phi[:2] = torch.tensor([1e-6, 1.0 - 1e-6], device=DEV)
    ctx = torch.randn((n, 9), generator=gen, device=DEV)
    oh = torch.nn.functional.one_hot(torch.randint(0, 3, (n,), generator=gen, device=DEV), 3).float()
    k = torch.randint(0, 80, (n,), generator=gen, device=DEV)
    k[2] = 80
    ang = 2 * np.pi * torch.rand((n,), generator=gen, device=DEV)
    kf = torch.stack([(k + 0.5) / 80, torch.sin(ang), torch.cos(ang)], -1).contiguous()
    kv = k.float()
    g = torch.randn((n,), generator=gen, device=DEV)
    rows64 = [a.double() for a in (phi, oh, ctx, kf, kv)]
    w64 = w.astype(torch.float64)
    before = (mc.K2P.launches, mc.K3P.launches)
    val = mc.rows_logp_pulse(phi, oh, ctx, kf, kv, w).double()
    ref = mc.rows_logp_pulse_plain(*rows64, w64)
    assert float(((val - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 1e-4
    grads = mc.rows_logp_pulse_vjp(phi, oh, ctx, kf, kv, w, g)
    # Gradients row by row: each to 1e-3 x max(1, the row's largest |ref|),
    # with the row's float32 spread added where it exceeds that, on all but
    # 0.1 % of the rows (ops/rowcheck.py, as chip_smoke.py holds K3p), and
    # on each of the rows at the clip edges and past the last slot.
    rows = (phi, oh, ctx, kf, kv)
    refs, spreads = reference(lambda *a: mc.rows_logp_pulse_vjp_plain(*a[:-1], w64, a[-1]), rows, g, (2, 3))
    plains = mc.rows_logp_pulse_vjp_plain(*rows, w, g)
    for got, plain, want, spread in zip(grads, plains, refs, spreads):
        c = row_check(got, plain, want, spread, value=False)
        assert c.ok and not bool(c.over[:3].any()), c
    assert (mc.K2P.launches, mc.K3P.launches) == (before[0] + 1, before[1] + 1)
    # Autograd through the fused Function launches the same pair.
    phi_ = phi.clone().requires_grad_(True)
    out = mc.FusedPulseRowsLogProb.apply(phi_, oh, ctx, kf, kv, w)
    (dphi,) = torch.autograd.grad(out, phi_, grad_outputs=g)
    torch.testing.assert_close(dphi, grads[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["fma", "transcendental"])
def test_k4_matches_its_plain_version_in_float64(kind):
    """K4 at K = 1,024 on 12,345 values (not a multiple of the 256-thread
    block) against the plain version in float64: the fma chain within one
    rounding a step (``fma_tolerance``), the transcendental chain within 8
    float32 ulps of the value (it contracts towards a fixed point, so only
    the last turn's special functions count), and against the plain float32
    version within the two tolerances added."""
    K = 1024
    x = torch.rand((12345,), generator=torch.Generator(DEV).manual_seed(3), device=DEV) * 0.75 + 0.25
    before = K4.launches
    got = ceiling_chain(x, K, kind)
    assert K4.launches == before + 1 and got.shape == x.shape and got.dtype == torch.float32
    exact = ceiling_plain(x.double(), K, kind)
    plain = ceiling_plain(x, K, kind)
    if kind == "fma":
        tol, plain_tol = fma_tolerance(K, exact.abs()), fma_tolerance(K, exact.abs(), roundings=2)
        assert bool(((exact - x).abs() > tol).all())  # the chain moved every value by more than that
        # One rounding a step, as the plain chain's fused route rounds: a turn short or long is ~17 ulps away.
        fused = ceiling_plain(x, K, kind, fused=True)
        assert bool(((got - fused).abs() <= FUSED_ULPS * 2.0**-24).all())
    else:
        tol = plain_tol = torch.full_like(exact, 8 * 2.0**-23)
    assert bool(((got.double() - exact).abs() <= tol).all())
    assert bool(((got.double() - plain.double()).abs() <= tol + plain_tol).all())
    assert torch.equal(ceiling_chain(x, 7, kind), x)  # no turn: a copy
