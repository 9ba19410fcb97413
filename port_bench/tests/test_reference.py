"""The plain reference: its gradient against float64 finite differences of
itself, and its values against the port's plain CPU network in float64."""

import pytest
import torch

from port_bench import generator, run
from port_bench.reference import mnle as ref

MODELS = ["artifacts/models/mnle_10m_shifted_logt_affine.npz", "artifacts/models/mnle_1m_pulseabs.npz"]


def _inputs(n=6, T=12):
    theta, x, s = generator.sessions(11, 1, T, "cpu")
    gen = generator.generator(12, "cpu")
    th = generator.prior_draws(gen, n).double()
    return th, x[0][None].expand(n, T, 2).double(), s[0][None].expand(n, T, 80).double()


@pytest.mark.parametrize("model,tnd_eps,tnd_rtol", [(MODELS[0], 2e-4, 1e-2), (MODELS[1], 1e-6, 1e-4)])
def test_gradient_against_finite_differences(model, tnd_eps, tnd_rtol):
    m = ref.load_npz(run.ROOT / model, torch.float64)
    th, x, s = _inputs()
    ll, g = ref.log_lik_and_grad(m, x, s, th)
    # In the shifted-log model t_nd meets the float32 observation in float32
    # (the onset gap): its difference quotient takes a step far above
    # float32's spacing, and a wider tolerance for the step's curvature.
    for j, eps, rtol in ((0, 1e-8, 1e-5), (1, 1e-8, 1e-5), (2, 1e-8, 1e-5), (3, 1e-8, 1e-5), (4, tnd_eps, tnd_rtol)):
        step = torch.zeros_like(th)
        step[:, j] = eps * th[:, j].abs().clamp(min=1e-3)
        fd = (ref.log_lik(m, x, s, th + step) - ref.log_lik(m, x, s, th - step)) / (2 * step[:, j])
        assert torch.allclose(g[:, j], fd, rtol=rtol, atol=rtol * 0.1 * g.abs().max().item())


@pytest.mark.parametrize("model", MODELS)
def test_values_against_the_port_in_float64(model):
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model

    est = load_model(str(run.ROOT / model), device="cpu")
    est.net.double()
    for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
        setattr(est, name, getattr(est, name).double())
    m = ref.load_npz(run.ROOT / model, torch.float64)
    th, x, s = _inputs()
    n, T = x.shape[:2]
    cond = torch.cat([th[:, None].expand(n, T, 5), s], -1).reshape(n * T, -1)
    want = est.log_prob_fn(est.net, x.reshape(n * T, 2), cond).reshape(n, T).sum(-1)
    # The reference takes the pulse grid's slot and phase in the
    # observation's float32, the port here in float64: a few 1e-7 of a row.
    assert torch.allclose(ref.log_lik(m, x, s, th), want, rtol=1e-6, atol=1e-3)
