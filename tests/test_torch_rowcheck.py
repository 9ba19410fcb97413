"""PyTorch port: the per-row float64 check that holds the fused kernels to
their plain versions (``ops/rowcheck.py``, used by the
kernel tests). On the committed models and rows as the posterior potential
builds them, the plain version in float32 passes it, and faults planted in
the pulse rep's gradient fail it; a float32 knot tie shows why a gradient
is held on the share of rows over their allowance and not on its worst
row."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.nets.spline import _prepare_circular_knots, rq_spline_circular
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference, row_check
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

MODELS = {"pulse": "mnle_1m_pulseabs.npz", "flagship": "mnle_10m_shifted_logt_affine.npz"}


def _rows(est):
    """1,200 rows: 24 prior thetas against every trial of a numpy-made
    50-trial session (a quarter censored at the 8 s window end)."""
    rng = np.random.default_rng(3)
    choice = rng.choice([0.0, 1.0, 2.0], 50, p=[0.4, 0.35, 0.25])
    rt = np.where(choice == 2.0, 8.0, 0.15 + rng.gamma(2.0, 0.4, 50))
    x = torch.as_tensor(np.stack([rt, choice], -1), dtype=torch.float32)
    s = torch.as_tensor(np.where(rng.random((50, 80)) < 0.5, 1.0, -1.0), dtype=torch.float32)
    theta = build_prior_theta().sample(make_generator(4, "cpu"), (24,))
    cond = torch.cat([theta[:, None, :].expand(24, 50, 5), s[None].expand(24, 50, 80)], -1).reshape(-1, 85)
    xr = x[None].expand(24, 50, 2).reshape(-1, 2)
    if est.cfg.rt_rep == "pulse":
        return est.standardize_pulse(xr, cond)[:5]
    return est.standardize(xr, cond)[:3]


def _make_case(name):
    """(float32 weights, rows, cotangent, float64 reference, spread, (forward,
    backward) plain versions) on the committed model ``name``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    try:
        est = tmnle.load_model(MODELS[name], device="cpu")
    finally:
        mp.undo()
    w32 = mc.pack_mnle_weights(est)
    w64 = w32.astype(torch.float64)
    rows = tuple(a.contiguous() for a in _rows(est))
    g = torch.as_tensor(np.random.default_rng(5).normal(size=rows[0].shape[0]), dtype=torch.float32)
    fwd, bwd = (mc.rows_logp_pulse_plain, mc.rows_logp_pulse_vjp_plain) if w32.pulse else (
        mc.rows_logp_plain, mc.rows_logp_vjp_plain)
    ref, spread = reference(lambda *a: (fwd(*a[:-1], w64), *bwd(*a[:-1], w64, a[-1])), rows, g,
                            (2, 3) if w32.pulse else (2,))
    return w32, rows, g, ref, spread, (fwd, bwd)


@pytest.fixture(scope="module")
def pulse_case():
    return _make_case("pulse")


@pytest.fixture(scope="module")
def flagship_case():
    return _make_case("flagship")


def _outputs(case, w=None):
    """The plain version's (value, *grads) in float32, the gradients with
    the weights ``w`` when given."""
    w32, rows, g, _, _, (fwd, bwd) = case
    return (fwd(*rows, w32), *bwd(*rows, w32 if w is None else w, g))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_float32_version_passes_the_row_check(model, request):
    case = request.getfixturevalue(f"{model}_case")
    _, rows, _, ref, spread, _ = case
    out = _outputs(case)
    assert rows[0].shape[0] == 1200
    for i, x in enumerate(out):
        c = row_check(x, x, ref[i], spread[i], value=i == 0)
        assert c.ok and c.share == 0.0 and c.worst <= 1.0, (i, c)


def _no_slot_head_backward(case, out):
    # The slot head's weights zeroed in the backward only: its term no
    # longer reaches d emb, so dctx lacks it (K3p without its slot product).
    w32 = case[0]
    w = dataclasses.replace(w32, slot=(torch.zeros_like(w32.slot[0]), w32.slot[1]), _struct=None, _keep=None)
    return _outputs(case, w)


FAULTS = {
    "zero_dkf": lambda case, out: out[:3] + (torch.zeros_like(out[3]),),
    "no_slot_head_backward": _no_slot_head_backward,
    "gradients_one_percent_off": lambda case, out: out[:1] + tuple(1.01 * x for x in out[1:]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_gradient_faults_fail_the_row_check(pulse_case, fault):
    _, _, _, ref, spread, _ = pulse_case
    out = _outputs(pulse_case)
    bad = FAULTS[fault](pulse_case, out)
    checks = [row_check(b, x, r, s, value=i == 0) for i, (b, x, r, s) in enumerate(zip(bad, out, ref, spread))]
    assert checks[0].ok  # the value is untouched
    failed = [c for c in checks[1:] if not c.ok]
    assert failed
    # The fault shows in the share of rows over their allowance, not only in the worst row.
    assert max(c.share for c in failed) > 0.1


def test_a_float32_knot_tie_halves_the_gradient():
    """Where a phase lands exactly on a spline knot in float32, the bin's xi
    clip passes half the gradient (``jnp.clip``'s rule at a bound), while the
    float64 reference, whose knot lies an ulp away, passes all of it. Here
    the reference's spread reaches across the knot and covers the row; a
    tie deeper in a chain of splines, where the spread does not reach the
    knot, leaves the row over its allowance, which the share of rows
    tolerates and a worst-row limit would not."""
    K = 8
    rng = np.random.default_rng(0)
    params = torch.as_tensor(rng.normal(size=(1000, 3 * K + 1)), dtype=torch.float32)
    phi = torch.as_tensor(rng.random(1000), dtype=torch.float32)
    knots, _, _, rot = _prepare_circular_knots(params[:1], K)
    p = torch.remainder(knots[0, 3] + rot[0], 1.0)
    for _ in range(64):  # walk phi by ulps until (phi - rot) mod 1 is the knot itself
        z = torch.remainder(p - rot[0], 1.0)
        if z == knots[0, 3]:
            break
        p = torch.nextafter(p, torch.tensor(2.0 if z < knots[0, 3] else -1.0))
    assert z == knots[0, 3]
    phi[0] = p

    def grad(phi, params, g):
        x = phi.detach().requires_grad_(True)
        out, log_det = rq_spline_circular(x, params, num_bins=K)
        return (torch.autograd.grad(out + log_det, x, grad_outputs=g)[0],)

    g = torch.ones_like(phi)
    (got,) = grad(phi, params, g)
    ref, spread = reference(grad, (phi, params), g, (1,))
    torch.testing.assert_close(got[0].double(), 0.5 * ref[0][0], rtol=1e-5, atol=0)
    assert row_check(got, got, ref[0], spread[0], value=False).ok
