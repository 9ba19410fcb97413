"""PyTorch port: rational-quadratic splines against ``nets/spline.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu.nets import spline as js
from sbi_for_diffusion_models_tpu_torch.nets import spline as ts

K = 8
B = 5.0
# Knots are cumulative sums of softmax widths; the two frameworks sum in
# another order, which moves a knot by ~1e-6 and, inside a narrow bin, the
# relative position xi by up to ~1e-4. Values near zero and log-dets then
# differ by a few 1e-6 in absolute terms, hence the absolute tolerance.
RTOL, ATOL = 1e-5, 1e-5


def _inputs(seed, n=400, scale=1.0):
    rng = np.random.default_rng(seed)
    params = (scale * rng.normal(size=(n, 3 * K - 1))).astype(np.float32)
    x = rng.uniform(-6.5, 6.5, n).astype(np.float32)  # both tails included
    x[:3] = [-B, B, 0.0]
    return x, params


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rq_spline_matches_jax(inverse, seed):
    x, params = _inputs(seed)
    jf = js.rq_spline_inverse if inverse else js.rq_spline_forward
    tf = ts.rq_spline_inverse if inverse else ts.rq_spline_forward
    ry, rld = jf(jnp.asarray(x), jnp.asarray(params), num_bins=K, tail_bound=B)
    y, ld = tf(torch.from_numpy(x), torch.from_numpy(params), num_bins=K, tail_bound=B)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(rld), rtol=RTOL, atol=ATOL)
    tail = np.abs(x) > B
    np.testing.assert_array_equal(y.numpy()[tail], x[tail])
    np.testing.assert_array_equal(ld.numpy()[tail], 0.0)


def test_knots_and_bin_rule_match_jax():
    _, params = _inputs(3, n=64)
    for a, b in zip(ts._prepare_knots(torch.from_numpy(params), K, B), js._prepare_knots(jnp.asarray(params), K, B)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    xk = ts._prepare_knots(torch.from_numpy(params), K, B)[0]
    # A point on knot j+1 falls in bin j+1; the top edge in bin K-1.
    z = torch.stack([xk[:, 3], xk[:, -1], xk[:, 0]], -1)
    idx = ts._searchsorted(xk[:, None, :].expand(-1, 3, -1), z)
    ref = np.asarray(js._searchsorted(jnp.asarray(xk.numpy())[:, None, :].repeat(3, 1), jnp.asarray(z.numpy())))
    np.testing.assert_array_equal(idx.numpy(), ref)
    assert (idx[:, 0] == 3).all() and (idx[:, 1] == K - 1).all() and (idx[:, 2] == 0).all()


def test_inverse_undoes_forward():
    x, params = _inputs(4)
    xt, pt = torch.from_numpy(x), torch.from_numpy(params)
    y, ld = ts.rq_spline_forward(xt, pt, num_bins=K, tail_bound=B)
    x2, ld_inv = ts.rq_spline_inverse(y, pt, num_bins=K, tail_bound=B)
    np.testing.assert_allclose(x2.numpy(), x, atol=2e-4)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=2e-3)


# ---------------------------------------------------------------------------
# Circular RQ spline (the pulse-grid phase flow)
# ---------------------------------------------------------------------------
# Values to 2e-5 and gradients to 1e-4 relative L-infinity: the knots are the
# same cumulative sums taken in another order (a 1-ulp knot moves a value in
# a narrow bin by a few 1e-6).
CIRC_TOL, CIRC_GRAD_TOL = 2e-5, 1e-4


def _circ_params(seed, n):
    return (np.random.default_rng(seed).normal(size=(n, 3 * K + 1))).astype(np.float32)


def _f32_phase(phi, rot):
    """(phi - rot) mod 1 in float32, as both frameworks compute it."""
    a = np.float32(np.float32(phi) - np.float32(rot))
    return np.float32(a - np.floor(a))


def _pinned_rows(params):
    """Phases on the wrap point and on knots: rows whose rotation and knots
    are the same float32 numbers in both frameworks, with phi chosen so that
    (phi - rot) mod 1 lands exactly on the wrap (0), just below it (rounds
    to 1 and is clipped at 1 - 1e-6), just above it, or on an inner knot."""
    rot_t = torch.sigmoid(torch.from_numpy(params[:, 3 * K])).numpy()
    rot_j = np.asarray(jax.nn.sigmoid(jnp.asarray(params[:, 3 * K])))
    xk_j = np.asarray(js._prepare_circular_knots(jnp.asarray(params), K)[0])
    xk_t = ts._prepare_circular_knots(torch.from_numpy(params), K)[0].numpy()
    rows, phis, kinds = [], [], []
    for i in range(params.shape[0]):
        if rot_j[i] != rot_t[i]:
            continue
        rot = rot_t[i]
        for kind, phi in (("wrap", rot), ("below", np.nextafter(rot, np.float32(0))),
                          ("above", np.nextafter(rot, np.float32(1)))):
            rows.append(i), phis.append(np.float32(phi)), kinds.append(kind)
        for j in range(1, K):
            if xk_j[i, j] != xk_t[i, j]:
                continue
            phi = np.float32(xk_t[i, j] + rot)
            phi = np.float32(phi - 1) if phi >= 1 else phi
            for _ in range(8):  # step by ulps until the phase lands on the knot
                z = _f32_phase(phi, rot)
                if z == xk_t[i, j]:
                    rows.append(i), phis.append(phi), kinds.append(f"knot{j}")
                    break
                phi = np.nextafter(phi, np.float32(1) if z < xk_t[i, j] else np.float32(0))
    return np.asarray(rows), np.asarray(phis, np.float32), kinds


def _circ_err(a, b):
    """Per-row error of (phase, log-det) pairs: phases on the circle (0 and
    1 are one point), log-dets relative to max(1, |b|)."""
    d = np.abs(np.asarray(a[0], np.float64) - np.asarray(b[0], np.float64))
    dl = np.abs(np.asarray(a[1], np.float64) - b[1]) / np.maximum(1.0, np.abs(b[1]))
    return np.minimum(d, 1.0 - d), dl


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_circular_spline_matches_jax(inverse):
    """In float64 the port and JAX compute the same function (1e-9). In
    float32 the port is held to 2e-5 against the float64 reference, or where
    float32 cannot reach that (a knot moved by one ulp inside a narrow bin),
    to twice the JAX float32 error on the same rows."""
    params = _circ_params(5, 400)
    phi = np.random.default_rng(6).uniform(0, 1, 400).astype(np.float32)
    phi[:3] = [0.0, 1.0 - 1e-6, 0.5]
    kw = dict(num_bins=K, inverse=inverse)
    with jax.enable_x64(True):
        ref = [np.asarray(v) for v in js.rq_spline_circular(jnp.asarray(phi, jnp.float64),
                                                            jnp.asarray(params, jnp.float64), **kw)]
    t64 = ts.rq_spline_circular(torch.from_numpy(phi).double(), torch.from_numpy(params).double(), **kw)
    for e in _circ_err([v.numpy() for v in t64], ref):
        assert e.max() <= 1e-9
    j32 = js.rq_spline_circular(jnp.asarray(phi), jnp.asarray(params), **kw)
    y, ld = ts.rq_spline_circular(torch.from_numpy(phi), torch.from_numpy(params), **kw)
    for e_t, e_j in zip(_circ_err((y.numpy(), ld.numpy()), ref), _circ_err(j32, ref)):
        assert e_t.max() <= max(CIRC_TOL, 2 * e_j.max()), (e_t.max(), e_j.max())
    assert bool(((y >= 0) & (y < 1)).all()) if inverse else bool(((y >= 0) & (y <= 1)).all())


def test_circular_spline_value_and_gradient_match_jax_at_wrap_and_knots():
    """Value and gradient (w.r.t. the phase and the raw parameters) on random
    phases and on rows pinned at the wrap point and on knots, where the clips
    of the phase and of the bin position take JAX's gradient rule (half at a
    bound, none beyond it)."""
    params = _circ_params(7, 64)
    rows, pinned, kinds = _pinned_rows(params)
    assert {"wrap", "below", "above"} <= set(kinds) and any(k.startswith("knot") for k in kinds)
    rng = np.random.default_rng(8)
    phi = np.concatenate([rng.uniform(0, 1, 64).astype(np.float32), pinned])
    p = np.concatenate([params, params[rows]])
    gy, gl = rng.normal(size=(2, phi.shape[0])).astype(np.float32)

    def jfn(a, b):
        out, ld = js.rq_spline_circular(a, b, num_bins=K)
        return jnp.sum(out * gy + ld * gl), (out, ld)

    (_, (ry, rld)), (rg_phi, rg_p) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(phi), jnp.asarray(p))
    tphi, tp = torch.from_numpy(phi).requires_grad_(True), torch.from_numpy(p).requires_grad_(True)
    y, ld = ts.rq_spline_circular(tphi, tp, num_bins=K)
    (y * torch.from_numpy(gy) + ld * torch.from_numpy(gl)).sum().backward()
    d = np.abs(y.detach().numpy() - np.asarray(ry))
    assert np.minimum(d, 1.0 - d).max() <= CIRC_TOL
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(rld), rtol=CIRC_TOL, atol=CIRC_TOL)
    for got, want, what in ((tphi.grad.numpy(), np.asarray(rg_phi), "dphi"), (tp.grad.numpy(), np.asarray(rg_p), "dparams")):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= CIRC_GRAD_TOL, f"{what}: relative L-inf {err:.3e}"
    # Just below the wrap the phase is clipped at 1 - 1e-6: no gradient to phi.
    below = 64 + np.flatnonzero(np.asarray(kinds) == "below")
    np.testing.assert_array_equal(tphi.grad.numpy()[below], 0.0)


def test_circular_knots_wrap_shared_derivative_and_inverse():
    params = _circ_params(9, 32)
    xk, yk, d, rot = ts._prepare_circular_knots(torch.from_numpy(params), K)
    for a, b in zip((xk, yk, d, rot), js._prepare_circular_knots(jnp.asarray(params), K)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert (xk[:, 0] == 0).all() and (xk[:, -1] == 1).all() and (yk[:, -1] == 1).all()
    torch.testing.assert_close(d[:, -1], d[:, 0], rtol=0, atol=0)  # d_K = d_0
    phi = torch.from_numpy(np.random.default_rng(10).uniform(0, 1, 32).astype(np.float32))
    y, ld = ts.rq_spline_circular(phi, torch.from_numpy(params), num_bins=K)
    back, ld_inv = ts.rq_spline_circular(y, torch.from_numpy(params), num_bins=K, inverse=True)
    d_back = (back - phi).abs()
    assert float(torch.minimum(d_back, 1 - d_back).max()) < 2e-4
    assert float((ld + ld_inv).abs().max()) < 2e-3
