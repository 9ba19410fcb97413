"""PyTorch port: rational-quadratic splines against ``nets/spline.py``."""

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
