"""PyTorch port: the MNLE network, its weight converter, ``load_model`` and
the plain versions of kernels K2/K3 and K2p/K3p, against the JAX package.

The CUDA kernels themselves cannot run here; ``tests/test_torch_cuda.py``
holds them to these plain versions on the card. On CPU tensors the fused path
(``dispatch_log_prob("pallas")``) runs its ``autograd.Function`` with the
plain row function, so its plumbing is tested here too.
"""

import functools
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import mnle as jmnle
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig as JConfig
from sbi_for_diffusion_models_tpu.nets.mnle_net import build_mnle
from sbi_for_diffusion_models_tpu.ops import mnle_pallas as jpallas
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, mnle_from_flax_params
from sbi_for_diffusion_models_tpu_torch.ops import _cuda
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as tk
from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference

SMALL = dict(hidden_features=32, num_transforms=4, num_bins=8)
VARIANTS = {
    "log": {},
    "shifted_log_censor": dict(rt_rep="shifted_log", censor_rt=True),
    "cond_affine": dict(censor_rt=True, cond_affine=True),
    "log_theta_dims": dict(rt_rep="shifted_log", censor_rt=True, log_condition_dims=(1, 2, 3), cond_affine=True,
                           trunk_depth=3),
    "pulse_abs": dict(rt_rep="pulse", censor_rt=True),
    "pulse_tnd": dict(rt_rep="pulse", censor_rt=True, grid_anchor="tnd"),
}
FLAGSHIP = "mnle_10m_shifted_logt_affine.npz"
PULSE_MODEL = "mnle_1m_pulseabs.npz"


@functools.lru_cache(maxsize=None)
def _jax_est_cached(variant):
    return _jax_est(**VARIANTS[variant])


def _jax_est(cd=9, **kw):
    cfg = JConfig(condition_dim=cd, num_categories=3, **SMALL, **kw)
    est = build_mnle(jax.random.key(0), cfg)
    return est.__class__(
        cfg=cfg, params=est.params,
        cond_mean=0.1 * jnp.arange(cd, dtype=jnp.float32), cond_std=jnp.linspace(0.5, 2.0, cd),
        x_mean=jnp.float32(0.3), x_std=jnp.float32(1.7), train_meta=None,
    )


def _port(jest):
    tree = jax.tree.map(np.asarray, jest.params)
    cfg = MNLEConfig(**jest.cfg.__dict__)
    return mnle_from_flax_params(cfg, tree, jest.cond_mean, jest.cond_std, jest.x_mean, jest.x_std, device="cpu")


def _data(seed, n, cd):
    rng = np.random.default_rng(seed)
    rt = np.exp(0.5 * rng.normal(size=n)) + 0.3
    choice = rng.integers(0, 3, n)
    x = np.stack([rt, choice], -1).astype(np.float32)
    cond = (0.7 * rng.normal(size=(n, cd)) + 0.2).astype(np.float32)
    cond[:, 1:4] = np.abs(cond[:, 1:4]) + 0.05  # positive where log-transformed
    cond[:, 4] = rng.uniform(0.0, 0.3, n)  # t_nd below most rts
    return x, cond


def _assert_rel_linf(a, b, tol, what=""):
    """Relative L-infinity error max|a - b| / max|b| <= tol."""
    err = float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(float(np.max(np.abs(b))), 1e-30))
    assert err <= tol, f"{what}: relative L-inf error {err:.3e} > {tol:g}"


def _value_and_cond_grad_torch(fn, x, cond):
    c = torch.from_numpy(cond).requires_grad_(True)
    lp = fn(torch.from_numpy(x), c)
    (g,) = torch.autograd.grad(lp.sum(), c)
    return lp.detach().numpy(), g.numpy()


def _value_and_cond_grad_jax(fn, x, cond):
    xs = jnp.asarray(x)
    val, g = jax.jit(jax.vmap(jax.value_and_grad(lambda c, a: fn(a[None], c[None])[0]), (0, 0)))(jnp.asarray(cond), xs)
    return np.asarray(val), np.asarray(g)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_small_model_log_prob_and_condition_grad_match_jax(variant):
    jest = _jax_est_cached(variant)
    est = _port(jest)
    x, cond = _data(1, 37, 9)
    ref_v, ref_g = _value_and_cond_grad_jax(lambda a, c: jest.log_prob_fn(jest.params, a, c), x, cond)
    # The pulse rep's tnd anchor has no fused path (as in the JAX package):
    # "auto" gives the plain function and "pallas" raises.
    kernels = ("xla", "auto") if variant == "pulse_tnd" else ("xla", "pallas")
    for kernel in kernels:  # plain path; fused autograd.Function on CPU rows
        fn = est.dispatch_log_prob(kernel)
        v, g = _value_and_cond_grad_torch(fn, x, cond)
        np.testing.assert_allclose(v, ref_v, rtol=2e-5, atol=2e-5, err_msg=kernel)
        _assert_rel_linf(g, ref_g, 1e-4, kernel)
    if variant == "pulse_tnd":
        with pytest.raises(ValueError, match="grid_anchor='absolute'"):
            est.dispatch_log_prob("pallas")


def test_weight_converter_keeps_torch_layout_and_checks_shapes():
    jest = _jax_est_cached("cond_affine")
    est = _port(jest)
    k = np.asarray(jest.params["flow_trunk"]["Dense_0"]["kernel"])
    w = est.net.flow_trunk.layers[0].weight.detach().numpy()
    assert w.shape == (k.shape[1], k.shape[0]) and np.array_equal(w, k.T)
    # pack_mnle_weights agrees with the JAX pack, matrix for matrix.
    jw = jpallas.pack_mnle_weights(jest)
    tw = tk.pack_mnle_weights(est).as_list()
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).reshape(b.shape))
    tree = jax.tree.map(np.asarray, jest.params)
    tree["spline_head_0"]["kernel"] = tree["spline_head_0"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="kernel shape"):
        mnle_from_flax_params(est.cfg, tree, jest.cond_mean, jest.cond_std, 0.0, 1.0, device="cpu")


@pytest.mark.parametrize("variant", ["log", "cond_affine"])
def test_row_function_and_vjp_match_jax(variant):
    """Plain versions of K2 and K3 against the JAX row function ``_rows_logp``
    and ``jax.vjp`` of it, on the same packed weights (no pallas_call)."""
    jest = _jax_est_cached(variant)
    est = _port(jest)
    cfg = jest.cfg
    rng = np.random.default_rng(2)
    n = 53
    t = rng.normal(0, 1.5, n).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    ctx = rng.normal(size=(n, 9)).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    kw = dict(n_layers=cfg.trunk_depth + 1, num_transforms=cfg.num_transforms, num_bins=cfg.num_bins,
              tail_bound=cfg.tail_bound, censored_col=cfg.censored_category if cfg.censor_rt else None,
              cond_affine=cfg.cond_affine)
    jw = jpallas.pack_mnle_weights(jest)

    @jax.jit
    def jrows_vjp(tt, cc, gg):
        out, vjp = jax.vjp(lambda a, b: jpallas._rows_logp(a, jnp.asarray(oh), b, jw, **kw), tt, cc)
        return (out,) + vjp(gg)

    ref, ref_dt, ref_dc = jrows_vjp(jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(g))
    w = tk.pack_mnle_weights(est)
    tt, to, tc = torch.from_numpy(t), torch.from_numpy(oh), torch.from_numpy(ctx)
    np.testing.assert_allclose(tk.rows_logp_plain(tt, to, tc, w).numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    dt, dc = tk.rows_logp_vjp_plain(tt, to, tc, w, torch.from_numpy(g))
    _assert_rel_linf(dt.numpy(), np.asarray(ref_dt), 1e-4, "dt")
    _assert_rel_linf(dc.numpy(), np.asarray(ref_dc), 1e-4, "dctx")
    # The wrappers take the plain versions for CPU tensors, without a launch.
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    assert torch.equal(tk.rows_logp(tt, to, tc, w), tk.rows_logp_plain(tt, to, tc, w))
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before


def test_pulse_row_function_and_vjp_match_jax():
    """Plain versions of K2p and K3p against the JAX row function
    ``_rows_logp_pulse`` and ``jax.vjp`` of it (w.r.t. phi, ctx and kf), on
    the same packed weights (no pallas_call). Rows include censored ones,
    phases at the clip edges and a slot index past the last slot."""
    jest = _jax_est_cached("pulse_abs")
    est = _port(jest)
    cfg = jest.cfg
    jw = jpallas.pack_mnle_weights(jest)
    w = tk.pack_mnle_weights(est)
    assert w.pulse and w.num_features == 3
    tw = w.as_list()  # cat, trunk, slot head, heads: the JAX order
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).reshape(b.shape))
    rng = np.random.default_rng(4)
    n = 61
    phi = rng.uniform(0, 1, n).astype(np.float32)
    phi[:2] = [1e-6, 1.0 - 1e-6]
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    ctx = rng.normal(size=(n, 9)).astype(np.float32)
    k = rng.integers(0, cfg.num_pulse_slots, n)
    k[2] = cfg.num_pulse_slots  # outside the slots: no slot term
    ang = 2 * np.pi * rng.uniform(0, 1, n)
    kf = np.stack([(k + 0.5) / cfg.num_pulse_slots, np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    kv = k.astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    kw = dict(n_layers=cfg.trunk_depth + 1, num_transforms=cfg.num_transforms, num_bins=cfg.num_bins,
              num_slots=cfg.num_pulse_slots, censored_col=cfg.censored_category)

    @jax.jit
    def jrows_vjp(pp, cc, ff, gg):
        f = lambda a, b, c: jpallas._rows_logp_pulse(a, jnp.asarray(oh), b, c, jnp.asarray(kv), jw, **kw)  # noqa: E731
        out, vjp = jax.vjp(f, pp, cc, ff)
        return (out,) + vjp(gg)

    ref = [np.asarray(a) for a in jrows_vjp(*map(jnp.asarray, (phi, ctx, kf, g)))]
    rows = [torch.from_numpy(a) for a in (phi, oh, ctx, kf, kv)]
    np.testing.assert_allclose(tk.rows_logp_pulse_plain(*rows, w).numpy(), ref[0], rtol=2e-5, atol=2e-5)
    grads = tk.rows_logp_pulse_vjp_plain(*rows, w, torch.from_numpy(g))
    for got, want, what in zip(grads, ref[1:], ("dphi", "dctx", "dkf")):
        _assert_rel_linf(got.numpy(), want, 1e-4, what)
    # The wrappers take the plain versions for CPU tensors, without a launch.
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    assert torch.equal(tk.rows_logp_pulse(*rows, w), tk.rows_logp_pulse_plain(*rows, w))
    for a, b in zip(tk.rows_logp_pulse_vjp(*rows, w, torch.from_numpy(g)), grads):
        assert torch.equal(a, b)
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    assert {"mnle_pulse_fwd", "mnle_pulse_bwd"} <= set(_cuda.KERNELS)


def test_censored_rows_keep_only_the_choice_term():
    jest = _jax_est_cached("cond_affine")
    est = _port(jest)
    x, cond = _data(3, 12, 9)
    x[:, 1] = 2.0
    x[:6, 0] = 0.0  # rt below t_nd: a flow term that would be non-finite
    lp = est.log_prob(torch.from_numpy(x), torch.from_numpy(cond))
    fused = est.dispatch_log_prob("pallas")(torch.from_numpy(x), torch.from_numpy(cond)).detach()
    ref = np.asarray(jax.jit(jest.log_prob_fn)(jest.params, jnp.asarray(x), jnp.asarray(cond)))
    assert torch.isfinite(lp).all() and torch.isfinite(fused).all()
    np.testing.assert_allclose(lp.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(fused.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_unported_options_raise():
    """Every option of the config is ported: invalid ones still raise, so
    does a tail-sharp threshold that training has not resolved, and a tree
    whose widths are not the config's context (the embedding widens it)."""
    with pytest.raises(ValueError, match="requires censor_rt=True"):
        mnle_from_flax_params(MNLEConfig(rt_rep="pulse"), {}, 0.0, 1.0, 0.0, 1.0, device="cpu")
    with pytest.raises(ValueError, match="training-time sentinel"):
        mnle_from_flax_params(MNLEConfig(tail_sharp_k=2.0, tail_sharp_c=None), {}, 0.0, 1.0, 0.0, 1.0, device="cpu")
    jest = _jax_est_cached("log")
    tree = jax.tree.map(np.asarray, jest.params)
    embedded = MNLEConfig(**{**jest.cfg.__dict__, "pulse_dim": 4, "embed_dim": 8})
    with pytest.raises(ValueError, match="kernel shape"):
        mnle_from_flax_params(embedded, tree, 0.0, 1.0, 0.0, 1.0, device="cpu")
    est = _port(jest)
    assert est.sample(0, torch.zeros((5, 9))).shape == (5, 2)
    with pytest.raises(ValueError, match="unknown log-prob kernel"):
        est.dispatch_log_prob("triton")


@functools.lru_cache(maxsize=None)
def _ragged_rows_and_jax_vjp(n_max=1201):
    """n_max rows of the "cond_affine" estimator (censored and affine) with
    a cotangent, and the JAX row function ``_rows_logp`` on them: its value
    and ``jax.vjp``'s dt and dctx; rows are independent, so the first n
    rows' results are its first n."""
    jest = _jax_est_cached("cond_affine")
    cfg = jest.cfg
    rng = np.random.default_rng(6)
    t = rng.normal(0, 1.5, n_max).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_max)]
    ctx = rng.normal(size=(n_max, 9)).astype(np.float32)
    g = rng.normal(size=n_max).astype(np.float32)
    kw = dict(n_layers=cfg.trunk_depth + 1, num_transforms=cfg.num_transforms, num_bins=cfg.num_bins,
              tail_bound=cfg.tail_bound, censored_col=cfg.censored_category, cond_affine=True)
    jw = jpallas.pack_mnle_weights(jest)
    val, vjp = jax.vjp(lambda a, b: jpallas._rows_logp(a, jnp.asarray(oh), b, jw, **kw), jnp.asarray(t),
                       jnp.asarray(ctx))
    return (t, oh, ctx, g) + tuple(np.asarray(a) for a in vjp(jnp.asarray(g))) + (np.asarray(val),)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 1199, 1201])
def test_k3_wrapper_matches_jax_at_ragged_row_counts(n):
    """K3's wrapper on CPU rows at counts on either side of its 8-row tiles
    (and K2's 16-row tiles): it takes the plain version without a launch,
    and that matches ``jax.vjp`` of the JAX row function ``_rows_logp`` on
    the same packed weights, censored and affine rows included."""
    t, oh, ctx, g, ref_dt, ref_dc, _ = (a[:n] for a in _ragged_rows_and_jax_vjp())
    w = tk.pack_mnle_weights(_port(_jax_est_cached("cond_affine")))
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    dt, dc = tk.rows_logp_vjp(*map(torch.from_numpy, (t, oh, ctx)), w, torch.from_numpy(g))
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    assert dt.shape == (n,) and dc.shape == (n, 9)
    # To 1e-4 of max(1, largest |ref|), the scale rule of ops/rowcheck.py: a
    # lone row's small dt can be a cancellation that no float32 version
    # holds to its own size (row 0's 0.0025 is 1e-3 off float64 in both).
    for got, want, what in ((dt, ref_dt, "dt"), (dc, ref_dc, "dctx")):
        err = float(np.abs(got.numpy().astype(np.float64) - want).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), f"{what}: max abs error {err:.3e}"


@functools.lru_cache(maxsize=None)
def _ragged_pulse_rows_and_jax_vjp(n_max=1201):
    """n_max rows of the "pulse_abs" estimator with a cotangent, and the
    JAX row function ``_rows_logp_pulse`` on them: ``jax.vjp``'s gradients
    (w.r.t. phi, ctx and kf) and its value. Row i is special by i % 5: the
    phase at either clip edge, the slot index past the last slot or below
    the first, or a censored choice."""
    jest = _jax_est_cached("pulse_abs")
    cfg = jest.cfg
    NS = cfg.num_pulse_slots
    rng = np.random.default_rng(7)
    i = np.arange(n_max) % 5
    phi = np.where(i == 0, 1e-6, np.where(i == 1, 1.0 - 1e-6, rng.uniform(0, 1, n_max))).astype(np.float32)
    choice = np.where(i == 4, cfg.censored_category, rng.integers(0, 3, n_max))
    oh = np.eye(3, dtype=np.float32)[choice]
    ctx = rng.normal(size=(n_max, 9)).astype(np.float32)
    k = np.where(i == 2, NS, np.where(i == 3, -1, rng.integers(0, NS, n_max)))
    ang = 2 * np.pi * rng.uniform(0, 1, n_max)
    kf = np.stack([(k + 0.5) / NS, np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    kv = k.astype(np.float32)
    g = rng.normal(size=n_max).astype(np.float32)
    kw = dict(n_layers=cfg.trunk_depth + 1, num_transforms=cfg.num_transforms, num_bins=cfg.num_bins,
              num_slots=NS, censored_col=cfg.censored_category)
    jw = jpallas.pack_mnle_weights(jest)
    f = lambda a, b, c: jpallas._rows_logp_pulse(a, jnp.asarray(oh), b, c, jnp.asarray(kv), jw, **kw)  # noqa: E731
    val, vjp = jax.vjp(f, *map(jnp.asarray, (phi, ctx, kf)))
    # Each row's float32 conditioning: how far the exact gradients move under
    # an input change of a few ulps (ops/rowcheck.py, the plain version in float64).
    w64 = tk.pack_mnle_weights(_port(jest)).astype(torch.float64)
    rows = tuple(map(torch.from_numpy, (phi, oh, ctx, kf, kv)))
    _, spread = reference(lambda *a: (tk.rows_logp_pulse_plain(*a[:-1], w64),
                                      *tk.rows_logp_pulse_vjp_plain(*a[:-1], w64, a[-1])),
                          rows, torch.from_numpy(g), (2, 3))
    # refs: dphi, dctx, dkf, value; spreads: value, dphi, dctx, dkf.
    return ((phi, oh, ctx, kf, kv, g), [np.asarray(a) for a in vjp(jnp.asarray(g))] + [np.asarray(val)],
            [a.numpy() for a in spread])


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 1000, 1201])
def test_k3p_wrapper_matches_jax_at_ragged_row_counts(n):
    """K3p's wrapper on CPU rows at counts on either side of its 8-row
    tiles: it takes the plain version without a launch, and that matches
    ``jax.vjp`` of the JAX row function ``_rows_logp_pulse`` on the same
    packed weights, with censored rows, phases at the clip edges and slot
    indices outside the slots. The kernel itself is held to the same
    ``jax.vjp`` results on the card, through ``K3P_JAX_REFERENCE``
    (``tests/test_torch_cuda.py``)."""
    rows, refs, spreads = ([a[:n] for a in part] for part in _ragged_pulse_rows_and_jax_vjp())
    phi, oh, ctx, kf, kv, g = rows
    w = tk.pack_mnle_weights(_port(_jax_est_cached("pulse_abs")))
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    grads = tk.rows_logp_pulse_vjp(*map(torch.from_numpy, (phi, oh, ctx, kf, kv)), w, torch.from_numpy(g))
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    assert [tuple(a.shape) for a in grads] == [(n,), (n, 9), (n, 3)]
    censored = oh[:, 2] > 0
    assert not grads[0].numpy()[censored].any() and not grads[2].numpy()[censored].any()
    # Row by row to 1e-4 of max(1, the row's largest |ref|), plus twice the
    # row's spread on steep rows, where the two float32 versions round apart
    # (the allowance rule of ops/rowcheck.py).
    for got, want, spread, what in zip(grads, refs, spreads[1:], ("dphi", "dctx", "dkf")):
        err = np.abs(got.numpy().astype(np.float64) - want).reshape(n, -1).max(1)
        allow = 1e-4 * np.maximum(1.0, np.abs(want).reshape(n, -1).max(1)) + 2.0 * spread
        assert (err <= allow).all(), f"{what}: worst row {int((err / allow).argmax())} at {float((err / allow).max()):.3f}"


@pytest.mark.parametrize("n", [1, 8, 9, 1201])
def test_value_and_vjp_wrapper_matches_plain_and_jax(n):
    """``rows_logp_and_vjp`` (one K3 launch on the card) on CPU rows of the
    "cond_affine" estimator: no launch, the plain value and VJP bit for bit,
    and the JAX row function ``_rows_logp``'s value and ``jax.vjp`` to 1e-4
    of max(1, largest |ref|) (the scale rule of ops/rowcheck.py)."""
    t, oh, ctx, g, ref_dt, ref_dc, ref_v = (a[:n] for a in _ragged_rows_and_jax_vjp())
    w = tk.pack_mnle_weights(_port(_jax_est_cached("cond_affine")))
    rows = tuple(map(torch.from_numpy, (t, oh, ctx)))
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    got = tk.rows_logp_and_vjp(*rows, w, torch.from_numpy(g))
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    want = (tk.rows_logp_plain(*rows, w), *tk.rows_logp_vjp_plain(*rows, w, torch.from_numpy(g)))
    assert [tuple(a.shape) for a in got] == [(n,), (n,), (n, 9)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, ref, what in zip(got, (ref_v, ref_dt, ref_dc), ("value", "dt", "dctx")):
        err = float(np.abs(a.numpy().astype(np.float64) - ref).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), f"{what}: max abs error {err:.3e}"


@pytest.mark.parametrize("n", [1, 8, 9, 1201])
def test_pulse_value_and_vjp_wrapper_matches_plain_and_jax(n):
    """``rows_logp_pulse_and_vjp`` (one K3p launch on the card) on CPU rows
    of the "pulse_abs" estimator, censored rows, phases at the clip edges and
    slot indices outside the slots included: no launch, the plain value and
    VJP bit for bit, and the JAX row function ``_rows_logp_pulse``'s value
    and ``jax.vjp`` row by row to 1e-4 of max(1, the row's largest |ref|)
    plus twice the row's float32 spread (ops/rowcheck.py)."""
    rows, refs, spreads = ([a[:n] for a in part] for part in _ragged_pulse_rows_and_jax_vjp())
    w = tk.pack_mnle_weights(_port(_jax_est_cached("pulse_abs")))
    trows = tuple(map(torch.from_numpy, rows))
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    got = tk.rows_logp_pulse_and_vjp(*trows[:5], w, trows[5])
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    want = (tk.rows_logp_pulse_plain(*trows[:5], w), *tk.rows_logp_pulse_vjp_plain(*trows[:5], w, trows[5]))
    assert [tuple(a.shape) for a in got] == [(n,), (n,), (n, 9), (n, 3)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, ref, spread, what in zip(got, refs[3:] + refs[:3], spreads, ("value", "dphi", "dctx", "dkf")):
        err = np.abs(a.numpy().astype(np.float64) - ref).reshape(n, -1).max(1)
        allow = 1e-4 * np.maximum(1.0, np.abs(ref).reshape(n, -1).max(1)) + 2.0 * spread
        assert (err <= allow).all(), f"{what}: worst row {int((err / allow).argmax())} at {float((err / allow).max()):.3f}"


# The small "pulse_abs" estimator in the ``save_model`` layout, with the rows
# of ``_ragged_pulse_rows_and_jax_vjp`` ("row:<name>") and ``jax.vjp``'s
# gradients on them ("jax:<name>"): the card has no JAX, so the card test
# of K3p reads them from here. Rewritten by running this file as a script.
K3P_JAX_REFERENCE = Path(__file__).with_name("data") / "k3p_pulse_jax_vjp.npz"
K3P_ROWS = ("phi", "onehot", "ctx", "kf", "kv", "g")
K3P_GRADS = ("dphi", "dctx", "dkf")


def write_k3p_jax_reference(path=K3P_JAX_REFERENCE):
    rows, refs, _ = _ragged_pulse_rows_and_jax_vjp()
    refs = refs[:3]
    with tempfile.TemporaryDirectory() as d:
        os.environ["MODEL_DIR"] = d
        with np.load(tmnle.save_model(_port(_jax_est_cached("pulse_abs")), None, "model.npz")) as m:
            model = dict(m)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **model, **{f"row:{k}": a for k, a in zip(K3P_ROWS, rows)},
             **{f"jax:{k}": a for k, a in zip(K3P_GRADS, refs)})


def test_k3p_jax_reference_file_is_what_jax_gives_now():
    """``K3P_JAX_REFERENCE`` loads to the small "pulse_abs" estimator's
    weights, and holds the rows and the ``jax.vjp`` gradients that JAX
    gives on them now: row by row to 1e-6 of max(1, the row's largest
    |ref|) plus the row's float32 spread, for XLA on another CPU may round
    steep rows apart."""
    est = tmnle.load_model(str(K3P_JAX_REFERENCE), device="cpu")
    now = _port(_jax_est_cached("pulse_abs"))
    for a, b in zip(tk.pack_mnle_weights(est).as_list(), tk.pack_mnle_weights(now).as_list()):
        assert torch.equal(a, b)
    assert est.cfg == now.cfg
    rows, refs, spreads = _ragged_pulse_rows_and_jax_vjp()
    with np.load(K3P_JAX_REFERENCE) as data:
        for name, a in zip(K3P_ROWS, rows):
            np.testing.assert_array_equal(data[f"row:{name}"], a)
        for name, want, spread in zip(K3P_GRADS, refs, spreads[1:]):
            got = data[f"jax:{name}"]
            assert got.shape == want.shape and got.dtype == np.float32
            err = np.abs(got.astype(np.float64) - want).reshape(len(got), -1).max(1)
            allow = 1e-6 * np.maximum(1.0, np.abs(want).reshape(len(got), -1).max(1)) + spread
            assert (err <= allow).all(), f"{name}: worst row {int((err / allow).argmax())}"


# The JAX row function's value on the rows of ``K3P_JAX_REFERENCE`` (the same
# small "pulse_abs" estimator): the card test of K2p and K3p's values reads
# it from here. Rewritten by running this file as a script.
K2P_JAX_VALUE = Path(__file__).with_name("data") / "k2p_pulse_jax_value.npz"


def write_k2p_jax_value(path=K2P_JAX_VALUE):
    _, refs, _ = _ragged_pulse_rows_and_jax_vjp()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{"jax:value": refs[3]})


def test_k2p_jax_value_file_is_what_jax_gives_now():
    """``K2P_JAX_VALUE`` holds the JAX row function's value on the rows of
    ``K3P_JAX_REFERENCE`` as JAX gives it now: row by row to 1e-6 of max(1,
    |ref|) plus the row's float32 spread, for XLA on another CPU may round
    steep rows apart."""
    rows, refs, spreads = _ragged_pulse_rows_and_jax_vjp()
    with np.load(K3P_JAX_REFERENCE) as data:
        for name, a in zip(K3P_ROWS, rows):
            np.testing.assert_array_equal(data[f"row:{name}"], a)
    with np.load(K2P_JAX_VALUE) as data:
        got = data["jax:value"]
    want = refs[3]
    assert got.shape == want.shape == (len(rows[0]),) and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want)
    allow = 1e-6 * np.maximum(1.0, np.abs(want)) + spreads[0]
    assert (err <= allow).all(), f"worst row {int((err / allow).argmax())}"


@pytest.mark.parametrize("model", ["small", "committed"])
def test_k3p_padded_head_copies_equal_the_head_with_zero_padding(model, request):
    """K2p's and K3p's copies of the head weights
    (``MNLEWeights.padded_head``): rows padded with zero columns to a
    multiple of 4 floats, the head (and its
    transpose) unchanged in the other columns; the committed pulse model's
    730 and 131 columns become 732 and 132."""
    if model == "small":
        est = _port(_jax_est_cached("pulse_abs"))
    else:
        est = request.getfixturevalue("pulse_model")[1]
    w = tk.pack_mnle_weights(est)
    hw, hwt = w.padded_head()
    HF, HO = w.head_w.shape
    if model == "committed":
        assert (HF, HO) == (131, 730) and hw.shape == (131, 732) and hwt.shape == (730, 132)
    assert hw.shape[1] % 4 == 0 and hwt.shape[1] % 4 == 0
    assert hw.shape[1] - HO < 4 and hwt.shape[1] - HF < 4
    assert torch.equal(hw[:, :HO], w.head_w) and torch.equal(hwt[:, :HF], w.head_w.t())
    assert not hw[:, HO:].any() and not hwt[:, HF:].any()


@pytest.fixture(scope="module")
def flagship(request):
    mp = pytest.MonkeyPatch()
    from pathlib import Path

    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    jest, est = jmnle.load_model(FLAGSHIP), tmnle.load_model(FLAGSHIP, device="cpu")
    request.addfinalizer(mp.undo)
    return jest, est


@pytest.fixture(scope="module")
def pulse_model(request):
    mp = pytest.MonkeyPatch()
    from pathlib import Path

    mp.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    jest, est = jmnle.load_model(PULSE_MODEL), tmnle.load_model(PULSE_MODEL, device="cpu")
    request.addfinalizer(mp.undo)
    return jest, est


def _session_rows(seed=0, n_theta=4):
    """One simulated 50-trial session against a few prior thetas."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    theta = build_prior_theta().sample(make_generator(seed, "cpu"), (n_theta,))
    theta[:, 4] = 0.5 * theta[:, 4]  # most trials after the onset
    x, s = simulate_observed_session(theta[0], 50, seed=seed)
    cond = torch.cat([theta[:, None, :].expand(n_theta, 50, 5), s[None].expand(n_theta, 50, 80)], -1)
    return x[None].expand(n_theta, 50, 2).reshape(-1, 2).numpy(), cond.reshape(-1, 85).numpy()


def _as_float64(jest, est):
    """Both estimators in float64, the reference the float32 runs are held to."""
    import copy

    j64 = jest.__class__(
        cfg=jest.cfg, params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jest.params),
        cond_mean=jnp.asarray(jest.cond_mean, jnp.float64), cond_std=jnp.asarray(jest.cond_std, jnp.float64),
        x_mean=jnp.asarray(jest.x_mean, jnp.float64), x_std=jnp.asarray(jest.x_std, jnp.float64), train_meta=None,
    )
    t64 = copy.deepcopy(est)
    t64.net.double()
    for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
        setattr(t64, name, getattr(t64, name).double())
    return j64, t64


def test_flagship_load_model_matches_jax(flagship):
    """The committed flagship model through the port's load_model.

    In float64 the port and JAX compute the same function to 1e-9. In float32
    both round away from it: ten 128-wide layers and ten splines, behind a
    cond-affine scale exp(-log sigma) of up to e^7, amplify rounding on some
    rows (measured: about 1% of realistic rows move by more than 1e-4 in
    value). So in float32 the port is held to the issue's tolerances (values
    1e-4 relative to max(1, |ref|), gradients 1e-3 relative L-inf) against
    the float64 reference, or, where float32 itself cannot reach them, to
    twice the error of the JAX float32 run on the same rows."""
    jest, est = flagship
    assert est.cfg.cond_affine and est.cfg.rt_rep == "shifted_log" and est.cfg.num_transforms == 10
    _hold_committed_model_to_jax(jest, est, "xla")


def test_pulse_model_load_model_matches_jax(pulse_model):
    """The committed pulse-grid model (absolute anchor, full width) through
    the port's load_model, on the plain path and on the fused path (K2p/K3p's
    plain versions on CPU rows), held as the flagship is."""
    jest, est = pulse_model
    cfg = est.cfg
    assert (cfg.rt_rep, cfg.grid_anchor, cfg.censor_rt) == ("pulse", "absolute", True)
    assert (cfg.hidden_features, cfg.num_transforms, cfg.num_bins, cfg.num_pulse_slots) == (128, 10, 24, 80)
    assert est.net.spline_heads[0].weight.shape == (73, 131) and est.net.pulse_slot_head.weight.shape == (80, 128)
    for kernel in ("xla", "pallas"):
        _hold_committed_model_to_jax(jest, est, kernel)


def _hold_committed_model_to_jax(jest, est, kernel):
    assert est.cfg == MNLEConfig(**jest.cfg.__dict__)
    np.testing.assert_array_equal(est.cond_std.numpy(), np.asarray(jest.cond_std))
    x, cond = _session_rows()
    j32_v, j32_g = _value_and_cond_grad_jax(lambda a, c: jest.log_prob_fn(jest.params, a, c), x, cond)
    t32_v, t32_g = _value_and_cond_grad_torch(est.dispatch_log_prob(kernel), x, cond)
    with jax.enable_x64(True):
        j64, t64 = _as_float64(jest, est)
        r_v, r_g = _value_and_cond_grad_jax(lambda a, c: j64.log_prob_fn(j64.params, a, c),
                                           x.astype(np.float64), cond.astype(np.float64))
    t64_v, t64_g = _value_and_cond_grad_torch(t64.log_prob, x.astype(np.float64), cond.astype(np.float64))
    assert r_v.dtype == np.float64 and t64_v.dtype == np.float64
    np.testing.assert_allclose(t64_v, r_v, rtol=1e-9, atol=1e-9)
    _assert_rel_linf(t64_g, r_g, 1e-9, "float64 gradient")

    def val_err(v):
        return float(np.max(np.abs(v - r_v) / np.maximum(1.0, np.abs(r_v))))

    def grad_err(g):
        return float(np.max(np.abs(g - r_g)) / np.max(np.abs(r_g)))

    assert val_err(t32_v) <= max(1e-4, 2 * val_err(j32_v)), (val_err(t32_v), val_err(j32_v))
    assert grad_err(t32_g) <= max(1e-3, 2 * grad_err(j32_g)), (grad_err(t32_g), grad_err(j32_g))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mnle.py rewrites K3P_JAX_REFERENCE and K2P_JAX_VALUE.
    write_k3p_jax_reference()
    write_k2p_jax_value()
    print(f"wrote {K3P_JAX_REFERENCE} and {K2P_JAX_VALUE}")
