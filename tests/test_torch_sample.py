"""PyTorch port: ``MNLE.sample`` / ``sample_fn`` against the JAX package's
sampler, in distribution (the two draw from different streams), on a small
model of each RT representation: log, shifted-log with the cond-affine head
and the left-tail sharpening (the Newton inverse), and the pulse grid with
either anchor (the slot head and the circular inverse for the absolute
one). Held by a chi-square test on the choices and two-sample KS tests on
the RTs of each choice (p >= 1e-3); censored draws sit at T_MAX; every draw
has a finite log-prob; the same seed gives the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sbi_for_diffusion_models_tpu.nets import mnle_net as jnet
from sbi_for_diffusion_models_tpu_torch.constants import T_MAX
from sbi_for_diffusion_models_tpu_torch.nets import mnle_net as tnet

SMALL = dict(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=6)
REPS = {
    "log": dict(),
    "shifted_log_sharp": dict(rt_rep="shifted_log", censor_rt=True, log_condition_dims=(1, 2, 3), cond_affine=True,
                              tail_sharp_k=1.5, tail_sharp_c=-1.0),
    "pulse_abs": dict(rt_rep="pulse", censor_rt=True),
    "pulse_tnd": dict(rt_rep="pulse", censor_rt=True, grid_anchor="tnd"),
}
N_DRAWS = 6000
P_MIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(rep):
    """A small JAX MNLE of ``rep`` with standardization stats that are not
    the identity, and the same model carried across to the port."""
    cfg = jnet.MNLEConfig(**SMALL, **REPS[rep])
    jest = jnet.build_mnle(jax.random.key(11), cfg)
    rng = np.random.default_rng(12)
    jest = jest.__class__(
        cfg=cfg, params=jest.params,
        cond_mean=jnp.asarray(0.1 * rng.normal(size=85), jnp.float32),
        cond_std=jnp.asarray(rng.uniform(0.8, 1.3, 85), jnp.float32),
        x_mean=jnp.float32(-0.6), x_std=jnp.float32(0.9), train_meta=None,
    )
    tree = jax.tree.map(np.asarray, jest.params)
    est = tnet.mnle_from_flax_params(tnet.MNLEConfig(**cfg.__dict__), tree, jest.cond_mean, jest.cond_std,
                                     jest.x_mean, jest.x_std, device="cpu")
    return jest, est


def _conditions(n, seed=13):
    """n condition rows cycling over 12 (theta, pulses) pairs."""
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(0.2, 0.8, 12), rng.lognormal(-1, 0.5, 12), rng.lognormal(0, 0.5, 12),
                      rng.lognormal(2.75, 0.3, 12), rng.uniform(0.05, 0.25, 12)], -1)
    cond = np.concatenate([theta, np.where(rng.random((12, 80)) < 0.5, 1.0, -1.0)], -1).astype(np.float32)
    return cond[np.arange(n) % 12]


def same_distribution(a, b, censored=None):
    """p-values: chi-square on the choice counts, and a KS test on the RTs
    of each choice both samples have more than 20 draws of (censored draws
    are a constant, so not tested by KS)."""
    counts = np.array([[np.sum(d[:, 1] == c) for c in range(3)] for d in (a, b)])
    seen = counts.sum(0) > 0
    p = {"choice": float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0}
    for c in range(3):
        if c != censored and counts[:, c].min() > 20:
            p[f"rt|{c}"] = float(stats.ks_2samp(a[a[:, 1] == c, 0], b[b[:, 1] == c, 0]).pvalue)
    return p


@pytest.mark.parametrize("rep", sorted(REPS))
def test_sample_matches_jax_in_distribution(rep):
    jest, est = _models(rep)
    cond = _conditions(N_DRAWS)
    want = np.asarray(jax.jit(jest.sample)(jax.random.key(5), jnp.asarray(cond)))
    got = est.sample(7, torch.from_numpy(cond)).numpy()
    assert got.shape == (N_DRAWS, 2) and np.isfinite(got).all()
    cens = est.cfg.censored_category if est.cfg.censor_rt else None
    p = same_distribution(got, want, cens)
    assert len(p) >= 3 and min(p.values()) >= P_MIN, p
    if cens is not None:
        assert (got[got[:, 1] == cens, 0] == T_MAX).all() and (got[:, 1] == cens).any()
    lp = est.log_prob(torch.from_numpy(got), torch.from_numpy(cond))
    assert bool(torch.isfinite(lp).all())
    # The same seed (or an equal generator) gives the same draws; another seed others.
    again = est.sample_fn(est.params, torch.Generator().manual_seed(7), torch.from_numpy(cond)).numpy()
    assert np.array_equal(got, again)
    assert not np.array_equal(got, est.sample(8, torch.from_numpy(cond)).numpy())


def test_sample_keeps_leading_shape_and_onsets():
    """A (2, 3, D) condition gives (2, 3, 2) draws, and the shifted-log rep
    draws every RT that is not censored after its own row's onset."""
    _, est = _models("shifted_log_sharp")
    cond = torch.from_numpy(_conditions(6).reshape(2, 3, 85))
    out = est.sample(3, cond)
    assert out.shape == (2, 3, 2)
    draws = est.sample(4, torch.from_numpy(_conditions(2000)))
    onset = torch.from_numpy(_conditions(2000))[:, 4]
    live = draws[:, 1] != 2
    assert bool((draws[live, 0] > onset[live]).all())
