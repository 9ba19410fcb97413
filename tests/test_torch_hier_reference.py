"""PyTorch port: the hierarchical model's joint density
(``models/hierarchical._hierarchical_density``: ``logp``, ``ll`` and the
closed-form ``vg``) against the benchmark's plain float64 reference
(``port_bench/reference/hierarchical.py``), on a small MNLE with seeded
random weights saved to and read from a ``.npz``, at 3 subjects of 4
trials, 5 chain rows and inverse temperatures 1 and 0.3. A chain rule
given a wrong Jacobian term must fail the same comparison. The recorder's
``hier.density`` spans and ``hier.rows`` counter, and the draws with the
recorder on and off. CPU only, one intra-op thread."""

import numpy as np
import pytest
import torch

from port_bench.reference import hierarchical as ref_hier
from port_bench.reference import mnle as ref
from sbi_for_diffusion_models_tpu_torch.distributions import Bijector, mcmc_transform
from sbi_for_diffusion_models_tpu_torch.mnle import load_model, save_model
from sbi_for_diffusion_models_tpu_torch.models import hierarchical as th
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.utils import metrics

S, T, N = 3, 4, 5
# The port computes in float32 against float64. A value sums S*T rows of a few float32 roundings each (about
# 1e-7 of a row), so its gap relative to max(|value|, S*T) stays near 1e-7 (7e-8 here); 1e-6 leaves ten times that.
# A gradient element carries the rows' float32 gradients through the chain rule; relative to the row's largest
# element it reads 1.5e-7 here, and 1e-5 leaves room for cancelling terms while a term left out of the chain rule
# moves it by a sizeable share of its own size (0.84 with the Jacobian's derivative dropped).
VALUE_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The saved small estimator, both sides' models, the cohort and the chain rows."""
    path = str(tmp_path_factory.mktemp("models") / "small.npz")
    cfg = MNLEConfig(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=5, rt_rep="shifted_log",
                     censor_rt=True, log_condition_dims=(1, 2, 3), cond_affine=True)
    gen = torch.Generator().manual_seed(5)
    est = build_mnle(3, cfg, cond_mean=0.1 * torch.randn(85, generator=gen),
                     cond_std=0.5 + torch.rand(85, generator=gen), x_mean=0.2, x_std=0.8, device="cpu")
    save_model(est, None, path)
    est = load_model(path, device="cpu")
    m64 = ref.load_npz(path, torch.float64)

    rng = np.random.default_rng(7)
    choice = rng.integers(0, 3, (1, S, T)).astype(np.float32)
    rt = np.where(choice == 2, 8.0, rng.uniform(1.0, 3.0, (1, S, T))).astype(np.float32)
    xs = torch.from_numpy(np.stack([rt, choice], -1))
    ps = torch.from_numpy(np.where(rng.uniform(size=(1, S, T, 80)) < 0.75, 1.0, -1.0).astype(np.float32))

    prior = build_prior_theta()
    model = th.HierarchicalModel.from_prior(prior, device="cpu")
    hyper = ref_hier.Hyperprior(model.mu_loc, model.mu_scale, model.log_tau_loc, model.log_tau_scale)
    center = torch.cat([model.mu_loc, model.log_tau_loc, torch.zeros(S * 5)])
    scale = torch.cat([model.mu_scale, model.log_tau_scale, torch.ones(S * 5)])
    q = center + 0.5 * scale * torch.randn((N, model.dim(S)), generator=gen)
    data = (torch.zeros(N, dtype=torch.int64), torch.tensor([1.0, 0.3, 1.0, 0.3, 1.0]))
    want = ref_hier.log_density(m64, hyper, q, xs[data[0]], ps[data[0]], data[1])
    return dict(est=est, prior=prior, model=model, xs=xs, ps=ps, q=q, data=data, want=want)


def _value_gap(have, want):
    return float(((have.double() - want).abs() / want.abs().clamp(min=S * T)).max())


def _grad_gap(have, want):
    return float(((have.double() - want).abs().amax(-1) / want.abs().amax(-1)).max())


@pytest.mark.parametrize("jacobian", ["exact", "term_dropped"])
def test_density_matches_the_float64_reference(case, jacobian, monkeypatch):
    """logp, ll and vg (with and without the gradient) against the
    reference; with the Jacobian's log-determinant derivative dropped from
    the chain rule, the gradient gap exceeds its tolerance."""
    if jacobian == "term_dropped":
        real = Bijector.forward_and_grads

        def wrong(self, u):
            theta, dtheta, log_det, dlog_det = real(self, u)
            return theta, dtheta, log_det, torch.zeros_like(dlog_det)

        monkeypatch.setattr(Bijector, "forward_and_grads", wrong)
    logp, ll, vg = th._hierarchical_density(case["model"], mcmc_transform(case["prior"]), case["est"], case["xs"],
                                            case["ps"])
    assert vg is not None  # the closed-form path
    q, data = case["q"], case["data"]
    v_ref, g_ref, ll_ref = case["want"]
    value, grad = vg(q, data)
    value_only, none = vg(q, data, need_grad=False)
    assert none is None and torch.equal(value_only, value)
    assert _value_gap(value, v_ref) < VALUE_TOL
    assert _value_gap(logp(q, data), v_ref) < VALUE_TOL
    assert _value_gap(ll(q, data), ll_ref) < VALUE_TOL
    gap = _grad_gap(grad, g_ref)
    if jacobian == "exact":
        assert gap < GRAD_TOL
    else:
        assert gap > 10 * GRAD_TOL


def test_density_spans_hold_the_potential_and_count_rows(case):
    """With the recorder on, each evaluation is a ``hier.density`` span with
    the likelihood's ``potential`` span inside, and ``hier.rows`` counts
    N*S*T rows a call; off, nothing is recorded."""
    logp, ll, vg = th._hierarchical_density(case["model"], mcmc_transform(case["prior"]), case["est"], case["xs"],
                                            case["ps"])
    q, data = case["q"], case["data"]
    off = vg(q, data)
    assert not metrics.RECORDING and metrics.drain() == ([], {})
    metrics.enable()
    try:
        on = vg(q, data)
        vg(q, data, need_grad=False)
        ll(q, data)
        logp(q, data)
    finally:
        spans, counters = metrics.drain()
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    outer = [i for i, s in enumerate(spans) if s.name == "hier.density"]
    assert len(outer) == 4 and all(spans[i].parent == -1 for i in outer)
    assert sorted(spans[i].parent for i, s in enumerate(spans) if s.name == "potential") == outer
    assert counters["hier.rows"] == 4 * N * S * T


def test_recording_changes_no_hierarchical_draw(case):
    """A tiny joint run with the recorder on gives the draws of the run with
    it off, bit for bit."""
    kw = dict(num_chains=1, num_warmup=2, num_samples=2, max_tree_depth=2, pt_replicas=2, seed=4, verbose=False)
    args = (case["est"], case["prior"], case["xs"][0], case["ps"][0])
    off = th.run_hierarchical_inference(*args, model=case["model"], **kw)
    metrics.enable()
    try:
        on = th.run_hierarchical_inference(*args, model=case["model"], **kw)
    finally:
        spans, _ = metrics.drain()
    assert any(s.name == "hier.density" for s in spans)
    np.testing.assert_array_equal(on["raw"], off["raw"])
