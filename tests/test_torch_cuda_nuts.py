"""PyTorch port: the NUTS leaf kernel (``csrc/nuts_leaf.cu``,
``ops/nuts_cuda.py``) on the card. The kernel against the plain leaf
(``inference/nuts._leaf_plain``) leaf by leaf on the same inputs and
uniforms; a whole run through the kernel against the plain leaf on the card;
``sharded_run_nuts`` over two ranks sharing the card against the unsharded
run; a correlated Gaussian recovered through the kernel; and the launches a
leaf makes. Without a CUDA device (or without nvcc to build the kernel) every
test here is skipped. This module imports no JAX: the ranks import it.
"""

import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
from sbi_for_diffusion_models_tpu_torch.ops import nuts_cuda
from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals, warm_window
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

pytestmark = pytest.mark.requires_cuda

DEV = torch.device("cuda", 0)
ULPS = 4  # the kernel's floats against the plain leaf's
LEAF_DEPTH = 10  # CALIBRATED_CONFIG's MCMC_MAX_TREE_DEPTH: the deepest subtree a serving or SBC run builds
_FLOATS = ("edge", "prop", "rho", "log_w", "sum_accept", "r_ckpts", "rsum_ckpts")
_EXACT = ("n_leaves", "turning", "diverging", "live")


@pytest.fixture(autouse=True)
def _needs_card():
    """Skip unless there is a CUDA device and nvcc (decided per test, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the leaf kernel is CUDA C++ with no CPU mode")
    if not (Path("/usr/local/cuda/bin/nvcc").exists() or shutil.which("nvcc")):
        pytest.skip("needs nvcc: the kernels are built from source at first use")


def _ulps(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The largest distance in float32 ulps between x and y (0 where both
    are NaN, 2^31 where one is)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(x) - ordered(y)).abs()
    nx, ny = torch.isnan(x), torch.isnan(y)
    d = torch.where(nx & ny, 0, torch.where(nx ^ ny, 2**31, d))
    return d.max() if d.numel() else torch.zeros((), dtype=torch.int64, device=x.device)


def _gaussian(D: int, seed: int):
    """A diagonal Gaussian's (logp, grad) with a random mean and precision."""
    rng = np.random.default_rng(seed)
    mu = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=DEV)
    prec = torch.tensor(rng.uniform(0.3, 3.0, D), dtype=torch.float32, device=DEV)

    def vg(x):
        return -0.5 * ((x - mu) ** 2 * prec).sum(-1), -(x - mu) * prec

    return vg


def _start(C: int, D: int, depth: int, seed: int):
    """A subtree's start: positions and momenta from N(0, 1), step sizes
    that make some chains turn within a few leaves, every fifth chain
    inactive. Returns the state dict of ``_build_subtree`` and its inputs."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=DEV)  # noqa: E731
    vg = _gaussian(D, seed)
    u, p = f32(rng.normal(size=(C, D))), f32(rng.normal(size=(C, D)))
    inv_mass = f32(rng.uniform(0.5, 2.0, (C, D)))
    eps = f32(rng.uniform(0.02, 0.6, C))
    direction = torch.where(f32(rng.uniform(size=C)) < 0.5, 1.0, -1.0)
    active = torch.from_numpy(np.arange(C) % 5 != 4).to(DEV)
    logp, g = vg(u)
    H0 = -logp + tn._kinetic(p, inv_mass)
    edge = torch.cat([u, p, g, logp[:, None]], dim=1)
    S = LEAF_DEPTH + 1
    s = dict(edge=edge, prop=torch.cat([edge[:, :D], edge[:, 2 * D :]], dim=1),
             rho=torch.zeros((C, D), device=DEV), log_w=torch.full((C,), -math.inf, device=DEV),
             sum_accept=torch.zeros((C,), device=DEV), n_leaves=torch.zeros((C,), dtype=torch.int64, device=DEV),
             turning=torch.zeros((C,), dtype=torch.bool, device=DEV),
             diverging=torch.zeros((C,), dtype=torch.bool, device=DEV), live=active.clone(),
             r_ckpts=torch.zeros((C, S, D), device=DEV), rsum_ckpts=torch.zeros((C, S, D), device=DEV))
    half_e = (0.5 * eps * direction)[:, None]
    e_im = (eps * direction)[:, None] * inv_mass
    return s, vg, half_e, e_im, inv_mass, H0


def _poison(logp: torch.Tensor, n: int) -> torch.Tensor:
    """At the first leaves, a NaN, a -inf and a divergent log-density on a
    few chains (by chain index modulo 11)."""
    bad = {1: math.nan, 2: -math.inf, 3: -5000.0}
    if n not in bad:
        return logp
    c = torch.arange(logp.shape[0], device=logp.device)
    return torch.where(c % 11 == 2 * n, torch.full_like(logp, bad[n]), logp)


# (C, D): every chain count at D = 5 and 7; the hierarchical sampler's widths (D = 2 * 5 + 5 S, 330 at S = 64)
# and the edges of PyTorch's sum orders over D (its four-wide loads from D = 128) at 24 and 33 chains.
LEAF_CASES = [(C, D) for D in (5, 7) for C in (1, 7, 24, 33, 2304)] + [
    (C, D) for D in (30, 127, 128, 129, 170, 330) for C in (24, 33)]


@pytest.mark.parametrize("C,D", LEAF_CASES)
def test_leaf_kernel_matches_the_plain_leaf(C, D):
    """Every leaf of subtrees of depth 0 to LEAF_DEPTH: the kernel's state,
    next position and flag against the plain leaf's on the same potential
    and uniforms, one launch a leaf. Counts and booleans exact, floats
    within ULPS."""
    worst, diverged, launched = 0, False, nuts_cuda.LEAF.launches
    for depth in range(LEAF_DEPTH + 1):
        plain, vg, half_e, e_im, inv_mass, H0 = _start(C, D, depth, seed=100 * C + 10 * D + depth)
        fused = {k: v.clone() for k, v in plain.items()}
        flag = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
        kernel = nuts_cuda.LeafKernel(fused, half_e, e_im, inv_mass, H0, flag)
        e = fused["edge"]  # the first half step, as _build_subtree makes it
        torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D], out=kernel.p_half)
        u_fused = torch.addcmul(e[:, :D], e_im, kernel.p_half)
        gen = make_generator(depth, DEV)
        per_leaf = []
        for n in range(1 << depth):
            e = plain["edge"]
            p_half = torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D])
            u_new = torch.addcmul(e[:, :D], e_im, p_half)
            logp_new, g_new = vg(u_new)
            logp_new = _poison(logp_new, n)
            uni = torch.rand((C,), generator=gen, device=DEV)
            pos = _ulps(u_fused, u_new)
            u_fused = kernel.leaf(u_fused, logp_new, g_new, uni, tn._leaf_slots(n), n % 2)
            plain = tn._leaf_plain(n, plain, u_new, p_half, logp_new, g_new, uni, half_e, inv_mass, H0)
            torch.cuda.synchronize()
            per_leaf.append({
                "u_new": pos, **{k: _ulps(fused[k], plain[k]) for k in _FLOATS},
                **{k: (fused[k] != plain[k]).sum() for k in _EXACT},
                "flag": bool(flag[n % 2]) != bool(plain["live"].any())})
        for n, diff in enumerate(per_leaf):
            for k, v in diff.items():
                v = int(v)
                if k in _EXACT or k == "flag":
                    assert v == 0, f"C={C} D={D} depth={depth} leaf {n}: {k} differs on {v} chains"
                else:
                    assert v <= ULPS, f"C={C} D={D} depth={depth} leaf {n}: {k} off by {v} ulps"
                    worst = max(worst, v)
        diverged = diverged or bool(plain["diverging"].any())
    assert diverged == (C > 2)  # the poisoned chains' leaves diverged
    assert nuts_cuda.LEAF.launches - launched == (1 << (LEAF_DEPTH + 1)) - 1
    print(f"leaf kernel against the plain leaf, C={C} D={D}: worst {worst} ulps")


def _recovery_run(seed: int = 1):
    mean = torch.tensor([1.0, -2.0], device=DEV)
    prec = torch.linalg.inv(torch.tensor([[1.0, 0.8], [0.8, 1.5]], device=DEV))

    def logp(u):
        d = u - mean
        return -0.5 * ((d @ prec) * d).sum(-1)

    C, R = 4, 3
    betas = torch.as_tensor(tn.geometric_ladder(R, 0.2)).repeat(C).to(DEV)
    ex = tn.ReplicaExchange(n_replicas=R, betas=betas, ll_fn=lambda u, b: logp(u))
    init = (torch.randn((C * R, 2), generator=make_generator(0)) * 3.0).to(DEV)
    samples, info = tn.run_nuts(seed, lambda u, b: b * logp(u), init, num_warmup=150, num_samples=400, data=betas,
                                exchange=ex, max_depth=6)
    return samples, info, mean


def test_nuts_with_parallel_tempering_recovers_correlated_gaussian_through_the_kernel():
    before = nuts_cuda.LEAF.launches
    samples, info, mean = _recovery_run()
    assert nuts_cuda.LEAF.launches > before
    cold = samples.reshape(4, 3, 400, 2)[:, 0].cpu()
    flat = cold.reshape(-1, 2)
    assert torch.allclose(flat.mean(0), mean.cpu(), atol=0.1), flat.mean(0)
    var = flat.var(0)
    assert torch.all((var / torch.tensor([1.0, 1.5]) - 1.0).abs() < 0.2), var
    assert 0.0 < info["swap_accept"] <= 1.0
    assert int(info["diverging"].sum()) == 0
    assert float(np.max(split_r_hat(cold))) < 1.1
    assert float(np.min(effective_sample_size(cold))) > 100


def test_run_nuts_through_the_kernel_equals_the_plain_leaf(monkeypatch):
    """The same run with every leaf in the kernel and with every leaf in
    ``_leaf_plain`` on the card: the same samples, bit for bit."""
    before = nuts_cuda.LEAF.launches
    fused, info_f, _ = _recovery_run(seed=5)
    launched = nuts_cuda.LEAF.launches - before
    monkeypatch.setattr(tn, "_takes_leaf_kernel", lambda edge: False)
    plain, info_p, _ = _recovery_run(seed=5)
    assert nuts_cuda.LEAF.launches - before == launched > 0
    assert torch.equal(fused, plain)
    assert torch.equal(info_f["accept_prob"], info_p["accept_prob"])
    assert info_f["potential_calls"] == info_p["potential_calls"]


def _sharded_kw(kind: str):
    """Plain NUTS on 7 chains, or replica exchange on 3 groups of 3 (each
    padded over two ranks), D = 5."""
    C = 7 if kind == "plain" else 9
    mu = torch.arange(5, dtype=torch.float32, device=DEV) * 0.5

    def ll(u, beta=None):
        return -0.5 * ((u - mu) ** 2).sum(-1)

    def logp(u, beta=None):
        return ll(u) if beta is None else -0.5 * (u ** 2).sum(-1) + beta * ll(u)

    kw = dict(num_warmup=10, num_samples=10, max_depth=6, segment_length=5)
    if kind == "pt":
        betas = torch.as_tensor(tn.geometric_ladder(3, 0.3)).repeat(3).to(DEV)
        kw.update(data=betas, exchange=tn.ReplicaExchange(n_replicas=3, betas=betas, ll_fn=ll))
    init = torch.randn((C, 5), generator=make_generator(3)).to(DEV)
    return logp, init, kw


def _sharded_rank() -> dict:
    """A rank of a world of two sharing the card: both sharded runs."""
    from sbi_for_diffusion_models_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.default_mesh(2, "chains")
    out = {}
    for kind in ("plain", "pt"):
        logp, init, kw = _sharded_kw(kind)
        before = nuts_cuda.LEAF.launches
        s, info = pmesh.sharded_run_nuts(4, logp, init, mesh=mesh, **kw)
        out[kind] = {"samples": s.cpu().numpy(), "accept_prob": info["accept_prob"].cpu().numpy(),
                     "leaf_launches": nuts_cuda.LEAF.launches - before}
    return out


def test_sharded_run_nuts_through_the_kernel_equals_the_unsharded_run():
    """``sharded_run_nuts`` over two ranks sharing the card (gloo), each leaf
    in the kernel: the unsharded run's samples and accept probabilities, bit
    for bit, on both ranks."""
    from sbi_for_diffusion_models_tpu_torch.parallel import multihost

    nuts_cuda.LEAF.library.build()  # before the ranks load it
    ranks = multihost.launch_local(_sharded_rank, 2, (), device="cuda", backend="gloo", timeout_s=300.0)
    for kind in ("plain", "pt"):
        logp, init, kw = _sharded_kw(kind)
        s, info = tn.run_nuts(4, logp, init, **kw)
        for r, res in enumerate(ranks):
            assert res[kind]["leaf_launches"] > 0, (kind, r)
            np.testing.assert_array_equal(res[kind]["samples"], s.cpu().numpy(), err_msg=f"{kind} rank {r}")
            np.testing.assert_array_equal(res[kind]["accept_prob"], info["accept_prob"].cpu().numpy())


def test_a_leaf_launches_the_draw_and_the_kernel_alone():
    """Outside the potential (here one with no launch of its own) a leaf
    makes two device operations, ``torch.rand`` and the leaf kernel: 32
    leaves against 1 add 31 of each and nothing else."""
    C, D = 24, 5
    logp0 = torch.zeros((C,), device=DEV)
    g0 = torch.zeros((C, D), device=DEV)

    def vg(u):
        return logp0, g0  # a straight line: no chain turns or diverges

    def device_ops(depth: int) -> dict:
        u = torch.zeros((C, D), device=DEV)
        p = torch.ones((C, D), device=DEV)
        edge = torch.cat([u, p, g0, logp0[:, None]], dim=1)
        inv_mass = torch.ones((C, D), device=DEV)
        H0 = tn._kinetic(p, inv_mass)
        eps = torch.full((C,), 0.1, device=DEV)
        active = torch.ones((C,), dtype=torch.bool, device=DEV)
        gen = make_generator(0, DEV)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            warm_window()  # the profiler can miss the events at the ends of its window; spins, not counted
            out = tn._build_subtree(gen, edge, depth, torch.ones((C,), device=DEV), eps, inv_mass, H0, 6, vg,
                                    active)
            warm_window()
        assert int(out["n_leaves"].min()) == 1 << depth
        names: dict = {}
        for _, _, name in device_intervals(prof):
            if "spin" not in name:
                names[name] = names.get(name, 0) + 1
        return names

    one, many = device_ops(0), device_ops(5)
    extra = {k: many.get(k, 0) - one.get(k, 0) for k in set(one) | set(many)}
    extra = {k: v for k, v in extra.items() if v}
    assert sum(extra.values()) == 2 * 31, extra
    assert sum(v for k, v in extra.items() if "nuts_leaf_kernel" in k) == 31, extra


def test_hierarchical_run_at_64_subjects_takes_the_kernel_at_every_leaf():
    """``run_hierarchical_inference`` at S = 64 subjects (D = 330, the
    benchmark's cohort) on the flagship estimator, 4 chains x 6 rungs: one
    ``launch.leaf`` for every ``nuts.leaf`` that evaluated the density."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.models import hierarchical as th
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils import metrics

    root = Path(__file__).resolve().parents[1]
    est = load_model(str(root / "artifacts" / "models" / "mnle_10m_shifted_logt_affine.npz"), device=DEV)
    prior = build_prior_theta()
    _, x, pulses = th.simulate_hierarchical_sessions(prior, 64, 50, seed=1, hyper_shrink=1.0, device=DEV)
    metrics.enable()
    try:
        out = th.run_hierarchical_inference(est, prior, x, pulses, num_chains=4, num_warmup=3, num_samples=2,
                                            max_tree_depth=4, pt_replicas=6, seed=2, verbose=False)
    finally:
        spans, counters = metrics.drain()
    assert out["raw"].shape == (4, 2, 330) and np.isfinite(out["raw"]).all()
    leaves = {i for i, s in enumerate(spans) if s.name == "nuts.leaf"}
    evaluated = {s.parent for s in spans if s.name == "hier.density" and s.parent in leaves}
    assert counters["spans.dropped"] == 0
    assert counters.get("launch.leaf", 0) == len(evaluated) > 0
