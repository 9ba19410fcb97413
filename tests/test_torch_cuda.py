"""PyTorch port: the CUDA kernels K1, K2, K3, K2p, K3p and K4 against their
plain versions on the card, at small shapes and at the main paths' full
sizes (K1 at 4,096, 131,072 and 524,288 prior draws; K2/K3 and K2p/K3p on
the committed models at up to 115,200 session rows; K4 at the roofline
path's shape), ptxas's report of every build, and the potential's launches.
Without a CUDA device (or without nvcc to build the kernels) every test here
is skipped.
"""

import functools
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import roofline
from sbi_for_diffusion_models_tpu_torch.mnle import load_model
from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
    generate_pulse_matrix,
    n_pulses_max_from_schedule,
    pulse_schedule,
)
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, mnle_from_flax_params
from sbi_for_diffusion_models_tpu_torch.ops import _cuda, density_cuda, nuts_cuda  # noqa: F401 (every library)
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import (
    FUSED_ULPS,
    K4,
    ceiling_chain,
    ceiling_plain,
    fma_tolerance,
)
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import (
    K1,
    K1_LAST_LAUNCH,
    K1_THREADS,
    ddm_rt_choice_cuda,
    k1_launch_shape,
    k1_noise_mismatches,
)
from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference, row_check
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

import k1_fixture  # tests/k1_fixture.py
from card_common import hold_rows, ptxas_report, same_distribution, session_rows  # tests/card_common.py

pytestmark = pytest.mark.requires_cuda

DEV = torch.device("cuda", 0)
MODELS = Path(__file__).resolve().parents[1] / "artifacts" / "models"
P_MIN = 1e-3  # K1 against its plain scan in distribution


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


def _k1_trials(case: str, n: int, seed: int):
    """(theta, pulses, window keywords) of K1's checks: ``window``, n trials
    on the short window KW; ``prior``, the first n of 131,072 prior draws
    (seed 7) with their stimuli on the full window (the main path's launch
    at 4,096, groups refilling at 131,072); ``roofline``, the roofline
    path's n fixed-theta trials (``roofline.simulator_inputs``)."""
    if case == "window":
        return (*_theta_and_pulses(n, seed), KW)
    if case == "roofline":
        theta, s, n_max, spp = roofline.simulator_inputs(n, DEV)
        return theta, s, dict(n_max=n_max, steps_per_pulse=spp)
    n_max, spp = pulse_schedule()
    gen = make_generator(7, DEV)
    theta = build_prior_theta().sample(gen, (131_072,))
    s = generate_pulse_matrix(gen, 131_072, n_pulses_max_from_schedule(n_max, spp))
    return theta[:n].contiguous(), s[:n].contiguous(), dict(n_max=n_max, steps_per_pulse=spp)


K1_TRIALS = [("window", 8192), ("prior", 4096), ("prior", 131_072), ("roofline", 524_288)]


@pytest.mark.parametrize("case,n", K1_TRIALS, ids=[f"{c}-{n}" for c, n in K1_TRIALS])
def test_k1_equals_its_plain_version_without_noise_and_counts_launches(case, n):
    theta, s, kw = _k1_trials(case, n, seed=0)
    before = K1.launches
    got = ddm_rt_choice_cuda(theta, s, 1, mu_sensory=0.0, **kw)
    ref = ddm_rt_choice_scan(theta, s, 2, mu_sensory=0.0, chunk_steps=kw["steps_per_pulse"], **kw)
    assert K1.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


K1_NOISY = [("window", 4096), ("prior", 4096), ("prior", 131_072), ("roofline", 524_288)]


@pytest.mark.parametrize("case,n", K1_NOISY, ids=[f"{c}-{n}" for c, n in K1_NOISY])
def test_k1_is_deterministic_per_seed_and_differs_across_seeds(case, n):
    """With noise: the same seed gives the same bits, another seed other
    bits, and the plain scan the same distribution (chi-square on the
    choices, KS on RT per choice; p > P_MIN)."""
    theta, s, kw = _k1_trials(case, n, seed=1)
    a = ddm_rt_choice_cuda(theta, s, 5, **kw)
    b = ddm_rt_choice_cuda(theta, s, 5, **kw)
    c = ddm_rt_choice_cuda(theta, s, 6, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert set(a[:, 1].unique().tolist()) <= {0.0, 1.0, 2.0}
    p = same_distribution(a, ddm_rt_choice_scan(theta, s, 12, chunk_steps=kw["steps_per_pulse"], **kw))
    assert min(p.values()) > P_MIN, p


@pytest.mark.parametrize("collapse", [0.0, 2.0])
def test_k1_per_trial_noise_scale(collapse):
    """K1's per-trial noise-scale instances: at sigma_i = 0 the plain scan's
    bits (and the scalar launch's at 0), at sigma_i all equal to 1 the
    scalar launch's bits, and with noise other bits than at sigma_i = 1 and
    the plain scan's distribution at the same sigma_i. Then each trial's own
    sigma, with groups refilling: sigma_i is 0 or 1 at random per trial, and
    each row has the bits of the scalar launch at its own sigma with the same
    seed (the rows at 0 also the plain scan's)."""
    theta, s = _theta_and_pulses(4096, seed=2)
    kw = dict(KW, collapse_rate=collapse)
    zero, ones = torch.zeros(4096, device=DEV), torch.ones(4096, device=DEV)
    got = ddm_rt_choice_cuda(theta, s, 1, mu_sensory=zero, **kw)
    assert torch.equal(got, ddm_rt_choice_scan(theta, s, 2, mu_sensory=zero, chunk_steps=200, **kw))
    assert torch.equal(got, ddm_rt_choice_cuda(theta, s, 1, mu_sensory=0.0, **kw))
    assert torch.equal(ddm_rt_choice_cuda(theta, s, 3, mu_sensory=ones, **kw),
                       ddm_rt_choice_cuda(theta, s, 3, mu_sensory=1.0, **kw))
    sigma = 0.5 + torch.rand(4096, generator=make_generator(4, DEV), device=DEV)
    varied = ddm_rt_choice_cuda(theta, s, 3, mu_sensory=sigma, **kw)
    assert not torch.equal(varied, ddm_rt_choice_cuda(theta, s, 3, mu_sensory=ones, **kw))
    p = same_distribution(varied, ddm_rt_choice_scan(theta, s, 4, mu_sensory=sigma, chunk_steps=200, **kw))
    assert min(p.values()) > P_MIN, p

    n = 131_072
    theta, s = _theta_and_pulses(n, seed=3)
    noisy = torch.rand(n, generator=make_generator(5, DEV), device=DEV) < 0.5
    mixed = ddm_rt_choice_cuda(theta, s, 7, mu_sensory=noisy.to(torch.float32), **kw)
    assert K1_LAST_LAUNCH["blocks"] * K1_THREADS // K1_LAST_LAUNCH["G"] < n  # groups refilled
    at_one = ddm_rt_choice_cuda(theta, s, 7, mu_sensory=1.0, **kw)
    at_zero = ddm_rt_choice_cuda(theta, s, 7, mu_sensory=0.0, **kw)
    assert torch.equal(mixed[noisy], at_one[noisy])
    assert torch.equal(mixed[~noisy], at_zero[~noisy])
    assert torch.equal(mixed[~noisy], ddm_rt_choice_scan(theta, s, 8, mu_sensory=0.0, chunk_steps=200, **kw)[~noisy])
    assert (at_one != at_zero).any(1).sum() > n // 50  # the two sigmas give other rows: the check can tell them apart


@functools.lru_cache(maxsize=None)
def _k1_fixture():
    return k1_fixture.load()


def test_k1_square_root_and_sine_cosine_are_the_math_librarys():
    """K1 takes sqrtf and sincosf without their branches to inputs it never
    has; on every input the noise can give them, the bits are the same."""
    assert k1_noise_mismatches(DEV) == 0


@pytest.mark.parametrize("case", sorted(k1_fixture.CASES))
def test_k1_equals_the_parent_k1_bit_for_bit(case):
    """The fixture (tests/k1_fixture.py): the parent K1's outputs on inputs
    rebuilt from seeds, at N = 1, 31, 33, 4,096, 8,192 (with and without a
    collapsing bound), the full 16,000-step window at 4,096, and 300,000
    trials, where groups refill."""
    got = k1_fixture.run(ddm_rt_choice_cuda, k1_fixture.CASES[case], DEV).cpu().numpy()
    want = _k1_fixture()[case]
    diff = np.flatnonzero((got != want).any(1))
    assert diff.size == 0, f"{diff.size} rows differ from the parent K1, first {diff[:5].tolist()}"


@pytest.mark.parametrize("collapse", [0.0, 2.0])
@pytest.mark.parametrize("per_trial", [False, True])
def test_k1_blocks_with_their_offsets_equal_one_launch(collapse, per_trial):
    """A batch of 131,072 trials with noise launched as blocks (four equal
    ones, as four ranks of a sharded run launch them, and a ragged split),
    each with its trial offset: the rows of one launch over the batch bit for
    bit, with one noise scale and with one a trial (each instance family),
    and another output for a block launched without its offset."""
    n = 131_072
    theta, s = _theta_and_pulses(n, seed=6)
    mu = (0.5 + torch.rand(n, generator=make_generator(7, DEV), device=DEV)) if per_trial else 1.0
    kw = dict(KW, collapse_rate=collapse)

    def launch(lo, hi, offset):
        m = mu[lo:hi].contiguous() if per_trial else mu
        return ddm_rt_choice_cuda(theta[lo:hi].contiguous(), s[lo:hi].contiguous(), 9, mu_sensory=m,
                                  trial_offset=offset, **kw)

    whole = launch(0, n, 0)
    for cuts in ((0, n // 4, n // 2, 3 * n // 4, n), (0, 1, 1000, 77_777, n)):
        blocks = torch.cat([launch(lo, hi, lo) for lo, hi in zip(cuts[:-1], cuts[1:])])
        diff = torch.nonzero((blocks != whole).any(1)).reshape(-1)
        assert diff.numel() == 0, f"blocks {cuts}: {diff.numel()} rows differ, first {diff[:5].tolist()}"
    assert not torch.equal(launch(n // 2, n, 0), whole[n // 2:])


@pytest.mark.parametrize("case", ["kw_n8192_c0", "kw_n300000_c0"])
def test_k1_at_offset_zero_gives_the_parent_bits(case):
    """An explicit trial_offset of 0 is the launch the fixture was made by,
    also where groups refill."""
    got = k1_fixture.run(functools.partial(ddm_rt_choice_cuda, trial_offset=0), k1_fixture.CASES[case], DEV)
    assert np.array_equal(got.cpu().numpy(), _k1_fixture()[case])


def test_k1_rejects_an_offset_past_its_32_bit_counter():
    theta, s = _theta_and_pulses(16)
    with pytest.raises(ValueError, match="32-bit"):
        ddm_rt_choice_cuda(theta, s, 1, trial_offset=2**32 - 8, **KW)


def _k1_capacity(collapse):
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import _card_capacity

    return _card_capacity(DEV, collapse)


@pytest.mark.parametrize("case", ["kw_n8192_c0", "kw_n8192_c2"])
def test_k1_every_launch_shape_gives_the_parent_bits(case):
    """For every launch shape the rule picks as N grows from 8,192 (on the
    H100: G = 8 with a group for every trial, then G = 8, 2 and 1 with
    groups that refill), the smallest N that lands in it: the first 8,192
    trials equal the fixture's (a trial's output does not depend on N), and
    the wrapper records the shape it launched."""
    c = k1_fixture.CASES[case]
    sm, resident = _k1_capacity(c["collapse_rate"] != 0.0)
    spp = k1_fixture.KW["steps_per_pulse"]
    first = {}
    for n in sorted({int(8192 * 1.25**i) for i in range(40)} | {8192}):
        G, blocks = k1_launch_shape(n, spp, sm, resident)
        first.setdefault((G, blocks * K1_THREADS // G >= n), (n, blocks))  # (G, a group for every trial?)
    assert len(first) >= 3, first
    want = _k1_fixture()[case]
    for (G, whole), (n, blocks) in sorted(first.items()):
        got = k1_fixture.run(ddm_rt_choice_cuda, c, DEV, n=n)[:8192].cpu().numpy()
        assert K1_LAST_LAUNCH == {"n": n, "G": G, "blocks": blocks}
        diff = np.flatnonzero((got != want).any(1))
        assert diff.size == 0, f"N={n} (G={G}, refill={not whole}): {diff.size} rows differ, first {diff[:5].tolist()}"


def test_k1_two_launches_in_a_row_give_the_same_bits_when_groups_refill():
    """The refill counter is zeroed before every launch: a second launch at
    a refilling N, on the same stream right after the first, repeats it."""
    c = k1_fixture.CASES["kw_n300000_c0"]
    sm, resident = _k1_capacity(False)
    G, blocks = k1_launch_shape(c["n"], k1_fixture.KW["steps_per_pulse"], sm, resident)
    assert blocks * K1_THREADS // G < c["n"], "300,000 trials no longer refill on this card"
    before = K1.launches
    a = k1_fixture.run(ddm_rt_choice_cuda, c, DEV)
    b = k1_fixture.run(ddm_rt_choice_cuda, c, DEV)
    assert K1.launches == before + 2
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.cpu().numpy(), _k1_fixture()["kw_n300000_c0"])


def _small_estimator(**kw):
    cfg = MNLEConfig(**{**dict(condition_dim=9, hidden_features=32, num_transforms=4, num_bins=8), **kw})
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


def _committed_rows(model: str, n: int):
    """The committed ``model``'s packed weights, its first n session rows as
    the posterior potential builds them (``card_common.session_rows``: 1,200
    a session) and a cotangent."""
    est = load_model(str(MODELS / f"{model}.npz"), device=DEV)
    rows = session_rows(est, build_prior_theta(), DEV, -(-n // 1200))
    g = torch.randn((n,), generator=torch.Generator(DEV).manual_seed(5), device=DEV)
    return mc.pack_mnle_weights(est), tuple(a[:n].contiguous() for a in rows), g


def _flagship_like_rows(n, seed=0):
    gen = torch.Generator(DEV).manual_seed(seed)
    t = 2.0 * torch.randn((n,), generator=gen, device=DEV)
    ctx = torch.randn((n, 9), generator=gen, device=DEV)
    oh = torch.nn.functional.one_hot(torch.randint(0, 3, (n,), generator=gen, device=DEV), 3).float()
    g = torch.randn((n,), generator=gen, device=DEV)
    return (t, oh, ctx), g


# The committed models at the paths' row counts: the flagship's serving call and the calibrated preset's SBC
# datasets in one launch, the tail-sharp model's serving call and SBC fold, the roofline path's rows on its model.
K2K3_COMMITTED = [("mnle_10m_shifted_logt_affine", 1200), ("mnle_10m_shifted_logt_affine", 115_200),
                  ("mnle_10m_shifted_logt_sharp", 1200), ("mnle_10m_shifted_logt_sharp", 9600),
                  ("mnle_1m_censor", 65_536)]
K2K3_VARIANTS = {"log": {}, "censor_affine": dict(censor_rt=True, cond_affine=True)}
K2K3_CASES = [(v, n) for n in (1000, 1, 7, 8, 9, 15, 16, 17, 1199, 1200, 1201) for v in K2K3_VARIANTS] + K2K3_COMMITTED


@pytest.mark.parametrize("variant,n", K2K3_CASES, ids=[f"{v}-{n}" for v, n in K2K3_CASES])
def test_k2_k3_match_their_plain_versions(variant, n):
    """K2 and K3 against the plain version in float64, row by row, K3's
    value K2's bit for bit (``hold_rows``): on a small random estimator at
    row counts on either side of their 8-row tiles, where also every row's
    value is within its allowance, and on a committed model's session rows."""
    if variant in K2K3_VARIANTS:
        w, (rows, g) = mc.pack_mnle_weights(_small_estimator(**K2K3_VARIANTS[variant])), _flagship_like_rows(n)
    else:
        w, rows, g = _committed_rows(variant, n)
    _, checks = hold_rows(w, rows, g)
    if variant in K2K3_VARIANTS:
        assert not bool(checks[0].over.any()), checks[0]


def test_wrappers_reject_wrong_dtypes():
    est = _small_estimator()
    w = mc.pack_mnle_weights(est)
    t = torch.zeros((4,), device=DEV, dtype=torch.float64)
    with pytest.raises(ValueError):
        mc.rows_logp(t, torch.zeros((4, 3), device=DEV), torch.zeros((4, 9), device=DEV), w)


def _pulse_rows(n, seed=1):
    """n rows of the small pulse-grid model; row i is special by i % 5:
    the phase at either clip edge, the slot index past the last slot or
    below the first (int(kv) outside [0, NS)), or a censored choice."""
    gen = torch.Generator(DEV).manual_seed(seed)
    phi = torch.rand((n,), generator=gen, device=DEV)
    ctx = torch.randn((n, 9), generator=gen, device=DEV)
    choice = torch.randint(0, 3, (n,), generator=gen, device=DEV)
    k = torch.randint(0, 80, (n,), generator=gen, device=DEV)
    i = torch.arange(n, device=DEV) % 5
    phi = torch.where(i == 0, 1e-6, torch.where(i == 1, 1.0 - 1e-6, phi))
    k = torch.where(i == 2, 80, torch.where(i == 3, -1, k))
    choice = torch.where(i == 4, 2, choice)  # the censored category
    oh = torch.nn.functional.one_hot(choice, 3).float()
    ang = 2 * np.pi * torch.rand((n,), generator=gen, device=DEV)
    kf = torch.stack([(k + 0.5) / 80, torch.sin(ang), torch.cos(ang)], -1).contiguous()
    g = torch.randn((n,), generator=gen, device=DEV)
    return (phi.contiguous(), oh, ctx, kf, k.float()), g


K2PK3P_CASES = [("small", n) for n in (1000, 1, 7, 8, 9, 17, 1201)] + [("mnle_1m_pulseabs", 1200),
                                                                        ("mnle_1m_pulseabs", 115_200)]


@pytest.mark.parametrize("model,n", K2PK3P_CASES, ids=[f"{m}-{n}" for m, n in K2PK3P_CASES])
def test_k2p_k3p_match_their_plain_versions(model, n):
    """K2p/K3p against the plain version in float64, row by row, K3p's value
    K2p's bit for bit (``hold_rows``), and autograd through the fused
    Function gives K3p's phase gradient: on a small pulse-grid model at row
    counts on either side of their 8-row tiles, with censored rows, phases at
    the clip edges and slot indices outside the slots, where also every
    row's value and each of the first five rows (one of each special kind)
    is within its allowance; on the committed pulse-grid model's session
    rows."""
    if model == "small":
        est = _small_estimator(rt_rep="pulse", censor_rt=True)
        assert est.device.type == "cuda" and est.cfg.censored_category == 2
        w, (rows, g) = mc.pack_mnle_weights(est), _pulse_rows(n)
    else:
        w, rows, g = _committed_rows(model, n)
    kern, checks = hold_rows(w, rows, g)
    if model == "small":
        assert not bool(checks[0].over.any()), checks[0]
        assert not any(bool(c.over[:5].any()) for c in checks), checks
    phi_ = rows[0].clone().requires_grad_(True)
    out = mc.FusedPulseRowsLogProb.apply(phi_, *rows[1:], w)
    (dphi,) = torch.autograd.grad(out, phi_, grad_outputs=g)
    torch.testing.assert_close(dphi, kern[2], rtol=0, atol=0)


def test_k3p_rejects_more_than_32_bins():
    """K2p and K3p hold a spline's bins on the lanes of one warp: 33 bins
    raise, with no fallback to the plain version."""
    est = _small_estimator(rt_rep="pulse", censor_rt=True, num_bins=33)
    w = mc.pack_mnle_weights(est)
    rows, g = _pulse_rows(16)
    before = (mc.K2P.launches, mc.K3P.launches)
    with pytest.raises(ValueError, match="num_bins=33"):
        mc.rows_logp_pulse_vjp(*rows, w, g)
    with pytest.raises(ValueError, match="num_bins=33"):
        mc.rows_logp_pulse(*rows, w)
    assert (mc.K2P.launches, mc.K3P.launches) == before


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1199, 1200, 1201])
@pytest.mark.parametrize("rep", ["censor_affine", "pulse"])
def test_forward_kernel_value_row_by_row_and_backward_value_bit_equal(rep, n):
    """K2 (K2p) on a small censored model against the plain version in
    float64, row by row (``ops/rowcheck.py``: 1e-4 x max(1, |ref|) plus
    twice the row's float32 spread on steep rows, on all but 0.1 % of the
    rows, the worst row within its limit), at counts on either side of the
    8-row tiles; the value K3 (K3p) writes beside its gradients has K2's
    (K2p's) bits on every row."""
    if rep == "pulse":
        est = _small_estimator(rt_rep="pulse", censor_rt=True)
        rows, g = _pulse_rows(n)
        fwd, both, plain, K_fwd, K_bwd = mc.rows_logp_pulse, mc.rows_logp_pulse_and_vjp, mc.rows_logp_pulse_plain, \
            mc.K2P, mc.K3P
        continuous = (2, 3)
    else:
        est = _small_estimator(censor_rt=True, cond_affine=True)
        rows, g = _flagship_like_rows(n)
        fwd, both, plain, K_fwd, K_bwd = mc.rows_logp, mc.rows_logp_and_vjp, mc.rows_logp_plain, mc.K2, mc.K3
        continuous = (2,)
    w = mc.pack_mnle_weights(est)
    w64 = w.astype(torch.float64)
    before = (K_fwd.launches, K_bwd.launches)
    val = fwd(*rows, w)
    val_bwd = both(*rows, w, g)[0]
    assert (K_fwd.launches, K_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert val.shape == (n,) and torch.equal(val_bwd, val)
    (ref,), (spread,) = reference(lambda *a: (plain(*a[:-1], w64),), rows, g, continuous)
    c = row_check(val, plain(*rows, w), ref, spread, value=True)
    assert c.ok, c


# Written and held to JAX on the CPU by tests/test_torch_mnle.py.
K3P_JAX_REFERENCE = Path(__file__).with_name("data") / "k3p_pulse_jax_vjp.npz"


@functools.lru_cache(maxsize=None)
def _k3p_jax_reference():
    """The small "pulse_abs" estimator's weights on the card, its 1,201 rows
    and cotangent, ``jax.vjp``'s gradients of the JAX row function
    ``_rows_logp_pulse`` on them, and each row's float32 spread (the plain
    version in float64, ``ops/rowcheck.py``)."""
    est = load_model(str(K3P_JAX_REFERENCE), device=DEV)
    with np.load(K3P_JAX_REFERENCE) as data:
        rows = [torch.from_numpy(data[f"row:{k}"]).to(DEV) for k in ("phi", "onehot", "ctx", "kf", "kv", "g")]
        refs = [data[f"jax:{k}"].astype(np.float64) for k in ("dphi", "dctx", "dkf")]
    w = mc.pack_mnle_weights(est)
    w64 = w.astype(torch.float64)
    _, spreads = reference(lambda *a: mc.rows_logp_pulse_vjp_plain(*a[:-1], w64, a[-1]), rows[:5], rows[5], (2, 3))
    return w, rows, refs, [a.cpu().numpy() for a in spreads]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 1000, 1201])
def test_k3p_matches_jax_vjp_at_ragged_row_counts(n):
    """K3p itself against ``jax.vjp`` of the JAX row function on the same
    weights and rows as ``tests/test_torch_mnle.py`` holds its plain version
    to, at counts on either side of its 8-row tiles, with censored rows,
    phases at the clip edges and slot indices outside the slots: row by row
    to 1e-4 of max(1, the row's largest |ref|) plus twice the row's spread
    (the allowance rule of ``ops/rowcheck.py``)."""
    w, rows, refs, spreads = _k3p_jax_reference()
    rows = [a[:n].contiguous() for a in rows]
    before = mc.K3P.launches
    grads = mc.rows_logp_pulse_vjp(*rows[:5], w, rows[5])
    assert mc.K3P.launches == before + 1
    assert [tuple(a.shape) for a in grads] == [(n,), (n, 9), (n, 3)]
    censored = (rows[1][:, 2] > 0).cpu().numpy()
    for got, want, spread, what in zip(grads, refs, spreads, ("dphi", "dctx", "dkf")):
        got = got.cpu().numpy().astype(np.float64)
        if what != "dctx":
            assert not got[censored].any(), f"{what}: a censored row has a gradient"
        err = np.abs(got - want[:n]).reshape(n, -1).max(1)
        allow = 1e-4 * np.maximum(1.0, np.abs(want[:n]).reshape(n, -1).max(1)) + 2.0 * spread[:n]
        assert (err <= allow).all(), f"{what}: worst row {int((err / allow).argmax())} at {float((err / allow).max()):.3f}"


# The JAX row function's value on the rows of K3P_JAX_REFERENCE; written and
# held to JAX on the CPU by tests/test_torch_mnle.py.
K2P_JAX_VALUE = Path(__file__).with_name("data") / "k2p_pulse_jax_value.npz"


@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 1000, 1201])
def test_k2p_and_k3p_values_match_jax_at_ragged_row_counts(n):
    """K2p's value, and the value K3p writes beside its gradients, against
    the JAX row function ``_rows_logp_pulse``'s value on the rows of
    ``K3P_JAX_REFERENCE`` (censored rows, phases at the clip edges, slot
    indices outside the slots): row by row to 1e-4 of max(1, |ref|) plus
    twice the row's float32 spread (the allowance rule of
    ``ops/rowcheck.py``), and K3p's value is K2p's bit for bit."""
    w, rows, _, _ = _k3p_jax_reference()
    rows = [a[:n].contiguous() for a in rows]
    with np.load(K2P_JAX_VALUE) as data:
        want = data["jax:value"][:n].astype(np.float64)
    w64 = w.astype(torch.float64)
    (_,), (spread,) = reference(lambda *a: (mc.rows_logp_pulse_plain(*a[:-1], w64),), rows[:5], rows[5], (2, 3))
    val = mc.rows_logp_pulse(*rows[:5], w)
    val_bwd = mc.rows_logp_pulse_and_vjp(*rows[:5], w, rows[5])[0]
    assert torch.equal(val_bwd, val)
    got = val.cpu().numpy().astype(np.float64)
    err = np.abs(got - want)
    allow = 1e-4 * np.maximum(1.0, np.abs(want)) + 2.0 * spread.cpu().numpy()
    assert (err <= allow).all(), f"worst row {int((err / allow).argmax())} at {float((err / allow).max()):.3f}"


@pytest.mark.parametrize("model", ["mnle_10m_shifted_logt_affine.npz", "mnle_1m_pulseabs.npz"])
def test_potential_gradient_call_launches_the_backward_kernel_alone(model, monkeypatch):
    """``log_lik_and_grad`` on the card with a committed model: a gradient
    call launches K3 (K3p) once and K2 (K2p) never, a value-only call K2
    (K2p) once and K3 (K3p) never, and both give the same log-likelihood."""
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood

    monkeypatch.setenv("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    est = load_model(model, device=DEV)
    fwd, bwd = (mc.K2P, mc.K3P) if est.cfg.rt_rep == "pulse" else (mc.K2, mc.K3)
    gen = make_generator(4, DEV)
    rng = np.random.default_rng(4)
    pulses = torch.as_tensor(np.where(rng.random((50, 80)) < 0.5, 1.0, -1.0), dtype=torch.float32, device=DEV)
    x = torch.as_tensor(np.stack([0.15 + rng.gamma(2.0, 0.4, 50), rng.integers(0, 3, 50)], -1),
                        dtype=torch.float32, device=DEV)
    theta = build_prior_theta().sample(gen, (24,))
    lik = ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas")
    for need_grad in (True, False):
        before = (fwd.launches, bwd.launches)
        ll, g = lik.log_lik_and_grad(x, theta, need_grad=need_grad)
        torch.cuda.synchronize()
        assert (fwd.launches - before[0], bwd.launches - before[1]) == ((0, 1) if need_grad else (1, 0))
        assert ll.shape == (24,) and bool(torch.isfinite(ll).all())
        assert (g is not None) == need_grad
        if need_grad:
            ll_grad = ll
            assert g.shape == (24, 5) and bool(torch.isfinite(g).all())
    torch.testing.assert_close(ll, ll_grad, rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _roofline_report() -> dict:
    """The roofline entry point's report (``roofline.main``: K4's two issue
    ceilings at (64, 256, 128) elements and chains of 2^14 and 2^17, then K1
    and K2 against them), once a process: the report it writes equals the one
    it returns, and K4, K1 and K2 launched."""
    kernels = (K4, K1, mc.K2)
    before = [k.launches for k in kernels]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "roofline_h100.json"
        report = roofline.main(["--out", str(out)])
        assert json.loads(out.read_text()) == report
    assert all(k.launches > b for k, b in zip(kernels, before)), [k.name for k in kernels]
    return report


def _k4_case(case, kind: str):
    """(values, chain lengths, the length at which the plain float32 chain
    also runs on every value) of a case: values in [0.25, 1) at the case's
    shape, one length. At the roofline path's shape, its measured ceiling is
    first held within (0, 105 %] of the datasheet's FMA rate (above it the
    chain was folded or the timing is wrong); then its elements of 0.5 at
    both of its lengths, the plain chain at the longer for fma and the
    shorter for transcendental."""
    if case == "roofline":
        r = _roofline_report()[f"issue_{kind}"]
        assert 0.0 < r["share_of_datasheet_fma"] <= 1.05, r
        x = torch.full((64, 256, 128), 0.5, dtype=torch.float32, device=DEV)
        assert r["elements"] == x.numel()
        return x, (r["K_lo"], r["K_hi"]), r["K_hi"] if kind == "fma" else r["K_lo"]
    shape, K = case
    return torch.rand(shape, generator=torch.Generator(DEV).manual_seed(3), device=DEV) * 0.75 + 0.25, (K,), K


# (elements, chain length): 12,345 values (not a multiple of the 256-thread block), a (4, 64, 128) block at a
# short and a long chain, and the roofline path's shape and chains.
K4_CASES = [((12_345,), 1024), ((4, 64, 128), 64), ((4, 64, 128), 1024), "roofline"]


@pytest.mark.parametrize("case", K4_CASES, ids=["12345-1024", "4x64x128-64", "4x64x128-1024", "roofline"])
@pytest.mark.parametrize("kind", ["fma", "transcendental"])
def test_k4_matches_its_plain_version_in_float64(kind, case):
    """K4 at each case's elements and chain lengths (``_k4_case``), one
    launch a chain, against the plain version in float64 on each distinct
    value: the fma chain within one rounding a step (``fma_tolerance``),
    which the chain's own movement must exceed, and within FUSED_ULPS of the
    plain chain rounded once a step; the transcendental chain within 8
    float32 ulps of the value (it contracts towards a fixed point, so only
    the last turn's special functions count). Against the plain float32
    chain within both sides' roundings: three for fma (the kernel rounds
    once a step, the plain version twice), 16 ulps for transcendental."""
    x, lengths, plain_at = _k4_case(case, kind)
    values, inverse = torch.unique(x, return_inverse=True)  # the roofline's elements are all one value
    for K in lengths:
        before = K4.launches
        got = ceiling_chain(x, K, kind)
        assert K4.launches == before + 1 and got.shape == x.shape and got.dtype == torch.float32
        exact = ceiling_plain(values.double(), K, kind)[inverse]
        if kind == "fma":
            tol, plain_tol = fma_tolerance(K, exact.abs()), fma_tolerance(K, exact.abs(), roundings=3)
            assert bool(((exact - x).abs() > tol).all())  # the chain moved every value by more than that
            # One rounding a step, as the plain chain's fused route rounds: a turn short or long is ~17 ulps away.
            fused = ceiling_plain(values, K, kind, fused=True)[inverse]
            assert bool(((got - fused).abs() <= FUSED_ULPS * 2.0**-24).all())
        else:
            tol = torch.full_like(exact, 8 * 2.0**-23)
            plain_tol = 2 * tol
        assert bool(((got.double() - exact).abs() <= tol).all())
        if K == plain_at:
            assert bool(((got.double() - ceiling_plain(x, K, kind).double()).abs() <= plain_tol).all())
    assert torch.equal(ceiling_chain(x, 7, kind), x)  # no turn: a copy


def test_every_kernel_builds_without_spilling_registers():
    """What ptxas said of every build, as the build keeps it beside each
    library (``card_common.ptxas_report``): K1's twelve instances, one build
    of each fused kernel, of the leaf kernel and of the density pair's two,
    and no spill in any of them."""
    _cuda.build_all()
    report = ptxas_report()
    builds = {"ddm_rt_choice_kernel": 12, "mnle_logprob_fwd_kernel": 1, "mnle_logprob_bwd_kernel": 1,
              "mnle_pulse_fwd_kernel": 1, "mnle_pulse_bwd_kernel": 1, "nuts_leaf_kernel": 1, "density_pre_kernel": 1,
              "density_post_kernel": 1}
    found = {name: {e: v for e, v in report.items() if name in e} for name in builds}
    assert {name: len(v) for name, v in found.items()} == builds, sorted(report)
    spills = {e: r for entries in found.values() for e, r in entries.items()
              if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    assert not spills, spills
