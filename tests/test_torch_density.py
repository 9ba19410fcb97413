"""PyTorch port: the u-space density's kernel pair (``ops/density_cuda.py``,
``csrc/udensity.cu``) on the CPU. The tables it reads from the priors the
port builds (the flagship's ``MultipleIndependent``, a ``BoxUniform``, a
``Normal`` and an interleaved ``MultipleIndependent``), its refusals, and
``tempered_value_and_grad`` on CPU tensors taking the plain composition, bit
for bit. The kernels themselves run only on the card
(``tests/test_torch_cuda_density.py``)."""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import distributions as td
from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import potentials as tp
from sbi_for_diffusion_models_tpu_torch.ops import density_cuda
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

MODELS = os.path.join(os.path.dirname(__file__), "..", "artifacts", "models")
L = np.float32(0.5 * math.log(2.0 * math.pi))


def _f32(v):
    return np.float32(v)


def _interleaved():
    """[Uniform, Beta, Normal, LogNormal, Beta]: MultipleIndependent keeps
    Uniform and Normal where they are and merges the Betas after them."""
    return td.MultipleIndependent([td.Uniform(-1.0, 3.0), td.Beta(2.0, 5.0), td.Normal(0.5, 2.0),
                                   td.LogNormal(0.3, 0.7), td.Beta(1.5, 1.2)])


def _tables(prior):
    return density_cuda.DensityTables(prior, td.mcmc_transform(prior))


def test_tables_of_the_flagship_prior():
    """build_prior_theta(): the Betas (columns 0 and 4) and the LogNormals
    (1, 2, 3) merged into one group each, summed from 0.0 in that order;
    interval supports on (0, 1) for the Betas, positive for the LogNormals."""
    t = _tables(build_prior_theta())
    assert (t.D, t.G, t.zero_start) == (5, 2, 1)
    assert t.order == [0, 4, 1, 2, 3] and t.group_start == [0, 2, 5]
    assert t.family == [2, 3, 3, 3, 2]
    assert t.code == [2, 1, 1, 1, 2]
    k = t.k
    np.testing.assert_array_equal(k[:, 0], [0, 0, 0, 0, 0])  # lo
    np.testing.assert_array_equal(k[:, 1], [1, 1, 1, 1, 1])  # span (1 where the support has none)
    np.testing.assert_array_equal(k[:, 2], [0, 0, 0, 0, 0])  # log span
    log_beta = torch.lgamma(torch.tensor(2.0)) * 2 - torch.lgamma(torch.tensor(4.0))
    for d in (0, 4):
        np.testing.assert_array_equal(k[d, 3:], [1.0, 1.0, log_beta.item(), 0.0])
    for d, (mu, sigma) in zip((1, 2, 3), ((-1.0, 1.0), (0.0, 1.0), (2.75, 0.5))):
        np.testing.assert_array_equal(k[d, 3:], [_f32(mu), _f32(sigma), torch.log(torch.tensor(sigma)).item(), L])
    assert t.ints().tolist() == t.code + t.family + t.group_start + t.order


def test_tables_of_a_box_uniform_and_a_normal():
    box = _tables(td.BoxUniform([0.1, -2.0, 0.0], [0.9, 2.0, 5.0]))
    assert (box.D, box.G, box.zero_start) == (3, 1, 0)
    assert box.order == [0, 1, 2] and box.group_start == [0, 3]
    assert box.family == [0, 0, 0] and box.code == [2, 2, 2]
    np.testing.assert_array_equal(box.k[:, 0], np.float32([0.1, -2.0, 0.0]))
    np.testing.assert_array_equal(box.k[:, 1], np.float32([0.9 - 0.1, 4.0, 5.0]))
    np.testing.assert_array_equal(box.k[:, 2], np.float32([math.log(0.9 - 0.1), math.log(4.0), math.log(5.0)]))
    np.testing.assert_array_equal(box.k[:, 3:6], np.float32([[0.1, 0.9, -math.log(0.8)], [-2.0, 2.0, -math.log(4.0)],
                                                             [0.0, 5.0, -math.log(5.0)]]))

    normal = _tables(td.Normal([0.0, 1.5], [1.0, 0.25]))
    assert (normal.D, normal.G, normal.zero_start) == (2, 1, 0)
    assert normal.family == [1, 1] and normal.code == [0, 0]
    for d, (mu, sigma) in enumerate(((0.0, 1.0), (1.5, 0.25))):
        s = _f32(sigma)
        # -log sigma - log sqrt(2 pi) and sigma^2, each rounded once in float32, as the plain path rounds them.
        np.testing.assert_array_equal(normal.k[d, 3:], [_f32(mu), s, np.float32(-_f32(math.log(sigma))) - L, s * s])


def test_tables_of_an_interleaved_multiple_independent():
    t = _tables(_interleaved())
    assert (t.D, t.G, t.zero_start) == (5, 4, 1)
    # MultipleIndependent's own order: Uniform, Normal (unmerged, in place), then the merged Betas, the LogNormal.
    assert t.order == [0, 2, 1, 4, 3] and t.group_start == [0, 1, 2, 4, 5]
    assert t.family == [0, 2, 1, 3, 2]
    assert t.code == [2, 2, 0, 1, 2]
    np.testing.assert_array_equal(t.k[0, :6], np.float32([-1.0, 4.0, math.log(4.0), -1.0, 3.0, -math.log(4.0)]))
    a, b = torch.tensor([2.0, 1.5]), torch.tensor([5.0, 1.2])
    log_beta = (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)).tolist()
    am1, bm1 = (a - 1.0).tolist(), (b - 1.0).tolist()  # float32(1.2) - 1, not 0.2
    np.testing.assert_array_equal(t.k[1, 3:6], np.float32([am1[0], bm1[0], log_beta[0]]))
    np.testing.assert_array_equal(t.k[4, 3:6], np.float32([am1[1], bm1[1], log_beta[1]]))
    # LogNormal's log sigma is float32 log of float32 sigma.
    np.testing.assert_array_equal(t.k[3, 3:], [_f32(0.3), _f32(0.7), torch.log(torch.tensor(0.7)).item(), L])


class _Gamma(td.Distribution):
    event_shape = (1,)

    def supports(self):
        return [td.positive_support()]


@pytest.mark.parametrize("prior", [
    _Gamma(),
    td.MultipleIndependent([td.Beta(2.0, 2.0), _Gamma()]),
    td.MultipleIndependent([td.Beta(2.0, 2.0), td.MultipleIndependent([td.Normal(0.0, 1.0)])]),
    td.BoxUniform([0.0] * 128, [1.0] * 128),
], ids=["other family", "other family inside", "nested", "D 128"])
def test_the_tables_refuse_what_the_kernel_does_not_take(prior):
    with pytest.raises(ValueError):
        _tables(prior)


def test_building_the_pair_on_a_card_raises_for_an_unsupported_prior():
    """The pair is built with ``vg`` for a likelihood on a card, so an
    unsupported prior raises there; on the CPU nothing is built."""
    prior = td.MultipleIndependent([td.Beta(2.0, 2.0), _Gamma()])
    bij = td.mcmc_transform(prior)
    tp.tempered_value_and_grad(prior, bij, SimpleNamespace(local_theta=torch.zeros((3, 2))))
    with pytest.raises(ValueError, match="Uniform, Normal, Beta and LogNormal"):
        tp.tempered_value_and_grad(prior, bij, SimpleNamespace(local_theta=SimpleNamespace(is_cuda=True)))


def _composition_as_before(prior, bij, likelihood, temperature, u, x, beta, need_grad, sessions=None):
    """``tempered_value_and_grad``'s ``vg`` body before the kernel pair,
    verbatim."""
    theta, dtheta, log_det, dlog_det = bij.forward_and_grads(u)
    lp, g_lp = prior.log_prob_and_grad(theta)
    ll, g_ll = likelihood.log_lik_and_grad(x, theta, need_grad, sessions=sessions)
    beta_t = beta / temperature
    value = lp + log_det + beta_t * ll
    if not need_grad:
        return value, None
    return value, (g_lp + beta_t[:, None] * g_ll) * dtheta + dlog_det


def _bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def flagship_likelihood():
    est = tmnle.load_model(os.path.join(MODELS, "mnle_10m_shifted_logt_affine.npz"), device="cpu")
    rng = np.random.default_rng(3)
    choice = rng.choice([0.0, 1.0, 2.0], 20, p=[0.45, 0.4, 0.15])
    rt = np.where(choice == 2.0, 8.0, 0.2 + rng.gamma(2.0, 0.3, 20))
    x = torch.tensor(np.stack([rt, choice], -1), dtype=torch.float32)
    pulses = torch.tensor(np.where(rng.random((20, 80)) < 0.5, 1.0, -1.0), dtype=torch.float32)
    return tp.ConditionedMNLELogLikelihood(est, pulses, logprob_kernel="pallas"), x


@pytest.mark.parametrize("prior_name", ["flagship", "interleaved"])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_vg_on_the_cpu_is_the_plain_composition_bit_for_bit(flagship_likelihood, prior_name, temperature,
                                                             monkeypatch):
    """On CPU tensors ``vg`` builds no kernel and takes the plain
    composition: the same bits as the composition before the pair, with
    and without the gradient, at rung betas below 1."""
    lik, x = flagship_likelihood
    prior = build_prior_theta() if prior_name == "flagship" else _interleaved()
    bij = td.mcmc_transform(prior)
    monkeypatch.setattr(density_cuda, "UDensity", None)  # building the pair here would fail
    vg = tp.tempered_value_and_grad(prior, bij, lik, temperature)
    gen = torch.Generator().manual_seed(11)
    theta = prior.sample(gen, (12,))
    theta[:, 4] = theta[:, 4] * 0.2  # t_nd well under the session's RTs
    u = bij.inverse(theta)
    beta = torch.tensor(np.geomspace(1.0, 0.04, 6), dtype=torch.float32).repeat(2)
    for need_grad in (True, False):
        got = vg(u, x, beta, need_grad)
        want = _composition_as_before(prior, bij, lik, temperature, u, x, beta, need_grad)
        assert _bits_equal(got[0], want[0])
        assert torch.isfinite(got[0]).all()
        if need_grad:
            assert _bits_equal(got[1], want[1])
        else:
            assert got[1] is None
