"""The port's span and counter recorder (``utils/metrics.py``) on the CPU:
off by default, the spans of the sampler and of training where the work
happens, the kernels' launch counters, samples unchanged by recording, the
bounded buffer, spans cut by an exception, the clock of ``torch.profiler``,
and the card's idle time put down to the spans."""

import types

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch import run_config as trc
from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
from sbi_for_diffusion_models_tpu_torch.utils import metrics

CALLERS = {"nuts.leaf", "move.grid_hop", "move.dim_slice", "nuts.exchange", "nuts.init"}


@pytest.fixture(autouse=True)
def no_recording_left():
    torch.set_num_threads(1)
    yield
    metrics.drain()


def _gauss_vg(u, need_grad=True):
    logp = -0.5 * (u * u).sum(-1)
    return logp, (-u if need_grad else None)


def _small_nuts(seed=3, vg=_gauss_vg):
    return tn.run_nuts(seed, lambda u: _gauss_vg(u)[0], torch.zeros(4, 2), num_warmup=6, num_samples=6, max_depth=3,
                       value_and_grad_fn=vg)


def _tiny_session_run(pulse: bool, record: bool = False):
    """The calibrated sampler stack (PT, grid hop, t_nd slice) over a tiny
    random estimator, every row through the kernels' dispatchers (their
    plain versions on the CPU), with the recorder on around the sampler if
    ``record``: (samples, info, potential calls by need_grad)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    kind = dict(rt_rep="pulse") if pulse else dict(rt_rep="shifted_log", log_condition_dims=(1, 2, 3), cond_affine=True)
    est = build_mnle(0, MNLEConfig(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=4, censor_rt=True,
                                   **kind), device="cpu")
    est.net.requires_grad_(False)
    x_o, p_o = simulate_observed_session(np.array([0.5, 0.3, 1.2, 10.0, 0.2], np.float32), 10, seed=1, device="cpu")
    rc = trc.CALIBRATED_CONFIG.replace(WARMUP_STEPS=4, POSTERIOR_SAMPLES=8, NUM_CHAINS=2, MCMC_PT_REPLICAS=2,
                                       MCMC_MAX_TREE_DEPTH=3, MNLE_LOGPROB_KERNEL="pallas")
    calls = {"grad": 0, "value": 0}
    real_grad, real_fn = ConditionedMNLELogLikelihood.log_lik_and_grad, ConditionedMNLELogLikelihood.log_lik_fn

    def log_lik_and_grad(lik, x, theta, need_grad=True, sessions=None):
        calls["grad" if need_grad else "value"] += 1
        return real_grad(lik, x, theta, need_grad, sessions)

    def log_lik_fn(lik, params, x, theta, sessions=None):
        calls["value"] += 1
        return real_fn(lik, params, x, theta, sessions)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ConditionedMNLELogLikelihood, "log_lik_and_grad", log_lik_and_grad)
        mp.setattr(ConditionedMNLELogLikelihood, "log_lik_fn", log_lik_fn)
        if record:
            metrics.enable()
        samples, info = tmnle.run_inference_mcmc(rc, build_prior_theta(), est, x_o, p_o, seed=0, return_info=True,
                                                 verbose=False)
    return samples, info, calls


def _assert_nested(spans):
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.run == s.run


def test_off_by_default_records_nothing():
    assert metrics.RECORDING is False
    _small_nuts()
    assert metrics.drain() == ([], {})


@pytest.mark.parametrize("pulse", [False, True], ids=["shifted_log", "pulse"])
def test_potential_spans_name_their_caller_and_launches_match_the_calls(pulse):
    """Every ``potential`` span sits in a leaf, a move, the exchange sweep or
    the run's set-up; there are as many as ``potential_calls``; and each
    kernel's dispatcher counted one launch a call of its kind."""
    _, info, calls = _tiny_session_run(pulse, record=True)
    spans, counters = metrics.drain()
    _assert_nested(spans)
    potentials = [s for s in spans if s.name == "potential"]
    assert len(potentials) == info["potential_calls"] == calls["grad"] + calls["value"]
    assert {spans[s.parent].name for s in potentials} == CALLERS
    assert {s.name for s in spans} == CALLERS | {"potential", "nuts.transition", "wait"}
    assert len({s.run for s in spans}) == 1
    grad, value = ("launch.k3p", "launch.k2p") if pulse else ("launch.k3", "launch.k2")
    launches = {k: v for k, v in counters.items() if k.startswith("launch.")}
    assert launches == {grad: calls["grad"], value: calls["value"]}
    assert counters["spans.dropped"] == counters["spans.cut"] == 0


def test_recording_changes_no_sample():
    off = _tiny_session_run(False)
    on = _tiny_session_run(False, record=True)
    assert metrics.drain()[0]
    assert torch.equal(on[0], off[0])
    for k in ("accept_prob", "num_steps", "diverging", "step_size", "inv_mass"):
        assert torch.equal(on[1][k], off[1][k]), k
    assert on[1]["swap_accept"] == off[1]["swap_accept"] and on[2] == off[2]


def test_train_phases_nest_in_the_step():
    rng = np.random.default_rng(0)
    n = 600
    z = (0.7 * rng.normal(size=(n, 9)) + 0.2).astype(np.float32)
    z[:, 1:4] = np.abs(z[:, 1:4]) + 0.05
    z[:, 4] = rng.uniform(0.0, 0.3, n)
    x = np.stack([z[:, 4] + np.exp(0.5 * rng.normal(size=n)) * 0.4 + 0.01, rng.integers(0, 3, n)], -1)
    cfg = trc.RUN_CONFIG_PARAMS.replace(MNLE_HIDDEN_FEATURES=16, MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=6,
                                        TRAIN_BATCH_SIZE=128, TRAIN_MAX_EPOCHS=2, TRAIN_STOP_AFTER_EPOCHS=2)
    metrics.enable()
    est = tmnle.train_mnle(cfg, types.SimpleNamespace(theta_dim=5), z, x.astype(np.float32), device="cpu",
                           verbose=False)
    spans, _ = metrics.drain()
    _assert_nested(spans)
    steps = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert len(steps) == 2 * est.train_meta["steps_per_epoch"]
    assert [s.name for s in spans if s.name == "train.validation"] == ["train.validation"] * 2
    for i in steps:
        phases = [s for s in spans if s.parent == i]
        assert [s.name for s in phases] == ["train.forward", "train.backward", "train.optimizer"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
        assert sum(s.end_ns - s.start_ns for s in phases) <= spans[i].end_ns - spans[i].start_ns
    assert len({s.run for s in spans}) == 1


def test_a_full_buffer_drops_and_counts():
    metrics.enable(capacity=3)
    outer = metrics.begin("a")
    tokens = [metrics.begin(name) for name in ("b", "c", "d", "e")]
    assert tokens[2:] == [-1, -1]
    for t in reversed(tokens):
        metrics.end(t)
    metrics.end(outer)
    metrics.count("launch.k3", 2)
    spans, counters = metrics.drain()
    assert [(s.name, s.parent) for s in spans] == [("a", -1), ("b", 0), ("c", 1)]
    assert counters == {"launch.k3": 2, "spans.dropped": 2, "spans.cut": 0}
    metrics.end(outer)  # a token of a drained recording does nothing
    assert metrics.drain() == ([], {})


def test_spans_open_at_disable_end_there():
    metrics.enable()
    outer = metrics.begin("run")
    inner = metrics.begin("work")
    metrics.disable()
    metrics.end(inner)  # after disable: nothing
    spans, counters = metrics.drain()
    assert [(s.name, s.parent) for s in spans] == [("run", -1), ("work", 0)]
    assert spans[0].end_ns == spans[1].end_ns and counters["spans.cut"] == 0
    metrics.end(outer)


def test_an_exception_leaves_no_open_span():
    """A potential call that raises cuts the spans around it: none of them is
    handed over, and the next run's spans nest as they should."""
    state = {"n": 0}

    def failing(u, need_grad=True):
        state["n"] += 1
        if state["n"] == 12:
            raise RuntimeError("lost")
        return _gauss_vg(u, need_grad)

    metrics.enable()
    with pytest.raises(RuntimeError, match="lost"):
        _small_nuts(vg=failing)
    span = metrics.begin("after")  # a span at the top level, not inside a cut one
    metrics.end(span)
    _small_nuts()
    spans, counters = metrics.drain()
    _assert_nested(spans)
    assert counters["spans.cut"] >= 2  # the transition and the leaf the call was in
    after = next(i for i, s in enumerate(spans) if s.name == "after")
    assert spans[after].parent == -1
    second = spans[after + 1:]
    assert second and all(s.run == second[0].run != spans[0].run for s in second)
    assert all(spans[s.parent].name in {"nuts.leaf", "nuts.init", "nuts.transition"}
               for s in second if s.name == "wait" and s.parent >= 0)


def test_spans_are_on_the_profilers_clock():
    """A ``record_function`` range under a CPU-activity profiler lies inside
    the program span around it once the span is converted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    metrics.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer = metrics.begin("outer")
        with record_function("inner_range"):
            (a @ a).sum()
        metrics.end(outer)
    (span,), _ = metrics.drain()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner_range" and e.device_type() == DeviceType.CPU]
    assert inner
    for e in inner:
        assert span.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= span.end_ns


def test_idle_by_span_splits_each_gap_by_overlap():
    """Device events at [0, 10), [40, 50) and [90, 100) ns in a window
    [0, 110); spans: a [5, 60) with its child b [20, 35), and c [70, 80).
    The gap [10, 40) straddles a and a/b (15 ns each); of the gap [50, 90),
    10 ns lie in a, 10 in c and 20 in no span, as does the gap [100, 110)."""
    S = metrics.Span
    spans = [S("a", 5, 60, -1, 0), S("b", 20, 35, 0, 0), S("c", 70, 80, -1, 0)]
    device = [(0, 10, "k"), (40, 50, "k"), (90, 100, "k")]
    out = metrics.idle_by_span(device, spans, 0, 110)
    assert out == pytest.approx({"a": 25e-9, "a/b": 15e-9, "c": 10e-9, metrics.NO_SPAN: 30e-9})
    assert sum(out.values()) == pytest.approx(80e-9)
    assert metrics.idle_by_span([], [], 0, 10) == pytest.approx({metrics.NO_SPAN: 10e-9})
