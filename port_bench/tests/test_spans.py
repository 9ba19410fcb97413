"""The readers of the port's spans (``port_bench/spans.py``) on synthetic
timelines, and the recorder's state in the benchmark's own runs."""

import pytest

from port_bench import spans as sp
from sbi_for_diffusion_models_tpu_torch.utils import metrics

from .conftest import run_small, small_mix

S = metrics.Span

# ns. A transition holding a leaf (its potential call and a wait) and a grid
# hop (its potential call); a K3 event runs past its call into the wait, then
# a small kernel and a K2 event inside the hop's call. Tail [0, 120): the gap
# [28, 60) straddles the leaf, the wait, the hop and its call; of the gap
# [80, 120), 20 ns lie inside the transition and 20 outside every span.
SAMPLER = [S("nuts.transition", 0, 100, -1, 1), S("nuts.leaf", 0, 50, 0, 1), S("potential", 5, 25, 1, 1),
           S("wait", 30, 45, 1, 1), S("move.grid_hop", 50, 90, 0, 1), S("potential", 55, 70, 4, 1)]
DEVICE = [(10, 28, "mnle_logprob_bwd_kernel"), (60, 62, "elementwise_kernel"), (66, 80, "mnle_logprob_fwd_kernel")]
TAIL = (0, 120)


def test_sampler_readers_split_the_idle_time():
    out = sp.read_spans(SAMPLER, {"launch.k3": 1, "launch.k2": 1}, DEVICE, TAIL)
    assert out == pytest.approx({
        "device_idle_pct": 100 * 86 / 120,
        "potential_span_ms": 17.5e-6,
        "sampler_self_ms": 25e-6,  # (100 - 20 - 15 - 15) / 2
        "sampler_wait_ms": 7.5e-6,
        "idle_in_potential_pct": 100 * 14 / 120,  # [5, 10), [55, 60), [62, 66)
        "idle_in_sampler_pct": 100 * 37 / 120,  # leaf 12, hop 15, transition 10
        "small_ops_per_call": 0.5,
    })
    assert out["idle_in_potential_pct"] + out["idle_in_sampler_pct"] <= out["device_idle_pct"]
    idle = sp.top_idle(SAMPLER, DEVICE, TAIL, n=2)
    assert set(list(idle)[:2]) == {"nuts.transition/move.grid_hop", "nuts.transition/nuts.leaf/wait"}  # 15 ns each
    assert list(idle)[2] == metrics.NO_SPAN
    assert idle[metrics.NO_SPAN] == pytest.approx(20e-9)


def test_clock_check_holds_each_backward_kernel_to_its_call():
    late = [(10, 28, "mnle_pulse_bwd_kernel"), (56, 95, "mnle_logprob_bwd_kernel"), (1, 4, "mnle_logprob_bwd_kernel")]
    out = sp.clock_check(SAMPLER, late)
    # The first lies before its wait's end; the second has no wait after its
    # call; the third began before any call.
    assert (out["events"], out["inside"], out["share"]) == (3, 1, pytest.approx(1 / 3))
    assert sp.clock_check(SAMPLER, DEVICE[1:]) is None


def test_training_readers_average_each_phase_a_step():
    spans = [S("train.step", 0, 100, -1, 1), S("train.forward", 5, 30, 0, 1), S("train.backward", 30, 70, 0, 1),
             S("train.optimizer", 70, 95, 0, 1), S("train.step", 100, 200, -1, 1), S("train.forward", 100, 120, 4, 1),
             S("train.backward", 120, 170, 4, 1), S("train.optimizer", 170, 190, 4, 1)]
    out = sp.read_spans(spans, {}, [(0, 50, "k")], (0, 200))
    assert out == pytest.approx({"device_idle_pct": 75.0, "train_forward_ms": 22.5e-6, "train_backward_ms": 45e-6,
                                 "train_optimizer_ms": 22.5e-6, "train_step_span_ms": 100e-6})


def test_an_untraced_run_leaves_the_recorder_off(monkeypatch):
    enabled = []
    monkeypatch.setattr(metrics, "enable", lambda *a, **k: enabled.append(1))
    res = run_small("flagship.serve")
    assert res["correct"] and not enabled and metrics.RECORDING is False
    assert metrics.drain() == ([], {})


def test_a_traced_cpu_run_records_the_tail():
    line = sp.execute("flagship.serve", 2**31 + 7, 3.0, "cpu", mix=small_mix("flagship.serve"))
    assert line["result"]["correct"] and metrics.RECORDING is False
    assert line["n_spans"] > 0 and line["counters"]["launch.k3"] > 0
    assert {"potential_span_ms", "sampler_self_ms", "sampler_wait_ms", "small_ops_per_call"} <= set(line["spans"])
    assert metrics.NO_SPAN in line["idle_by_span"]
