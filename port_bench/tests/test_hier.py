"""The ``hier`` driver at a tiny size on the CPU: a cohort run through
``run.execute`` comes out correct with both comparisons made, the planted
answer fault in the likelihood fails it, on the card the control (both
references in float32 with TF32 products) fails the cell's limits, and the
reader of the hierarchical density's spans (``drivers/hier.density_self``)."""

import pytest
import torch

from port_bench import compare, run
from port_bench.calibrate import fault
from port_bench.drivers import hier
from sbi_for_diffusion_models_tpu_torch.utils import metrics

# Three subjects of four trials, two cohorts; the cell's sampler at warmup 2, 2 draws a chain, depth 2.
SMALL = {"cohorts": 2, "hierarchical": {"subjects": 3, "trials": 4}, "capture_rate": 0.5, "max_captures": 8,
         "density_capture_rate": 0.5, "density_max_captures": 8,
         "run_config": {"WARMUP_STEPS": 2, "POSTERIOR_SAMPLES": 8, "MCMC_MAX_TREE_DEPTH": 2},
         "warmup_request": {"WARMUP_STEPS": 1, "POSTERIOR_SAMPLES": 4}}


def _run(seconds=3.0, trace=False, keep=None):
    _, _, mix = run.cell("hier64.serve")
    torch.manual_seed(0)
    return run.execute("hier64.serve", 2**31 + 7, seconds, trace, "cpu", mix={**mix, **SMALL}, keep=keep)


def test_hier_cohort_run_is_correct_on_the_cpu():
    keep = {}
    res = _run(keep=keep)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"lik_rows_per_s", "setup_s"}
    n = keep["numbers"]
    assert n["calls_compared"] > 0 and n["density_calls_compared"] > 0 and n["density_rows_judged"] > 0
    assert "vg" in {c["kind"] for c in keep["ctx"].data["density"]} <= {"vg", "ll"}
    assert not metrics.RECORDING


def test_hier_answer_altered_fails():
    with fault("answer_altered"):
        res = _run()
    assert res["correct"] is False
    assert res["checks"]["density_value_gap_max"]["value"] > res["checks"]["density_value_gap_max"]["limit"]


def test_hier_traced_run_reads_the_density_spans(monkeypatch):
    # A tail long enough to hold whole density calls on a busy CPU, where the profiler records every operation.
    monkeypatch.setattr(run, "TRACE_SECONDS", 6.0)
    res = _run(seconds=2.0, trace=True)
    assert res["correct"] is True
    assert {"hier_density_ms", "potential_ms", "sampler_host_ms"} <= set(res["metrics"])
    assert res["metrics"]["hier_density_ms"]["value"] > 0
    assert not metrics.RECORDING


def test_density_self_leaves_out_the_potential():
    S = metrics.Span
    spans = [S("nuts.leaf", 0, 100, -1, 1), S("hier.density", 10, 60, 0, 1), S("potential", 20, 45, 1, 1),
             S("potential", 70, 80, 0, 1), S("hier.density", 85, 95, 0, 1)]
    assert hier.density_self(spans) == (35e-9, 1)


@pytest.mark.requires_cuda
def test_hier_control_fails_on_the_card(cuda):
    keep = {}
    res = run.execute("hier64.serve", 2**31 + 99, 6.0, False, "cuda", keep=keep)
    assert res["correct"] is True
    ok, checks = compare.judge(hier.control(keep["ctx"]), compare.load_limits("hier64.serve"))
    assert not ok
    assert any(checks[k]["value"] > checks[k]["limit"] for k in checks if k.startswith("density_"))
