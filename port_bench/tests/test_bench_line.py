"""The result line's shape, and the refusal to run without a card."""

import json

import pytest
import torch

from port_bench import run

from .conftest import run_small

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload,metric", [("flagship.serve", "lik_rows_per_s"),
                                             ("flagship.train", "train_pairs_per_s")])
def test_untraced_line(workload, metric):
    res = run_small(workload)
    assert set(res) == KEYS
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {metric, "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"]) and res["device"]["count"] == 1
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.loads(json.dumps(res))


def test_traced_line_has_breakdown():
    res = run_small("flagship.serve", trace=True)
    assert set(res) == KEYS | {"breakdown"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    # Host-span metrics are read on the CPU too; the trace's need the card.
    assert {"sampler_host_ms", "potential_ms", "sampler_mfu_pct"} <= set(res["metrics"])


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "flagship.serve", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
