"""The port's metrics utilities (``utils/metrics.py``) on the CPU: the JSONL
records of the JAX package's logger and ``device_time`` summing the device's
events only. The span and counter recorder is in ``test_torch_tracing.py``."""

import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from sbi_for_diffusion_models_tpu.utils import metrics as jax_metrics
from sbi_for_diffusion_models_tpu_torch.utils.metrics import MetricsLogger, device_time


def test_metrics_logger_writes_the_jax_packages_records(tmp_path):
    calls = (("sim", "steps_per_s", 1e9, {"batch": 4}), ("train", "loss", 0.5, {}))
    records = {}
    for name, logger in (("jax", jax_metrics.MetricsLogger), ("port", MetricsLogger)):
        path = tmp_path / name / "metrics.jsonl"
        log = logger(path)
        for stage, key, value, extra in calls:
            log.log(stage, key, value, **extra)
        records[name] = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(isinstance(r.pop("ts"), float) for side in records.values() for r in side)
    assert records["port"] == records["jax"]


def test_metrics_logger_prints_without_a_path(capsys):
    MetricsLogger(None).log("a", "b", 1)
    assert "a/b = 1" in capsys.readouterr().out


def test_device_time_sums_the_device_events_once():
    def event(device_type, us, count=1, legacy=False, annotation=False):
        return SimpleNamespace(device_type=device_type, self_device_time_total=us, count=count, is_legacy=legacy,
                               is_user_annotation=annotation)

    events = [
        event(DeviceType.CPU, 30.0, 3),  # a host op carrying its three kernels' time
        event(DeviceType.CUDA, 30.0, 3),  # those kernels
        event(DeviceType.CUDA, 31.0, annotation=True),  # a profiler step's device-side span over them
        event(DeviceType.CUDA, 5.0),  # a copy on the card
        event(DeviceType.CPU, 2.0, legacy=True),  # the legacy profiler: kernel time on the host op only
        event(DeviceType.CPU, 0.0, 7),  # host work without kernels
    ]
    ms, kernels = device_time(SimpleNamespace(key_averages=lambda: events))
    assert ms == pytest.approx(0.037) and kernels == 5
