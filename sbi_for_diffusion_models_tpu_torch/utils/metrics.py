"""Structured metrics and profiling (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/utils/metrics.py``:

* ``MetricsLogger``: append-only JSONL event log, one ``{"ts", "stage",
  "name", "value"}`` record per line;
* ``host_sync`` and ``timed``: wall-clock a device computation, waiting for
  the card with ``torch.cuda.synchronize`` before the clock is read;
* ``trace``: a ``torch.profiler`` trace around a block, and
  ``device_time``: the card's busy time in a finished profiler run.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["MetricsLogger", "timed", "trace", "host_sync", "device_time"]


def _first_leaf(x):
    """The first tensor or array of a nested tuple / list / dict."""
    while isinstance(x, (tuple, list, dict)):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    return x


def host_sync(x) -> float:
    """Wait until the device has computed ``x`` (a tensor, an array or a
    nest of them) and return its first leaf's first element."""
    leaf = _first_leaf(x)
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return float(leaf.detach().reshape(-1)[0])
    return float(np.asarray(leaf).ravel()[0])


class MetricsLogger:
    """Append-only JSONL metrics: one {"ts", "stage", "name", "value"} per line."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, stage: str, name: str, value: Any, **extra) -> None:
        rec = {"ts": time.time(), "stage": stage, "name": name, "value": value}
        rec.update(extra)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        else:
            print(f"[metrics] {stage}/{name} = {value}")


def timed(fn: Callable, *args, sync: bool = True, **kwargs):
    """Run fn(*args, **kwargs), return (result, seconds) with host sync."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        host_sync(out)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str | Path = "torch_trace"):
    """Profile the enclosed block with ``torch.profiler`` (the host and,
    where there is a card, the device) and write its Chrome trace to
    ``logdir/trace.json``. Yields the profiler, whose ``key_averages()``
    sums the time by operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(logdir / "trace.json"))


def device_time(prof) -> tuple[float, int]:
    """The card's busy time in ms and its count of device events (kernels,
    copies, fills) in a finished ``torch.profiler`` run, summed as the
    profiler's own table sums them. A host op carries the time of the
    kernels it launched too, and a ``record_function`` range (a profiler
    step's among them) has a device-side span over its kernels: a sum over
    every event counts those kernels two or three times."""
    from torch.autograd import DeviceType

    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            if not e.is_legacy:
                continue
        elif getattr(e, "is_user_annotation", False):
            continue
        us += getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        n += e.count
    return us / 1e3, n
