"""Run one benchmark cell of the PyTorch + CUDA port and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic mix
are found by name: ``BENCHMARK.json`` names the cell's configuration and
mix, ``configs/<config>.json`` holds the configuration as it is run,
``traffic/<mix>.json`` the mix, ``metrics/<metric>.py`` each metric's
reader and ``limits/<workload>.json`` the limits of the comparison with the
reference. The run sets up, measures a window of ``--seconds`` (with
``--trace 1`` then a profiled tail of device activity), compares what the
timed path produced with the plain reference, and prints, last on standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared with its limit, also the last lines on standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; it exits with code 3 if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sbi_for_diffusion_models_tpu")
TRACE_SECONDS = 2.0  # the profiled tail of a --trace 1 run


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic mix) of the cell ``name``."""
    from .generator import load_mix

    bench = bench or benchmark()
    work = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    return work, json.loads((ROOT / entry["file"]).read_text()), load_mix(work["traffic"])


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", HERE / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def leaf_shapes(npz_path) -> dict:
    """Parameter shapes of a saved estimator, by leaf name (``cat_net/Dense_0/kernel``)."""
    import re

    import numpy as np

    with np.load(npz_path, allow_pickle=False) as data:
        return {"/".join(re.findall(r"\['([^']*)'\]", k[len("param:"):])): tuple(data[k].shape)
                for k in data.files if k.startswith("param:")}


def execute(workload: str, seed: int, seconds: float, trace: bool, device, *, mix: dict | None = None,
            t0: float | None = None, keep=None) -> dict:
    """One run of the cell on ``device``; returns the result object. ``mix``
    replaces the cell's traffic mix (the tests' small sizes); ``keep``, a
    dict, receives the run's context and numbers (for the control)."""
    import torch

    from . import compare, counts, drivers
    from . import trace as trace_mod
    from .probes import Probe

    t0 = _T0 if t0 is None else t0
    bench = benchmark()
    work, config, cell_mix = cell(workload, bench)
    mix = mix or cell_mix
    driver = drivers.load(mix["kind"])
    device = torch.device(device)
    model_path = ROOT / config["model"]
    on_card = device.type == "cuda"
    probe = Probe(seconds=seconds, seed=seed, trace_seconds=TRACE_SECONDS if trace else 0.0,
                  capture_rate=mix.get("capture_rate", 0.0), max_captures=mix.get("max_captures", 0), sync=on_card)
    ctx = types.SimpleNamespace(config=config, mix=mix, seed=seed, device=device, model_path=model_path, probe=probe,
                                shapes_leaves=leaf_shapes(model_path), data=None, cards=1,
                                memory_peak_bytes=0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    probe.install()
    try:
        attempted, failed = driver.run(ctx)
    finally:
        probe.uninstall()
    # A driver that runs ranks on other cards sets ``cards`` and their peak.
    memory_peak = max(int(torch.cuda.max_memory_allocated()) if on_card else 0, ctx.memory_peak_bytes)
    tr = trace_mod.read(probe.profiler) if probe.profiler is not None else None
    probe.profiler = None
    if on_card:
        torch.cuda.empty_cache()

    # The comparison, after the window and the memory reading.
    numbers = driver.numbers(ctx, keep is not None)
    ok, checks = compare.judge(numbers, compare.load_limits(workload))
    if keep is not None:
        keep.update(ctx=ctx, numbers=numbers)

    rec = types.SimpleNamespace(window=probe.window, window_s=probe.window_s or math.nan, tail=probe.tail,
                                tail_s=probe.tail_s, trace=tr, shapes=counts.shapes(str(model_path)),
                                setup_s=probe.window_opened_at - t0)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = reader(m["name"])(rec) if probe.window_s else None
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": ctx.cards, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(ok and failed == 0 and probe.window_s > 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=probe.tail_s)
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]} for k, c in checks.items()}
    return result


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e308


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build" / "port_bench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    work, _, _ = cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(work["chips"]):
        print(f"port_bench: the cell {args.workload} needs {work['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"port_bench: loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
