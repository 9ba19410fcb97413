"""Roofline entry point: the card's achievable issue ceilings, and the two
kernel families' demand against them (PyTorch + CUDA port).

Counterpart of ``benchmarks/roofline.py``. The simulator is an element-wise
workload: it reads 85 floats and writes 2 per trial and runs thousands of
dependent steps, so neither the tensor cores nor device memory bound it, and
a datasheet's peak says little about what a serial chain can reach. So the
ceilings are measured, with kernel K4 (``ops/ceiling_cuda.py``,
``csrc/issue_ceiling.cu``):

* ``fma``: K chained multiply-adds per element held in a register, the
  achievable FP32 rate;
* ``transcendental``: K chained operations of an exp/log/sqrt/sin mix (four
  special functions and four cheap operations per eight), the achievable
  special-function rate.

Each is timed at two chain lengths and differenced, ops/s = elements x
(K_hi - K_lo) / (t_hi - t_lo), so whatever a launch costs whatever its
length cancels (``issue_ceiling``, ``ceiling_from_times``).

Then the simulator K1 is timed at ``--batch`` trials with a high bound (few
early exits) and its operations per trial-step, counted from
``csrc/ddm_rt_choice.cu``, are stated against the two ceilings; and the
fused log-prob kernel K2 is timed at 65,536 rows on a committed model, as
rows/s with the FLOP of its matrix products per row.

K1's operations per executed trial-step (``K1_FMA_CLASS_OPS``,
``K1_TRANSCENDENTAL_CLASS_OPS``): the Euler-Maruyama update is 3 products
and 2 sums (no contraction), 2 bound compares, and about 6 predicate and
select operations (active, hit, choice): 13. A quarter of a Philox4x32-10
call (10 rounds of 2 mulhi, 2 mullo, 4 xor, 2 adds) is 25 integer
operations (the kernel takes each mulhi and mullo pair from one wide
multiply; both halves are counted). Half a Box-Muller pair outside its special functions (2 shifts,
2 conversions, 3 for u1 and u2, the -2 and 2 pi scalings, 2 products) is
5.5. Together 43.5 FMA-class operations, against the 18 counted for the TPU
kernel: the TPU draws its bits from a hardware generator, here Philox runs
in the kernel's own instructions and is more than half the count. The
special functions are the same 2 per step (half each of log, sqrt, sin and
cos).

Usage, on a machine with one CUDA card and nvcc::

    python -m sbi_for_diffusion_models_tpu_torch.roofline [--out FILE] [--trace DIR]

Writes ``artifacts/roofline_h100.json`` by default. ``--trace DIR`` also
records one simulator pass with ``torch.profiler`` and writes its Chrome
trace there. There is no CPU path: without a card the entry point raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

from .ops.ceiling_cuda import KINDS, ceiling_chain
from .utils.device import resolve_device
from .utils.metrics import device_time

__all__ = ["issue_ceiling", "ceiling_from_times", "simulator_inputs", "mnle_layer_shapes", "main"]

FP32_FMA_PER_S = 33.5e12  # H100 SXM datasheet: 67 TFLOP/s FP32, two FLOP per FMA
K1_FMA_CLASS_OPS = 43.5
K1_TRANSCENDENTAL_CLASS_OPS = 2.0
MODEL_FILES = ("mnle_1m_censor.npz", "mnle_10m_shifted_logt_affine.npz")


def _median_seconds(fn, reps: int, device: torch.device) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after one warm-up call,
    each between two CUDA events."""
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) * 1e-3)
    return statistics.median(times)


def ceiling_from_times(n_elements: int, K_lo: int, K_hi: int, t_lo: float, t_hi: float) -> float:
    """ops/s from the times of two chain lengths: the difference of the
    operations over the difference of the times. Where noise swamped the
    difference (t_hi <= t_lo), the long chain's own rate, a lower bound."""
    dt = t_hi - t_lo
    if dt <= 0:
        return n_elements * K_hi / t_hi
    return n_elements * (K_hi - K_lo) / dt


def issue_ceiling(kind: str, *, R: int = 256, G: int = 64, K_lo: int = 1 << 14, K_hi: int = 1 << 17,
                  reps: int = 5, device=None) -> tuple[float, float, float, int]:
    """Achievable issue rate of chained element-wise work of ``kind``
    (counterpart of ``vpu_ceiling``): (ops/s, t_lo, t_hi, elements), from the
    median seconds of the chain at the two lengths on (G, R, 128) float32
    elements of 0.5."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: expected one of {KINDS}")
    device = resolve_device(device)
    x = torch.full((G, R, 128), 0.5, dtype=torch.float32, device=device)
    t_lo = _median_seconds(lambda: ceiling_chain(x, K_lo, kind), reps, device)
    t_hi = _median_seconds(lambda: ceiling_chain(x, K_hi, kind), reps, device)
    return ceiling_from_times(x.numel(), K_lo, K_hi, t_lo, t_hi), t_lo, t_hi, x.numel()


def mnle_layer_shapes(w) -> list[tuple[int, int]]:
    """(in, out) of every matrix product of one row through the fused
    log-prob kernels, from the packed weights: the categorical MLP, the
    trunk, the slot head (pulse rep) and the one product to all heads."""
    layers = [tuple(W.shape) for W, _ in w.cat + w.trunk]
    if w.pulse:
        layers.append(tuple(w.slot[0].shape))
    return layers + [tuple(w.head_w.shape)]


def simulator_inputs(batch: int, device: torch.device):
    """The simulator row's inputs: (theta, pulses, n_max, steps_per_pulse)
    for ``batch`` trials of theta = (0.5, 0.1, 1.0, 30, 0.1), a high bound
    (few early exits, close to the most steps a trial can take), each with
    its own stimulus."""
    from .models.rt_choice_model import generate_pulse_matrix, n_pulses_max_from_schedule, pulse_schedule
    from .utils.rng import make_generator

    n_max, spp = pulse_schedule()
    theta = torch.tensor([[0.5, 0.1, 1.0, 30.0, 0.1]], dtype=torch.float32, device=device).repeat(batch, 1)
    pulses = generate_pulse_matrix(make_generator(0, device), batch, n_pulses_max_from_schedule(n_max, spp))
    return theta, pulses, n_max, spp


def _simulator_row(report: dict, ceilings: dict, batch: int, device: torch.device):
    """Time K1 on ``simulator_inputs(batch)`` and state its demand against
    the ceilings; returns the timed call."""
    from .ops.ddm_cuda import ddm_rt_choice_cuda

    theta, pulses, n_max, spp = simulator_inputs(batch, device)
    P = pulses.shape[1]

    def run():
        return ddm_rt_choice_cuda(theta, pulses, 1, n_max=n_max, steps_per_pulse=spp)

    seconds = _median_seconds(run, 5, device)
    out = run()
    dt = 5e-4
    executed = int(torch.round((out[:, 0] - theta[:, 4]) / dt).clamp(min=0).sum())
    nominal = batch * n_max
    report["sim_batch"] = batch
    report["sim_seconds"] = seconds
    report["sim_trial_steps_per_s"] = nominal / seconds
    report["sim_executed_trial_steps_per_s"] = executed / seconds
    report["sim_executed_fraction"] = executed / nominal
    report["sim_ops_per_step"] = {"fma_class": K1_FMA_CLASS_OPS, "transcendental_class": K1_TRANSCENDENTAL_CLASS_OPS}
    for name, steps in (("sim_issue_utilization_est", executed), ("sim_issue_utilization_nominal_est", nominal)):
        rate = steps / seconds
        report[name] = (K1_FMA_CLASS_OPS * rate / ceilings["fma"]
                        + K1_TRANSCENDENTAL_CLASS_OPS * rate / ceilings["transcendental"])
    bytes_per_trial = 5 * 4 + P * 4 + 2 * 4
    report["sim_hbm_gb_per_s"] = batch * bytes_per_trial / seconds / 1e9
    print(f"[roofline] sim: {executed / seconds:.3e} executed trial-steps/s ({executed / nominal:.3f} of the "
          f"nominal {nominal / seconds:.3e}); est issue utilization {report['sim_issue_utilization_est'] * 100:.1f}% "
          f"of the measured serial ceilings (executed steps; {report['sim_issue_utilization_nominal_est'] * 100:.1f}% "
          f"if every nominal step is counted); device memory {report['sim_hbm_gb_per_s']:.2f} GB/s")
    return run


def _fused_row(report: dict, device: torch.device, rows: int = 65536) -> None:
    """Time K2 at ``rows`` rows on the first committed model of MODEL_FILES
    that ``$MODEL_DIR`` holds."""
    from .mnle import _model_dir, load_model
    from .ops.mnle_cuda import pack_mnle_weights

    name = next((f for f in MODEL_FILES if (_model_dir() / f).exists()), None)
    if name is None:
        raise FileNotFoundError(f"none of {MODEL_FILES} in $MODEL_DIR ({_model_dir()}): the fused-kernel row "
                                "needs one of the models committed under artifacts/models")
    est = load_model(name, device=device)
    D = est.cond_mean.shape[0]
    cond = torch.zeros((rows, D), dtype=torch.float32, device=device) + est.cond_mean
    x = torch.cat([torch.full((rows, 1), 1.0, device=device), torch.zeros((rows, 1), device=device)], -1)
    lp_fn = est.dispatch_log_prob("pallas")
    with torch.no_grad():
        seconds = _median_seconds(lambda: lp_fn(x, cond), 5, device)
    flops_row = 2 * sum(a * b for a, b in mnle_layer_shapes(pack_mnle_weights(est)))
    report["mnle_model"] = name
    report["mnle_rows"] = rows
    report["mnle_rows_per_s"] = rows / seconds
    report["mnle_flops_per_row"] = flops_row
    report["mnle_gflops_per_s"] = rows / seconds * flops_row / 1e9
    print(f"[roofline] mnle-fused ({name}): {rows / seconds:.3e} rows/s "
          f"(~{rows / seconds * flops_row / 1e12:.2f} TFLOP/s of matrix products, {flops_row} FLOP a row)")


def _trace(report: dict, run, trace_dir: str, device: torch.device) -> None:
    """One simulator pass under ``torch.profiler``; the Chrome trace goes to
    ``trace_dir`` and the device time the profiler saw into the report."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / "roofline_trace.json"))
    device_ms, _ = device_time(prof)
    report["trace_dir"] = str(out)
    report["trace_device_ms"] = device_ms
    print(f"[roofline] trace -> {out} (device time seen by the profiler: {device_ms:.3f} ms)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", type=str, default=None, help="directory for a torch.profiler trace of one simulator pass")
    ap.add_argument("--batch", type=int, default=524288, help="simulator trials")
    ap.add_argument("--out", type=str, default="artifacts/roofline_h100.json")
    args = ap.parse_args(argv)

    device = resolve_device(None)
    # The committed models, unless the caller points elsewhere.
    os.environ.setdefault("MODEL_DIR", str(Path(__file__).resolve().parents[1] / "artifacts" / "models"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    report = {"backend": "cuda", "device": torch.cuda.get_device_name(device), "nvidia_smi": smi,
              "torch": torch.__version__, "datasheet_fp32_fma_per_s": FP32_FMA_PER_S}

    ceilings = {}
    K_lo, K_hi = 1 << 14, 1 << 17
    for kind in KINDS:
        ceilings[kind], t_lo, t_hi, n = issue_ceiling(kind, K_lo=K_lo, K_hi=K_hi, device=device)
        report[f"issue_{kind}"] = {"elements": n, "K_lo": K_lo, "K_hi": K_hi, "seconds_lo": t_lo, "seconds_hi": t_hi,
                                   "ops_per_s": ceilings[kind],
                                   "share_of_datasheet_fma": ceilings[kind] / FP32_FMA_PER_S}
        print(f"[roofline] {kind} ceiling: {ceilings[kind] / 1e12:.3f} Tops/s "
              f"({ceilings[kind] / FP32_FMA_PER_S * 100:.1f}% of the datasheet's {FP32_FMA_PER_S / 1e12:.1f} T FMA/s; "
              f"chains of {K_lo} and {K_hi}: {t_lo * 1e3:.3f} and {t_hi * 1e3:.3f} ms) on {smi}")

    run = _simulator_row(report, ceilings, args.batch, device)
    _fused_row(report, device)
    if args.trace:
        _trace(report, run, args.trace, device)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"[roofline] -> {out}")
    return report


if __name__ == "__main__":
    main()
