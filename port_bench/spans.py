"""The port's own spans and counters over a cell's profiled tail: which host
code held each idle gap of the card.

    python3 -m port_bench.spans --workload <name> --seed <n> --seconds <s> [--recorder on|both] [--pairs k] [--tail s]

runs the cell as ``python3 -m port_bench.run ... --trace 1`` does, with the
port's span and counter recorder (``utils.metrics``) on for the profiled
tail only, and prints one JSON line a run: the run's result line
(``result``), the numbers the readers below take from the recorder and the
tail's device events (``spans``), ``idle_by_span`` (the ten span paths that
held the most device-idle seconds, and ``(no span)``), the tail's
``counters``, and ``clock``: the share of the fused backward kernel's
device events that lie between the start of the ``potential`` span that
launched them and the end of the first ``wait`` span after it (the check
that the spans and the device events share one clock).

``--recorder both`` runs ``--pairs`` pairs of the cell on one seed, the
recorder on in the tail of one run of a pair and off in the other (the
order alternates), and adds to each line ``tail_rate``: the tail's
potential calls (training: optimizer steps) per second, whose ratio is the
recorder's cost. ``--tail`` sets the profiled tail's seconds (2 as in the
benchmark). Needs a CUDA card, as ``port_bench.run`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import probes, run

BACKWARD_KERNELS = ("mnle_logprob_bwd_kernel", "mnle_pulse_bwd_kernel")


class SpanProbe(probes.Probe):
    """The benchmark's probe, with the port's recorder on from the start of
    the profiled tail to its end (or ``uninstall``)."""

    record = True
    last = None  # the probe of the latest run

    def __post_init__(self):
        super().__post_init__()
        self.tail_profiler = self.tail_spans = self.tail_counters = None
        self.tail_ns = (0, 0)  # the tail's start and end on the Unix epoch
        SpanProbe.last = self

    def boundary(self) -> None:
        if self.phase == "tail" and time.perf_counter() >= self._deadline:
            self._end_tail()
        before = self.phase
        super().boundary()
        if before == "window" and self.phase == "tail":
            self._start_tail()

    def uninstall(self) -> None:
        if self.phase == "tail":
            self._end_tail()
        super().uninstall()

    def _start_tail(self) -> None:
        from sbi_for_diffusion_models_tpu_torch.utils import metrics

        self.tail_profiler = self.profiler
        self._epoch = time.time_ns() - time.perf_counter_ns()
        self.tail_ns = (round(self._t_start * 1e9) + self._epoch, 0)
        if self.record:
            metrics.enable()

    def _end_tail(self) -> None:
        """At the tail's end, before the profiler stops: the card's queue
        drained, the recording ended (the spans in flight end here)."""
        from sbi_for_diffusion_models_tpu_torch.utils import metrics

        self._wait()
        self.tail_spans, self.tail_counters = metrics.drain()
        self.tail_ns = (self.tail_ns[0], time.perf_counter_ns() + self._epoch)


SAMPLER_SPANS = {"nuts.init", "nuts.transition", "nuts.leaf", "nuts.exchange", "move.grid_hop", "move.dim_slice"}


def _sum_ms(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-6


def _seconds(by_path: dict, keep) -> float:
    """The seconds of the paths whose span names ``keep`` accepts."""
    return sum(v for path, v in by_path.items() if keep(set(path.split("/"))))


def _sampler_self(names: set) -> bool:
    return bool(names & SAMPLER_SPANS) and not names & {"potential", "wait"}


def read_spans(spans, counters, device, tail_ns) -> dict:
    """The per-layer numbers of the recorder over a tail: the sampler's
    where the tail holds potential spans, the training's where it holds
    steps, and ``device_idle_pct`` over the same stretch, for comparison.
    ``device``: the tail's device events, ``(start_ns, end_ns, name)``;
    ``tail_ns``: its start and end.

    Sampler, a potential call being a ``potential`` span: the mean span
    (``potential_span_ms``); the host's time a call inside the sampler's
    spans (``nuts.*``, ``move.*``) and outside the potential's and the
    waits' (``sampler_self_ms``), and in the waits (``sampler_wait_ms``);
    the card's idle time in those, as shares of the tail
    (``idle_in_potential_pct``, ``idle_in_sampler_pct``); and the device
    operations a call other than the kernels the ``launch.*`` counters
    count (``small_ops_per_call``). Time is each instant's innermost span's,
    so a transition begun before the recording (its leaves then have no
    parent) still counts its leaves' own time. Training: the mean of each
    phase span a step, and of the step span."""
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import idle_by_span

    tail_s = (tail_ns[1] - tail_ns[0]) * 1e-9
    idle = idle_by_span(device, spans, *tail_ns)
    held = idle_by_span([], spans, *tail_ns)  # all of the tail, by innermost span
    out = {"device_idle_pct": 100.0 * sum(idle.values()) / tail_s}
    calls = sum(s.name == "potential" for s in spans)
    if calls:
        launches = sum(v for k, v in counters.items() if k.startswith("launch."))
        out.update(
            potential_span_ms=_sum_ms(spans, "potential") / calls,
            sampler_self_ms=_seconds(held, _sampler_self) * 1e3 / calls,
            sampler_wait_ms=_seconds(held, lambda names: "wait" in names) * 1e3 / calls,
            idle_in_potential_pct=100.0 * _seconds(idle, lambda names: "potential" in names) / tail_s,
            idle_in_sampler_pct=100.0 * _seconds(idle, _sampler_self) / tail_s,
            small_ops_per_call=(len(device) - launches) / calls,
        )
    steps = sum(s.name == "train.step" for s in spans)
    if steps:
        for phase in ("forward", "backward", "optimizer"):
            out[f"train_{phase}_ms"] = _sum_ms(spans, f"train.{phase}") / steps
        out["train_step_span_ms"] = _sum_ms(spans, "train.step") / steps
    return out


def top_idle(spans, device, tail_ns, n: int = 10) -> dict:
    """The ``n`` span paths holding the most device-idle seconds in the tail,
    and ``(no span)``."""
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import NO_SPAN, idle_by_span

    idle = idle_by_span(device, spans, *tail_ns)
    top = sorted(((k, v) for k, v in idle.items() if k != NO_SPAN), key=lambda kv: -kv[1])[:n]
    return dict(top + [(NO_SPAN, idle.get(NO_SPAN, 0.0))])


def clock_check(spans, device) -> dict | None:
    """Of the fused backward kernel's device events, the share that lies
    between the start of the last ``potential`` span begun before the event
    and the end of the first ``wait`` span begun after that one; None
    without such events."""
    import bisect

    events = [(a, b) for a, b, name in device if any(k in name for k in BACKWARD_KERNELS)]
    pot = sorted(s.start_ns for s in spans if s.name == "potential")
    waits = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "wait")
    if not events or not pot:
        return None
    inside = 0
    lags = []
    for a, b in events:
        k = bisect.bisect_right(pot, a) - 1
        if k < 0:
            continue
        j = bisect.bisect_left(waits, (pot[k], -1))
        if j < len(waits) and b <= waits[j][1]:
            inside += 1
        lags.append(a - pot[k])
    lags.sort()
    return {"events": len(events), "inside": inside, "share": inside / len(events),
            "launch_to_start_us_median": lags[len(lags) // 2] * 1e-3 if lags else None}


def execute(workload: str, seed: int, seconds: float, device, *, record: bool = True, mix: dict | None = None) -> dict:
    """One traced run of the cell with the recorder on in its tail (or off,
    ``record=False``); returns the line printed for it."""
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals

    real = probes.Probe
    SpanProbe.record = record
    probes.Probe = SpanProbe
    try:
        result = run.execute(workload, seed, seconds, True, device, mix=mix)
    finally:
        probes.Probe = real
    probe = SpanProbe.last
    tail = probe.tail
    line = {"workload": workload, "seed": seed, "recorder": "on" if record else "off", "result": result,
            "tail_rate": (tail.steps or tail.calls) / probe.tail_s if probe.tail_s else None}
    if record and probe.tail_profiler is not None and probe.tail_spans is not None:
        events = device_intervals(probe.tail_profiler)
        line.update(spans=read_spans(probe.tail_spans, probe.tail_counters, events, probe.tail_ns),
                    idle_by_span=top_idle(probe.tail_spans, events, probe.tail_ns), counters=probe.tail_counters,
                    clock=clock_check(probe.tail_spans, events), n_spans=len(probe.tail_spans))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", choices=("on", "both"), default="on")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--tail", type=float, default=run.TRACE_SECONDS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    run.TRACE_SECONDS = args.tail
    if args.recorder == "on":
        plan = [True]
    else:
        plan = [flag for i in range(args.pairs) for flag in ((True, False) if i % 2 == 0 else (False, True))]
    for record in plan:
        line = execute(args.workload, args.seed, args.seconds, "cuda", record=record)
        line["device_name"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
