"""Device readings from a ``torch.profiler`` run of device activity only.

``read(profiler)`` turns the profiled tail into what the per-layer metrics
and the result line's ``breakdown`` read:

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, fill) ran;
* ``op_s`` / ``op_n``: device seconds and launches by operation name;
* ``device_ops``: the ten operations that took most device time;
* ``idle_gaps``: idle time between device operations, summed by the pair
  of operations around each gap, the ten largest. A gap before a kernel
  the host launched late is host time (the sampler's Python, a read-back,
  the next call's set-up).
"""

from __future__ import annotations

import re
from collections import defaultdict

__all__ = ["read", "short_name"]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _events(prof):
    """(name, start_ns, end_ns) of every device event of the run."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(start), int(start + dur)))
    out.sort(key=lambda ev: ev[1])
    return out


def read(prof) -> dict:
    events = _events(prof)
    op_s, op_n = defaultdict(float), defaultdict(int)
    gaps = defaultdict(float)
    busy_ns, end, prev = 0, None, None
    for name, start, stop in events:
        short = short_name(name)
        op_s[short] += (stop - start) * 1e-9
        op_n[short] += 1
        if end is None or start >= end:
            if end is not None:
                gaps[f"{prev} -> {short}"] += (start - end) * 1e-9
            busy_ns += stop - start
            end = stop
        elif stop > end:
            busy_ns += stop - end
            end = stop
        if stop >= (end or 0):
            prev = short
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns * 1e-9,
        "events": len(events),
        "op_s": dict(op_s),
        "op_n": dict(op_n),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in idle],
    }
