"""Structured metrics, the port's spans and counters, and profiler readings
(PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/utils/metrics.py``:

* ``MetricsLogger``: append-only JSONL event log, one ``{"ts", "stage",
  "name", "value"}`` record per line;
* the recorder: spans and counters that the port records at its layer
  boundaries while ``enable()`` is in force (``begin`` / ``end``,
  ``count``, ``new_run``), handed over by ``drain()``;
* ``device_time``: the card's busy time in a finished profiler run;
  ``device_intervals``: its device events on the profiler's clock;
  ``warm_window``: throwaway device work at the ends of a profiler window
  whose events are counted; and ``idle_by_span``: the card's idle time put
  down to the spans open on the host.

The recorder is off by default. Every span site in the port reads
``RECORDING`` first and does nothing more while it is False, so off it
costs one flag test and allocates nothing. On, a span records its name,
its start and end (``time.perf_counter_ns``), the span open around it when
it began (its parent) and the run it belongs to: ``run_nuts`` and
``train_mnle`` each start a run, so the spans of one request share an id.
Spans go into a buffer of fixed capacity: past it they are dropped and
counted (``spans.dropped``), and the buffer never grows. A span still open
at ``disable`` (the work in flight when the recording stops) ends there. A
span that an exception went through, found so when a span around it ends
or the next run starts, is left out of what ``drain`` returns and counted
(``spans.cut``). ``drain`` converts the stamps to the Unix epoch, the clock
of ``torch.profiler``'s events, by the pair of clock readings taken at
``enable``. Recording changes no draw, no bit and no launch. Spans are
recorded for one thread: the port's host loops run on the caller's thread.

The port's spans (name: what it encloses):

* ``nuts.init``: ``run_nuts``'s first potential call and step-size search;
* ``nuts.transition``: one transition of ``run_nuts``, its moves,
  adaptation and exchange sweep inside it;
* ``nuts.leaf``: one iteration of ``_build_subtree``'s loop (the last one,
  which stops the loop, holds only its flag read);
* ``nuts.exchange``: the swap sweep and the potential call after it;
* ``move.grid_hop``, ``move.dim_slice``: the extra moves;
* ``potential``: the body of ``log_lik_and_grad`` and ``log_lik_fn``;
  its parent names the caller;
* ``hier.density``: one evaluation of the hierarchical model's joint
  density (``models/hierarchical._hierarchical_density``: value and
  gradient, value, or the untempered likelihood), its ``potential`` inside;
* ``wait``: the host blocked on the card (``batch_any``'s read, the lagged
  flag's event, the host mirror's copy);
* ``train.step`` with ``train.forward``, ``train.backward`` and
  ``train.optimizer`` inside it, and ``train.validation``.

Counters: ``launch.k1``, ``launch.k2``, ``launch.k3``, ``launch.k2p`` and
``launch.k3p``, the calls of each kernel's dispatcher, whichever route
(kernel or plain version) they take; a replay of captured launches counts
the launches it replays. ``launch.leaf``: the NUTS leaf kernel's launches
(``ops/nuts_cuda.py``), one a leaf that took it; a plain leaf counts none,
so ``launch.leaf`` over the ``nuts.leaf`` spans is the share of leaves run
in the kernel. ``launch.density``: the launches of the u-space density's
kernel pair (``ops/density_cuda.py``: ``density_pre`` and
``density_post``), two a call of ``potentials.tempered_value_and_grad``'s
density on the card; the plain route counts none. ``hier.rows``: the
likelihood rows (chain rows x subjects x trials) of the ``hier.density``
evaluations.
"""

from __future__ import annotations

import json
import time
from collections import namedtuple
from pathlib import Path
from typing import Any

__all__ = [
    "MetricsLogger", "device_time", "device_intervals", "warm_window", "idle_by_span",
    "Span", "NO_SPAN", "RECORDING", "enable", "disable", "drain", "begin", "end", "count", "new_run",
]


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


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------
Span = namedtuple("Span", "name start_ns end_ns parent run")
Span.__doc__ = """A closed span: stamps in ns on the Unix epoch, ``parent`` the
index of the nearest closed span around it in ``drain``'s list (-1: none),
``run`` the id of the run it belongs to."""

RECORDING = False  # read at every span and counter site
DEFAULT_CAPACITY = 1 << 18  # spans a recording holds


class _Recording:
    """One recording's buffer, from ``enable`` to ``drain``."""

    def __init__(self, capacity: int, base: int):
        self.capacity = int(capacity)
        self.base = base  # tokens are base + index, so a token of an earlier recording is told apart
        self.names = [None] * self.capacity
        self.starts = [0] * self.capacity
        self.ends = [-1] * self.capacity  # -1: open
        self.parents = [-1] * self.capacity
        self.runs = [0] * self.capacity
        self.n = 0
        self.stack: list = []  # indices of the open spans, innermost last
        self.run = 0
        self.dropped = 0
        self.counters: dict = {}
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self.epoch_offset = wall - (p0 + p1) // 2


_rec: _Recording | None = None
_recordings = 0


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start a new recording of at most ``capacity`` spans (what an earlier
    one held and was not drained is discarded)."""
    global RECORDING, _rec, _recordings
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    _recordings += 1
    _rec = _Recording(capacity, _recordings << 40)
    RECORDING = True


def disable() -> None:
    """Stop recording: the spans still open end now, and what was recorded
    waits for ``drain``."""
    global RECORDING
    t = time.perf_counter_ns()
    if RECORDING:
        for i in _rec.stack:
            _rec.ends[i] = t
        _rec.stack.clear()
    RECORDING = False


def begin(name: str) -> int:
    """Open the span ``name`` inside the innermost open one; returns the
    token ``end`` takes (-1 when the buffer is full). Call sites test
    ``RECORDING`` first."""
    r = _rec
    i = r.n
    if i == r.capacity:
        r.dropped += 1
        return -1
    r.n = i + 1
    r.names[i] = name
    r.parents[i] = r.stack[-1] if r.stack else -1
    r.runs[i] = r.run
    r.stack.append(i)
    r.starts[i] = time.perf_counter_ns()
    return r.base + i


def end(token: int) -> None:
    """Close the span of ``token``, and cut every span begun inside it and
    not ended: an exception went through them. Nothing happens for -1,
    after ``disable``, or for a span already cut."""
    t = time.perf_counter_ns()
    if not RECORDING or token < 0:
        return
    r = _rec
    i = token - r.base
    stack = r.stack
    if stack and stack[-1] == i:
        stack.pop()
    elif 0 <= i < r.n and i in stack:
        del stack[stack.index(i):]
    else:
        return
    r.ends[i] = t


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Call sites test ``RECORDING`` first."""
    c = _rec.counters
    c[name] = c.get(name, 0) + n


def new_run() -> None:
    """Start a new run id. Spans still open were cut by an exception that
    left an earlier run: they are cut. Call sites test ``RECORDING`` first."""
    r = _rec
    r.run += 1
    r.stack.clear()


def drain() -> tuple[list, dict]:
    """End the recording and hand it over: ``(spans, counters)``, ``spans``
    the closed spans (``Span``) in the order they began, ``counters`` the
    counters with ``spans.dropped`` (past the capacity) and ``spans.cut``
    (an exception went through them). ``([], {})`` without a recording."""
    global _rec
    disable()
    r, _rec = _rec, None
    if r is None:
        return [], {}
    new_index = [-1] * r.n
    spans = []
    for i in range(r.n):
        if r.ends[i] < 0:
            continue
        p = r.parents[i]
        while p >= 0 and new_index[p] < 0:
            p = r.parents[p]
        new_index[i] = len(spans)
        spans.append(Span(r.names[i], r.starts[i] + r.epoch_offset, r.ends[i] + r.epoch_offset,
                          new_index[p] if p >= 0 else -1, r.runs[i]))
    counters = dict(r.counters)
    counters["spans.dropped"] = r.dropped
    counters["spans.cut"] = r.n - len(spans)
    return spans, counters


# ---------------------------------------------------------------------------
# Profiler readings
# ---------------------------------------------------------------------------
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


def device_intervals(prof) -> list:
    """``(start_ns, end_ns, name)`` of every device event (kernel, copy,
    fill) of a finished ``torch.profiler`` run, on the profiler's clock (the
    Unix epoch, as ``drain``'s spans), in order of start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((int(start), int(start + dur), e.name()))
    out.sort()
    return out


# How long the card spins at each end of a profiler window whose events are counted.
WARM_WINDOW_S = 0.2


def warm_window() -> None:
    """Throwaway device work at an end of a ``torch.profiler`` window on the
    card, called first inside the window and again after its work. The
    profiler can leave out events at a window's start: on the H100, in a
    process that had run for minutes, from one event to those of its first
    50 ms (a 50 ms spin among them); a 0.2 s wait on the host and 64 short
    spins at the start did not stop it. So the card runs spins of 0.5 ms,
    each waited for, for ``WARM_WINDOW_S`` of host time at both ends. The
    spins' kernel has ``spin`` in its name; the window's readers leave those
    events out."""
    import torch

    torch.cuda.synchronize()
    end = time.perf_counter() + WARM_WINDOW_S
    while time.perf_counter() < end:
        torch.cuda._sleep(1_000_000)  # about 0.5 ms
        torch.cuda.synchronize()


def _span_paths(spans) -> list:
    """Each span's path from its outermost closed ancestor: ``a/b/c``."""
    paths = []
    for s in spans:
        paths.append(s.name if s.parent < 0 else f"{paths[s.parent]}/{s.name}")
    return paths


def _innermost(spans) -> list:
    """``(start_ns, end_ns, path)`` pieces, in order, that cover the time
    some span is open, each labelled with the innermost open span's path.
    Spans nest (one thread), so a stack of open spans suffices."""
    paths = _span_paths(spans)
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns, i))
    pieces, stack, cursor = [], [], 0

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            stop, path = stack.pop()
            if stop > cursor:
                pieces.append((cursor, stop, path))
            cursor = max(cursor, stop)

    for i in order:
        s = spans[i]
        close_until(s.start_ns)
        if stack and s.start_ns > cursor:
            pieces.append((cursor, s.start_ns, stack[-1][1]))
        cursor = max(cursor, s.start_ns)
        stack.append((s.end_ns, paths[i]))
    close_until(float("inf"))
    return pieces


NO_SPAN = "(no span)"


def idle_by_span(device, spans, start_ns: int, end_ns: int) -> dict:
    """The card's idle seconds in ``[start_ns, end_ns]`` by the path of the
    innermost span open on the host at the time (``NO_SPAN`` where none is):
    each gap between device events (``device_intervals``' pairs, on the same
    clock as ``spans``, ``drain``'s closed spans) split across the spans by
    overlap. The values sum to the window's idle time."""
    idle, cursor = [], start_ns
    for ev_start, ev_end, *_ in sorted(device):
        if ev_start > cursor:
            idle.append((cursor, min(ev_start, end_ns)))
        cursor = max(cursor, ev_end)
        if cursor >= end_ns:
            break
    if cursor < end_ns:
        idle.append((cursor, end_ns))
    out: dict = {}
    pieces = _innermost(spans)
    k = 0
    for a, b in idle:
        if b <= a:
            continue
        covered = 0
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            overlap = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if overlap > 0:
                out[pieces[j][2]] = out.get(pieces[j][2], 0.0) + overlap * 1e-9
                covered += overlap
            j += 1
        if b - a > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered) * 1e-9
    return out
