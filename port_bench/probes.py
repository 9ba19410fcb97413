"""The benchmark's own spans and counters at the port's layer boundaries.

``Probe.install`` wraps, for the length of one run, the boundaries the
benchmark reads:

* the potential: ``ConditionedMNLELogLikelihood.log_lik_and_grad`` (every
  sampler call, gradient or value-only) and ``log_lik_fn`` (the value calls
  of the potential itself), each counted with its rows (theta rows x trials)
  and timed on the host's clock;
* training: ``mnle.train_step``, counted with its pairs and timed the same
  way, and ``mnle.build_mnle``, whose fresh weights are replaced by the
  benchmark's (``weights``) so that the reference starts from the same ones.

A probe runs through phases: ``setup``, then ``window`` from ``start_window``
for ``seconds``, then, in a traced run, ``tail``: a further stretch under
``torch.profiler`` (device activity only). At the first boundary after a
phase's deadline the probe waits for the card and either moves on or raises
``WindowClosed``, which abandons the request in flight: every rate is then
all the work completed in the window over the window's whole length.

A sample of the window's potential calls, drawn from the run's seed, is kept
(inputs and outputs) for the comparison with the reference. A driver whose
requests cross another boundary wraps it with ``wrap`` before its set-up,
calling ``boundary`` on entry and ``count_call`` on return.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["WindowClosed", "Counters", "Probe"]


class WindowClosed(Exception):
    """Raised at the first boundary after the measured stretch has ended."""


@dataclass
class Counters:
    calls: int = 0
    grad_calls: int = 0
    grad_rows: int = 0
    value_rows: int = 0
    potential_s: float = 0.0
    steps: int = 0
    pairs: int = 0
    step_s: float = 0.0

    @property
    def rows(self) -> int:
        return self.grad_rows + self.value_rows


@dataclass
class Probe:
    seconds: float
    seed: int
    trace_seconds: float = 0.0  # > 0: a profiled tail of this length after the window
    capture_rate: float = 0.0  # share of the window's potential calls kept for the comparison
    max_captures: int = 0
    sync: bool = True  # wait for the card at the phase boundaries (False on the CPU)
    phase: str = "setup"
    window: Counters = field(default_factory=Counters)
    tail: Counters = field(default_factory=Counters)
    captures: list = field(default_factory=list)
    train_capture: dict = field(default_factory=dict)
    weights: dict | None = None  # leaf name -> float32 tensor, put into the net that ``build_mnle`` makes
    start_at_step: int | None = None  # training: the window opens at this optimizer step
    before_window: object = None  # training: called with the estimator just before the window opens
    window_opened_at: float = math.nan  # the host clock's reading when the window opened
    window_s: float = 0.0
    tail_s: float = 0.0
    profiler: object = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed & ((1 << 63) - 1))
        self._undo = []
        self._steps_seen = 0

    # -- phases -------------------------------------------------------------
    def _wait(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    def start_window(self) -> None:
        self._wait()
        self.phase = "window"
        self._t_start = self.window_opened_at = time.perf_counter()
        self._deadline = self._t_start + self.seconds

    def boundary(self) -> None:
        """Called on entry to every wrapped call."""
        if self.phase not in ("window", "tail") or time.perf_counter() < self._deadline:
            return
        self._wait()
        now = time.perf_counter()
        if self.phase == "window":
            self.window_s = now - self._t_start
            if self.trace_seconds > 0:
                from torch.profiler import ProfilerActivity, profile

                self.phase = "closed"  # stays so if the profiler fails to start
                # The card's activity only: recording every host operation
                # too would slow the host several times over.
                activity = ProfilerActivity.CUDA if self.sync else ProfilerActivity.CPU
                self.profiler = profile(activities=[activity])
                self.profiler.__enter__()
                self.phase = "tail"
                self._t_start = time.perf_counter()
                self._deadline = self._t_start + self.trace_seconds
                return
        else:
            self.tail_s = now - self._t_start
            self.profiler.__exit__(None, None, None)
        self.phase = "closed"
        raise WindowClosed

    @property
    def counters(self) -> Counters | None:
        return {"window": self.window, "tail": self.tail}.get(self.phase)

    # -- wrappers -----------------------------------------------------------
    def wrap(self, owner, name: str, replacement) -> None:
        """Put ``replacement`` in the place of ``owner.name`` until ``uninstall``."""
        real = getattr(owner, name)
        setattr(owner, name, replacement)
        self._undo.append(lambda: setattr(owner, name, real))

    def install(self) -> None:
        from sbi_for_diffusion_models_tpu_torch import mnle
        from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood as Lik

        real_grad, real_fn = Lik.log_lik_and_grad, Lik.log_lik_fn
        real_step, real_build = mnle.train_step, mnle.build_mnle
        probe = self

        def log_lik_and_grad(lik, x, theta, need_grad=True, sessions=None):
            probe.boundary()
            t0 = time.perf_counter()
            out = real_grad(lik, x, theta, need_grad, sessions)
            probe.count_call(theta.shape[0] * x.shape[-2], need_grad, time.perf_counter() - t0)
            if probe.phase == "window" and len(probe.captures) < probe.max_captures \
                    and probe._rng.random() < probe.capture_rate:
                probe.captures.append({
                    "x": x, "stim": lik.local_theta, "theta": theta.detach().clone(),
                    "sessions": None if sessions is None else sessions.clone(), "need_grad": need_grad,
                    "ll": out[0].detach().clone(), "grad": None if out[1] is None else out[1].detach().clone(),
                })
            return out

        def log_lik_fn(lik, params, x, theta, sessions=None):
            probe.boundary()
            t0 = time.perf_counter()
            out = real_fn(lik, params, x, theta, sessions)
            probe.count_call(theta.shape[0] * x.shape[-2], False, time.perf_counter() - t0)
            return out

        def train_step(estimator, state, xb, zb, step):
            k = probe._steps_seen
            probe._steps_seen += 1
            if k == probe.start_at_step:
                if probe.before_window is not None:
                    probe.before_window(estimator)
                probe.start_window()
            probe.boundary()
            if k < 4:
                probe._capture_step(k, estimator, state, xb, zb)
            t0 = time.perf_counter()
            loss = real_step(estimator, state, xb, zb, step)
            c = probe.counters
            if c is not None:
                c.steps += 1
                c.pairs += int(xb.shape[0])
                c.step_s += time.perf_counter() - t0
            if k < 3:
                probe._capture_after(k, state, loss)
            return loss

        def build_mnle(*args, **kwargs):
            est = real_build(*args, **kwargs)
            if probe.weights is not None:
                with torch.no_grad():
                    for name, p in net_params(est.net).items():
                        w = probe.weights[name].to(p.device)
                        p.copy_(w.T if name.endswith("/kernel") else w)
            return est

        self.wrap(Lik, "log_lik_and_grad", log_lik_and_grad)
        self.wrap(Lik, "log_lik_fn", log_lik_fn)
        self.wrap(mnle, "train_step", train_step)
        self.wrap(mnle, "build_mnle", build_mnle)

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()
        if self.phase == "tail":  # a request ended the tail early: stop the profiler all the same
            self._wait()
            self.tail_s = time.perf_counter() - self._t_start
            self.profiler.__exit__(None, None, None)
            self.phase = "closed"

    def count_call(self, rows: int, need_grad: bool, seconds: float) -> None:
        c = self.counters
        if c is None:
            return
        c.calls += 1
        c.potential_s += seconds
        if need_grad:
            c.grad_calls += 1
            c.grad_rows += rows
        else:
            c.value_rows += rows

    def _capture_step(self, k: int, estimator, state, xb, zb) -> None:
        """Before step k (0-based): the batch, and the weights before the first
        step and after the third (on entry to the fourth)."""
        cap = self.train_capture
        params = net_params(estimator.net)
        if k == 0:
            cap["cfg"] = estimator.cfg
            cap["params"] = params
            cap["before"] = {n: p.detach().clone() for n, p in params.items()}
        if k == 3:
            cap["after3"] = {n: p.detach().clone() for n, p in params.items()}
            return
        cap.setdefault("batches", []).append((xb, zb))

    def _capture_after(self, k: int, state, loss) -> None:
        """After step k: its loss, and after the first step the gradient as the
        optimizer got it, from Adam's first moment (1 - beta1) g."""
        cap = self.train_capture
        cap.setdefault("losses", []).append(loss.detach().clone())
        if k == 0:
            b1 = state.adam.param_groups[0]["betas"][0]
            by_id = {id(p): n for n, p in cap["params"].items()}
            cap["grad1"] = {by_id[id(p)]: (st["exp_avg"] / (1.0 - b1)).clone()
                            for p, st in state.adam.state.items() if id(p) in by_id}


def net_params(net) -> dict:
    """The port's ``MNLENet`` parameters under the names of the saved ``.npz``
    (``cat_net/Dense_0/kernel`` ...); kernels keep PyTorch's (out, in) layout,
    the transpose of the file's."""
    out = {}

    def put(name, lin):
        out[f"{name}/kernel"] = lin.weight
        out[f"{name}/bias"] = lin.bias

    for group in ("cat_net", "flow_trunk"):
        for i, lin in enumerate(getattr(net, group).layers):
            put(f"{group}/Dense_{i}", lin)
    for i, lin in enumerate(net.spline_heads):
        put(f"spline_head_{i}", lin)
    if net.affine_head is not None:
        put("affine_head", net.affine_head)
    if net.pulse_slot_head is not None:
        put("pulse_slot_head", net.pulse_slot_head)
    return out
