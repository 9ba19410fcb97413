"""What the request kinds share: the port's ``RunConfig`` of a cell, the
closed loop, the estimator's load, and the sampler cells' comparison and
control."""

from __future__ import annotations

import contextlib
import sys
import traceback

import torch

from .. import compare
from ..probes import WindowClosed
from ..reference import mnle as ref

__all__ = ["run_config", "loop", "load", "tf32", "sampler_numbers", "sampler_control", "SAMPLER_FAULTS"]

SAMPLER_FAULTS = ("answer_altered",)


def run_config(config: dict, mix: dict, **extra):
    """The port's ``RunConfig``: the configuration's fields, then the mix's
    overrides, then ``extra``."""
    from sbi_for_diffusion_models_tpu_torch.run_config import RunConfig

    fields = {**config["run_config"], **mix.get("run_config", {}), **extra}
    return RunConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def loop(probe, request) -> tuple[int, int]:
    """Requests 0, 1, ... one after another until the probe closes the
    window: (attempted, failed)."""
    attempted = failed = 0
    i = 0
    while True:
        try:
            probe.boundary()
            attempted += 1
            request(i)
        except WindowClosed:
            return attempted, failed
        except Exception:  # a request that fails counts as failed; the loop goes on
            failed += 1
            traceback.print_exc(file=sys.stderr)
            if probe.phase == "closed":
                return attempted, failed
        i += 1


def load(ctx):
    """The kernels (built into the checkout on its first run), the prior and
    the cell's trained estimator."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import _cuda
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    if ctx.device.type == "cuda":
        _cuda.build_all()
    return build_prior_theta(), load_model(str(ctx.model_path), device=ctx.device)


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def sampler_numbers(ctx, detail: bool = False) -> dict:
    """The kept potential calls against the float64 reference."""
    model = ref.load_npz(ctx.model_path, torch.float64, ctx.device)
    numbers = compare.sampler_numbers(model, ctx.probe.captures, detail=detail)
    numbers["calls_compared"] = len(ctx.probe.captures)
    return numbers


def sampler_control(ctx) -> dict:
    """The same numbers with the reference in float32 and TF32 products in
    the port's place, on the same kept calls."""
    model = ref.load_npz(ctx.model_path, torch.float64, ctx.device)
    with tf32():
        return compare.sampler_numbers(model, ctx.probe.captures, against=model.to(torch.float32), detail=True)
