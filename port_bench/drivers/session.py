"""``session``: a fresh observed session per request, made by the
benchmark's generator, through ``mnle.run_inference_mcmc``."""

from __future__ import annotations

from .. import generator
from .common import SAMPLER_FAULTS as FAULTS
from .common import load, loop, run_config
from .common import sampler_control as control
from .common import sampler_numbers as numbers

__all__ = ["run", "numbers", "control", "FAULTS"]


def run(ctx) -> tuple[int, int]:
    from sbi_for_diffusion_models_tpu_torch.mnle import run_inference_mcmc

    mix = ctx.mix
    prior, est = load(ctx)
    _, x, s = generator.sessions(generator.child(ctx.seed, 1), mix["sessions"], mix["trials"], ctx.device)
    cfg = run_config(ctx.config, mix)

    def request(i, cfg=cfg):
        k = i % x.shape[0]
        run_inference_mcmc(cfg, prior, est, x[k], s[k], ctx.device, seed=generator.child(ctx.seed, 2, i),
                           verbose=False)

    request(-1, run_config(ctx.config, mix, **mix["warmup_request"]))
    ctx.probe.start_window()
    return loop(ctx.probe, request)
