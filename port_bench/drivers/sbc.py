"""``sbc``: ``mnle.run_sbc`` per request, each with its own seed, writing
its files under a temporary directory."""

from __future__ import annotations

import shutil
import tempfile

from .. import generator
from .common import SAMPLER_FAULTS as FAULTS
from .common import load, loop, run_config
from .common import sampler_control as control
from .common import sampler_numbers as numbers

__all__ = ["run", "numbers", "control", "FAULTS"]


def run(ctx) -> tuple[int, int]:
    from sbi_for_diffusion_models_tpu_torch.mnle import run_sbc

    mix = ctx.mix
    prior, est = load(ctx)
    cfg = run_config(ctx.config, mix)
    out = tempfile.mkdtemp(prefix="port_bench_sbc_")
    try:
        def request(i, cfg=cfg):
            run_sbc(cfg, prior, est, ctx.device, num_datasets=mix["datasets"], outdir=f"{out}/{i}",
                    seed=generator.child(ctx.seed, 3, i), verbose=False, group_size=mix["group_size"])
            shutil.rmtree(f"{out}/{i}", ignore_errors=True)

        request(-1, run_config(ctx.config, mix, **mix["warmup_request"]))
        ctx.probe.start_window()
        return loop(ctx.probe, request)
    finally:
        shutil.rmtree(out, ignore_errors=True)
