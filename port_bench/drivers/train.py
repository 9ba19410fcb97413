"""``train``: ``mnle.train_mnle`` on pairs made by the benchmark's
generator, from the benchmark's initial weights. Its first optimizer steps
belong to the set-up, through the same call and loader as the window's;
the window opens at step ``window_from_step`` of that call."""

from __future__ import annotations

import dataclasses
import json
import math
import types

import numpy as np
import torch

from .. import compare, generator
from ..probes import WindowClosed
from ..reference import train as ref_train
from .common import run_config, tf32

__all__ = ["run", "numbers", "control", "FAULTS", "initial_weights"]

FAULTS = ("half_batch", "state_unchanged")


def run(ctx) -> tuple[int, int]:
    from sbi_for_diffusion_models_tpu_torch import mnle
    from sbi_for_diffusion_models_tpu_torch.ops import _cuda

    mix = ctx.mix
    if ctx.device.type == "cuda":
        _cuda.build_all()
    z, x = generator.training_pairs(generator.child(ctx.seed, 4), mix["pairs"], ctx.device)
    ctx.data = (z, x)
    ctx.probe.weights = initial_weights(generator.child(ctx.seed, 5), ctx.shapes_leaves, ctx.device)
    ctx.probe.start_at_step = mix["window_from_step"]
    cfg = run_config(ctx.config, mix)
    n_val = int(mix["pairs"] * cfg.TRAIN_VALIDATION_FRACTION)

    def before_window(est):
        """The validation pass's row blocks, at their shapes, before the window."""
        with torch.no_grad():
            for n in {min(65_536, n_val), n_val % 65_536} - {0}:
                est.log_prob_fn(est.net, x[:n], z[:n])

    ctx.probe.before_window = before_window
    try:
        mnle.train_mnle(cfg, types.SimpleNamespace(theta_dim=5), z, x, ctx.device,
                        seed=generator.child(ctx.seed, 6), verbose=False)
    except WindowClosed:
        return 1, 0
    return 1, 1  # training stopped before the window closed


def initial_weights(seed: int, leaves: dict, device) -> dict:
    """The benchmark's initial weights, one normal draw for all of them: each
    kernel (in, out) with variance 1 / in (LeCun), biases and the
    cond-affine head zero (that layer starts as the identity)."""
    gen = generator.generator(seed, device)
    sizes = {n: int(torch.Size(s).numel()) for n, s in leaves.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in leaves.items():
        w = flat[at:at + sizes[name]].reshape(shape)
        at += sizes[name]
        if name.endswith("/bias") or name.startswith("affine_head/"):
            w = torch.zeros_like(w)
        else:
            w = w / float(shape[0]) ** 0.5
        out[name] = w
    return out


def _file_config(ctx) -> dict:
    with np.load(ctx.model_path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))["mnle_config"]


def _schedule(ctx) -> tuple[float, int]:
    """(initial learning rate, steps of the cosine schedule) of the cell."""
    rc = ctx.config["run_config"] | ctx.mix.get("run_config", {})
    total = ref_train.schedule_steps(ctx.mix["pairs"], rc["TRAIN_VALIDATION_FRACTION"], rc["TRAIN_BATCH_SIZE"],
                                     rc["TRAIN_MAX_EPOCHS"])
    return rc["TRAIN_LEARNING_RATE"], total


def _same(v, w) -> bool:
    as_list = (lambda u: list(u) if isinstance(u, (list, tuple)) else u)
    return as_list(v) == as_list(w)


def numbers(ctx, detail: bool = False) -> dict:
    """The first three optimizer steps against the float64 reference, the
    three batches against the training pairs, and the network the port
    built against the file's configuration."""
    cap = ctx.probe.train_capture
    if len(cap.get("batches", ())) < 3 or "after3" not in cap:
        return {"arch_mismatch": math.inf}
    ref_cfg = _file_config(ctx)
    prog_cfg = dataclasses.asdict(cap["cfg"])
    lr0, total = _schedule(ctx)
    z, x = ctx.data
    out = compare.train_numbers(ref_cfg, cap, ctx.probe.weights, z, x, lr0=lr0, total_steps=total, detail=detail)
    out["batch_rows_foreign"] = compare.foreign_rows(z, x, cap["batches"][:3])
    out["arch_mismatch"] = float(sum(1 for k, v in ref_cfg.items() if not _same(v, prog_cfg.get(k))))
    return out


def control(ctx) -> dict:
    """The same numbers with the reference's own steps in float32 with TF32
    products in the port's place, from the same weights and batches."""
    cap = ctx.probe.train_capture
    cfg = _file_config(ctx)
    lr0, total = _schedule(ctx)
    z, x = ctx.data
    with tf32():
        low = ref_train.steps(cfg, {k: v.float() for k, v in ctx.probe.weights.items()}, z, x, cap["batches"][:3],
                              lr0=lr0, total_steps=total)
    return compare.train_numbers(cfg, cap, ctx.probe.weights, z, x, lr0=lr0, total_steps=total, against=low,
                                 detail=True)
