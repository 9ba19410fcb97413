"""Training checkpoint/resume (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/utils/checkpoint.py``, which
writes with orbax: here each checkpoint is one ``torch.save`` of a plain dict
(the parameters, the optimizer state, the step and the seed, where the JAX
package keeps its key's data), loaded back with ``weights_only=True``, at
``<directory>/<step>/train_state.pt``; the 3 newest steps are kept. The two
packages' checkpoints do not load in each other. ``config_fingerprint`` is
the JAX function's algorithm, so one config gives one hash in both.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

__all__ = [
    "config_fingerprint",
    "save_train_state",
    "restore_train_state",
    "latest_step",
]

_MAX_TO_KEEP = 3
_STATE_FILE = "train_state.pt"


def config_fingerprint(cfg) -> str:
    """Stable hash of a (dataclass) config for checkpoint compatibility checks."""
    blob = json.dumps({k: repr(v) for k, v in sorted(cfg.__dict__.items())}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _steps(directory: Path) -> list:
    """The steps with a complete checkpoint under ``directory``, ascending."""
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir() if p.name.isdigit() and (p / _STATE_FILE).is_file())


def save_train_state(
    directory: str | Path,
    step: int,
    params: Any,
    opt_state: Any,
    seed: int,
    cfg=None,
    extra: Optional[dict] = None,
) -> None:
    """Checkpoint full training state at ``step`` (epoch): ``params`` and
    ``opt_state`` (e.g. a module's and an optimizer's ``state_dict()``),
    ``seed`` and ``extra`` as given. The file is written under a temporary
    name and renamed, so a cut never leaves a partial checkpoint; then all
    but the newest 3 steps are removed."""
    directory = Path(directory).absolute()
    state = {"params": params, "opt_state": opt_state, "seed": int(seed), "meta": {"step": int(step)}}
    if extra:
        state["extra"] = extra
    step_dir = directory / str(int(step))
    step_dir.mkdir(parents=True, exist_ok=True)
    tmp = step_dir / (_STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, step_dir / _STATE_FILE)
    for old in _steps(directory)[:-_MAX_TO_KEEP]:
        shutil.rmtree(directory / str(old))
    if cfg is not None:
        (directory / "config_fingerprint.txt").write_text(config_fingerprint(cfg))


def latest_step(directory: str | Path) -> Optional[int]:
    steps = _steps(Path(directory).absolute())
    return steps[-1] if steps else None


def restore_train_state(
    directory: str | Path,
    abstract_state: Optional[dict] = None,
    step: Optional[int] = None,
    cfg=None,
) -> Optional[dict]:
    """Restore training state (tensors on the CPU); returns None when no
    checkpoint exists.

    ``abstract_state``, where given, is a state of the same structure (a
    fresh init): every tensor of its ``params`` must be in the checkpoint
    with the same shape, else ``ValueError``. When ``cfg`` is given, a
    fingerprint mismatch raises instead of silently resuming with different
    hyperparameters.
    """
    directory = Path(directory).absolute()
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    if cfg is not None:
        fp_file = directory / "config_fingerprint.txt"
        if fp_file.exists() and fp_file.read_text() != config_fingerprint(cfg):
            raise ValueError(
                f"checkpoint at {directory} was written with a different "
                "config; refusing to resume (delete the directory to restart)"
            )
    state = torch.load(directory / str(int(step)) / _STATE_FILE, map_location="cpu", weights_only=True)
    if abstract_state is not None and isinstance(abstract_state.get("params"), dict):
        want = {k: tuple(v.shape) for k, v in abstract_state["params"].items()}
        got = {k: tuple(v.shape) for k, v in state["params"].items()}
        if want != got:
            raise ValueError(f"checkpoint at {directory} step {step} holds other parameters than the state to "
                             f"restore: {sorted(set(want.items()) ^ set(got.items()))}")
    return state
