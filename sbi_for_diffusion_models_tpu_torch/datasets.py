"""Real behavioral-data utilities: pack experimental tables into MNLE's x.

Counterpart of ``sbi_for_diffusion_models_tpu/datasets.py``: a behavioral
table (a pandas DataFrame, or any mapping of column name to array, so pandas
stays optional) becomes the MNLE x-convention (N, 2) [rt, choice], with the
same drop, clamp and validation rules; the result is a float32 tensor on
``device`` (default: the CUDA card).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.device import resolve_device

__all__ = ["make_x_from_rat_df", "split_by_subject"]


def _col(df, name: str) -> np.ndarray:
    if hasattr(df, "columns") or isinstance(df, Mapping):  # a pandas DataFrame, or a mapping
        return np.asarray(df[name])
    raise TypeError(f"unsupported table type {type(df)}")


def make_x_from_rat_df(
    df,
    *,
    rt_col: str = "rt",
    choice_col: str = "choice",
    log_rt: bool = False,
    rt_min: float = 1e-6,
    rt_max: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Pack a behavioral table into the MNLE x-convention (N, 2) [rt, choice]:
    the RT column first (clamped to [rt_min, rt_max], optionally logged),
    the choice last as float, never logged. Rows with a non-finite RT or
    choice are dropped; a choice outside {0, 1, 2} raises ``ValueError``."""
    rt = np.asarray(_col(df, rt_col), np.float32)
    choice = np.asarray(_col(df, choice_col), np.float32)
    keep = np.isfinite(rt) & np.isfinite(choice)
    rt, choice = rt[keep], choice[keep]
    rt = np.maximum(rt, rt_min)
    if rt_max is not None:
        rt = np.minimum(rt, rt_max)
    if not np.isin(np.unique(choice), [0.0, 1.0, 2.0]).all():
        raise ValueError(f"choice column must be coded in {{0,1,2}}, got values {np.unique(choice)[:10]}")
    if log_rt:
        rt = np.log(rt)
    return torch.as_tensor(np.stack([rt, choice], axis=-1), device=resolve_device(device))


def split_by_subject(df, subject_col: str = "subject", **pack_kwargs) -> Tuple[Sequence, list]:
    """Per-subject packing for independent or hierarchical fits: returns
    (subject_ids, [x_subject ...]) in subject-id order; ``pack_kwargs`` go to
    ``make_x_from_rat_df`` (``device`` among them)."""
    subjects = np.asarray(_col(df, subject_col))
    ids = sorted(set(subjects.tolist()))
    xs = []
    for sid in ids:
        mask = subjects == sid
        sub = df[mask] if hasattr(df, "loc") else {k: np.asarray(v)[mask] for k, v in df.items()}
        xs.append(make_x_from_rat_df(sub, **pack_kwargs))
    return ids, xs
